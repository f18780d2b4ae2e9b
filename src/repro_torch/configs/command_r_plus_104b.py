"""command-r-plus-104b [dense] — GQA kv=8, no-bias
(hf:CohereForAI/c4ai-command-r-v01 family).  long_500k skipped."""
from repro_torch.configs.base import ArchConfig, Segment

ARCH = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab=256000,
    pattern=(Segment(("attn",), 64),),
    tie_embeddings=True,
    notes="sequential pre-norm blocks (upstream uses parallel attn+FFN; "
          "sequential kept for substrate uniformity — FLOPs identical)",
)
