"""gemma-7b [dense] — GeGLU, head_dim=256 (q_dim 4096 > d_model 3072),
16 heads MHA (arXiv:2403.08295).  long_500k skipped."""
from repro_torch.configs.base import ArchConfig, Segment

ARCH = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab=256000,
    act="geglu",
    tie_embeddings=True,
    pattern=(Segment(("attn",), 28),),
)
