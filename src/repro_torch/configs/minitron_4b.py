"""minitron-4b [dense] — pruned Nemotron geometry (arXiv:2407.14679):
24 heads (24 % 16 != 0 -> attention mixer replicated under MP, DESIGN.md §5).
long_500k skipped."""
from repro_torch.configs.base import ArchConfig, Segment

ARCH = ArchConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab=256000,
    pattern=(Segment(("attn",), 32),),
)
