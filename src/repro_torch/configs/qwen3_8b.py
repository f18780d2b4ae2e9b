"""qwen3-8b [dense] — per-head q/k RMSNorm, GQA kv=8 (hf:Qwen/Qwen3-8B).
long_500k skipped."""
from repro_torch.configs.base import ArchConfig, Segment

ARCH = ArchConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    pattern=(Segment(("attn",), 36),),
)
