"""llama-3.2-vision-90b [vlm] — 100-layer backbone: 80 self-attention +
20 gated cross-attention layers (every 5th).  The vision frontend is a
stub, as in the reference: a request or a batch carries precomputed patch
embeddings (B, 1601, d_model)."""
from repro_torch.configs.base import ArchConfig, Segment

ARCH = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    rope_theta=500000.0,
    pattern=(Segment(("attn", "attn", "attn", "attn", "cross_attn"), 20),),
    frontend="vision",
    n_img_tokens=1601,
    notes="tanh-gated cross-attn/MLP on image layers; frontend stubbed",
)
