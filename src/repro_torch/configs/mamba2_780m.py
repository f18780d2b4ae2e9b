"""mamba2-780m [ssm] — attention-free SSD (arXiv:2405.21060).
d_inner=3072, 48 heads x head_dim 64, d_state=128.  Decode carries O(1)
recurrent state; runs long_500k."""
from repro_torch.configs.base import ArchConfig, SSMSpec, Segment

ARCH = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,          # attention-free; SSD heads live in SSMSpec
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    pattern=(Segment(("mamba2",), 48),),
    ssm=SSMSpec(d_state=128, head_dim=64, expand=2, n_groups=1),
    sub_quadratic=True,
    tie_embeddings=True,
)
