"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block
(arXiv:2411.15242).  54 Mamba2 layers; one *shared-weight* transformer block
applied every 6 layers (9 applications) on concat(hidden, embeddings), with a
per-application output projection.  Runs long_500k (sub-quadratic)."""
from repro_torch.configs.base import ArchConfig, SSMSpec, Segment

ARCH = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    act="geglu",
    pattern=(Segment(("shared_attn", "mamba2", "mamba2", "mamba2",
                      "mamba2", "mamba2", "mamba2"), 9),),
    ssm=SSMSpec(d_state=64, head_dim=64, expand=2, n_groups=1),
    sub_quadratic=True,
    tie_embeddings=True,
    notes="shared attn block on 2*d_model concat; 9 applications over 54 mamba layers",
)
