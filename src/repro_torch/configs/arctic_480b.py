"""arctic-480b [moe] — Snowflake Arctic: dense-MoE hybrid, 128 experts top-2
with a parallel dense residual FFN (hf:Snowflake/snowflake-arctic-base)."""
from repro_torch.configs.base import ArchConfig, MoESpec, Segment

ARCH = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,                # 56 % 16 != 0: attention mixer weights stay
    n_kv_heads=8,              # replicated under MP (DESIGN.md §5)
    d_ff=4864,
    vocab=32000,
    pattern=(Segment(("moe_attn",), 35),),
    moe=MoESpec(n_experts=128, top_k=2, d_ff=4864, dense_d_ff=4864,
                capacity_factor=1.25),
    notes="dense residual FFN in parallel with 128e top-2 MoE",
)
