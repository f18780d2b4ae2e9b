"""deepseek-v3-671b [moe] — MLA + 1 shared + 256 routed top-8 experts + MTP
(arXiv:2412.19437).  First 3 layers dense (d_ff 18432); 58 MoE layers with
per-expert d_ff=2048; sigmoid routing renormalized over the selected top-8."""
from repro_torch.configs.base import ArchConfig, MLASpec, MoESpec, Segment

ARCH = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,                 # dense-layer FFN (first 3 layers)
    vocab=129280,
    pattern=(Segment(("mla_dense",), 3), Segment(("mla",), 58)),
    moe=MoESpec(n_experts=256, top_k=8, d_ff=2048, router="sigmoid",
                n_shared_experts=1, shared_d_ff=2048, capacity_factor=1.25),
    mla=MLASpec(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                qk_rope_head_dim=64, v_head_dim=128),
    mtp=True,
    notes="MLA latent KV cache (512+64/token); MTP depth-1 head",
)
