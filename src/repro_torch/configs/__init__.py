"""Architecture registry: the ten reference configs, every one of which
the port serves (``qwen3-8b``, ``mamba2-780m``, ``zamba2-2.7b``,
``gemma-7b``, ``minitron-4b``, ``command-r-plus-104b``,
``deepseek-v3-671b``, ``arctic-480b``, ``whisper-medium`` and
``llama-3.2-vision-90b``)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (SHAPES, ArchConfig, EncoderSpec,
                                      MLASpec, MoESpec, Segment, ShapeSpec,
                                      SSMSpec, shape_applicable)
from repro_torch.configs import (arctic_480b, command_r_plus_104b,
                                 deepseek_v3_671b, gemma_7b,
                                 llama_3_2_vision_90b, mamba2_780m,
                                 minitron_4b, qwen3_8b, whisper_medium,
                                 zamba2_2_7b)

ARCHS: dict[str, ArchConfig] = {m.ARCH.name: m.ARCH
                                for m in (zamba2_2_7b, gemma_7b, qwen3_8b,
                                          mamba2_780m, minitron_4b,
                                          command_r_plus_104b,
                                          deepseek_v3_671b, arctic_480b,
                                          whisper_medium,
                                          llama_3_2_vision_90b)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduce_for_smoke(arch: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke runs: small width, few
    layers/experts, tiny vocab — structure preserved."""
    pattern = tuple(Segment(s.blocks, min(s.repeat, 2)) for s in arch.pattern)
    kw = dict(
        name=arch.name + "-smoke",
        d_model=128,
        n_heads=4,
        n_kv_heads=min(arch.n_kv_heads, 4) if arch.n_kv_heads < arch.n_heads else 4,
        head_dim=32 if arch.head_dim else None,
        d_ff=256 if arch.d_ff else 0,
        vocab=512,
        n_layers=sum(len(s.blocks) * min(s.repeat, 2) for s in arch.pattern),
        pattern=pattern,
        dtype="float32",
        param_dtype="float32",
        n_img_tokens=min(arch.n_img_tokens, 16),
    )
    if arch.moe:
        kw["moe"] = dataclasses.replace(
            arch.moe, n_experts=4, top_k=min(arch.moe.top_k, 2), d_ff=64,
            shared_d_ff=64 if arch.moe.n_shared_experts else 0,
            dense_d_ff=64 if arch.moe.dense_d_ff else 0, capacity_factor=2.0)
    if arch.ssm:
        kw["ssm"] = dataclasses.replace(arch.ssm, d_state=16, head_dim=16,
                                        chunk=16)
    if arch.mla:
        kw["mla"] = MLASpec(q_lora_rank=64, kv_lora_rank=32,
                            qk_nope_head_dim=32, qk_rope_head_dim=16,
                            v_head_dim=32)
    if arch.encoder:
        kw["encoder"] = EncoderSpec(n_layers=2, seq_len=24, d_ff=256)
    return dataclasses.replace(arch, **kw)


__all__ = ["ARCHS", "get_arch", "reduce_for_smoke", "SHAPES", "ShapeSpec",
           "shape_applicable", "ArchConfig", "Segment", "MoESpec", "SSMSpec",
           "MLASpec", "EncoderSpec"]
