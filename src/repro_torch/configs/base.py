"""Architecture config schema (the port's own copy of ``repro.configs.base``).

An ``ArchConfig`` fully describes a model: geometry, block kinds, and the
*stack pattern* — an ordered list of ``Segment``s, each a group of block
kinds applied ``repeat`` times with their params stacked on a leading axis.

Block kinds named by the schema:
  attn        — self-attention (GQA/MQA/qk-norm) + dense MLP
  mla         — multi-head latent attention + (dense | MoE) FFN
  moe_attn    — self-attention + MoE FFN
  mamba2      — SSD block (attention-free)
  shared_attn — zamba2-style *shared-weight* attention block
  cross_attn  — gated cross-attention + MLP (llama-vision)
  enc_attn    — bidirectional self-attention + MLP (encoders)
  wdec        — whisper decoder block: causal self-attention, cross
                attention over the encoder output, MLP

The port runs every kind named here (and ``mla_dense``, MLA with a dense
MLP); the serving engine serves them all but ``enc_attn``, which runs in
the encoder only, and raises ``NotImplementedError`` naming an unknown
kind at construction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Segment:
    blocks: tuple[str, ...]   # block kinds applied in order within the group
    repeat: int               # group is applied `repeat` times


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden
    router: str = "softmax"
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    dense_d_ff: int = 0            # arctic parallel dense FFN
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class MLASpec:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    n_layers: int
    seq_len: int              # fixed encoder length (whisper: 1500 frames)
    d_ff: int


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None      # default d_model // n_heads
    act: str = "silu"
    qk_norm: bool = False
    attn_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"
    pattern: tuple[Segment, ...] = ()
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    mla: Optional[MLASpec] = None
    encoder: Optional[EncoderSpec] = None     # enc-dec archs
    frontend: Optional[str] = None            # "audio" | "vision" stub
    n_img_tokens: int = 1601                  # vlm stub cross-kv length
    mtp: bool = False                         # DeepSeek-V3 multi-token predict
    sub_quadratic: bool = False               # eligible for long_500k
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"             # production default; smoke: fp32
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (the reference shards the
        embedding table evenly this way; the port keeps the same param
        shapes so checkpoints convert leaf for leaf).  Greedy sampling and
        the loss mask the padding logits."""
        return ((self.vocab + 255) // 256) * 256

    def scaled(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# input shapes assigned to the LM family (the planner's workloads)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """long_500k only runs on sub-quadratic archs (SSM/hybrid)."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, ("skipped: pure full-attention arch — a 512k dense-attention "
                       "KV decode requires sub-quadratic attention (DESIGN.md §5)")
    return True, ""
