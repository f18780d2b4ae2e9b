"""The paper's own models, ViT and ResNet-50 with CIFAR-100 heads (twin of
``repro/models/vision.py``).

Params keep the reference's keys, shapes and layouts, so a JAX param tree
converts leaf for leaf (``repro_torch.convert``): the ViT's layers stacked
on a leading ``n_layers`` axis (the reference's ``jax.vmap(layer)``),
ResNet's conv weights HWIO and its ``stage{s}`` lists of block dicts.
Images are NHWC, as in the reference.

The ViT's self-attention runs through the port's flash kernel with
``causal=False`` (``kernels.ops.flash_attention``; on the CPU its plain
version), where the reference attends through plain ``_sdpa``: the port
puts its kernels wherever the reference computes the same function in
plain jnp.  LayerNorm stays plain, as in the reference.  ResNet-50 runs no
kernel of the port's: its convolutions are library convolutions
(``F.conv2d``, the reference's ``lax.conv_general_dilated``) and its
BatchNorm ``F.batch_norm`` on batch statistics.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch import device as _device
from repro_torch import tree
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L

Params = dict


def _generator(device, generator, seed):
    dev = _device.resolve(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    return dev, generator


# ---------------------------------------------------------------------------
# ViT
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 32          # CIFAR-100
    patch: int = 4                # 32/4 = 8x8 = 64 patches (paper uses /16 at 224)
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    n_classes: int = 100
    dtype: str = "float32"

    @property
    def n_patches(self):
        return (self.image_size // self.patch) ** 2


def _attn_cfg(cfg: ViTConfig) -> L.AttnConfig:
    return L.AttnConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                        n_kv_heads=cfg.n_heads,
                        head_dim=cfg.d_model // cfg.n_heads,
                        use_rope=False, causal=False, bias=True)


def init_vit(cfg: ViTConfig, *, device=None,
             generator: torch.Generator | None = None,
             seed: int = 0) -> Params:
    """Random params with the reference ``init_vit``'s keys, shapes, dtypes
    and distributions, drawn on ``device`` (CUDA unless asked otherwise)
    from ``generator`` (default: one on that device seeded with
    ``seed``)."""
    dev, gen = _generator(device, generator, seed)
    dt = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    kw = dict(generator=gen, device=dev, dtype=dt)
    n = cfg.n_layers
    return {
        "patch_proj": L.init_dense(3 * cfg.patch * cfg.patch, cfg.d_model,
                                   bias=True, **kw),
        "cls": L._normal((1, 1, cfg.d_model), dt, 0.02, gen, dev),
        "pos": L._normal((1, cfg.n_patches + 1, cfg.d_model), dt, 0.02, gen,
                         dev),
        "layers": {
            "norm1": L.init_layernorm(cfg.d_model, device=dev, dtype=dt,
                                      repeat=n),
            "attn": L.init_attention(_attn_cfg(cfg), repeat=n, **kw),
            "norm2": L.init_layernorm(cfg.d_model, device=dev, dtype=dt,
                                      repeat=n),
            "mlp": L.init_mlp(cfg.d_model, cfg.d_ff, act="gelu", bias=True,
                              repeat=n, **kw)},
        "final_norm": L.init_layernorm(cfg.d_model, device=dev, dtype=dt),
        "head": L.init_dense(cfg.d_model, cfg.n_classes, bias=True, **kw),
    }


def _attention(p: Params, cfg: ViTConfig, x: torch.Tensor) -> torch.Tensor:
    """Bidirectional multi-head self-attention with biased projections,
    through the flash kernel (head dim d_model / n_heads)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    D = cfg.d_model // H
    q, k, v = (L.dense(p[w], x).reshape(B, S, H, D)
               for w in ("wq", "wk", "wv"))
    o = kops.flash_attention(q, k, v, scale=1.0 / math.sqrt(D), causal=False)
    return L.dense(p["wo"], o.reshape(B, S, H * D))


def _embed(params: Params, cfg: ViTConfig,
           images: torch.Tensor) -> torch.Tensor:
    """Patchify (rows in the reference's order), project, prepend the cls
    token, add the positions.  The activations take the promoted type of
    the images and the params, as in the reference (fp32 images over bf16
    params compute in fp32)."""
    Bsz = images.shape[0]
    p = cfg.patch
    g = cfg.image_size // p
    x = images.reshape(Bsz, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(Bsz, g * g, p * p * 3)
    x = L.dense(params["patch_proj"], x)
    cls = params["cls"].expand(Bsz, 1, cfg.d_model)
    dt = torch.promote_types(x.dtype, cls.dtype)
    return torch.cat([cls.to(dt), x.to(dt)], dim=1) + params["pos"]


def _mixer(lp: Params, cfg: ViTConfig, x: torch.Tensor) -> torch.Tensor:
    return x + _attention(lp["attn"], cfg, L.layernorm(lp["norm1"], x))


def _ffn(lp: Params, x: torch.Tensor) -> torch.Tensor:
    return x + L.mlp(lp["mlp"], L.layernorm(lp["norm2"], x), "gelu")


def _head(params: Params, x: torch.Tensor) -> torch.Tensor:
    x = L.layernorm(params["final_norm"], x)
    return L.dense(params["head"], x[:, 0]).float()


def vit_apply(params: Params, cfg: ViTConfig,
              images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, 3) -> fp32 logits (B, n_classes)."""
    x = _embed(params, cfg, images)
    for i in range(cfg.n_layers):
        lp = tree.map(lambda t: t[i], params["layers"])   # views
        x = _ffn(lp, _mixer(lp, cfg, x))
    return _head(params, x)


# ---------------------------------------------------------------------------
# ResNet-50 (BN with batch statistics; CIFAR stem)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple = (3, 4, 6, 3)   # ResNet-50
    width: int = 64
    n_classes: int = 100
    image_size: int = 32


def _init_conv(gen, dev, kh, kw, cin, cout) -> Params:
    fan_in = kh * kw * cin
    return {"w": L._normal((kh, kw, cin, cout), torch.float32,
                           math.sqrt(2.0 / fan_in), gen, dev)}


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one axis: the output has ceil(n / s) rows,
    and the padding they need goes low // 2, the rest high (so (0, 1) for
    a 3-wide kernel at stride 2 over an even size)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(p: Params, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC x, HWIO weight, "SAME" padding -> NHWC.  The conv runs on the
    NCHW view of x, which is channels_last in memory, so the activations
    are not copied to change layout (only padded, where XLA's padding is
    not symmetric)."""
    kh, kw = p["w"].shape[:2]
    (t, b), (lft, r) = (_same_pads(x.shape[1], kh, stride),
                        _same_pads(x.shape[2], kw, stride))
    y = x.permute(0, 3, 1, 2)
    pad = 0
    if (t, lft) == (b, r):
        pad = (t, lft)
    else:
        y = F.pad(y, (lft, r, t, b))
    y = F.conv2d(y, p["w"].permute(3, 2, 0, 1), stride=stride,
                 padding=pad)
    return y.permute(0, 2, 3, 1)


def _init_bn(c, dev) -> Params:
    return {"scale": torch.ones((c,), device=dev),
            "bias": torch.zeros((c,), device=dev)}


def _bn(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm on the batch's statistics over N, H and W (the population
    variance, as ``jnp.var``; no running statistics), on NHWC x."""
    y = F.batch_norm(x.permute(0, 3, 1, 2), None, None, p["scale"],
                     p["bias"], training=True, eps=eps)
    return y.permute(0, 2, 3, 1)


def _init_bottleneck(gen, dev, cin, cmid, cout, stride) -> Params:
    p = {"conv1": _init_conv(gen, dev, 1, 1, cin, cmid),
         "bn1": _init_bn(cmid, dev),
         "conv2": _init_conv(gen, dev, 3, 3, cmid, cmid),
         "bn2": _init_bn(cmid, dev),
         "conv3": _init_conv(gen, dev, 1, 1, cmid, cout),
         "bn3": _init_bn(cout, dev)}
    if stride != 1 or cin != cout:
        p["proj"] = _init_conv(gen, dev, 1, 1, cin, cout)
        p["proj_bn"] = _init_bn(cout, dev)
    return p


def _bottleneck(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    r = x
    y = F.relu(_bn(p["bn1"], _conv(p["conv1"], x)))
    y = F.relu(_bn(p["bn2"], _conv(p["conv2"], y, stride)))
    y = _bn(p["bn3"], _conv(p["conv3"], y))
    if "proj" in p:
        r = _bn(p["proj_bn"], _conv(p["proj"], x, stride))
    return F.relu(y + r)


def init_resnet(cfg: ResNetConfig, *, device=None,
                generator: torch.Generator | None = None,
                seed: int = 0) -> Params:
    """Random fp32 params with the reference ``init_resnet``'s keys,
    shapes and distributions (He-normal convs, unit BN scales)."""
    dev, gen = _generator(device, generator, seed)
    params = {"stem": _init_conv(gen, dev, 3, 3, 3, cfg.width),
              "stem_bn": _init_bn(cfg.width, dev)}
    cin = cfg.width
    for s, n_blocks in enumerate(cfg.stage_sizes):
        cmid = cfg.width * (2 ** s)
        cout = cmid * 4
        blocks = []
        for b in range(n_blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            blocks.append(_init_bottleneck(gen, dev, cin, cmid, cout, stride))
            cin = cout
        params[f"stage{s}"] = blocks
    params["head"] = L.init_dense(cin, cfg.n_classes, bias=True,
                                  generator=gen, device=dev)
    return params


def resnet_apply(params: Params, cfg: ResNetConfig,
                 images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, 3) -> fp32 logits (B, n_classes)."""
    x = F.relu(_bn(params["stem_bn"], _conv(params["stem"], images)))
    for s, n_blocks in enumerate(cfg.stage_sizes):
        for b in range(n_blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            x = _bottleneck(params[f"stage{s}"][b], x, stride)
    x = torch.mean(x, dim=(1, 2))
    return L.dense(params["head"], x).float()
