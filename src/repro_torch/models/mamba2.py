"""Mamba2 block — SSD (state-space duality) form, arXiv:2405.21060 (twin of
``repro/models/mamba2.py``).

Prefill, the whole-sequence forward and training run the chunked SSD
scan through the port's Hopper kernels (``kernels.ops.ssd_scan``) whatever
``impl`` is, as the port does with RMSNorm: on CUDA the scan is the
kernel forward and backward (its gradient is ``csrc/ssd_scan_bwd.cu``),
where the reference computes the same math in jnp (``_ssd_chunked``,
which it differentiates) under ``impl="xla"`` and in its Pallas kernel
under ``impl="pallas"``.  On the CPU the scan is the plain version, which
autograd differentiates.  Decode is the O(1) recurrent update carrying
``(conv_state, ssm_state)``, plain PyTorch as in the reference.

Projections stay separate (z/x/B/C/dt, one causal conv per stream), as the
reference keeps them, so its params convert leaf for leaf.

Under tensor parallelism (``split``, a ``HeadSplit``) a rank runs the
mixer on its own heads, as GSPMD partitions the reference's: its columns
of z/x/dt_proj, its conv_x channels, A_log, D and gated-norm scale, its
rows of out_proj, and its slices of the conv_x and ssm state; B and C
(b/c_proj, conv_b/c, replicated) are computed whole on every rank and
handed to the scan at the groups of its heads.  The gated norm runs over
the whole d_inner: one all-reduce of each row's sum of squares over the
group (``kernels.ops.rmsnorm_split``).  What the caller does: Megatron's f
on the input and the all-reduce after out_proj, whose bias it adds once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L

Params = dict


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 128

    @property
    def d_inner(self):
        return self.expand * self.d_model

    @property
    def n_heads(self):
        return self.d_inner // self.head_dim

    @property
    def d_bc(self):
        return self.n_groups * self.d_state


@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """The mixer's heads over the ``size`` ranks of ``group``, in order:
    rank ``rank`` holds heads rank * H / size onward."""
    group: object
    size: int
    rank: int


def _stacked(draw, repeat: Optional[int]) -> torch.Tensor:
    """``draw()`` once, or ``repeat`` independent draws stacked on a
    leading axis (a segment's repeat axis)."""
    if repeat is None:
        return draw()
    return torch.stack([draw() for _ in range(repeat)])


def init_mamba2(cfg: Mamba2Config, *, generator, device,
                dtype=torch.float32, repeat: Optional[int] = None) -> Params:
    """The reference's shapes and distributions, drawn from ``generator``.
    ``A_log``, ``dt_bias`` and ``D`` stay float32 whatever ``dtype`` is."""
    H = cfg.n_heads
    kw = dict(generator=generator, device=device, dtype=dtype, repeat=repeat)
    lead = () if repeat is None else (repeat,)

    def dt_bias():
        u = torch.rand((H,), generator=generator, device=device)
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001))
                       + math.log(0.001))
        return dt + torch.log(-torch.expm1(-dt))       # inverse softplus

    def conv(width):
        return {"w": _stacked(lambda: L._normal(
                    (cfg.d_conv, width), dtype, 1.0 / math.sqrt(cfg.d_conv),
                    generator, device), repeat),
                "b": torch.zeros(lead + (width,), dtype=dtype, device=device)}

    a_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                   device=device))
    return {
        "z_proj": L.init_dense(cfg.d_model, cfg.d_inner, **kw),
        "x_proj": L.init_dense(cfg.d_model, cfg.d_inner, **kw),
        "b_proj": L.init_dense(cfg.d_model, cfg.d_bc, **kw),
        "c_proj": L.init_dense(cfg.d_model, cfg.d_bc, **kw),
        "dt_proj": L.init_dense(cfg.d_model, H, **kw),
        "conv_x": conv(cfg.d_inner),
        "conv_b": conv(cfg.d_bc),
        "conv_c": conv(cfg.d_bc),
        "A_log": a_log.expand(lead + (H,)).clone(),
        "dt_bias": _stacked(dt_bias, repeat),
        "D": torch.ones(lead + (H,), dtype=torch.float32, device=device),
        "norm": L.init_rmsnorm(cfg.d_inner, device=device, dtype=dtype,
                               repeat=repeat),
        "out_proj": L.init_dense(cfg.d_inner, cfg.d_model,
                                 scale=1.0 / math.sqrt(cfg.d_inner), **kw),
    }


def init_mamba2_cache(cfg: Mamba2Config, batch: int, *, device,
                      dtype=torch.float32,
                      repeat: Optional[int] = None) -> Params:
    """Conv buffers (batch, d_conv-1, C) and SSM state (batch, H, P, N),
    zeroed; ``repeat`` stacks them on a leading axis."""
    K = cfg.d_conv - 1
    lead = () if repeat is None else (repeat,)

    def zeros(*shape):
        return torch.zeros(lead + (batch,) + shape, dtype=dtype,
                           device=device)
    return {"conv_x": zeros(K, cfg.d_inner),
            "conv_b": zeros(K, cfg.d_bc),
            "conv_c": zeros(K, cfg.d_bc),
            "ssm": zeros(cfg.n_heads, cfg.head_dim, cfg.d_state)}


def _causal_conv(u: torch.Tensor, conv: Params,
                 left: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d + silu. u: (B,S,C); w: (K,C).  ``left``
    (B, K-1, C) supplies the raw inputs preceding u (the carried conv
    buffer during chunked prefill); None means zero left context."""
    w = conv["w"]
    K = w.shape[0]
    if left is None:
        pad = F.pad(u, (0, 0, K - 1, 0))
    else:
        pad = torch.cat([left.to(u.dtype), u], dim=1)
    out = sum(pad[:, k: k + u.shape[1], :] * w[k].to(u.dtype)
              for k in range(K))
    return F.silu(out + conv["b"].to(u.dtype))


def _conv_tail(buf: torch.Tensor, raw: torch.Tensor,
               new_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next conv buffer: the last (d_conv-1) valid raw inputs of
    buffer+chunk.  Rows >= new_lens[b] are padding and skipped; the old
    buffer supplies the left context a short chunk lacks."""
    K = buf.shape[1]
    full = torch.cat([buf, raw.to(buf.dtype)], dim=1)              # (B,K+S,C)
    if new_lens is None:
        return full[:, -K:, :]
    idx = new_lens.long()[:, None] + torch.arange(K, device=buf.device)
    return torch.gather(full, 1, idx[:, :, None].expand(-1, -1,
                                                        full.shape[2]))


def _conv_step(u_new: torch.Tensor, buf: torch.Tensor,
               conv: Params) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token conv update. u_new: (B,1,C); buf: (B,K-1,C)."""
    w = conv["w"]
    full = torch.cat([buf, u_new.to(buf.dtype)], dim=1)           # (B,K,C)
    out = sum(full[:, k, :] * w[k].to(buf.dtype) for k in range(w.shape[0]))
    out = F.silu(out + conv["b"].to(buf.dtype))
    return out[:, None, :], full[:, 1:, :]


def mamba2(p: Params, cfg: Mamba2Config, x: torch.Tensor, *,
           cache: Optional[Params] = None,
           new_lens: Optional[torch.Tensor] = None,
           impl: str = "xla",
           split: Optional[HeadSplit] = None
           ) -> tuple[torch.Tensor, Optional[Params]]:
    """x: (B,S,D).  With ``cache`` and S==1 runs the recurrent decode path.

    With ``cache`` and S>1 (prefill) the cached conv buffers supply the raw
    left context and the cached SSM state seeds the scan (h0), so a prompt
    may be fed in several chunks.  ``new_lens`` (B,) marks token rows >=
    new_lens[b] as padding: their dt is zeroed (decay 1, zero input) and
    they never enter the carried conv buffer.  ``impl`` is accepted for the
    reference's signature; the scan is the port's kernel either way, and
    differentiable: under grad its backward is the backward kernel.

    With ``split`` the params and ``cache`` are this rank's (the module
    docstring says which leaves are sliced), the heads are its own and the
    output is its share of out_proj's product: all-reduced over the group
    by the caller."""
    Bsz, S, _ = x.shape
    H, P, G, N = cfg.n_heads, cfg.head_dim, cfg.n_groups, cfg.d_state
    dt_bias = p["dt_bias"]
    groups = tuple(range(G))                   # the B/C groups of our heads
    if split is not None:
        H //= split.size
        dt_bias = dt_bias[split.rank * H:(split.rank + 1) * H]
        groups = L.local_groups(cfg.n_heads, G, split.size, split.rank)
    z = L.dense(p["z_proj"], x)
    xr = L.dense(p["x_proj"], x)
    br = L.dense(p["b_proj"], x)
    cr = L.dense(p["c_proj"], x)
    dt_raw = L.dense(p["dt_proj"], x)
    A = -torch.exp(p["A_log"])                                     # (H,)
    dt = F.softplus(dt_raw.float() + dt_bias)                      # (B,S,H)

    def own(t):
        """B or C (..., G, N) at the groups of this rank's heads."""
        return t if groups == tuple(range(G)) else t[..., list(groups), :]

    if cache is not None and S == 1:
        head_group = torch.arange(H, device=x.device) // (H // len(groups))
        xu, conv_x = _conv_step(xr, cache["conv_x"], p["conv_x"])
        bu, conv_b = _conv_step(br, cache["conv_b"], p["conv_b"])
        cu, conv_c = _conv_step(cr, cache["conv_c"], p["conv_c"])
        xs = xu.reshape(Bsz, H, P).float()
        Bm = own(bu.reshape(Bsz, G, N)).float()
        Cm = own(cu.reshape(Bsz, G, N)).float()
        a = torch.exp(dt[:, 0] * A[None, :])                       # (B,H)
        Bh, Chd = Bm[:, head_group], Cm[:, head_group]             # (B,H,N)
        h = (cache["ssm"].float() * a[:, :, None, None]
             + torch.einsum("bh,bhp,bhn->bhpn", dt[:, 0], xs, Bh))
        y = torch.einsum("bhpn,bhn->bhp", h, Chd)
        y = y + p["D"][None, :, None] * xs
        y = y.reshape(Bsz, 1, H * P)
        new_cache = {"conv_x": conv_x, "conv_b": conv_b, "conv_c": conv_c,
                     "ssm": h.to(cache["ssm"].dtype)}
    else:
        left = cache if cache is not None else {}
        xc = _causal_conv(xr, p["conv_x"], left=left.get("conv_x"))
        bc = _causal_conv(br, p["conv_b"], left=left.get("conv_b"))
        cc = _causal_conv(cr, p["conv_c"], left=left.get("conv_c"))
        xs = xc.reshape(Bsz, S, H, P)
        Bm = own(bc.reshape(Bsz, S, G, N))
        Cm = own(cc.reshape(Bsz, S, G, N))
        if new_lens is not None:
            # padded tail rows: dt=0 => decay 1, zero input — state untouched
            valid = torch.arange(S, device=x.device)[None, :] < \
                new_lens[:, None]                                  # (B,S)
            dt = torch.where(valid[:, :, None], dt,
                             torch.zeros((), device=x.device))
        a = dt * A[None, None, :]                                  # (B,S,H)
        h0 = cache["ssm"] if cache is not None else None
        y, h_final = kops.ssd_scan(xs, Bm, Cm, dt, a, h0=h0, chunk=cfg.chunk)
        y = y + p["D"][None, None, :, None] * xs.float()
        y = y.reshape(Bsz, S, H * P)
        new_cache = None
        if cache is not None:
            # prefill -> decode handoff: the last (d_conv-1) *valid* raw
            # inputs of buffer+chunk
            new_cache = {
                "conv_x": _conv_tail(cache["conv_x"], xr, new_lens),
                "conv_b": _conv_tail(cache["conv_b"], br, new_lens),
                "conv_c": _conv_tail(cache["conv_c"], cr, new_lens),
                "ssm": h_final.to(cache["ssm"].dtype),
            }

    y = y.to(x.dtype) * F.silu(z)
    if split is None:
        y = L.rmsnorm(p["norm"], y)
    else:       # this rank's columns of a norm over the whole d_inner
        y = kops.rmsnorm_split(y, p["norm"]["scale"], d_total=cfg.d_inner,
                               group=split.group)
    return L.dense(p["out_proj"], y), new_cache


def mamba2_slot(p: Params, cfg: Mamba2Config, x: torch.Tensor, *,
                pool: Params, slot_ids: torch.Tensor,
                new_lens: Optional[torch.Tensor] = None,
                impl: str = "xla",
                split: Optional[HeadSplit] = None
                ) -> tuple[torch.Tensor, Params]:
    """Serving path over a *slot-indexed state pool* (continuous batching).

    pool: the mamba2 cache dict with a leading (slots+1) row axis shared by
    every in-flight request — row i holds engine slot i's recurrent state
    and the last row is the reserved null slot.  ``slot_ids`` (B,) maps
    each batch row to its pool row; inactive rows point at the null slot,
    so their garbage lands in scratch no live request reads.  With
    ``split`` (``mamba2``'s) the pool is this rank's: its conv_x channels
    and ssm heads, and conv_b / conv_c whole, which every rank computes
    alike.

    Gather rows -> the exact recurrence / chunked scan on them (decode when
    S==1 and new_lens is None, chunk-prefill otherwise) -> scatter the
    updated rows back IN PLACE; the pool returned is the one passed in."""
    idx = slot_ids.long()
    rows = {k: t[idx] for k, t in pool.items()}
    decode = x.shape[1] == 1 and new_lens is None
    y, new_rows = mamba2(p, cfg, x, cache=rows,
                         new_lens=None if decode else new_lens, impl=impl,
                         split=split)
    for k, t in pool.items():
        t[idx] = new_rows[k].to(t.dtype)
    return y, pool
