"""Plain PyTorch versions of every kernel (allclose targets in tests and in
``chip_smoke.py``).  Straightforward math, no tiling: they say WHAT the
kernels compute, in the same layouts as the port's kernel wrappers."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * scale over the last axis, in fp32,
    cast back to x.dtype.  x: (..., D); scale: (D,)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


class _SumOver(torch.autograd.Function):
    """The sum of a tensor over the ranks of ``group`` (an all-reduce), and
    the same of its gradient: each rank's output feeds that rank's own
    terms, so every input's gradient is the sum of theirs."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def rmsnorm_split_ref(x: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-6, *, d_total: int,
                      group=None) -> torch.Tensor:
    """``rmsnorm_ref`` of a row split over the ranks of ``group``: x (...,
    D) and scale (D,) are this rank's D of the row's ``d_total`` columns;
    the mean of squares is the sum over every rank's columns (one
    all-reduce, whose gradient is one more) over d_total.  Without a group
    the row is whole here (d_total = D)."""
    xf = x.float()
    ss = xf.square().sum(dim=-1, keepdim=True)
    if group is not None:
        ss = _SumOver.apply(ss, group)
    return (xf * torch.rsqrt(ss / d_total + eps) * scale.float()).to(x.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: float, causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,D); k,v: (B,T,Hkv,D) with Hkv | H — q head h reads kv
    head h // (H // Hkv).  fp32 softmax over dense logits; the causal mask
    is top-left aligned (query i sees keys 0..i, both counted from 0, also
    when S != T) with the finite mask value -1e30.  Returns q.dtype."""
    H, Hkv = q.shape[2], k.shape[2]
    S, T = q.shape[1], k.shape[1]
    kf = k.float().repeat_interleave(H // Hkv, dim=2)
    vf = v.float().repeat_interleave(H // Hkv, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), kf) * scale
    if causal:
        qp = torch.arange(S, device=q.device)
        kp = torch.arange(T, device=q.device)
        logits = logits.masked_fill(~(qp[:, None] >= kp[None, :]), NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs, vf).to(q.dtype)


def ssd_scan_ref(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                 dt: torch.Tensor, a: torch.Tensor,
                 h0: torch.Tensor | None = None, *,
                 chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD chunked scan, the form of ``repro/models/mamba2.py::
    _ssd_chunked``.  x: (B,S,H,P); Bm, Cm: (B,S,G,N) with G | H — head h
    reads group h // (H // G); dt, a: (B,S,H); h0: (B,H,P,N) or None.

    Chunks of Q = min(chunk, S) rows; a ragged tail is padded with
    dt = a = 0 (decay 1, no input: the state is untouched).  Per chunk:
    y = (C·Bᵀ ⊙ exp(cum_i − cum_j) · dt_j)_{j≤i} @ x + exp(cum) · C·hᵀ and
    h' = exp(cum_Q)·h + Σ_j exp(cum_Q − cum_j)·dt_j·x_j⊗B_j.  exp(seg) above
    the diagonal may overflow, so seg is masked to -inf there BEFORE the
    exp: masking after it (``where(tri, exp(seg), 0)``) gives the same
    forward but a NaN gradient once exp overflows, because the select's
    0 cotangent meets exp's inf (0·inf).  Autograd through this function
    is the port's differentiable path on the CPU, and what the backward
    kernel is held against.
    Returns (y (B,S,H,P) fp32, h_final (B,H,P,N) fp32)."""
    Bsz, S_orig, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S_orig)
    x, Bm, Cm, dt, a = (t.float() for t in (x, Bm, Cm, dt, a))
    pad = (-S_orig) % Q
    if pad:
        x, Bm, Cm = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                     for t in (x, Bm, Cm))
        dt, a = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (dt, a))
    hpg = H // G
    head_group = torch.arange(H, device=x.device) // hpg
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for c0 in range(0, x.shape[1], Q):
        x_c, B_c, C_c = (t[:, c0:c0 + Q] for t in (x, Bm, Cm))
        dt_c, a_c = dt[:, c0:c0 + Q], a[:, c0:c0 + Q]              # (B,Q,H)
        cum = torch.cumsum(a_c, dim=1)
        seg = cum[:, :, None, :] - cum[:, None, :, :]              # (B,Q,Q,H)
        # mask before the exp: exp(-inf) = 0 exactly where a select after
        # it would choose 0, so the forward is the same, and the gradient
        # above the diagonal is 0 (a select after an overflowed exp sends
        # its 0 cotangent into exp's inf: NaN)
        decay = torch.exp(seg.masked_fill(~tri[None, :, :, None],
                                          float("-inf")))
        cb = torch.einsum("bign,bjgn->bijg", C_c, B_c)[..., head_group]
        scores = cb * decay * dt_c[:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", scores, x_c)
        Ch, Bh = C_c[:, :, head_group], B_c[:, :, head_group]      # (B,Q,H,N)
        y = y + torch.einsum("bqhn,bhpn->bqhp", Ch, h) * \
            torch.exp(cum)[..., None]
        dec_end = torch.exp(cum[:, -1:, :] - cum)                  # (B,Q,H)
        bx = torch.einsum("bqh,bqhp,bqhn->bhpn", dec_end * dt_c, x_c, Bh)
        h = h * torch.exp(cum[:, -1, :])[:, :, None, None] + bx
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S_orig], h
