"""The work each hand-written kernel must do, and the least time an H100
SXM needs for it.

A kernel's work is counted, not measured: the bytes it must move (each
input read once, each output written once) and its operations by the
type they run at.  ``chip_smoke.py`` puts ``bound`` beside each kernel's
measured time; ``analysis/ircost.py`` adds a kernel's work to a serving
step's count in place of the plain version's own operations, so that a
step counts the same whichever of the two ran, and the dry run
(``launch/dryrun.py``) adds a backward kernel's work to a train step's.
Pure arithmetic: no torch.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "tfloat32": 495e12,  # dense tensor-core TF32
              "float32": 67e12}    # float32 outside the tensor cores


def bound(nbytes, flops):
    """The least time for moving ``nbytes`` and doing ``flops``, a dict of
    operation counts by the type they run at, each at its peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(f / PEAK_FLOPS[t] for t, f in flops.items()) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def rmsnorm_work(R, D, itemsize, scale_itemsize):
    """(bytes, flops by type) of RMSNorm over R rows of D: x read and y
    written once, the scale read once; 4 fp32 operations an element (the
    square, the sum, the product by 1 / rms and by the scale)."""
    return (2 * R * D * itemsize + D * scale_itemsize,
            {"float32": 4 * R * D})


def rmsnorm_bwd_work(R, D, itemsize, scale_itemsize):
    """(bytes, flops by type) of RMSNorm's backward over R rows of D: x and
    dy read and dx written once, the scale read and dscale written once;
    8 fp32 operations an element."""
    return (3 * R * D * itemsize + 2 * D * scale_itemsize,
            {"float32": 8 * R * D})


def ssd_products(B, S, H, P, N, G, Q):
    """The scan's arithmetic, 2 flops per multiply-add over the causal
    triangle of each chunk's real rows: (C.B^T, once per group; the score
    product, the inter-chunk term and the state update, once per head)."""
    cb = ops = 0
    for c0 in range(0, S, Q):
        q = min(Q, S - c0)
        tri = q * (q + 1) // 2
        cb += B * G * 2 * tri * N
        ops += B * H * (2 * tri * P + 4 * q * N * P)
    return cb, ops


def ssd_work(B, S, H, P, N, G, Q, dtype_name, itemsize, has_h0):
    """(bytes, flops by type) the scan must move and do: each input read
    once, each output written once; 2 flops per multiply-add over the
    causal triangle of each chunk's real rows, every product on the bf16
    tensor cores.  C.B^T depends on the group alone (decay and dt scale it
    afterwards), so it counts once per group: once with bf16 inputs (a
    product of two bf16 values summed in fp32 is exact), three times with
    fp32 ones (hi.hi + hi.lo + lo.hi of a split into bf16 hi + lo).  The
    score product, the inter-chunk term and the state update count once
    per head, each with an fp32 factor split into hi + lo: twice with bf16
    inputs, three times with fp32 ones."""
    cb, ops = ssd_products(B, S, H, P, N, G, Q)
    bf16 = dtype_name == "bfloat16"
    flops = {"bfloat16": (1 if bf16 else 3) * cb + (2 if bf16 else 3) * ops}
    nbytes = (B * S * H * P * itemsize + 2 * B * S * G * N * itemsize
              + 2 * B * S * H * 4 + B * S * H * P * 4
              + B * H * P * N * 4 * (2 if has_h0 else 1))
    return nbytes, flops


def ssd_bwd_products(B, S, H, P, N, G, Q):
    """The backward's products, 2 flops per multiply-add over the causal
    triangle of each chunk's real rows: (C.B^T and the intra terms of dB
    and dC, Mbar^T C and Mbar B, once per group; dS = dy.x^T and dx's intra
    term K^T dy once per head; the products of the state's size, of which
    the backward takes five a head: the chunk states and the dy.C sums
    again, dh B_j, dh^T x_j, h^T dy_i).  Returned as (cb, mbar, tri_p, st),
    one of each."""
    cb = mbar = tri_p = st = 0
    for c0 in range(0, S, Q):
        q = min(Q, S - c0)
        tri = q * (q + 1) // 2
        cb += B * G * 2 * tri * N
        mbar += B * G * 2 * (2 * tri * N)
        tri_p += B * H * 2 * tri * P
        st += B * H * 2 * q * N * P
    return cb, mbar, tri_p, st


def ssd_bwd_work(B, S, H, P, N, G, Q, dtype_name, itemsize, has_h0,
                 has_dh):
    """(bytes, flops by type) of the scan's backward, counted as
    ``ssd_work`` counts the forward: each input (x, B, C, dt, a, h0, dy,
    dh_final) read once and each gradient written once; every product of
    ``ssd_bwd_products`` on the bf16 tensor cores (dcum's state term
    C_i.(h^T dy_i) reuses dC's h^T dy_i).  A product counts once per bf16
    product it takes: an fp32 factor goes in as hi + lo, so twice with one
    fp32 factor and three times (hi.hi + hi.lo + lo.hi) with two; with
    fp32 inputs every product has two.  This is the function's least
    work, not the kernel's: the bf16 body also takes C.h^T for dcum (2
    products) and dh^T x_j with x scaled into fp32 first (3, not 2)."""
    cb, mbar, tri_p, st = ssd_bwd_products(B, S, H, P, N, G, Q)
    if dtype_name == "bfloat16":
        # dS 2, K^T dy 3; s_c 2, u_c 2, dh B_j 2, dh^T x_j 2, h^T dy_i 3
        ops = cb + 2 * mbar + 5 * tri_p + 11 * st
    else:
        ops = 3 * (cb + mbar + 2 * tri_p + 5 * st)
    flops = {"bfloat16": ops}
    state = B * H * P * N * 4
    nbytes = (2 * (B * S * H * P * itemsize + 2 * B * S * G * N * itemsize
                   + 2 * B * S * H * 4)
              + B * S * H * P * 4 + state * (2 if has_h0 else 0)
              + (state if has_dh else 0))
    return nbytes, flops


def flash_work(B, S, Tk, H, HKV, D, causal, itemsize, backward):
    """(bytes, flops) of the forward (4 flops a pair a head dim: QK^T and
    PV) or the backward (10: S and dP recomputed, dV, dK, dQ): each input
    read once, each output written once.  Top-left causal: query i sees
    keys 0..i, so only the first min(S, T) keys are ever read."""
    pairs = (sum(min(i + 1, Tk) for i in range(S)) if causal else S * Tk)
    keys = min(S, Tk) if causal else Tk
    q, kv = B * S * H * D * itemsize, B * keys * HKV * D * itemsize
    if backward:      # q, o, dO, lse and k, v in; dq, dk, dv out
        return (4 * q + 4 * kv + B * H * S * 4, 10 * B * H * D * pairs)
    return 2 * q + 2 * kv, 4 * B * H * D * pairs
