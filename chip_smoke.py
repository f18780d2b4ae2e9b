#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py                 # everything (~1 minute on an H100)
    python3 chip_smoke.py --kernels-only  # build + kernel phase only
    python3 chip_smoke.py --out run.json  # also write every number to JSON
    python3 chip_smoke.py --profile       # plus a traced serve (by kernel)

Phases, each of which fails the run (exit code 1) on any error:

1. Device: needs CUDA; prints the card's name and power limit as
   ``nvidia-smi`` reports them; turns TF32 off for float32 products.
2. Build: compiles every kernel of the port from ``src/repro_torch/kernels/
   csrc`` with ``nvcc`` for ``sm_90a`` (one compiler per source, in
   parallel) and prints the build time.
3. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, in bf16 and fp32, with the tolerance stated: at every shape
   the serve path's decode and prefill steps and the forward give it at
   this script's settings (``served_cases``), and at larger and ragged
   edge cases.  Kernel, plain and library times are device times: 20
   calls captured in one CUDA graph and replayed between CUDA events.  The
   kernel's eager time per call from Python (``call_ms``) stands beside
   them: at the decode step's shapes that is the host's cost, not the
   device's.
4. Serve: qwen3-8b at its published widths and all 36 layers, bf16, random
   weights from a seeded generator, 8 greedy requests of 512 prompt tokens
   and 32 new tokens through ``ContinuousBatchingEngine.generate``.  Every
   launch counter is set to 0 just before and read just after.
5. Forward: ``lm_apply(impl="pallas")`` over 2 of the prompts (the flash
   kernel's path): the flash counter must rise by 36 and the RMSNorm counter
   by 145; the last-position logits and their argmax are held against the
   engine's own paged prefill logits for the same prompts.

The last three lines of standard output are the ``{"kernels": [...]}`` JSON
line (one entry per kernel: its launches on the main path that runs it
most, every path's count under ``launches_by_path``, and the numbers of
its bf16 case at that path's most launched shape), the card line
(``gpu: <name>, <power limit>``) and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of the
repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # float32 outside the tensor cores
# |kernel - plain| <= atol + rtol * |plain|.  Kernel and plain version both
# compute in fp32 and differ only by summation order (~1e-6 relative).  In
# fp32 that is all; in bf16 both round that fp32 value once to 8
# significant bits, so they may land one rounding step apart, and one step
# is at most 2^-7 of the value.
TOL = {"float32": (2e-5, 1e-5), "bfloat16": (1e-5, 2.0 ** -7)}
# flash-kernel forward vs the engine's paged prefill, both bf16 end to end
# over 36 layers: two independent attention paths, so the logits agree only
# to bf16 rounding; max |diff| must stay under this share of max |logit|
# (about 4x the 0.0038 measured on the H100), and each forward's argmax
# must be the paged prefill's, or within that tolerance of its top logit.
FORWARD_REL_TOL = 0.015

TIMED_LAUNCHES = 20                # per kernel time, after 3 warm-up launches

SERVE = dict(requests=8, prompt_len=512, max_new=32, slots=4, max_len=1024,
             block_size=16, prefill_chunk=256)
FORWARD_PROMPTS = 2                # batch of the lm_apply(impl="pallas") run


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def call_ms(fn, iters: int) -> float:
    """Time of one eager call: ``iters`` calls issued back to back from
    Python after 3 warm-up calls, CUDA events around them.  At small shapes
    this is the rate at which the host issues calls, not device time."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters: int) -> float:
    """Device time of one call: ``iters`` calls captured in one CUDA graph
    (after 3 warm-up calls on a side stream), replayed once to warm up and
    once between CUDA events.  The replay takes the host's launch cost out,
    so a small kernel is timed on the device, not at Python's pace."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_close(got, want, dtype_name):
    import torch
    atol, rtol = TOL[dtype_name]
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    ok = bool(torch.all(diff <= atol + rtol * want.float().abs()))
    if not torch.isfinite(got.float()).all():
        ok = False
    return err, ok, f"atol {atol:g} + rtol {rtol:g}*|plain|"


def served_cases(arch):
    """The shapes each main path gives the kernels at this script's
    settings, derived from ``SERVE`` and the arch, plus the larger and
    ragged cases that test the kernels' edges.  RMSNorm: ``(path, use,
    rows, D)``; flash: ``(path, B, S, T, causal)``.  The serve path's decode
    step normalises ``slots`` rows, its prefill step ``prefill_chunk`` rows
    (a padded chunk), and the forward ``FORWARD_PROMPTS * prompt_len``; the
    q/k norms see each row once per q/kv head."""
    d, H, Hkv, hd = arch.d_model, arch.n_heads, arch.n_kv_heads, arch.head_dim
    tokens = {"serve decode": SERVE["slots"],
              "serve prefill": SERVE["prefill_chunk"],
              "forward": FORWARD_PROMPTS * SERVE["prompt_len"]}
    norm = []
    for path, r in tokens.items():
        norm += [(path, "norm1/norm2/final_norm", r, d),
                 (path, "q_norm", r * H, hd), (path, "k_norm", r * Hkv, hd)]
    norm += [("edge", "long rows", 2048, d), ("edge", "q_norm", 2048 * H, hd)]
    S = SERVE["prompt_len"]
    flash = [("forward", FORWARD_PROMPTS, S, S, True),
             ("edge", 1, 2048, 2048, True), ("edge", 1, 300, 300, True),
             ("edge", 1, 256, 700, True), ("edge", 1, 300, 700, False)]
    return norm, flash


def kernel_phase(torch, arch, iters):
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rmsnorm as RN

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    norm_cases, flash_cases = served_cases(arch)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    for path, use, R, D in norm_cases:
        for dt in (torch.bfloat16, torch.float32):
            dn = str(dt).split(".")[1]
            x = randn(R, D, dtype=dt)
            scale = (1.0 + 0.1 * randn(D, dtype=torch.float32)).to(dt)
            got = RN.rmsnorm(x, scale)
            want = ref.rmsnorm_ref(x, scale)
            torch.cuda.synchronize()
            err, ok, tol = check_close(got, want, dn)
            ms = time_ms(lambda: RN.rmsnorm(x, scale), iters)
            eager = call_ms(lambda: RN.rmsnorm(x, scale), iters)
            plain_ms = time_ms(lambda: ref.rmsnorm_ref(x, scale), iters)
            lib_ms = (time_ms(lambda: F.rms_norm(x, (D,), scale, 1e-6), iters)
                      if hasattr(F, "rms_norm") else None)
            nbytes = 2 * R * D * x.element_size() + D * scale.element_size()
            flops = 4 * R * D
            rows.append(dict(
                name="rmsnorm", path=path, use=use, shape=f"({R}, {D})",
                dtype=dn, ok=ok, max_abs_err=err, tol=tol, ms=ms,
                call_ms=eager, plain_ms=plain_ms, library_ms=lib_ms,
                bytes=nbytes, flops=flops, **bound(nbytes, flops, "float32")))

    H, HKV, D = arch.n_heads, arch.n_kv_heads, arch.head_dim
    for path, B, S, Tk, causal in flash_cases:
        for dt in (torch.bfloat16, torch.float32):
            dn = str(dt).split(".")[1]
            q = randn(B, S, H, D, dtype=dt)
            k = randn(B, Tk, HKV, D, dtype=dt)
            v = randn(B, Tk, HKV, D, dtype=dt)
            sc = 1.0 / D ** 0.5
            got = ops.flash_attention(q, k, v, scale=sc, causal=causal)
            want = ref.flash_attention_ref(q, k, v, scale=sc, causal=causal)
            torch.cuda.synchronize()
            err, ok, tol = check_close(got, want, dn)
            ms = time_ms(lambda: ops.flash_attention(q, k, v, scale=sc,
                                                     causal=causal), iters)
            eager = call_ms(lambda: ops.flash_attention(q, k, v, scale=sc,
                                                        causal=causal), iters)
            plain_ms = time_ms(lambda: ref.flash_attention_ref(
                q, k, v, scale=sc, causal=causal), iters)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=sc, enable_gqa=True),
                iters)
            # top-left causal: query i sees keys 0..i, so only the first
            # min(S, T) keys are ever read and min(i+1, T) pairs are computed
            pairs = (sum(min(i + 1, Tk) for i in range(S)) if causal
                     else S * Tk)
            keys = min(S, Tk) if causal else Tk
            flops = 4 * B * H * D * pairs
            nbytes = (2 * B * S * H * D + 2 * B * keys * HKV * D) \
                * q.element_size()
            rows.append(dict(
                name="flash_attention", path=path, use="attention",
                shape=f"B={B} S={S} T={Tk} H={H} Hkv={HKV} D={D}"
                      f"{' causal' if causal else ''}",
                dtype=dn, ok=ok, max_abs_err=err, tol=tol, ms=ms,
                call_ms=eager, plain_ms=plain_ms, library_ms=lib_ms,
                bytes=nbytes, flops=flops, **bound(nbytes, flops, dn)))
    return rows


def bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def reset_counts():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    RN.rmsnorm.launches = 0
    FA.flash_attention.launches = 0


def read_counts():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    return {"rmsnorm": RN.rmsnorm.launches,
            "flash_attention": FA.flash_attention.launches}


def serve_phase(torch, np, report, arch):
    from repro_torch.models import transformer as T
    from repro_torch.runtime import steps as ST
    from repro_torch.serving.engine import ContinuousBatchingEngine, Request

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_lm(arch, device="cuda", generator=gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"serve: qwen3-8b, {arch.n_layers} layers, d_model {arch.d_model}, "
          f"{n_params / 1e9:.3f} B params ({n_bytes / 1e9:.2f} GB bf16), "
          f"init {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, arch.vocab, size=SERVE["prompt_len"])
               .astype(np.int32) for _ in range(SERVE["requests"])]
    engine_kw = dict(device="cuda", slots=SERVE["slots"],
                     max_len=SERVE["max_len"],
                     block_size=SERVE["block_size"],
                     prefill_chunk=SERVE["prefill_chunk"])
    # warm-up engine (not timed, not counted): first cuBLAS calls
    warm = ContinuousBatchingEngine(arch, params, **engine_kw)
    warm.generate([Request(id=0, prompt=prompts[0][:16], max_new_tokens=2)])
    del warm
    torch.cuda.synchronize()

    eng = ContinuousBatchingEngine(arch, params, **engine_kw)
    reqs = [Request(id=i, prompt=p, max_new_tokens=SERVE["max_new"])
            for i, p in enumerate(prompts)]
    reset_counts()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()

    for o in outs:
        if o.n_tokens != SERVE["max_new"] or o.finish_reason != "length":
            fail(f"request {o.request_id}: {o.n_tokens} tokens, "
                 f"finish {o.finish_reason!r} (want {SERVE['max_new']}, "
                 f"'length')")
        if not all(0 <= t < arch.vocab for t in o.token_ids):
            fail(f"request {o.request_id}: token outside [0, vocab)")
    if eng.cache.allocator.num_used != 0:
        fail(f"{eng.cache.allocator.num_used} blocks still held after drain")
    if counts["rmsnorm"] == 0:
        fail("the serving path launched no RMSNorm kernel")
    s = eng.metrics.summary()
    total = sum(o.n_tokens for o in outs)
    serve = dict(requests=len(outs), tokens=total, wall_s=wall,
                 tok_per_s=total / wall, ttft_p50_s=s["ttft_p50_s"],
                 ttft_max_s=s["ttft_max_s"], tpot_p50_s=s["tpot_p50_s"],
                 tpot_max_s=max(o.tpot_s for o in outs),
                 decode_steps=s["decode_steps"],
                 prefill_chunks=s["prefill_chunks"],
                 preemptions=s["preemptions"], launches=counts,
                 phases_host_s=s["phases"],
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    report["serve"] = serve
    print(f"serve: {len(outs)} requests, {total} tokens in {wall:.3f} s = "
          f"{total / wall:.2f} tok/s, TTFT p50 {s['ttft_p50_s'] * 1e3:.1f} ms, "
          f"TPOT p50 {s['tpot_p50_s'] * 1e3:.2f} ms, "
          f"{s['decode_steps']} decode steps / {s['prefill_chunks']} prefill "
          f"chunks, launches {counts}, blocks freed, peak memory "
          f"{serve['peak_mem_gb']:.2f} GB")

    # the engine's own paged prefill (its step, its cache) for 2 prompts,
    # without the fused sampler, to get the first-token logits
    prefill = ST.make_paged_prefill_step(arch)
    ref_logits = []
    C = SERVE["prefill_chunk"]
    for rid in range(FORWARD_PROMPTS):
        ctx = prompts[rid]
        if not eng.cache.reserve(1000 + rid, len(ctx)):
            fail("cannot reserve blocks for the reference prefill")
        table = torch.as_tensor(eng.cache.table_array([1000 + rid]),
                                device="cuda")
        for p0 in range(0, len(ctx), C):
            chunk = torch.as_tensor(ctx[p0:p0 + C][None, :], device="cuda")
            last, _ = prefill(params, eng.cache.pools, chunk,
                              torch.tensor([p0], device="cuda"), table,
                              torch.tensor([chunk.shape[1]], device="cuda"),
                              None)
        ref_logits.append(last[0])
        eng.cache.release(1000 + rid)
        first = int(torch.argmax(last[0, :arch.vocab]))
        if first != outs[rid].token_ids[0]:
            fail(f"request {rid}: paged prefill argmax {first} != the "
                 f"engine's first token {outs[rid].token_ids[0]}")
    return params, prompts, torch.stack(ref_logits)


def profile_phase(torch, report, arch, params, prompts):
    """A traced serve of one full batch (4 requests x 512 prompt tokens, 8
    new tokens each) under ``torch.profiler``: device busy share of the
    window and device time by kernel, from the exported Chrome trace.  The
    untraced serve phase above gives the end-to-end numbers; tracing adds
    host cost, so this run's wall time is not one of them."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import ContinuousBatchingEngine, Request

    eng = ContinuousBatchingEngine(
        arch, params, device="cuda", slots=SERVE["slots"],
        max_len=SERVE["max_len"], block_size=SERVE["block_size"],
        prefill_chunk=SERVE["prefill_chunk"])
    reqs = [Request(id=i, prompt=p, max_new_tokens=8)
            for i, p in enumerate(prompts[:SERVE["slots"]])]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trace = ROOT / "build" / "chip_smoke_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text()).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    launches = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                   and "LaunchKernel" in e.get("name", ""))
    s = eng.metrics.summary()
    out = dict(wall_s=wall, requests=len(reqs),
               decode_steps=s["decode_steps"],
               prefill_chunks=s["prefill_chunks"], kernel_events=len(kernels),
               launch_calls=launches)
    if not kernels:
        out["device_busy_share"] = None      # the profiler saw no device
        print("profile: no kernel events in the trace: device time not "
              "measured")
    else:
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
        busy, end = 0.0, None
        for a, b in spans:                   # union of kernel intervals
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        by_name: dict[str, list] = {}
        for e in kernels:
            n = e["name"]
            key = ("rmsnorm" if "rmsnorm_kernel" in n else
                   "flash" if "flash_fwd" in n else
                   "gemm" if "gemm" in n.lower() or "gemv" in n.lower() else
                   n[:60])
            t = by_name.setdefault(key, [0, 0.0])
            t[0] += 1
            t[1] += e["dur"]
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
        out.update(device_busy_s=busy / 1e6, device_busy_share=busy / 1e6 / wall,
                   by_kernel=[{"kernel": k, "count": c, "ms": us / 1e3}
                              for k, (c, us) in top])
        print(f"profile: traced serve of {len(reqs)} requests, wall "
              f"{wall * 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
              f"({100 * busy / 1e6 / wall:.1f}%), {len(kernels)} kernels, "
              f"{launches} launch calls, {s['decode_steps']} decode steps / "
              f"{s['prefill_chunks']} prefill chunks")
        for k, (c, us) in top:
            print(f"  profile kernel {k}: {c} launches, {us / 1e3:.2f} ms")
    report["profile"] = out


def forward_phase(torch, np, report, arch, params, prompts, ref_logits):
    from repro_torch.models import transformer as T

    B, S = FORWARD_PROMPTS, SERVE["prompt_len"]
    tokens = torch.as_tensor(np.stack(prompts[:B]), device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    out = T.lm_apply(params, arch, tokens, impl="pallas")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = {"flash_attention": arch.n_layers,
            "rmsnorm": 4 * arch.n_layers + 1}
    if counts != want:
        fail(f"forward launches {counts}, want {want}")
    logits = out.logits[:, -1, :arch.vocab]
    refl = ref_logits[:, :arch.vocab]
    if out.logits.shape != (B, S, arch.padded_vocab) or \
            not torch.isfinite(out.logits).all():
        fail(f"forward logits shape {tuple(out.logits.shape)} or not finite")
    err = float((logits - refl).abs().max())
    scale = float(refl.abs().max())
    tol = FORWARD_REL_TOL * scale
    picks = [int(torch.argmax(logits[i])) for i in range(B)]
    best = [int(torch.argmax(refl[i])) for i in range(B)]
    # how far below the paged prefill's top logit the forward's pick sits
    # (0 when the two argmaxes agree)
    shortfall = [float(refl[i, best[i]] - refl[i, picks[i]]) for i in range(B)]
    report["forward"] = dict(wall_s=wall, launches=counts, max_abs_err=err,
                             max_abs_logit=scale, rel_tol=FORWARD_REL_TOL,
                             argmax_agree=[p == b for p, b in zip(picks, best)],
                             argmax_shortfall=shortfall)
    print(f"forward: lm_apply(impl='pallas') B={B} S={S} in "
          f"{wall * 1e3:.1f} ms, launches {counts}; last-position logits vs "
          f"paged prefill: max |diff| {err:.4g} (max |logit| {scale:.4g}, "
          f"tol {FORWARD_REL_TOL}*max = {tol:.4g}), argmax {picks} vs {best}")
    if not err <= tol:
        fail(f"forward logits differ from the paged prefill by {err:.4g} "
             f"> {tol:.4g}")
    if any(s > tol for s in shortfall):
        fail(f"forward argmax {picks} != paged prefill argmax {best}, and "
             f"not a near tie (shortfall {shortfall} > {tol:.4g})")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels, skip serve/forward")
    ap.add_argument("--out", default=None,
                    help="also write every measured number to this JSON")
    ap.add_argument("--profile", action="store_true",
                    help="after the forward phase, trace one more serve "
                         "with torch.profiler (device busy share, time by "
                         "kernel)")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             f"repository")
    sys.path.insert(0, str(SRC))

    # 1. device
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} ({card}), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; TF32 off for "
          f"float32 matmul and cuDNN")

    # 2. build
    from repro_torch.kernels import build
    rep = build.build()
    print(f"build: {len(build.SOURCES)} libraries in {rep['seconds']:.1f} s "
          f"-> {build.BUILD_DIR}")
    for name, txt in rep["ptxas"].items():
        for line in txt.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    from repro_torch.configs import get_arch
    arch = get_arch("qwen3-8b")
    report = {"card": card, "build_s": rep["seconds"]}
    # 3. kernels vs their plain versions
    rows = kernel_phase(torch, arch, TIMED_LAUNCHES)
    report["kernel_cases"] = rows
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"kernel {r['name']} [{r['path']}: {r['use']}] {r['shape']} "
              f"{r['dtype']}: {'ok' if r['ok'] else 'MISMATCH'} max_abs_err "
              f"{r['max_abs_err']:.3g} (tol {r['tol']}), {r['ms']:.4f} ms "
              f"(eager call {r['call_ms']:.4f} ms), plain "
              f"{r['plain_ms']:.4f} ms, library {lib} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
    bad = [f"{r['name']} {r['shape']} {r['dtype']}" for r in rows
           if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")

    # launches on each main path, each counted from 0 around its own run
    by_path = {"serve": {"rmsnorm": 0, "flash_attention": 0},
               "forward": {"rmsnorm": 0, "flash_attention": 0}}
    if not args.kernels_only:
        # 4. serve, 5. forward
        params, prompts, ref_logits = serve_phase(torch, np, report, arch)
        forward_phase(torch, np, report, arch, params, prompts, ref_logits)
        if args.profile:
            profile_phase(torch, report, arch, params, prompts)
        by_path = {p: report[p]["launches"] for p in by_path}

    # 6. one entry per kernel, on the main path that serves it most: its
    # numbers are the bf16 case of that path with the most launches (the
    # decode step's (slots, d_model) norms; the forward's attention), its
    # launches that path's count, and every path's count beside it
    headline = {"rmsnorm": ("serve", "serve decode", "norm1/norm2/final_norm"),
                "flash_attention": ("forward", "forward", "attention")}
    replaces = {"rmsnorm": "src/repro/kernels/rmsnorm.py:20",
                "flash_attention": "src/repro/kernels/flash_attention.py:77"}
    source = {"rmsnorm": "src/repro_torch/kernels/csrc/rmsnorm.cu",
              "flash_attention":
                  "src/repro_torch/kernels/csrc/flash_attention.cu"}
    kernels = []
    for name, (path, case_path, use) in headline.items():
        r = next(r for r in rows if r["name"] == name and r["path"] ==
                 case_path and r["use"] == use and r["dtype"] == "bfloat16")
        kernels.append({
            "name": name, "route": "cuda", "source": source[name],
            "replaces": replaces[name], "launches": by_path[path][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "path": path, "shape": r["shape"], "dtype": r["dtype"],
            "tol": r["tol"],
            "launches_by_path": {p: c[name] for p, c in by_path.items()}})
    report["kernels"] = kernels
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(f"gpu: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
