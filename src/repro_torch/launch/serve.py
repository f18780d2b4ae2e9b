"""Serving launcher CLI for the PyTorch/CUDA port (twin of
``repro/launch/serve.py``: the same flags, refusals and output lines, plus
``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --smoke --device cpu --requests 6 --max-new 8

    # seeded nucleus sampling, traced, exported and sanitized
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --temperature 0.8 --top-p 0.95 --seed 7 --trace-out trace.json \
        --prom-out metrics.prom --sanitize

Every arch of the registry serves.  Like the reference's launcher it
passes no frontend: whisper's cross K/V rows and llama-3.2-vision's are
zeroed at admission (``Request.frontend`` carries one).

Runs on CUDA unless ``--device cpu`` is given; with no CUDA device and no
``--device`` it fails instead of falling back to the host.  Weights are
random, drawn from a generator seeded with 0 on the serving device.

--engine continuous  (default) the continuous-batching engine.
--engine wave        DEPRECATED: the ``runtime.server.Server`` shim, which
                     delegates every token to the same engine (greedy
                     only, no telemetry, no sanitizer).
--temperature /
--top-k / --top-p    per-request SamplingParams for every request
                     (temperature 0 = exact greedy argmax, the default).
--seed               base RNG seed; request i samples with seed+i.
--stop               comma-separated stop token ids (finish_reason="stop").
--logprobs           attach per-token logprobs to each RequestOutput.
--share-prefix       cross-request prefix caching: prompts share a system
                     prefix of --shared-prefix-len tokens (default
                     --prompt-len) plus 4 unique tokens each; the report
                     line gains the prefix-cache hit rate.  Refused for
                     archs with slot state (mamba2, zamba2, whisper,
                     llama-vision).
--metrics-out PATH   write the engine's JSON metrics report there.
--trace-out PATH     a Chrome trace-event JSON of the run (Perfetto).
--prom-out PATH      the final metrics as Prometheus text exposition.
--metrics-every S    with --metrics-out: a windowed-signal JSONL snapshot
                     to <metrics-out>.jsonl every S seconds of engine time.
--metrics-window S   sliding-window length of the signal vector (10 s).
--sanitize           attach the paged-cache sanitizer and print its report.
"""
from __future__ import annotations

import argparse
import collections
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    from repro_torch.configs import ARCHS, get_arch, reduce_for_smoke
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, failing without one)")
    ap.add_argument("--engine", choices=("wave", "continuous"),
                    default="continuous")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged-KV block size")
    ap.add_argument("--prefill-chunk", type=int, default=64,
                    help="prompt tokens prefilled per engine step")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="physical KV blocks (default: slots*max_len worth)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the k highest logits (0 = disabled)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 = disabled)")
    ap.add_argument("--seed", type=int, default=0,
                    help="base sampling seed; request i uses seed+i")
    ap.add_argument("--stop", default=None,
                    help="comma-separated stop token ids (finish_reason="
                         "'stop' when one is sampled)")
    ap.add_argument("--logprobs", action="store_true",
                    help="attach per-token logprobs to each RequestOutput")
    ap.add_argument("--share-prefix", action="store_true",
                    help="reuse cached KV blocks across requests sharing a "
                         "prompt prefix")
    ap.add_argument("--shared-prefix-len", type=int, default=None,
                    help="with --share-prefix: length of the common system "
                         "prefix (default: prompt-len)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the engine's JSON metrics here")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace-event JSON (Perfetto) of the "
                         "run: per-phase tracks + per-request spans")
    ap.add_argument("--prom-out", default=None,
                    help="write the final metrics as Prometheus text "
                         "exposition")
    ap.add_argument("--metrics-every", type=float, default=None,
                    help="with --metrics-out: append a windowed-signal JSONL "
                         "snapshot to <metrics-out>.jsonl every S seconds of "
                         "engine time")
    ap.add_argument("--metrics-window", type=float, default=10.0,
                    help="sliding-window seconds for the workload signal "
                         "vector (default 10)")
    ap.add_argument("--sanitize", action="store_true",
                    help="attach the paged-cache sanitizer (cross-checks "
                         "refcounts every step, fails on leaks and double "
                         "frees) and print its report")
    args = ap.parse_args(argv)
    if args.metrics_every is not None and not args.metrics_out:
        ap.error("--metrics-every needs --metrics-out (snapshots go to "
                 "<metrics-out>.jsonl)")
    if args.engine == "wave":
        if (args.temperature != 0.0 or args.top_k != 0 or args.top_p != 1.0
                or args.seed != 0 or args.stop or args.logprobs):
            ap.error("--engine wave is greedy-only (the legacy API has no "
                     "sampling field): drop the sampling flags or use "
                     "--engine continuous")
        if args.trace_out or args.prom_out or args.metrics_every is not None:
            ap.error("--trace-out/--prom-out/--metrics-every need the "
                     "continuous engine (the wave shim exposes no "
                     "telemetry): use --engine continuous")
        if args.sanitize:
            ap.error("--sanitize needs the continuous engine (the wave "
                     "shim exposes no cache hooks): use --engine "
                     "continuous")

    import torch

    from repro_torch import device as _device
    from repro_torch.models import transformer as T

    dev = _device.resolve(args.device)
    arch = get_arch(args.arch)
    if args.smoke:
        arch = reduce_for_smoke(arch)
    params = T.init_lm(arch, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    if args.share_prefix:
        plen = (args.prompt_len if args.shared_prefix_len is None
                else args.shared_prefix_len)
        shared = rng.integers(1, arch.vocab, size=plen)
        prompts = [np.concatenate([shared, rng.integers(1, arch.vocab,
                                                        size=4)])
                   .astype(np.int32) for _ in range(args.requests)]
    else:
        prompts = [rng.integers(1, arch.vocab, size=args.prompt_len)
                   .astype(np.int32) for _ in range(args.requests)]

    if args.engine == "wave":
        from repro_torch.runtime.server import Request, Server
        server = Server(arch, params, device=dev, slots=args.slots,
                        max_len=args.max_len, block_size=args.block_size,
                        num_blocks=args.num_blocks,
                        prefill_chunk=args.prefill_chunk)
        for i, p in enumerate(prompts):
            server.submit(Request(id=i, prompt=p,
                                  max_new_tokens=args.max_new))
        wall = server.run_until_drained()
        total = sum(len(r.out_tokens) for r in server.completed)
        print(f"[wave-shim] {len(server.completed)} requests, {total} "
              f"tokens, {wall:.2f}s wall ({total / max(wall, 1e-9):.1f} "
              f"tok/s host-wall), {server.decode_steps} decode steps "
              f"(continuous engine under the hood)")
        return

    from repro_torch.serving import (ChromeTracer, ContinuousBatchingEngine,
                                     Request, SamplingParams, ServingMetrics,
                                     SnapshotWriter, prometheus_text)
    from repro_torch.serving.export import atomic_write_text
    stop_ids = (tuple(int(s) for s in args.stop.split(","))
                if args.stop else ())
    tracer = ChromeTracer() if args.trace_out else None
    snapshot = (SnapshotWriter(args.metrics_out + ".jsonl",
                               every_s=args.metrics_every)
                if args.metrics_every is not None else None)
    sanitizer = None
    if args.sanitize:
        from repro_torch.analysis.sanitizer import CacheSanitizer
        sanitizer = CacheSanitizer()
    engine = ContinuousBatchingEngine(
        arch, params, device=dev, slots=args.slots, max_len=args.max_len,
        block_size=args.block_size, num_blocks=args.num_blocks,
        prefill_chunk=args.prefill_chunk, share_prefix=args.share_prefix,
        metrics=ServingMetrics(window_s=args.metrics_window),
        tracer=tracer, snapshot=snapshot, sanitizer=sanitizer)

    def flush_artifacts(out=sys.stdout) -> None:
        """Write every requested artifact through its atomic path, on the
        success exit and on the crash exit alike."""
        if args.metrics_out:
            engine.metrics.write(args.metrics_out, engine="continuous",
                                 arch=arch.name, device=str(dev))
            print(f"metrics -> {args.metrics_out}", file=out)
        if snapshot is not None:
            snapshot.write(engine.metrics)   # final flush past the cadence
            print(f"snapshots -> {snapshot.path} "
                  f"({snapshot.n_snapshots} lines)", file=out)
        if tracer is not None:
            tracer.write(args.trace_out)
            print(f"trace -> {args.trace_out} (open in ui.perfetto.dev)",
                  file=out)
        if args.prom_out:
            atomic_write_text(args.prom_out, prometheus_text(engine.metrics))
            print(f"prometheus -> {args.prom_out}", file=out)

    try:
        outs = engine.generate([
            Request(id=i, prompt=p, max_new_tokens=args.max_new,
                    sampling=SamplingParams(temperature=args.temperature,
                                            top_k=args.top_k,
                                            top_p=args.top_p,
                                            seed=args.seed + i,
                                            stop_token_ids=stop_ids,
                                            logprobs=args.logprobs))
            for i, p in enumerate(prompts)])
    except Exception as e:
        print(f"engine failed mid-drain: {type(e).__name__}: {e}",
              file=sys.stderr)
        try:
            flush_artifacts(out=sys.stderr)
        except Exception as flush_err:       # the crash exit must survive
            print(f"artifact flush failed: {flush_err}", file=sys.stderr)
        raise SystemExit(1)
    s = engine.metrics.summary()
    reasons = collections.Counter(o.finish_reason for o in outs)
    share = (f", prefix hit rate {s['prefix_hit_rate']:.2f}"
             if args.share_prefix else "")
    mode = ("greedy" if args.temperature == 0 else
            f"T={args.temperature} top_k={args.top_k} top_p={args.top_p} "
            f"seed={args.seed}")

    def ms(x):                       # None-safe: "no data" is not 0.0ms
        return "n/a" if x is None else f"{x * 1e3:.1f}ms"

    print(f"[continuous/{mode}] {s['completed']} requests, "
          f"{s['total_tokens']} tokens, "
          f"{s['decode_steps']} decode steps / {s['prefill_chunks']} prefill "
          f"chunks, ttft mean {ms(s['ttft_mean_s'])} "
          f"p50 {ms(s['ttft_p50_s'])} p95 {ms(s['ttft_p95_s'])} "
          f"p99 {ms(s['ttft_p99_s'])}, tpot p50 {ms(s['tpot_p50_s'])}, "
          f"occupancy {s['slot_occupancy_mean']*100:.0f}%, block util "
          f"{s['block_utilization_mean']:.2f}, "
          f"{s['preemptions']} preemptions, finish reasons "
          f"{dict(reasons)}{share}")
    for o in outs[:3]:
        lp = (f" logprobs[:3]={[round(x, 3) for x in o.logprobs[:3]]}"
              if o.logprobs else "")
        print(f"  req {o.request_id} [{o.finish_reason}] "
              f"{o.token_ids}{lp}")
    flush_artifacts()
    if sanitizer is not None:
        # reaching this line means every per-step and drain check passed
        print(f"sanitizer: clean ({sanitizer.report()})")


if __name__ == "__main__":
    main()
