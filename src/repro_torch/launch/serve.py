"""Serving launcher CLI for the PyTorch/CUDA port (twin of
``repro/launch/serve.py``, greedy continuous engine).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --smoke --device cpu --requests 6 --max-new 8
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper-medium --smoke --device cpu

Every arch of the registry serves.  Like the reference's launcher it
passes no frontend: whisper's cross K/V rows and llama-3.2-vision's are
zeroed at admission (``Request.frontend`` carries one).

Runs on CUDA unless ``--device cpu`` is given; with no CUDA device and no
``--device`` it fails instead of falling back to the host.  Weights are
random, drawn from a generator seeded with 0 on the serving device.

--share-prefix   cross-request prefix caching: prompts share a system
                 prefix of --prompt-len tokens plus 4 unique tokens each,
                 later requests reuse its cached blocks and start prefill at
                 the matched boundary; the report line gains the prefix-cache
                 hit rate.  Refused for archs with slot state (mamba2,
                 zamba2, whisper, llama-vision).
--metrics-out    write the engine's JSON metrics report there.
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
    ap.add_argument("--share-prefix", action="store_true",
                    help="reuse cached KV blocks across requests sharing a "
                         "prompt prefix")
    ap.add_argument("--metrics-out", default=None,
                    help="write the engine's JSON metrics here")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import device as _device
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ContinuousBatchingEngine, Request

    dev = _device.resolve(args.device)
    arch = get_arch(args.arch)
    if args.smoke:
        arch = reduce_for_smoke(arch)
    params = T.init_lm(arch, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    if args.share_prefix:
        shared = rng.integers(1, arch.vocab, size=args.prompt_len)
        prompts = [np.concatenate([shared, rng.integers(1, arch.vocab,
                                                        size=4)])
                   .astype(np.int32) for _ in range(args.requests)]
    else:
        prompts = [rng.integers(1, arch.vocab, size=args.prompt_len)
                   .astype(np.int32) for _ in range(args.requests)]

    engine = ContinuousBatchingEngine(
        arch, params, device=dev, slots=args.slots, max_len=args.max_len,
        block_size=args.block_size, num_blocks=args.num_blocks,
        prefill_chunk=args.prefill_chunk, share_prefix=args.share_prefix)
    try:
        outs = engine.generate([
            Request(id=i, prompt=p, max_new_tokens=args.max_new)
            for i, p in enumerate(prompts)])
    except Exception as e:
        print(f"engine failed mid-drain: {type(e).__name__}: {e}",
              file=sys.stderr)
        if args.metrics_out:
            engine.metrics.write(args.metrics_out, engine="continuous",
                                 arch=arch.name)
        raise SystemExit(1)
    s = engine.metrics.summary()
    reasons = collections.Counter(o.finish_reason for o in outs)
    share = (f", prefix hit rate {s['prefix_hit_rate']:.2f}"
             if args.share_prefix else "")

    def ms(x):                       # None-safe: "no data" is not 0.0ms
        return "n/a" if x is None else f"{x * 1e3:.1f}ms"

    print(f"[continuous/greedy] {s['completed']} requests, "
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
        print(f"  req {o.request_id} [{o.finish_reason}] {o.token_ids}")
    if args.metrics_out:
        engine.metrics.write(args.metrics_out, engine="continuous",
                             arch=arch.name, device=str(dev))
        print(f"metrics -> {args.metrics_out}")


if __name__ == "__main__":
    main()
