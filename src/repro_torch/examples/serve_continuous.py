"""Continuous-batching serving example (twin of
``examples/serve_continuous.py``): paged KV cache and request scheduler,
driven through the v2 generation API.

Mixed prompt lengths, priorities AND per-request ``SamplingParams`` flow
through one engine batch: greedy requests ride alongside seeded nucleus
sampling in the same decode step (per-slot temperature / top-k / top-p
rows), results come back as typed ``RequestOutput``s (token ids, finish
reason, optional logprobs, TTFT / TPOT), and ``on_token`` streams tokens
as they are sampled.

    PYTHONPATH=src python -m repro_torch.examples.serve_continuous \\
        [--device cpu]

The model is qwen3-8b at ``reduce_for_smoke`` widths, as the reference
example's, with the port's own random weights (``init_lm``, seed 0).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import tree
from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.models import transformer as T
from repro_torch.serving import (ContinuousBatchingEngine, Request,
                                 RequestScheduler, SamplingParams)


def requests(vocab: int) -> list:
    """Ten requests of 8-47 tokens: even ids greedy, odd ones seeded
    nucleus sampling with logprobs; every third urgent."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(10):
        prompt_len = int(rng.integers(8, 48))
        sampling = (SamplingParams() if i % 2 == 0 else
                    SamplingParams(temperature=0.8, top_p=0.95, seed=i,
                                   logprobs=True))
        out.append(Request(
            id=i,
            prompt=rng.integers(1, vocab, size=prompt_len).astype(np.int32),
            max_new_tokens=12,
            priority=0 if i % 3 == 0 else 1,    # every 3rd request urgent
            sampling=sampling))
    return out


def run(arch, params, device):
    """-> (the outputs in request order, the metrics summary, the
    (request id, token) pairs ``on_token`` streamed)."""
    streamed = []
    engine = ContinuousBatchingEngine(
        arch, params, device=device, slots=4, max_len=128, block_size=16,
        prefill_chunk=32,
        scheduler=RequestScheduler(max_tokens_in_flight=512),
        on_token=lambda rid, tok: streamed.append((rid, tok)))
    print(f"serving {arch.name}: "
          f"{sum(x.numel() for x in tree.leaves(params)):,} params, "
          f"{len(engine.slots)} slots, "
          f"{engine.cache.cfg.num_blocks} x {engine.cache.cfg.block_size}"
          f"-token KV blocks")
    outs = engine.generate(requests(arch.vocab))
    s = engine.metrics.summary()
    print(f"completed {s['completed']} requests, {s['total_tokens']} tokens "
          f"({s['decode_steps']} decode steps, "
          f"{s['prefill_chunks']} prefill chunks, "
          f"occupancy {s['slot_occupancy_mean']*100:.0f}%, "
          f"{len(streamed)} tokens streamed via on_token)")
    for o in outs[:4]:
        mode = "greedy" if o.logprobs is None else "sampled"
        lp = ("" if o.logprobs is None
              else f"  logprobs[:3]={[round(x, 2) for x in o.logprobs[:3]]}")
        print(f"  req {o.request_id} [{mode}, {o.finish_reason}, "
              f"ttft {o.ttft_s*1e3:.0f}ms]: {o.token_ids}{lp}")
    return outs, s, streamed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    arch = reduce_for_smoke(ARCHS["qwen3-8b"])
    return run(arch, T.init_lm(arch, device=args.device, seed=0),
               args.device)


if __name__ == "__main__":
    main()
