"""Continuous serving of the hybrid and encoder-decoder architectures
(twin of ``examples/serve_hybrid_archs.py``).

  * zamba2: the shared block's KV pages through a per-application block
    pool (one pool row per application of the shared weights), the Mamba2
    state rides the slot-state pools;
  * whisper: each request may carry audio frame embeddings as its
    ``frontend`` — the encoder runs ONCE at admission and every decoder
    layer's cross K/V is written into the request's slot rows; text-only
    requests decode against zero cross K/V.

    PYTHONPATH=src python -m repro_torch.examples.serve_hybrid_archs \\
        [--device cpu]

Both at ``reduce_for_smoke`` widths, as the reference example's, with the
port's own random weights (``init_lm``, seed 0) unless ``params`` is
given.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.models import transformer as T
from repro_torch.serving import (ContinuousBatchingEngine, Request,
                                 SamplingParams)


def serve(arch_name: str, device, *, frontend_for=None, params=None):
    """Eight requests of 8-47 tokens, seeded nucleus sampling, every other
    one with frame embeddings when ``frontend_for`` is given -> (the
    outputs in request order, the metrics summary, the ids that carried a
    frontend)."""
    arch = reduce_for_smoke(ARCHS[arch_name])
    if params is None:
        params = T.init_lm(arch, device=device, seed=0)
    engine = ContinuousBatchingEngine(arch, params, device=device, slots=4,
                                      max_len=128, block_size=16,
                                      prefill_chunk=32)
    rng = np.random.default_rng(0)
    reqs, has_fe = [], set()
    for i in range(8):
        prompt_len = int(rng.integers(8, 48))
        fe = None
        if frontend_for is not None and i % 2 == 0:   # every other request
            fe = rng.standard_normal(
                (1, arch.encoder.seq_len, arch.d_model)).astype(np.float32)
            has_fe.add(i)
        reqs.append(Request(
            id=i,
            prompt=rng.integers(1, arch.vocab, size=prompt_len)
            .astype(np.int32),
            max_new_tokens=12, frontend=fe,
            # seeded sampling works on the slot-state archs too — the
            # sampler only sees logits, never the cache layout
            sampling=SamplingParams(temperature=0.7, top_p=0.9, seed=i)))
    outs = engine.generate(reqs)
    s = engine.metrics.summary()
    print(f"[{arch.name}] {s['completed']} requests, {s['total_tokens']} "
          f"tokens ({s['decode_steps']} decode steps, "
          f"{s['prefill_chunks']} prefill chunks, occupancy "
          f"{s['slot_occupancy_mean']*100:.0f}%)")
    for o in outs[:2]:
        tag = " (audio frontend)" if o.request_id in has_fe else ""
        print(f"  req {o.request_id}{tag} [{o.finish_reason}]: {o.token_ids}")
    return outs, s, has_fe


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return (serve("zamba2-2.7b", args.device),
            serve("whisper-medium", args.device, frontend_for="audio"))


if __name__ == "__main__":
    main()
