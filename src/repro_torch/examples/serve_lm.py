"""Legacy serving API example (twin of ``examples/serve_lm.py``): the
wave-era ``runtime.server.Server`` interface, a deprecation shim — every
token below is decoded by ``repro_torch.serving.ContinuousBatchingEngine``
(see ``serve_continuous.py`` and ``serve_hybrid_archs.py`` beside this
file for the engine's own API).

With ``--share-prefix`` the demo instead drives the engine directly on a
chat-style workload whose prompts share one system prompt: cross-request
prefix caching hands each later request the cached KV blocks of the
shared prefix, so its prefill starts at the matched boundary (watch the
reported hit rate and prefill-chunk count).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --share-prefix

The model is qwen3-8b at ``reduce_for_smoke`` widths, as the reference
example's, with the port's own random weights (``init_lm``, seed 0).
"""
from __future__ import annotations

import argparse
import warnings

import numpy as np

from repro_torch import tree
from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.models import transformer as T


def serve_legacy(arch, params, device) -> list:
    """Ten 16-token prompts through the ``Server`` shim, 12 new tokens
    each -> the completed legacy requests."""
    from repro_torch.runtime.server import Request, Server
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        server = Server(arch, params, slots=4, max_len=128, device=device)
    print(f"serving {arch.name}: "
          f"{sum(x.numel() for x in tree.leaves(params)):,} params, "
          f"{server.slots} slots")
    rng = np.random.default_rng(0)
    for i in range(10):
        prompt = rng.integers(1, arch.vocab, size=16).astype(np.int32)
        server.submit(Request(id=i, prompt=prompt, max_new_tokens=12))
    wall = server.run_until_drained()
    total_tokens = sum(len(r.out_tokens) for r in server.completed)
    print(f"completed {len(server.completed)} requests, "
          f"{total_tokens} tokens in {wall:.2f}s "
          f"({server.decode_steps} decode steps via the continuous engine)")
    for r in server.completed[:3]:
        print(f"  req {r.id}: {r.out_tokens}")
    return server.completed


def serve_shared_prefix(arch, params, device):
    """Ten prompts that share a 64-token system prompt, with prefix
    sharing on -> (the outputs, the metrics summary, the cache's prefix
    stats)."""
    from repro_torch.serving import ContinuousBatchingEngine, Request
    eng = ContinuousBatchingEngine(arch, params, device=device, slots=4,
                                   max_len=128, block_size=16,
                                   prefill_chunk=32, share_prefix=True)
    rng = np.random.default_rng(0)
    system_prompt = rng.integers(1, arch.vocab, size=64).astype(np.int32)
    print(f"serving {arch.name} with prefix sharing: 64-token system "
          f"prompt shared by every request")
    outs = eng.generate([
        Request(id=i,
                prompt=np.concatenate(
                    [system_prompt,
                     rng.integers(1, arch.vocab, size=8).astype(np.int32)]),
                max_new_tokens=12)
        for i in range(10)])
    s = eng.metrics.summary()
    stats = eng.cache.prefix_stats()
    print(f"completed {s['completed']} requests, {s['total_tokens']} tokens "
          f"— prefix hit rate {s['prefix_hit_rate']:.2f}, "
          f"{s['prefill_chunks']} prefill chunks, "
          f"mean TTFT {s['ttft_mean_s']*1e3:.0f}ms, "
          f"block utilization {s['block_utilization_mean']:.2f} mean / "
          f"{s['block_utilization_max']:.2f} max")
    print(f"cache: {stats}")
    for o in outs[:3]:
        print(f"  req {o.request_id} [{o.finish_reason}]: {o.token_ids}")
    return outs, s, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--share-prefix", action="store_true",
                    help="demo cross-request prefix caching on the engine "
                         "(shared system prompt, hit rate reported)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    arch = reduce_for_smoke(ARCHS["qwen3-8b"])
    params = T.init_lm(arch, device=args.device, seed=0)
    if args.share_prefix:
        return serve_shared_prefix(arch, params, args.device)
    return serve_legacy(arch, params, args.device)


if __name__ == "__main__":
    main()
