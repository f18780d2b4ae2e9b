"""Engine replica worker (twin of ``repro/serving/cluster/worker.py``): one
``ContinuousBatchingEngine`` behind the cluster wire protocol.

Run as a subprocess by the launcher (``python -m
repro_torch.serving.cluster.worker --connect host:port --replica-id N
...``), or driven in-process by tests (``EngineWorker`` over an
``InProcTransport`` — same message handling, no sockets, no forks).

The process model: each worker owns its card (the launcher sets
``CUDA_VISIBLE_DEVICES`` per worker) and builds its engine placed on
``make_host_mesh(device=...)``, a world of 1 of its own that meets
through a file store, so replicas are pure data-parallel and never
communicate.  ``--device`` picks the device: CUDA unless it says ``cpu``;
a worker that finds no card dies at boot, which fails the launcher's
boot loudly.  Multi-host replicas (the reference's ``--distributed``)
are not ported: the flag raises.  Every torch import is deferred into
functions, so the protocol adapter imports none.

Parity contract: params come from ``init_lm`` with a generator seeded
with 0 on the worker's device — the same weights on every replica, and
the same as ``launch/serve.py``'s — and sampling keys are
``fold_in(seed, absolute_position)``, so a request produces bit-identical
tokens on ANY replica, and on a single-process engine.

The pump loop is single-threaded and clock-free: it alternates between
draining the transport (poll timeout 0 while the engine has work, a
short idle wait otherwise) and stepping the engine; per-token ``token``
messages fire from the engine's ``on_token`` hook mid-step, ``finish``
messages flush from ``engine.completed`` after each step.  Heartbeats
need no timer here — any ``ping`` is answered on the next loop
iteration, and the router counts any message (tokens included) as proof
of life.
"""
from __future__ import annotations

import argparse
import os
import socket

from repro_torch.serving.cluster.protocol import (ConnectionClosed,
                                                  MessageStream,
                                                  ProtocolError,
                                                  sampling_from_wire)

IDLE_POLL_S = 0.05          # transport wait when the engine is idle


class EngineWorker:
    """Protocol adapter around one engine.  ``transport`` is anything
    with send/poll (MessageStream in the subprocess, InProcTransport in
    tests)."""

    def __init__(self, engine, transport, replica_id: int):
        self.engine = engine
        self.transport = transport
        self.replica = replica_id
        self._draining = False
        self._drained_sent = False
        self._shutdown = False
        self._n_flushed = 0              # engine.completed flush cursor
        prev = engine.on_token

        def tap(rid: int, tok: int) -> None:
            if prev is not None:
                prev(rid, tok)
            self.transport.send({"type": "token", "rid": rid, "token": tok})

        engine.on_token = tap

    # -- outbound ------------------------------------------------------
    def _flush_completed(self) -> None:
        done = self.engine.completed
        while self._n_flushed < len(done):
            o = done[self._n_flushed]
            self._n_flushed += 1
            self.transport.send({
                "type": "finish", "rid": o.request_id,
                "token_ids": list(o.token_ids),
                "finish_reason": o.finish_reason,
                "prompt_len": o.prompt_len, "ttft_s": o.ttft_s,
                "tpot_s": o.tpot_s, "logprobs": o.logprobs})

    def _stats(self) -> dict:
        from repro_torch.serving.export import prometheus_text
        eng = self.engine
        return {
            "outstanding_tokens": eng.outstanding_tokens(),
            "in_flight": sum(s.busy for s in eng.slots),
            "queued": eng.scheduler.queue_depth,
            "completed": len(eng.completed),
            # lifetime counters, not windowed: summed across replicas they
            # give an exact aggregate hit rate
            "prefix_hits": eng.metrics.prefix_hit_tokens,
            "prefix_lookups": eng.metrics.prefix_lookup_tokens,
            "window": eng.metrics.window_signals(),
            "prom": prometheus_text(
                eng.metrics, labels={"replica": str(self.replica)})
            + kernel_launches_text(self.replica),
        }

    # -- inbound -------------------------------------------------------
    def _handle(self, m: dict) -> None:
        t = m.get("type")
        if t == "submit":
            self._handle_submit(m)
        elif t == "cancel":
            self.engine.cancel(int(m["rid"]),
                               reason=m.get("reason", "cancelled"))
        elif t == "ping":
            self.transport.send({"type": "pong", "seq": m.get("seq"),
                                 "stats": self._stats()})
        elif t == "stats":
            self.transport.send({"type": "stats", "stats": self._stats()})
        elif t == "drain":
            self._draining = True
        elif t == "shutdown":
            self._shutdown = True
        else:
            raise ProtocolError(f"unexpected message type {t!r} from router")

    def _handle_submit(self, m: dict) -> None:
        from repro_torch.serving.engine import Request
        rid = int(m["rid"])
        if self._draining:
            self.transport.send({"type": "error", "rid": rid,
                                 "error": "draining",
                                 "message": "worker is draining"})
            return
        try:
            req = Request(id=rid,
                          prompt=[int(x) for x in m["prompt"]],
                          max_new_tokens=int(m["max_new_tokens"]),
                          priority=int(m.get("priority", 0)),
                          sampling=sampling_from_wire(m.get("sampling", {})))
            self.engine.submit(req)
        except (TypeError, ValueError) as e:
            # reject-at-submit surfaces as a typed error upstream; the rid
            # is finished-with-error, never silently dropped.  TypeError
            # matters as much as ValueError: wrong-typed wire JSON
            # ("temperature": null -> float(None)) must reject the one
            # request, never crash the replica process
            self.transport.send({"type": "error", "rid": rid,
                                 "error": "rejected", "message": str(e)})

    # -- loop ----------------------------------------------------------
    def pump(self, idle_poll: float = IDLE_POLL_S) -> bool:
        """One loop iteration: drain the transport, step the engine,
        flush finishes.  False once the worker should exit (shutdown
        message or router gone).  Tests drive this directly."""
        if self._shutdown:
            return False
        timeout = 0.0 if self.engine.has_work else idle_poll
        try:
            msgs = self.transport.poll(timeout)
        except ConnectionClosed:
            return False                 # router is gone: exit, don't orphan
        for m in msgs:
            self._handle(m)
        if self._shutdown:
            return False
        if self.engine.has_work:
            self.engine.step()
        try:
            self._flush_completed()
            if self._draining and not self.engine.has_work \
                    and not self._drained_sent:
                self._drained_sent = True
                self.transport.send({"type": "drained"})
        except ConnectionClosed:
            return False
        return True

    def serve_forever(self) -> None:
        while self.pump():
            pass


def kernel_launches_text(replica: int,
                         namespace: str = "repro_serving") -> str:
    """Prometheus text of this process's kernel launch counters (each
    wrapper's ``launches``: one a kernel launch, none for a plain version
    on the CPU), labeled by replica and kernel, so that a caller of the
    cluster can see which kernels its requests ran through."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssd_scan as SSD
    full = f"{namespace}_kernel_launches_total"
    lines = [f"# HELP {full} launches of each kernel in this replica",
             f"# TYPE {full} counter"]
    for name, fn in (("rmsnorm", RN.rmsnorm),
                     ("flash_attention", FA.flash_attention),
                     ("ssd_scan", SSD.ssd_scan)):
        lines.append(f'{full}{{replica="{replica}",kernel="{name}"}} '
                     f'{fn.launches}')
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# subprocess entry point
# ---------------------------------------------------------------------------

def build_engine(args):
    """Arch + params + mesh + engine for one replica -> (engine, mesh)."""
    if args.distributed:
        raise NotImplementedError(
            "--distributed: multi-host replicas are not ported; a worker's "
            "mesh is a world of 1 on its own card")
    import torch

    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.launch.mesh import make_host_mesh, mesh_device
    from repro_torch.models import transformer as T
    from repro_torch.serving import ContinuousBatchingEngine, ServingMetrics

    arch = get_arch(args.arch)
    if args.smoke:
        arch = reduce_for_smoke(arch)
    mesh = make_host_mesh(device=args.device)
    dev = mesh_device(mesh)
    # identical per replica: a generator seeded with 0 on the device
    params = T.init_lm(arch, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
    engine = ContinuousBatchingEngine(
        arch, params, mesh, slots=args.slots, max_len=args.max_len,
        block_size=args.block_size, num_blocks=args.num_blocks,
        prefill_chunk=args.prefill_chunk, share_prefix=args.share_prefix,
        metrics=ServingMetrics(window_s=args.metrics_window))
    return engine, mesh


def boot_line(replica: int, mesh) -> str:
    """The worker's boot line: its replica, device, card and mesh shape."""
    import torch

    from repro_torch.launch.mesh import mesh_device
    dev = mesh_device(mesh)
    card = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "the host")
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return (f"worker {replica}: device {dev} ({card}), mesh "
            f"{' x '.join(f'{k} {v}' for k, v in shape.items())}, "
            f"pid {os.getpid()}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--connect", required=True,
                    help="router address host:port")
    ap.add_argument("--replica-id", type=int, required=True)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, failing without one)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--share-prefix", action="store_true")
    ap.add_argument("--metrics-window", type=float, default=10.0)
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host replicas: not ported, raises")
    args = ap.parse_args(argv)

    from repro_torch.launch.mesh import shutdown

    engine, mesh = build_engine(args)
    print(boot_line(args.replica_id, mesh), flush=True)
    host, port = args.connect.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)))
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    stream = MessageStream(sock)
    stream.send({"type": "ready", "replica": args.replica_id,
                 "pid": os.getpid(), "devices": mesh.size(),
                 "max_len": args.max_len})
    worker = EngineWorker(engine, stream, args.replica_id)
    try:
        worker.serve_forever()
    finally:
        stream.close()
        shutdown()


if __name__ == "__main__":
    main()
