"""Cluster serving launcher for the PyTorch/CUDA port (twin of
``repro/launch/serve_cluster.py``: every flag of the reference's, plus
``--device``): N engine replica workers + prefix-affinity router +
HTTP/SSE frontend.

    PYTHONPATH=src python -m repro_torch.launch.serve_cluster \
        --arch qwen3-8b --replicas 2 --slots 4 --max-len 1024 \
        --block-size 16 --prefill-chunk 256
    PYTHONPATH=src python -m repro_torch.launch.serve_cluster \
        --arch qwen3-8b --smoke --device cpu --replicas 2 --http-port 8080

Workers run on CUDA unless ``--device cpu`` is given, each on its own
card (round robin, printed, when there are fewer cards than replicas); a
worker that finds no card dies at boot and the launcher fails.  Weights
are random, from a generator seeded with 0 on each worker's device, so
every replica holds the same.  ``--devices-per-worker`` above 1 is
refused: a worker's mesh is a world of 1 on one card.

Boot sequence: bind the worker port (ephemeral unless --worker-port),
spawn the replicas (a subprocess each, each printing a boot line with its
device, card and mesh shape), accept their connections + ready
handshakes, then start the router poll loop on a background thread and
the HTTP server on this one.  Prints ``serving on http://...`` and the
worker pids once ready (a caller scrapes both; the pids for the
no-orphans check).

Shutdown: SIGTERM/SIGINT trips one event; the HTTP server stops, the
router broadcasts ``shutdown``, the launcher reaps every worker
(terminate -> kill escalation for stragglers) and the process exits 0.
A worker dying early fails the boot loudly instead of hanging accept.

The router/frontend process touches no CUDA device — only the worker
subprocesses pay device-runtime startup.
"""
from __future__ import annotations

import argparse
import signal
import sys
import threading
import traceback


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the workers' torch device (default: cuda, each "
                         "worker failing without one)")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--http-host", default="127.0.0.1")
    ap.add_argument("--http-port", type=int, default=0,
                    help="frontend port (0 = ephemeral, printed at boot)")
    ap.add_argument("--worker-port", type=int, default=0,
                    help="router's worker-facing port (0 = ephemeral)")
    ap.add_argument("--devices-per-worker", type=int, default=1,
                    help="cards per worker (only 1: a worker's mesh is a "
                         "world of 1)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--share-prefix", action="store_true")
    ap.add_argument("--metrics-window", type=float, default=10.0)
    ap.add_argument("--heartbeat-interval", type=float, default=1.0)
    ap.add_argument("--heartbeat-timeout", type=float, default=30.0)
    ap.add_argument("--boot-timeout", type=float, default=300.0,
                    help="seconds to wait for every worker to connect "
                         "(each starts torch, draws its weights and plans)")
    args = ap.parse_args(argv)
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")

    from repro_torch.serving.cluster.frontend import ClusterHTTPServer
    from repro_torch.serving.cluster.launcher import (
        WorkerProcesses, accept_workers, check_devices_per_worker,
        listen_socket)
    from repro_torch.serving.cluster.router import ReplicaHandle, Router

    try:
        check_devices_per_worker(args.devices_per_worker)
    except ValueError as e:
        ap.error(str(e))

    srv = listen_socket(port=args.worker_port)
    host, port = srv.getsockname()[:2]
    procs = WorkerProcesses.spawn(
        args.replicas, connect=f"{host}:{port}", arch=args.arch,
        devices_per_worker=args.devices_per_worker, device=args.device,
        smoke=args.smoke,
        slots=args.slots, max_len=args.max_len, block_size=args.block_size,
        num_blocks=args.num_blocks, prefill_chunk=args.prefill_chunk,
        share_prefix=args.share_prefix,
        metrics_window=args.metrics_window)
    try:
        conns = accept_workers(srv, args.replicas,
                               timeout=args.boot_timeout, procs=procs)
    except Exception:
        procs.stop(grace=2.0)
        raise
    handles = [ReplicaHandle(replica=rid, transport=stream,
                             pid=ready.get("pid"),
                             max_len=ready.get("max_len", args.max_len))
               for rid, (stream, ready) in sorted(conns.items())]
    router = Router(handles, block_size=args.block_size,
                    heartbeat_interval=args.heartbeat_interval,
                    heartbeat_timeout=args.heartbeat_timeout)
    http = ClusterHTTPServer(router, host=args.http_host,
                             port=args.http_port)

    stop = threading.Event()

    def on_signal(signum, frame):
        stop.set()
        # unblock serve_forever from the signal handler's thread safely
        threading.Thread(target=http.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)

    # Router.poll already contains per-replica failures (ProtocolError /
    # ConnectionClosed -> mark dead); anything that still escapes is a
    # router bug, and the one poll thread dying silently would leave the
    # HTTP server accepting requests that can never finish.  Fail the
    # whole process loudly instead.
    poll_failure: list = []

    def poll_loop():
        try:
            while not stop.is_set():
                router.poll(0.05)
        except Exception:
            poll_failure.append(traceback.format_exc())
            print(f"fatal: router poll thread died\n{poll_failure[0]}",
                  file=sys.stderr, flush=True)
            stop.set()
            threading.Thread(target=http.shutdown, daemon=True).start()

    poller = threading.Thread(target=poll_loop, daemon=True,
                              name="router-poll")
    poller.start()

    print(f"serving on {http.url} "
          f"({args.replicas} replica(s), arch {args.arch})", flush=True)
    print(f"worker pids: {' '.join(str(p) for p in procs.pids)}",
          flush=True)
    try:
        http.serve_forever(poll_interval=0.2)
    finally:
        stop.set()
        poller.join(timeout=5.0)
        router.broadcast_shutdown()
        codes = procs.stop(grace=10.0)
        http.server_close()
        srv.close()
        print(f"workers exited with {codes}", flush=True)
    sys.exit(1 if poll_failure else 0)


if __name__ == "__main__":
    main()
