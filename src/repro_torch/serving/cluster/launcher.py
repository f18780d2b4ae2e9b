"""Subprocess launcher for engine replica workers (twin of
``repro/serving/cluster/launcher.py``).

Spawns N copies of ``python -m repro_torch.serving.cluster.worker``, each
with its own environment: on CUDA each replica gets its own card
(``CUDA_VISIBLE_DEVICES``: replica i the i-th card this process sees, or,
with fewer cards than replicas, the cards round robin, which the launcher
prints), and no torchrun variables, so that every worker is a world of 1
of its own.  The parent router process never touches a CUDA device.
Workers dial back to the router's listening socket; ``accept_workers``
pairs each accepted connection with its ``ready`` message so the router
gets handles in replica order no matter the connect order.

A worker's mesh is a world of 1 on one card: multi-card replicas
(``devices_per_worker > 1``) are not ported and raise.

Teardown discipline (a SIGTERM to the router must leave no orphans):
``stop()`` broadcasts ``shutdown`` on any still-open transports, waits
``grace`` seconds for voluntary exit, then escalates terminate -> kill.
``WorkerProcesses`` is a context manager and its ``__exit__`` always
reaps, so an exception between spawn and accept cannot leak children.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import Optional

from repro_torch.serving.cluster.protocol import (ClusterError, MessageStream,
                                                  ProtocolError)

# torchrun's variables: a worker that inherited them would join the
# launcher's world instead of starting its own
_WORLD_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
               "GROUP_RANK", "MASTER_ADDR", "MASTER_PORT")


def worker_command(*, connect: str, replica_id: int, arch: str,
                   device: Optional[str] = None, smoke: bool = False,
                   slots: int = 4, max_len: int = 256,
                   block_size: int = 16, num_blocks: Optional[int] = None,
                   prefill_chunk: int = 64, share_prefix: bool = False,
                   metrics_window: float = 10.0) -> list[str]:
    cmd = [sys.executable, "-m", "repro_torch.serving.cluster.worker",
           "--connect", connect, "--replica-id", str(replica_id),
           "--arch", arch, "--slots", str(slots),
           "--max-len", str(max_len), "--block-size", str(block_size),
           "--prefill-chunk", str(prefill_chunk),
           "--metrics-window", str(metrics_window)]
    if device is not None:
        cmd += ["--device", device]
    if smoke:
        cmd.append("--smoke")
    if num_blocks is not None:
        cmd += ["--num-blocks", str(num_blocks)]
    if share_prefix:
        cmd.append("--share-prefix")
    return cmd


def check_devices_per_worker(devices_per_worker: int) -> None:
    if devices_per_worker != 1:
        raise ValueError(
            f"--devices-per-worker {devices_per_worker}: a replica of more "
            f"than one card is not ported (a worker's mesh is a world of 1 "
            f"on its own card)")


def visible_cards() -> list[str]:
    """The cards this process may hand out: its ``CUDA_VISIBLE_DEVICES``,
    else every card CUDA counts (read without a CUDA context)."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [c.strip() for c in env.split(",") if c.strip()]
    import torch
    return [str(i) for i in range(torch.cuda.device_count())]


def assign_cards(n_replicas: int, cards: list[str]) -> list[Optional[str]]:
    """Replica i's card: the i-th with a card per replica, else the cards
    round robin; None each when there is no card (the workers then fail
    at boot unless they serve on the CPU)."""
    if not cards:
        return [None] * n_replicas
    return [cards[i % len(cards)] for i in range(n_replicas)]


def worker_env(devices_per_worker: int = 1, *,
               card: Optional[str] = None) -> dict:
    """Child environment: the launcher's, without torchrun's variables,
    with ``CUDA_VISIBLE_DEVICES`` set to ``card`` when one is given.
    Raises, by name, for more than one card a worker."""
    check_devices_per_worker(devices_per_worker)
    env = {k: v for k, v in os.environ.items() if k not in _WORLD_VARS}
    if card is not None:
        env["CUDA_VISIBLE_DEVICES"] = card
    return env


class WorkerProcesses:
    """Owns the worker subprocesses of one cluster."""

    def __init__(self, procs: list[subprocess.Popen]):
        self.procs = procs

    @classmethod
    def spawn(cls, n_replicas: int, *, connect: str, arch: str,
              devices_per_worker: int = 1, device: Optional[str] = None,
              **worker_kwargs) -> "WorkerProcesses":
        """Start the workers; on CUDA (``device`` not ``"cpu"``) each on
        its card, printing the assignment when replicas share cards."""
        cards = ([None] * n_replicas if device == "cpu"
                 else assign_cards(n_replicas, visible_cards()))
        if len({c for c in cards if c is not None}) < n_replicas and \
                cards[0] is not None:
            print("replicas share cards: " + ", ".join(
                f"replica {i} on card {c}" for i, c in enumerate(cards)),
                flush=True)
        procs = []
        try:
            for i in range(n_replicas):
                cmd = worker_command(connect=connect, replica_id=i,
                                     arch=arch, device=device,
                                     **worker_kwargs)
                procs.append(subprocess.Popen(
                    cmd, env=worker_env(devices_per_worker, card=cards[i])))
        except Exception:
            cls(procs).stop(grace=2.0)
            raise
        return cls(procs)

    @property
    def pids(self) -> list[int]:
        return [p.pid for p in self.procs]

    def poll_dead(self) -> list[int]:
        """Indices of workers whose process has exited."""
        return [i for i, p in enumerate(self.procs) if p.poll() is not None]

    def stop(self, *, streams: Optional[list] = None,
             grace: float = 5.0) -> list[int]:
        """Reap every worker: polite shutdown message (when transports are
        provided), then wait, then terminate, then kill.  Returns exit
        codes.  Never raises — teardown must always finish."""
        if streams:
            for s in streams:
                try:
                    s.send({"type": "shutdown"})
                except Exception:
                    pass
        for p in self.procs:
            try:
                p.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        return [p.returncode for p in self.procs]

    def __enter__(self) -> "WorkerProcesses":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def listen_socket(host: str = "127.0.0.1", port: int = 0) -> socket.socket:
    """Router-side listening socket (port 0 = ephemeral; read the bound
    port off ``.getsockname()``)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(16)
    return srv


def accept_workers(srv: socket.socket, n: int, *, timeout: float = 120.0,
                   procs: Optional[WorkerProcesses] = None) \
        -> dict[int, tuple[MessageStream, dict]]:
    """Accept ``n`` worker connections and pair each with its ``ready``
    message -> {replica_id: (stream, ready_msg)}.  The generous default
    timeout covers the children's start: torch's import, the weights'
    init and the engine's plan.  Raises
    ClusterError if a worker process dies before connecting (checked
    between accepts via ``procs``) or the timeout lapses."""
    srv.settimeout(1.0)
    deadline = timeout
    by_replica: dict[int, tuple[MessageStream, dict]] = {}
    while len(by_replica) < n:
        if procs is not None and procs.poll_dead():
            raise ClusterError(f"worker(s) {procs.poll_dead()} exited "
                               f"before connecting")
        try:
            conn, _ = srv.accept()
        except socket.timeout:
            deadline -= 1.0
            if deadline <= 0:
                raise ClusterError(
                    f"timed out waiting for workers "
                    f"({len(by_replica)}/{n} connected)") from None
            continue
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        stream = MessageStream(conn)
        ready = _wait_ready(stream)
        rid = int(ready["replica"])
        if rid in by_replica:
            raise ProtocolError(f"two workers claimed replica id {rid}")
        by_replica[rid] = (stream, ready)
    return by_replica


def _wait_ready(stream: MessageStream, timeout: float = 30.0) -> dict:
    waited = 0.0
    while waited < timeout:
        msgs = stream.poll(0.5)
        if msgs:
            if msgs[0].get("type") != "ready":
                raise ProtocolError(f"worker's first message was "
                                    f"{msgs[0].get('type')!r}, not ready")
            return msgs[0]
        waited += 0.5
    raise ClusterError("worker connected but never sent ready")
