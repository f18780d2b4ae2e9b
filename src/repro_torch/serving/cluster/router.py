"""The cluster router (twin of ``repro/serving/cluster/router.py``): owns
replica connections, admission and placement.

One Router instance runs in the frontend process.  It holds a
``ReplicaHandle`` per worker (transport + liveness + in-flight set),
routes each submitted request to exactly one replica, relays streamed
tokens to per-request callbacks, and polices health with heartbeats.

Placement policy (tested without real workers in tests/test_torch_cluster.py):

  1. **prefix affinity** — the replica owning the longest chain-key
     prefix of the prompt (serving/cluster/affinity.py), so shared-prefix
     traffic keeps hitting the paged cache that already holds its blocks;
  2. **least-loaded fallback** — no affinity match ⇒ the live replica
     with the smallest *router-local* outstanding-token estimate:
     ``min(len(prompt) + max_new_tokens, max_len)`` charged at submit,
     decremented per relayed token, cleared at finish/error.  The
     estimate is deliberately local rather than read from worker ``pong``
     stats: stats age (heartbeat-interval granularity) and a burst of
     submits between two pongs would all land on the same replica.
     Worker-reported stats are kept for /metrics and healthz, not for
     placement arithmetic.

Health: a heartbeat ``ping`` goes to every live replica each
``heartbeat_interval``; *any* received message refreshes ``last_seen``
(token traffic is proof of life — a saturated worker must not need to
answer pings to stay alive).  ``last_seen`` older than
``heartbeat_timeout`` — or EOF on the transport, or a protocol
violation (``poll`` contains the ``ProtocolError`` that ``_dispatch``
raises — a malformed worker message kills that replica, never the poll
thread) — marks the replica dead: an absorbing state.  Its in-flight rids fail with
``ReplicaDeadError`` through their error callbacks, its affinity keys
drop, and the router keeps serving on the survivors (no zero-loss
restore: a dead replica's requests fail).

Invariants: every submitted rid is owned
by exactly one live replica until it leaves through exactly one of
finish / error / cancel; ``last_seen`` is monotone per replica; dead is
absorbing; a dead replica is never routed to.

Threading: the public surface (submit / cancel / poll / stats /
prometheus_text / drain / broadcast_shutdown) is serialized by one lock,
so an HTTP handler thread can submit while the router thread polls.
``poll`` waits for traffic before it takes the lock, never while holding
it: a loop that held the lock through its waits would re-take it the
moment it let go, and a handler thread could wait on it for seconds.
Sends happen with the lock held, which is safe only because
``MessageStream.send`` is bounded by its send timeout: a wedged worker
(blocked writing tokens at us while we block writing submits at it)
escalates to ConnectionClosed -> ``_mark_dead`` instead of holding the
lock — and thereby the poll thread — forever.
Callbacks fire with the lock held — they must be cheap and non-reentrant
(the HTTP frontend's just enqueue to a per-request Queue).

No torch in this module: routing never touches a device.
"""
from __future__ import annotations

import select
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.serving.cluster.affinity import PrefixAffinity
from repro_torch.serving.cluster.protocol import (ClusterError, ConnectionClosed,
                                            ProtocolError, ReplicaDeadError,
                                            SubmitRejectedError)

TokenCallback = Callable[[int, int, Optional[float]], None]
FinishCallback = Callable[[dict], None]
ErrorCallback = Callable[[Exception], None]


@dataclass
class ReplicaHandle:
    """Router-side state for one worker replica."""
    replica: int
    transport: object                      # MessageStream or InProcTransport
    state: str = "live"                    # "live" | "dead"
    last_seen: float = 0.0
    pid: Optional[int] = None
    max_len: int = 512                     # from the worker's ready message
    in_flight: set = field(default_factory=set)        # rids owned here
    last_stats: dict = field(default_factory=dict)     # newest pong stats
    prom_text: str = ""                    # newest per-replica /metrics text

    @property
    def alive(self) -> bool:
        return self.state == "live"


@dataclass
class _Pending:
    replica: int
    est_tokens: int                        # remaining worst-case tokens
    on_token: Optional[TokenCallback]
    on_finish: Optional[FinishCallback]
    on_error: Optional[ErrorCallback]


class Router:
    def __init__(self, handles: list[ReplicaHandle], *, block_size: int = 16,
                 heartbeat_interval: float = 1.0,
                 heartbeat_timeout: float = 10.0,
                 affinity_max_keys: int = 65536,
                 clock: Callable[[], float] = time.monotonic):  # reprolint: disable=clock-injection
        if not handles:
            raise ValueError("router needs at least one replica handle")
        self._handles = {h.replica: h for h in handles}
        if len(self._handles) != len(handles):
            raise ValueError("duplicate replica ids")
        self.affinity = PrefixAffinity(block_size,
                                       max_keys=affinity_max_keys)
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_timeout = heartbeat_timeout
        self._clock = clock
        self._lock = threading.RLock()
        self._pending: dict[int, _Pending] = {}
        self._next_rid = 0
        self._ping_seq = 0
        self._last_ping = clock()
        now = clock()
        for h in handles:
            h.last_seen = max(h.last_seen, now)
        self.stats = {"submitted": 0, "finished": 0, "errors": 0,
                      "cancelled": 0, "replicas_lost": 0}

    # -- placement -----------------------------------------------------
    def _live(self) -> list[ReplicaHandle]:
        return [h for h in self._handles.values() if h.alive]

    def _place(self, prompt) -> tuple[ReplicaHandle, int]:
        live = self._live()
        if not live:
            raise ClusterError("no live replicas")
        replica, matched = self.affinity.route(prompt,
                                               [h.replica for h in live])
        if replica is not None:
            return self._handles[replica], matched
        loads = {h.replica: sum(self._pending[r].est_tokens
                                for r in h.in_flight) for h in live}
        # deterministic tiebreak on replica id: unit tests pin placement
        best = min(live, key=lambda h: (loads[h.replica], h.replica))
        return best, 0

    # -- public surface ------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *, priority: int = 0,
               sampling: Optional[dict] = None,
               on_token: Optional[TokenCallback] = None,
               on_finish: Optional[FinishCallback] = None,
               on_error: Optional[ErrorCallback] = None) -> int:
        """Route one request; returns the cluster-assigned rid.  Raises
        ClusterError when no replica is live.  ``sampling`` is the wire
        dict (protocol.sampling_to_wire) — the router never imports
        SamplingParams."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1 "
                             f"(got {max_new_tokens})")
        with self._lock:
            handle, _ = self._place(prompt)
            rid = self._next_rid
            self._next_rid += 1
            est = min(len(prompt) + max_new_tokens, handle.max_len) \
                - len(prompt)
            self._pending[rid] = _Pending(
                replica=handle.replica, est_tokens=max(est, 0),
                on_token=on_token, on_finish=on_finish, on_error=on_error)
            handle.in_flight.add(rid)
            msg = {"type": "submit", "rid": rid, "prompt": prompt,
                   "max_new_tokens": int(max_new_tokens),
                   "priority": int(priority),
                   "sampling": sampling or {}}
            try:
                handle.transport.send(msg)
            except ConnectionClosed:
                self._mark_dead(handle, "send failed")
                raise ClusterError(
                    f"replica {handle.replica} died at submit") from None
            # register the prompt's blocks as living on this replica —
            # optimistic, but a later shared-prefix request should follow
            # this one even before its prefill commits
            self.affinity.commit(prompt, handle.replica)
            self.stats["submitted"] += 1
            return rid

    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        """Forward a cancel for an in-flight rid; True iff it was in
        flight here.  The rid stays pending until the worker's ``finish``
        (reason echoed back) arrives — cancel is a request, not a local
        state transition, so token/finish relays stay ordered."""
        with self._lock:
            p = self._pending.get(rid)
            if p is None:
                return False
            handle = self._handles[p.replica]
            if handle.alive:
                try:
                    handle.transport.send({"type": "cancel", "rid": rid,
                                           "reason": reason})
                except ConnectionClosed:
                    self._mark_dead(handle, "send failed")
            self.stats["cancelled"] += 1
            return True

    def _wait(self, timeout: float) -> None:
        """Wait up to ``timeout`` seconds, without the lock, until a live
        replica's socket is readable (the whole ``timeout`` when none has
        a socket: in-process transports, or no live replica)."""
        with self._lock:
            socks = [h.transport for h in self._live()
                     if hasattr(h.transport, "fileno")]
        if not socks:
            time.sleep(timeout)
            return
        try:
            select.select(socks, [], [], timeout)
        except (OSError, ValueError):
            pass              # a closed socket: the locked poll marks it

    def poll(self, timeout: float = 0.0) -> int:
        """Wait up to ``timeout`` seconds for a message, then drain every
        live replica's transport, dispatch callbacks, send due heartbeats
        and reap timed-out replicas.  Returns the number of messages
        handled.  The wait holds no lock, so that handler threads calling
        submit / cancel / stats between two polls are not starved by the
        router thread's loop.  The router thread calls this in a loop;
        unit tests call it directly under an injected clock."""
        if timeout > 0:
            self._wait(timeout)
        handled = 0
        with self._lock:
            for h in list(self._handles.values()):
                if not h.alive:
                    continue
                try:
                    msgs = h.transport.poll(0.0)
                except ConnectionClosed:
                    self._mark_dead(h, "connection closed")
                    continue
                if msgs:
                    h.last_seen = max(h.last_seen, self._clock())
                for m in msgs:
                    try:
                        self._dispatch(h, m)
                    except ProtocolError as e:
                        # one malformed worker message must never kill
                        # the (only) poll thread: the offending replica
                        # dies, survivors keep serving
                        self._mark_dead(h, str(e))
                        break
                    handled += 1
            self._heartbeat()
        return handled

    def drain(self) -> None:
        """Ask every live replica to finish in-flight work.  Poll until
        ``pending_count`` reaches zero to complete the drain."""
        with self._lock:
            for h in self._live():
                try:
                    h.transport.send({"type": "drain"})
                except ConnectionClosed:
                    self._mark_dead(h, "send failed")

    def request_stats(self) -> None:
        """Ask every live replica for a fresh stats snapshot; replies land
        in ``replica_states()[i]["stats"]`` on subsequent polls.  The
        cluster benchmark uses this to read exact lifetime counters after
        a drain instead of settling for heartbeat-aged pong stats."""
        with self._lock:
            for h in self._live():
                try:
                    h.transport.send({"type": "stats"})
                except ConnectionClosed:
                    self._mark_dead(h, "send failed")

    def broadcast_shutdown(self) -> None:
        with self._lock:
            for h in self._live():
                try:
                    h.transport.send({"type": "shutdown"})
                except ConnectionClosed:
                    self._mark_dead(h, "send failed")

    @property
    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def replica_states(self) -> dict[int, dict]:
        with self._lock:
            return {h.replica: {"state": h.state, "pid": h.pid,
                                "in_flight": len(h.in_flight),
                                "last_seen": h.last_seen,
                                "stats": dict(h.last_stats)}
                    for h in self._handles.values()}

    def aggregate_stats(self) -> dict:
        with self._lock:
            live = self._live()
            return {"router": dict(self.stats),
                    "affinity": dict(self.affinity.stats),
                    "replicas_live": len(live),
                    "replicas_total": len(self._handles),
                    "pending": len(self._pending)}

    def prometheus_text(self, namespace: str = "repro_serving") -> str:
        """Cluster /metrics payload: hand-rendered router-level series
        followed by each replica's latest self-reported exposition text
        (already labeled ``{replica="i"}`` by the worker).  Parses back
        through export.parse_prometheus_text — pinned in tests."""
        with self._lock:
            lines = []
            counters = {"requests_routed_total": self.stats["submitted"],
                        "requests_finished_total": self.stats["finished"],
                        "requests_errored_total": self.stats["errors"],
                        "replicas_lost_total": self.stats["replicas_lost"],
                        "affinity_routed_total":
                            self.affinity.stats["routed_affinity"],
                        "fallback_routed_total":
                            self.affinity.stats["routed_fallback"]}
            for name, v in counters.items():
                full = f"{namespace}_router_{name}"
                lines.append(f"# TYPE {full} counter")
                lines.append(f"{full} {int(v)}")
            gauges = {"replicas_live": len(self._live()),
                      "requests_pending": len(self._pending),
                      "affinity_keys": len(self.affinity)}
            for name, v in gauges.items():
                full = f"{namespace}_router_{name}"
                lines.append(f"# TYPE {full} gauge")
                lines.append(f"{full} {int(v)}")
            parts = ["\n".join(lines) + "\n"]
            parts.extend(h.prom_text for h in self._handles.values()
                         if h.prom_text)
            return "\n".join(parts)

    # -- message handling ----------------------------------------------
    def _dispatch(self, h: ReplicaHandle, m: dict) -> None:
        t = m.get("type")
        if t == "token":
            p = self._pending.get(int(m["rid"]))
            if p is not None:
                p.est_tokens = max(p.est_tokens - 1, 0)
                if p.on_token is not None:
                    p.on_token(int(m["rid"]), int(m["token"]),
                               m.get("logprob"))
        elif t == "finish":
            rid = int(m["rid"])
            p = self._pending.pop(rid, None)
            h.in_flight.discard(rid)
            if p is not None:
                self.stats["finished"] += 1
                if p.on_finish is not None:
                    p.on_finish(m)
        elif t == "error":
            rid = int(m["rid"])
            p = self._pending.pop(rid, None)
            h.in_flight.discard(rid)
            if p is not None:
                self.stats["errors"] += 1
                if p.on_error is not None:
                    p.on_error(SubmitRejectedError(
                        m.get("message", m.get("error", "rejected"))))
        elif t == "pong" or t == "stats":
            h.last_stats = dict(m.get("stats", {}))
            if "prom" in h.last_stats:
                h.prom_text = h.last_stats.pop("prom")
        elif t == "ready" or t == "drained":
            pass                  # liveness already refreshed by receipt
        else:
            raise ProtocolError(f"unexpected message type {t!r} from "
                                f"replica {h.replica}")

    # -- health --------------------------------------------------------
    def _heartbeat(self) -> None:
        now = self._clock()
        if now - self._last_ping >= self.heartbeat_interval:
            self._last_ping = now
            self._ping_seq += 1
            for h in self._live():
                try:
                    h.transport.send({"type": "ping",
                                      "seq": self._ping_seq})
                except ConnectionClosed:
                    self._mark_dead(h, "send failed")
        for h in self._live():
            if now - h.last_seen > self.heartbeat_timeout:
                self._mark_dead(h, f"no message for "
                                   f"{now - h.last_seen:.1f}s")

    def _mark_dead(self, h: ReplicaHandle, why: str) -> None:
        """Absorbing transition live -> dead.  Every in-flight rid on the
        replica fails with ReplicaDeadError; its affinity keys drop so no
        future request is routed at a ghost."""
        if not h.alive:
            return
        h.state = "dead"
        self.stats["replicas_lost"] += 1
        self.affinity.drop_replica(h.replica)
        err = ReplicaDeadError(h.replica, f"replica {h.replica} died "
                                          f"({why})")
        for rid in sorted(h.in_flight):
            p = self._pending.pop(rid, None)
            if p is not None:
                self.stats["errors"] += 1
                if p.on_error is not None:
                    p.on_error(err)
        h.in_flight.clear()
        try:
            h.transport.close()
        except Exception:
            pass
