"""Wire protocol between the cluster router and its engine workers (twin
of ``repro/serving/cluster/protocol.py``).

Framing is newline-delimited JSON (NDJSON): one message per line, UTF-8,
compact separators, no newlines inside a message.  JSON because every
payload (token ids, sampling params, stats dicts, Prometheus text) is
already JSON-able in this codebase; newline framing because it needs no
length prefix, is trivially inspectable with ``nc``/``socat``, and a
partial line at EOF is unambiguously a truncated message.

Message types:

  router -> worker:
    submit    rid, prompt, max_new_tokens, priority, sampling{...}
    cancel    rid, [reason]
    stats     (request one unsolicited stats message back)
    ping      seq                     (heartbeat probe)
    drain     (finish in-flight work, then report ``drained``)
    shutdown  (exit the serve loop; process exits 0)

  worker -> router:
    ready     replica, pid, devices   (sent once, first message)
    token     rid, token, [logprob]   (one per sampled token, in order)
    finish    rid, token_ids, finish_reason, prompt_len, ttft_s, tpot_s,
              [logprobs]
    error     rid, error, message     (submit-time rejection; rid is dead)
    pong      seq, stats{...}         (heartbeat reply + piggybacked stats)
    stats     stats{...}
    drained   (drain complete; engine idle)

The ``stats`` dict carries the worker's load/telemetry vector upstream:
``outstanding_tokens`` (the router's least-loaded fallback metric),
``in_flight``, ``queued``, ``completed``, ``window`` (the engine's
``window_signals()`` vector) and ``prom`` (Prometheus text rendered with
a ``replica`` label, concatenated by the frontend's /metrics).

Two transports implement the same ``send``/``poll`` surface:
``MessageStream`` wraps a real socket (non-blocking reads via ``select``,
bounded-blocking writes via ``sendall`` under a send timeout);
``InProcTransport`` is a deque pair for tests that run router and worker
in one process with no sockets at all.
"""
from __future__ import annotations

import json
import select
import socket
from collections import deque
from typing import Optional


class ClusterError(Exception):
    """Base for cluster-level failures surfaced to callers."""


class ProtocolError(ClusterError):
    """Malformed or unexpected message on the wire."""


class ConnectionClosed(ClusterError):
    """The peer closed its end of the transport."""


class ReplicaDeadError(ClusterError):
    """The replica owning a request died (heartbeat timeout or EOF)
    before the request finished.  In-flight requests on a dead replica
    fail with this (there is no zero-loss restore)."""

    def __init__(self, replica: int, message: str = ""):
        self.replica = replica
        super().__init__(message or f"replica {replica} died")


class SubmitRejectedError(ClusterError):
    """The worker's engine rejected the request at submit (validation or
    budget) — the rid is finished-with-error, never silently dropped."""


def encode_message(msg: dict) -> bytes:
    """One NDJSON frame.  Compact separators keep token messages — the
    high-rate path — under ~50 bytes."""
    line = json.dumps(msg, separators=(",", ":"))
    if "\n" in line:
        raise ProtocolError("message contains a newline after encoding")
    return line.encode("utf-8") + b"\n"


def decode_message(line: bytes) -> dict:
    try:
        msg = json.loads(line)
    except ValueError as e:
        raise ProtocolError(f"undecodable frame {line[:80]!r}: {e}") from None
    if not isinstance(msg, dict) or "type" not in msg:
        raise ProtocolError(f"frame is not a typed message: {line[:80]!r}")
    return msg


#: sendall bound.  A healthy peer drains its socket buffer in
#: milliseconds; a send still blocked after this long means the peer is
#: wedged (e.g. itself stuck in a blocking write back at us), and the
#: only safe escalation is ConnectionClosed so the caller marks the
#: replica dead instead of holding its lock forever.
SEND_TIMEOUT_S = 30.0


class MessageStream:
    """NDJSON messages over a connected socket.

    ``send`` is bounded-blocking (sendall under ``send_timeout`` — the
    writer is either the router's lock-held submit path or the worker's
    pump loop, both of which want backpressure, not buffering; but the
    router's submit holds the router lock, which the poll thread also
    needs, so an unbounded sendall against a wedged peer would deadlock
    the whole cluster).  A timed-out send raises ``ConnectionClosed``:
    the frame may be half-written, so the connection is unusable and the
    caller's mark-dead path is the correct escalation.  ``poll`` drains
    whatever is readable within ``timeout`` seconds and returns complete
    messages; a partial trailing line stays buffered for the next poll.
    EOF raises ``ConnectionClosed`` from the *next* poll after any
    buffered complete messages have been delivered — no message is lost
    to a close.
    """

    def __init__(self, sock: socket.socket,
                 send_timeout: float = SEND_TIMEOUT_S):
        self._sock = sock
        self._send_timeout = send_timeout
        self._rbuf = b""
        self._eof = False
        self._pending: deque = deque()

    def fileno(self) -> int:
        return self._sock.fileno()

    def send(self, msg: dict) -> None:
        data = encode_message(msg)
        try:
            self._sock.settimeout(self._send_timeout)
            try:
                self._sock.sendall(data)
            finally:
                self._sock.settimeout(None)
        except socket.timeout:
            raise ConnectionClosed(
                f"send timed out after {self._send_timeout:.0f}s "
                f"(peer wedged, frame possibly half-written)") from None
        except OSError as e:
            raise ConnectionClosed(f"send failed: {e}") from None

    def _drain_socket(self, timeout: float) -> None:
        while True:
            try:
                r, _, _ = select.select([self._sock], [], [], timeout)
            except OSError as e:
                raise ConnectionClosed(f"select failed: {e}") from None
            if not r:
                return
            try:
                chunk = self._sock.recv(65536)
            except OSError as e:
                raise ConnectionClosed(f"recv failed: {e}") from None
            if not chunk:
                self._eof = True
                return
            self._rbuf += chunk
            # keep draining without blocking: more may already be queued
            timeout = 0.0

    def poll(self, timeout: float = 0.0) -> list[dict]:
        """Complete messages received within ``timeout`` seconds (possibly
        none).  Raises ConnectionClosed once the peer is gone AND every
        buffered message has been returned."""
        if not self._eof:
            self._drain_socket(timeout)
        while b"\n" in self._rbuf:
            line, self._rbuf = self._rbuf.split(b"\n", 1)
            if line:                      # tolerate keepalive blank lines
                self._pending.append(decode_message(line))
        out = list(self._pending)
        self._pending.clear()
        if not out and self._eof:
            raise ConnectionClosed("peer closed the connection")
        return out

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class InProcTransport:
    """In-process transport half: messages ``send``-ed here appear in the
    paired half's ``poll``.  Built by ``pair()``; used by router unit
    tests (scripted fake workers) and the in-process parity test (real
    engines, no subprocesses).  ``close()`` makes the *peer* see
    ConnectionClosed — same semantics as a socket shutdown."""

    def __init__(self):
        self._inbox: deque = deque()
        self._peer: Optional[InProcTransport] = None
        self._closed = False

    @classmethod
    def pair(cls) -> tuple["InProcTransport", "InProcTransport"]:
        a, b = cls(), cls()
        a._peer, b._peer = b, a
        return a, b

    def send(self, msg: dict) -> None:
        if self._peer is None or self._peer._closed:
            raise ConnectionClosed("peer closed the transport")
        # encode/decode round-trip so tests exercise the same JSON
        # constraints (tuples become lists, keys become strings) as sockets
        self._peer._inbox.append(decode_message(encode_message(msg)[:-1]))

    def poll(self, timeout: float = 0.0) -> list[dict]:
        out = list(self._inbox)
        self._inbox.clear()
        if not out and (self._closed
                        or self._peer is None or self._peer._closed):
            raise ConnectionClosed("peer closed the transport")
        return out

    def close(self) -> None:
        self._closed = True


def sampling_to_wire(sp) -> dict:
    """SamplingParams -> JSON-able dict (tuples become lists on the wire;
    ``sampling_from_wire`` restores them)."""
    return {"temperature": sp.temperature, "top_k": sp.top_k,
            "top_p": sp.top_p, "seed": sp.seed,
            "stop_token_ids": list(sp.stop_token_ids),
            "stop": list(sp.stop), "logprobs": sp.logprobs}


def _wire_seq(d: dict, key: str) -> tuple:
    """A list-valued wire field as a tuple.  A bare string is rejected
    rather than iterated: ``"stop": "END"`` would otherwise silently
    become per-character stops ("E", "N", "D")."""
    v = d.get(key, ())
    if isinstance(v, (str, bytes)):
        raise ValueError(f"{key!r} must be a list, not a bare string "
                         f"({v!r})")
    return tuple(v)


def sampling_from_wire(d: dict):
    """Inverse of ``sampling_to_wire``, building the port's
    ``SamplingParams``.  Imported lazily, so that a process that only
    routes (the router never calls this) does not import torch through
    serving.sampling.

    Raises ValueError OR TypeError on wrong-typed fields (float(None),
    int("x"), ...) — callers that must survive arbitrary wire input
    (worker submit handling) catch both."""
    from repro_torch.serving.sampling import SamplingParams
    return SamplingParams(
        temperature=float(d.get("temperature", 0.0)),
        top_k=int(d.get("top_k", 0)),
        top_p=float(d.get("top_p", 1.0)),
        seed=None if d.get("seed") is None else int(d["seed"]),
        stop_token_ids=tuple(int(t) for t in _wire_seq(d, "stop_token_ids")),
        stop=_wire_seq(d, "stop"),
        logprobs=bool(d.get("logprobs", False)))
