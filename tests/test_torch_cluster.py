"""The port's serving cluster (``repro_torch.serving.detok``,
``repro_torch.serving.cluster``, ``repro_torch.launch.serve_cluster``) on
the CPU: the reference's ``tests/test_cluster.py`` re-pointed at the
port's modules.

Detok and stop strings (the fuzz case included), chain keys and
affinity, the NDJSON stream and ``InProcTransport``, the router
(placement, affinity, heartbeat and death, cancel, Prometheus text,
fake transports under an injected clock) and the generate-body parsing
are the reference's tests as they are.  The in-process cluster (real
engines behind ``EngineWorker`` + ``Router`` over ``InProcTransport``)
serves the goldens' tiny arch with the reference's params under the
goldens' RNG (``torch_port_fixtures``): its tokens equal the goldens for
tiny/base and the port's single-process engine.  Then one subprocess
cluster (``--device cpu --smoke``, two replicas) for the whole module:
health and metrics, generate parity with a single-process engine on the
same seeded weights, an SSE stream with a stop string, and the SIGTERM
teardown, which must be the last test of the file (it kills the
cluster).
"""
from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from repro_torch.serving.cluster.affinity import PrefixAffinity
from repro_torch.serving.cluster.protocol import (ClusterError,
                                                  ConnectionClosed,
                                                  InProcTransport,
                                                  MessageStream,
                                                  ProtocolError,
                                                  ReplicaDeadError,
                                                  SubmitRejectedError,
                                                  decode_message,
                                                  encode_message,
                                                  sampling_to_wire)
from repro_torch.serving.cluster.router import ReplicaHandle, Router
from repro_torch.serving.detok import StopStringMatcher, default_detokenizer
from repro_torch.serving.export import parse_prometheus_text
from repro_torch.serving.prefix_hash import chain_keys
from serving_fixtures import TINY, load_goldens, scenario_requests
from torch_port_fixtures import port_arch, torch_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# detok / stop strings
# ---------------------------------------------------------------------------

def _stream_invariant(stops, pieces):
    """Feed ``pieces`` and check the emission invariant after every feed:
    concatenated emissions never contain a stop string."""
    m = StopStringMatcher(stops)
    emitted = ""
    for piece in pieces:
        emitted += m.feed(piece)
        for s in stops:
            assert s not in emitted
    return m, emitted


def test_stop_matcher_basic_match_and_trim():
    m = StopStringMatcher(["STOP"])
    out = [m.feed(p) for p in ["he", "llo S", "TO", "P world"]]
    assert "".join(out) == "hello "
    assert m.matched == "STOP"
    assert m.feed("more") == ""          # dead after match


def test_stop_matcher_never_streams_partial_suffix():
    # the partial suffix "S", "ST", "STO" must be withheld until resolved
    m = StopStringMatcher(["STOP"])
    assert m.feed("abcS") == "abc"
    assert m.held == "S"
    assert m.feed("T") == ""
    assert m.feed("Oz") == "STOz"        # resolved: not a stop, released
    assert m.matched is None


def test_stop_matcher_flush_releases_tail():
    m = StopStringMatcher(["xyz"])
    assert [m.feed("ab"), m.feed("cx"), m.feed("y")] == ["ab", "c", ""]
    assert m.flush() == "xy"
    assert m.matched is None


def test_stop_matcher_earliest_match_wins():
    m = StopStringMatcher(["bb", "abc"])
    # "aabcbb": "abc" starts at 1, "bb" at 4 -> "abc" fires, text "a"
    assert m.feed("aabcbb") == "a"
    assert m.matched == "abc"


def test_stop_matcher_match_across_many_tokens():
    detok = default_detokenizer()
    stop = detok.decode(7) + detok.decode(9)       # "t7 t9 "
    m = StopStringMatcher([stop])
    emitted = "".join(m.feed(detok.decode(t)) for t in [1, 7, 9, 2])
    assert m.matched == stop
    assert emitted == "t1 "


@pytest.mark.parametrize("stops", [["ab"], ["aba", "bab"], ["aa", "b"]])
def test_stop_matcher_fuzz_chunkings(stops):
    import random
    rng = random.Random(0)
    for trial in range(50):
        text = "".join(rng.choice("ab") for _ in range(30))
        # random chunking of the same text must match deterministically
        pieces, i = [], 0
        while i < len(text):
            n = rng.randint(1, 4)
            pieces.append(text[i:i + n])
            i += n
        m, emitted = _stream_invariant(stops, pieces)
        whole = StopStringMatcher(stops)
        whole_out = whole.feed(text)
        assert (m.matched is None) == (whole.matched is None)
        if m.matched is not None:
            assert emitted == whole_out     # trim point chunking-invariant
        else:
            assert emitted + m.flush() == text


def test_stop_matcher_rejects_bad_stops():
    with pytest.raises(ValueError):
        StopStringMatcher([""])
    with pytest.raises(ValueError):
        StopStringMatcher([7])


def test_sampling_params_stop_string_validation():
    from repro_torch.serving.sampling import SamplingParams
    SamplingParams(stop=("done",)).validate(100)
    with pytest.raises(ValueError):
        SamplingParams(stop=("",)).validate(100)
    with pytest.raises(ValueError):
        SamplingParams(stop=(3,)).validate(100)


# ---------------------------------------------------------------------------
# prefix hash chain + affinity index
# ---------------------------------------------------------------------------

def test_chain_keys_incremental_extension_composes():
    toks = list(range(40))
    full = chain_keys(toks, 8)
    head = chain_keys(toks, 8, 0, 3)
    tail = chain_keys(toks, 8, 3, 5, prev=head[-1])
    assert head + tail == full
    assert len(full) == 5


def test_chain_keys_match_paged_cache_keys():
    """The affinity index and the paged cache must key identically —
    equal prompts produce equal chain keys regardless of consumer."""
    toks = list(range(32))
    a = chain_keys(toks, 16)
    b = chain_keys(tuple(toks), 16)       # sequence type must not matter
    assert a == b
    # a different final chunk changes only the final key
    toks2 = toks[:-1] + [99]
    c = chain_keys(toks2, 16)
    assert c[0] == a[0] and c[1] != a[1]


def test_affinity_longest_prefix_wins():
    af = PrefixAffinity(4)
    af.commit(list(range(8)), 0)            # blocks 0,1 -> replica 0
    replica, n = af.route(list(range(16)), [0, 1])
    assert (replica, n) == (0, 2)           # partial chain still routes
    af.commit(list(range(16)), 1)           # blocks 0..3 -> replica 1
    replica, n = af.route(list(range(16)), [0, 1])
    assert (replica, n) == (1, 4)           # longest chain owns the route
    # commit overwrote the shared blocks' owner, so dropping replica 1
    # leaves no affinity signal: route declines and the router falls
    # back to least-loaded (the index is a hint, not ground truth)
    af.drop_replica(1)
    replica, n = af.route(list(range(16)), [0])
    assert (replica, n) == (None, 0)


def test_affinity_lru_cap_evicts_coldest():
    af = PrefixAffinity(2, max_keys=4)
    af.commit([1, 2, 3, 4], 0)              # 2 keys
    af.commit([5, 6, 7, 8], 1)              # +2 keys (at cap)
    af.commit([9, 10], 0)                   # +1 -> evicts coldest
    assert len(af) == 4
    assert af.stats["keys_evicted"] == 1


# ---------------------------------------------------------------------------
# wire protocol
# ---------------------------------------------------------------------------

def test_ndjson_roundtrip_and_errors():
    msg = {"type": "submit", "rid": 3, "prompt": [1, 2], "sampling": {}}
    assert decode_message(encode_message(msg)[:-1]) == msg
    with pytest.raises(ProtocolError):
        decode_message(b"{not json")
    with pytest.raises(ProtocolError):
        decode_message(b'["no", "type"]')


def test_message_stream_reassembles_split_frames():
    a, b = socket.socketpair()
    try:
        sa, sb = MessageStream(a), MessageStream(b)
        payload = encode_message({"type": "token", "rid": 1, "token": 5}) \
            + encode_message({"type": "token", "rid": 1, "token": 6})
        a.sendall(payload[:10])             # mid-frame split
        got = sb.poll(0.2)                  # nothing complete yet
        a.sendall(payload[10:])
        for _ in range(10):
            got += sb.poll(0.2)
            if len(got) == 2:
                break
        assert [m["token"] for m in got] == [5, 6]
        sa.send({"type": "ping", "seq": 1})
        assert sb.poll(0.2)[0]["type"] == "ping"
    finally:
        a.close()
        b.close()


def test_message_stream_eof_after_buffered_messages():
    a, b = socket.socketpair()
    sb = MessageStream(b)
    a.sendall(encode_message({"type": "drained"}))
    a.close()
    try:
        got = []
        for _ in range(10):
            try:
                got += sb.poll(0.2)
            except ConnectionClosed:
                break
        assert got and got[0]["type"] == "drained"   # message not lost
        with pytest.raises(ConnectionClosed):
            sb.poll(0.0)
    finally:
        b.close()


def test_message_stream_send_timeout_escalates():
    """A peer that never drains its socket must not block send forever —
    the router calls send under its lock, so an unbounded sendall there
    would wedge the poll thread too.  The timeout escalates to
    ConnectionClosed (-> mark dead at the call sites)."""
    a, b = socket.socketpair()
    try:
        a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 8192)
        stream = MessageStream(a, send_timeout=0.2)
        big = {"type": "submit", "rid": 0, "prompt": [7] * 20000}
        with pytest.raises(ConnectionClosed):
            for _ in range(64):            # peer never reads: buffers fill
                stream.send(big)
    finally:
        a.close()
        b.close()


def test_sampling_from_wire_rejects_bare_string_seqs():
    from repro_torch.serving.cluster.protocol import sampling_from_wire
    # a bare string would silently become per-character entries
    with pytest.raises(ValueError):
        sampling_from_wire({"stop": "END"})
    with pytest.raises(ValueError):
        sampling_from_wire({"stop_token_ids": "12"})
    assert sampling_from_wire({"stop": ["END"]}).stop == ("END",)


def test_sampling_from_wire_wrong_types_raise_catchable():
    """Wrong-typed wire JSON raises ValueError or TypeError — both of
    which the worker's submit handler catches (a null temperature once
    crashed the replica process)."""
    from repro_torch.serving.cluster.protocol import sampling_from_wire
    for bad in ({"temperature": None}, {"top_k": "x"}, {"seed": "s"},
                {"top_p": [1]}):
        with pytest.raises((TypeError, ValueError)):
            sampling_from_wire(bad)


def test_inproc_transport_close_semantics():
    a, b = InProcTransport.pair()
    a.send({"type": "ping", "seq": 0})
    assert b.poll()[0]["type"] == "ping"
    a.close()
    with pytest.raises(ConnectionClosed):
        b.poll()
    with pytest.raises(ConnectionClosed):
        b.send({"type": "pong", "seq": 0})


# ---------------------------------------------------------------------------
# router unit tests: fake scripted transports, injected clock
# ---------------------------------------------------------------------------

class FakeTransport:
    """Scripted worker-side view: the test inspects ``sent`` (messages
    the router pushed) and enqueues replies via ``reply``."""

    def __init__(self):
        self.sent: list[dict] = []
        self._inbox: list[dict] = []
        self.closed = False

    def send(self, msg: dict) -> None:
        if self.closed:
            raise ConnectionClosed("closed")
        self.sent.append(decode_message(encode_message(msg)[:-1]))

    def reply(self, msg: dict) -> None:
        self._inbox.append(msg)

    def poll(self, timeout: float = 0.0) -> list[dict]:
        if self.closed and not self._inbox:
            raise ConnectionClosed("closed")
        out, self._inbox = self._inbox, []
        return out

    def close(self) -> None:
        self.closed = True


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def make_router(n=2, **kw):
    clock = kw.pop("clock", FakeClock())
    transports = [FakeTransport() for _ in range(n)]
    handles = [ReplicaHandle(replica=i, transport=t, max_len=64)
               for i, t in enumerate(transports)]
    kw.setdefault("block_size", 4)
    kw.setdefault("heartbeat_interval", 1.0)
    kw.setdefault("heartbeat_timeout", 5.0)
    router = Router(handles, clock=clock, **kw)
    return router, transports, clock


class Sink:
    def __init__(self):
        self.tokens: list[int] = []
        self.finish = None
        self.error = None

    def cb(self):
        return dict(on_token=lambda rid, tok, lp: self.tokens.append(tok),
                    on_finish=lambda m: setattr(self, "finish", m),
                    on_error=lambda e: setattr(self, "error", e))


def test_router_deterministic_least_loaded_placement():
    router, tr, clock = make_router(2)
    # empty cluster, no affinity: ties break on replica id -> replica 0
    r0 = router.submit([91, 92, 93], 8)
    assert tr[0].sent[-1]["rid"] == r0
    # replica 0 now loaded -> replica 1 (estimates, not stats, decide)
    r1 = router.submit([81, 82, 83], 8)
    assert tr[1].sent[-1]["rid"] == r1
    assert router.aggregate_stats()["affinity"]["routed_fallback"] == 2


def test_router_longest_prefix_same_replica():
    router, tr, clock = make_router(2)
    shared = list(range(100, 112))                       # 3 full blocks of 4
    router.submit(shared + [1], 8)                       # -> replica 0
    first = 0 if tr[0].sent else 1
    # a heavier-loaded replica still wins on prefix affinity
    for suffix in ([2], [3], [4]):
        router.submit(shared + suffix, 8)
    sent_to_first = [m for m in tr[first].sent if m["type"] == "submit"]
    assert len(sent_to_first) == 4                       # all co-located
    assert router.aggregate_stats()["affinity"]["routed_affinity"] == 3


def test_router_token_and_finish_flow():
    router, tr, clock = make_router(1)
    sink = Sink()
    rid = router.submit([1, 2, 3], 4, **sink.cb())
    for t in (10, 11):
        tr[0].reply({"type": "token", "rid": rid, "token": t})
    tr[0].reply({"type": "finish", "rid": rid, "token_ids": [10, 11],
                 "finish_reason": "length", "prompt_len": 3,
                 "ttft_s": 0.1, "tpot_s": 0.01})
    router.poll(0.0)
    assert sink.tokens == [10, 11]
    assert sink.finish["finish_reason"] == "length"
    assert router.pending_count == 0
    assert router.aggregate_stats()["router"]["finished"] == 1


def test_router_submit_rejection_surfaces_typed_error():
    router, tr, clock = make_router(1)
    sink = Sink()
    rid = router.submit([1], 4, **sink.cb())
    tr[0].reply({"type": "error", "rid": rid, "error": "rejected",
                 "message": "prompt too long"})
    router.poll(0.0)
    assert isinstance(sink.error, SubmitRejectedError)
    assert router.pending_count == 0


def test_router_heartbeat_timeout_marks_dead_and_fails_inflight():
    router, tr, clock = make_router(2, heartbeat_timeout=5.0)
    sink = Sink()
    rid = router.submit([1, 2, 3], 4, **sink.cb())
    owner = 0 if any(m.get("rid") == rid for m in tr[0].sent) else 1
    survivor = 1 - owner
    # the survivor answers heartbeats; the owner goes silent
    clock.advance(4.0)
    router.poll(0.0)                       # pings both (interval elapsed)
    tr[survivor].reply({"type": "pong", "seq": 1, "stats": {}})
    router.poll(0.0)                       # survivor's last_seen -> 4.0
    clock.advance(2.0)                     # owner silent for 6s > 5s timeout
    router.poll(0.0)
    assert isinstance(sink.error, ReplicaDeadError)
    assert sink.error.replica == owner
    assert router.replica_states()[owner]["state"] == "dead"
    assert router.replica_states()[survivor]["state"] == "live"
    # dead is absorbing and the survivor keeps serving
    rid2 = router.submit([4, 5, 6], 4)
    assert any(m.get("rid") == rid2 for m in tr[survivor].sent)
    assert router.replica_states()[owner]["state"] == "dead"


def test_router_dead_replica_rebalances_affinity():
    router, tr, clock = make_router(2, heartbeat_timeout=5.0)
    shared = list(range(16))
    router.submit(shared, 4)
    owner = 0 if any(m["type"] == "submit" for m in tr[0].sent) else 1
    tr[owner].closed = True                # EOF instead of timeout
    router.poll(0.0)
    assert router.replica_states()[owner]["state"] == "dead"
    # the shared prefix must re-route to the survivor, not the ghost
    router.submit(shared + [1], 4)
    survivor = 1 - owner
    submits = [m for m in tr[survivor].sent if m["type"] == "submit"]
    assert len(submits) == 1


def test_router_no_live_replicas_raises():
    router, tr, clock = make_router(1)
    tr[0].closed = True
    router.poll(0.0)
    with pytest.raises(ClusterError):
        router.submit([1, 2], 4)


def test_router_heartbeat_pings_and_last_seen_monotone():
    router, tr, clock = make_router(1, heartbeat_interval=1.0)
    seen0 = router.replica_states()[0]["last_seen"]
    clock.advance(1.5)
    router.poll(0.0)
    assert any(m["type"] == "ping" for m in tr[0].sent)
    tr[0].reply({"type": "pong", "seq": 1,
                 "stats": {"outstanding_tokens": 0, "prom": "x 1\n"}})
    router.poll(0.0)
    seen1 = router.replica_states()[0]["last_seen"]
    assert seen1 >= seen0                  # monotone (invariant section 10)
    assert router.replica_states()[0]["stats"]["outstanding_tokens"] == 0


def test_router_cancel_forwards_to_owner():
    router, tr, clock = make_router(1)
    rid = router.submit([1, 2], 4)
    assert router.cancel(rid, reason="stop")
    assert tr[0].sent[-1] == {"type": "cancel", "rid": rid,
                              "reason": "stop"}
    assert not router.cancel(rid + 999)


def test_router_poll_contains_protocol_error_marks_dead():
    """A malformed worker message must never propagate out of poll()
    (it would kill the only poll thread while the HTTP server keeps
    accepting): the offender dies, survivors keep serving."""
    router, tr, clock = make_router(2)
    sink = Sink()
    rid = router.submit([1, 2, 3], 4, **sink.cb())     # -> replica 0
    assert any(m.get("rid") == rid for m in tr[0].sent)
    tr[0].reply({"type": "bogus-type"})
    router.poll(0.0)                                   # must not raise
    assert router.replica_states()[0]["state"] == "dead"
    assert isinstance(sink.error, ReplicaDeadError)
    rid2 = router.submit([4, 5, 6], 4)                 # survivor serves on
    assert any(m.get("rid") == rid2 for m in tr[1].sent)


def test_router_poll_loop_does_not_starve_handler_threads():
    """The router thread loops on ``poll(timeout)``; a handler thread's
    call between two polls must get the lock at once, not after the loop
    happens to let go of it (the wait holds no lock)."""
    a, b = socket.socketpair()
    try:
        router = Router([ReplicaHandle(replica=0, transport=MessageStream(a),
                                       max_len=64)],
                        block_size=4, heartbeat_timeout=1e9)
        stop = threading.Event()

        def loop():
            while not stop.is_set():
                router.poll(0.05)
        t = threading.Thread(target=loop, daemon=True)
        t.start()
        waits = []
        for _ in range(20):
            t0 = time.perf_counter()
            router.replica_states()
            waits.append(time.perf_counter() - t0)
            time.sleep(0.01)
        stop.set()
        t.join(timeout=5)
        assert not t.is_alive()
        assert max(waits) < 0.2, waits
    finally:
        a.close()
        b.close()


def test_generate_body_rejects_wrong_typed_sampling():
    """Type errors become a 400 at the HTTP boundary — the frontend must
    never forward JSON a worker would choke on."""
    from repro_torch.serving.cluster.frontend import _parse_generate_body
    bad = [{"temperature": None}, {"temperature": "hot"}, {"top_k": 1.5},
           {"top_p": "x"}, {"seed": "s"}, {"logprobs": 1},
           {"stop_token_ids": "12"}, {"stop_token_ids": [1, "2"]}]
    for fields in bad:
        with pytest.raises(ValueError):
            _parse_generate_body({"prompt": [1, 2], **fields})
        with pytest.raises(ValueError):                # nested form too
            _parse_generate_body({"prompt": [1, 2], "sampling": fields})


def test_generate_body_rejects_bare_string_stop():
    """'stop': 'END' must be a 400, not per-character stops 'E','N','D'
    silently truncating at the first matching letter."""
    from repro_torch.serving.cluster.frontend import _parse_generate_body
    for fields in ({"stop": "END"}, {"stop": [""]}, {"stop": [1]},
                   {"stop": {"s": 1}}):
        with pytest.raises(ValueError):
            _parse_generate_body({"prompt": [1, 2], **fields})
    *_, stops = _parse_generate_body({"prompt": [1, 2], "stop": ["END"]})
    assert stops == ("END",)


def test_generate_body_sampling_nested_or_top_level():
    from repro_torch.serving.cluster.frontend import _parse_generate_body
    # top-level form (what the e2e tests use)
    _, _, _, sampling, _, stops = _parse_generate_body(
        {"prompt": [1, 2], "temperature": 0.5, "stop": ["t3 "]})
    assert sampling == {"temperature": 0.5} and stops == ("t3 ",)
    # nested form; nested wins
    _, _, _, sampling, _, stops = _parse_generate_body(
        {"prompt": [1, 2], "temperature": 0.9,
         "sampling": {"temperature": 0.5, "seed": 7, "stop": ["t3 "]}})
    assert sampling == {"temperature": 0.5, "seed": 7}
    assert stops == ("t3 ",)
    with pytest.raises(ValueError):
        _parse_generate_body({"prompt": [1, 2], "sampling": "greedy"})


def test_router_prometheus_text_parses():
    router, tr, clock = make_router(2)
    router.submit([1, 2], 4)
    tr[0].reply({"type": "pong", "seq": 1, "stats": {
        "prom": '# TYPE repro_serving_tokens_total counter\n'
                'repro_serving_tokens_total{replica="0"} 7\n'}})
    router.poll(0.0)
    series = parse_prometheus_text(router.prometheus_text())
    assert series["repro_serving_router_requests_routed_total"] == [({}, "1")]
    assert series["repro_serving_router_replicas_live"] == [({}, "2")]
    assert series["repro_serving_tokens_total"] == [({"replica": "0"}, "7")]


# ---------------------------------------------------------------------------
# engine.cancel / outstanding_tokens (real engine, tiny arch)
# ---------------------------------------------------------------------------

def make_engine(**kw):
    from repro_torch.analysis.sanitizer import CacheSanitizer
    from repro_torch.serving.engine import ContinuousBatchingEngine
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("block_size", 8)
    kw.setdefault("prefill_chunk", 16)
    kw.setdefault("sanitizer", CacheSanitizer())
    return ContinuousBatchingEngine(port_arch(TINY), torch_params(TINY),
                                    device="cpu", **kw)


def test_engine_cancel_running_request():
    from repro_torch.serving.engine import Request
    eng = make_engine()
    eng.submit(Request(id=0, prompt=[1, 2, 3, 4], max_new_tokens=16))
    for _ in range(3):
        eng.step()                      # prefill + a couple of tokens
    assert eng.cancel(0, reason="client_disconnect")
    assert eng.completed[-1].request_id == 0
    assert eng.completed[-1].finish_reason == "client_disconnect"
    assert not eng.has_work
    eng.run_until_drained()             # sanitizer: no leaked blocks
    assert eng.outstanding_tokens() == 0


def test_engine_cancel_queued_request():
    from repro_torch.serving.engine import Request
    eng = make_engine(slots=1)
    eng.submit(Request(id=0, prompt=[1, 2, 3, 4], max_new_tokens=4))
    eng.submit(Request(id=1, prompt=[5, 6, 7, 8], max_new_tokens=4))
    eng.step()                          # req 0 admitted, req 1 queued
    assert eng.cancel(1)
    out = [o for o in eng.completed if o.request_id == 1]
    assert out and out[0].finish_reason == "cancelled"
    assert out[0].token_ids == []
    eng.run_until_drained()
    assert {o.request_id for o in eng.completed} == {0, 1}
    assert eng.scheduler.queue_depth == 0


def test_engine_cancel_unknown_rid():
    assert not make_engine().cancel(123)


def test_engine_outstanding_tokens_decreases():
    from repro_torch.serving.engine import Request
    eng = make_engine()
    eng.submit(Request(id=0, prompt=[1, 2, 3, 4], max_new_tokens=8))
    est0 = eng.outstanding_tokens()
    assert est0 == 8
    for _ in range(4):
        eng.step()
    assert eng.outstanding_tokens() < est0
    eng.run_until_drained()
    assert eng.outstanding_tokens() == 0


# ---------------------------------------------------------------------------
# in-process cluster: real engines + Router over InProcTransport
# ---------------------------------------------------------------------------

def drive(router, workers, done):
    """Pump workers and router until ``done()`` or progress stalls."""
    for _ in range(5000):
        for w in workers:
            w.pump(idle_poll=0.0)
        router.poll(0.0)
        if done():
            return
    raise AssertionError("in-process cluster did not converge")


def make_inproc_cluster(n=2, **engine_kw):
    from repro_torch.serving.cluster.worker import EngineWorker
    workers, handles = [], []
    for i in range(n):
        wt, rt = InProcTransport.pair()
        workers.append(EngineWorker(make_engine(**engine_kw), wt, i))
        handles.append(ReplicaHandle(replica=i, transport=rt,
                                     max_len=engine_kw.get("max_len", 64)))
    router = Router(handles, block_size=engine_kw.get("block_size", 8),
                    heartbeat_timeout=1e9)
    return router, workers


def test_inproc_cluster_greedy_parity():
    from repro_torch.serving.engine import Request
    router, workers = make_inproc_cluster()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 250, size=12).tolist() for _ in range(4)]
    results = {}
    for p in prompts:
        router.submit(p, 8, on_finish=lambda m: results.__setitem__(
            m["rid"], m))
    drive(router, workers, lambda: len(results) == 4)
    assert all(w.engine.completed for w in workers)    # both replicas served

    ref = make_engine().generate(
        [Request(id=i, prompt=p, max_new_tokens=8)
         for i, p in enumerate(prompts)])
    for i, o in enumerate(ref):
        assert results[i]["token_ids"] == o.token_ids, \
            f"replica output diverged from single-process on request {i}"
        assert results[i]["finish_reason"] == o.finish_reason


def test_inproc_cluster_serves_the_goldens():
    """tiny/base through the router over two replicas at the goldens'
    engine settings: the tokens are the goldens'."""
    _, reqs, slots, max_len = scenario_requests("tiny/base")
    router, workers = make_inproc_cluster(slots=slots, max_len=max_len,
                                          block_size=4, prefill_chunk=3)
    results, rids = {}, {}
    for rid, prompt, max_new in reqs:
        r = router.submit(prompt.tolist(), max_new,
                          on_finish=lambda m: results.__setitem__(
                              m["rid"], m))
        rids[r] = rid
    drive(router, workers, lambda: len(results) == len(reqs))
    assert {rids[r]: m["token_ids"] for r, m in results.items()} \
        == load_goldens("tiny/base")
    assert all(w.engine.completed for w in workers)


def test_inproc_cluster_shared_prefix_affinity():
    """Shared-prefix traffic must co-locate on one replica and keep the
    prefix cache hot there — the hit signal survives clustering."""
    router, workers = make_inproc_cluster(share_prefix=True)
    shared = list(range(100, 116))                     # two full blocks
    results = {}
    for i in range(4):
        router.submit(shared + [1 + i], 6,
                      on_finish=lambda m: results.__setitem__(m["rid"], m))
        # serialize: let each request land (and commit blocks) before the
        # next routes, as a live cluster would under a Poisson trace
        drive(router, workers, lambda: len(results) == i + 1)
    assert router.aggregate_stats()["affinity"]["routed_affinity"] == 3
    hits = [w.engine.metrics.summary()["prefix_hit_rate"] for w in workers]
    assert max(hits) > 0.5                 # the co-located replica is hot
    busy = [i for i, w in enumerate(workers) if w.engine.completed]
    assert len(busy) == 1                  # all four on one replica


def test_inproc_cluster_stop_token_and_cancel():
    from repro_torch.serving.sampling import GREEDY, SamplingParams
    router, workers = make_inproc_cluster()
    results = {}
    streamed = []
    rid = router.submit([1, 2, 3, 4], 32,
                        sampling=sampling_to_wire(GREEDY),
                        on_token=lambda r, t, lp: streamed.append(t),
                        on_finish=lambda m: results.__setitem__(
                            m["rid"], m))
    # let a couple of tokens stream, then cancel mid-flight
    drive(router, workers, lambda: len(streamed) >= 2)
    router.cancel(rid, reason="stop")
    drive(router, workers, lambda: rid in results)
    assert results[rid]["finish_reason"] == "stop"
    assert 0 < len(results[rid]["token_ids"]) < 32
    # a stop token finishes the request on its replica
    stop = results[rid]["token_ids"][1]
    rid2 = router.submit([1, 2, 3, 4], 32, sampling=sampling_to_wire(
        SamplingParams(stop_token_ids=(stop,))),
        on_finish=lambda m: results.__setitem__(m["rid"], m))
    drive(router, workers, lambda: rid2 in results)
    assert results[rid2]["finish_reason"] == "stop"
    assert results[rid2]["token_ids"][-1] == stop


def test_worker_bad_typed_sampling_rejects_not_crash():
    """Wrong-typed sampling JSON ("temperature": null) reaching a worker
    must reject the one request with a typed error, never crash the
    replica process."""
    router, workers = make_inproc_cluster(n=1)
    sink = Sink()
    router.submit([1, 2, 3], 4, sampling={"temperature": None},
                  **sink.cb())
    drive(router, workers, lambda: sink.error is not None)
    assert isinstance(sink.error, SubmitRejectedError)
    assert router.replica_states()[0]["state"] == "live"
    # the worker survived: a well-typed request still completes on it
    results = {}
    router.submit([1, 2, 3, 4], 4,
                  on_finish=lambda m: results.__setitem__(m["rid"], m))
    drive(router, workers, lambda: results)


def test_frontend_disconnect_cancels_request():
    """A client that drops mid-SSE must cancel its rid upstream — the
    engine must not generate the remaining tokens as wasted work."""
    from repro_torch.serving.cluster.frontend import ClusterHTTPServer
    router, workers = make_inproc_cluster(n=1)
    http = ClusterHTTPServer(router)
    stop_pump = threading.Event()

    def pump():
        while not stop_pump.is_set():
            for w in workers:
                w.pump(idle_poll=0.0)
            router.poll(0.0)
            time.sleep(0.001)

    threading.Thread(target=pump, daemon=True).start()
    threading.Thread(target=http.serve_forever, daemon=True).start()
    try:
        host, port = http.server_address[:2]
        body = json.dumps({"prompt": [1, 2, 3, 4], "max_new_tokens": 48,
                           "stream": True}).encode()
        conn = socket.create_connection((host, port))
        conn.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                     b"Content-Type: application/json\r\n"
                     + f"Content-Length: {len(body)}\r\n\r\n".encode()
                     + body)
        buf = b""
        while b"data: " not in buf:        # first streamed token arrived
            chunk = conn.recv(4096)
            assert chunk, "server closed before streaming any token"
            buf += chunk
        conn.close()                       # client vanishes mid-stream
        deadline = time.time() + 60
        while time.time() < deadline and router.pending_count:
            time.sleep(0.01)
        assert router.pending_count == 0, "rid never left the router"
        assert router.stats["cancelled"] >= 1
        done = workers[0].engine.completed
        assert done and done[-1].finish_reason == "disconnect"
        assert len(done[-1].token_ids) < 48    # generation actually stopped
    finally:
        stop_pump.set()
        http.shutdown()
        http.server_close()


# ---------------------------------------------------------------------------
# what the port refuses: more than one card a worker, multi-host workers
# ---------------------------------------------------------------------------

def test_launcher_refuses_more_than_one_card_a_worker(capsys):
    from repro_torch.launch import serve_cluster
    from repro_torch.serving.cluster import launcher
    with pytest.raises(ValueError, match="--devices-per-worker 2"):
        launcher.worker_env(2)
    with pytest.raises(ValueError, match="--devices-per-worker 4"):
        launcher.WorkerProcesses.spawn(2, connect="127.0.0.1:1",
                                       arch="qwen3-8b", devices_per_worker=4,
                                       device="cpu")
    with pytest.raises(SystemExit) as e:
        serve_cluster.main(["--arch", "qwen3-8b", "--smoke", "--device",
                            "cpu", "--devices-per-worker", "2"])
    assert e.value.code == 2
    assert "--devices-per-worker 2" in capsys.readouterr().err


def test_worker_refuses_distributed():
    from repro_torch.serving.cluster import worker
    with pytest.raises(NotImplementedError, match="--distributed"):
        worker.main(["--connect", "127.0.0.1:1", "--replica-id", "0",
                     "--arch", "qwen3-8b", "--smoke", "--device", "cpu",
                     "--distributed"])


def test_launcher_gives_each_replica_its_card(monkeypatch):
    from repro_torch.serving.cluster import launcher
    assert launcher.assign_cards(2, ["0", "1", "2"]) == ["0", "1"]
    assert launcher.assign_cards(3, ["4", "6"]) == ["4", "6", "4"]
    assert launcher.assign_cards(2, []) == [None, None]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    monkeypatch.setenv("RANK", "1")
    assert launcher.visible_cards() == ["3", "5"]
    env = launcher.worker_env(card="5")
    assert env["CUDA_VISIBLE_DEVICES"] == "5" and "RANK" not in env
    cmd = launcher.worker_command(connect="h:1", replica_id=1,
                                  arch="qwen3-8b", device="cpu")
    assert cmd[2] == "repro_torch.serving.cluster.worker"
    assert cmd[cmd.index("--device") + 1] == "cpu"


# ---------------------------------------------------------------------------
# subprocess end-to-end: a real cluster on the CPU, HTTP/SSE
# ---------------------------------------------------------------------------

CLUSTER = dict(slots=4, max_len=64, block_size=8, prefill_chunk=16)


def _http(url, body=None, timeout=120.0):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read().decode()


def _sse_events(url, body, timeout=120.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    events = []
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        assert resp.headers["Content-Type"].startswith("text/event-stream")
        for raw in resp:
            line = raw.decode().strip()
            if line.startswith("data: "):
                events.append(json.loads(line[len("data: "):]))
    return events


@pytest.fixture(scope="module")
def live_cluster():
    """One real 2-replica cluster on the CPU for the whole module.  Yields
    (proc, url, worker_pids, boot_lines).  The SIGTERM test kills it;
    teardown tolerates that."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_cluster",
         "--arch", "qwen3-8b", "--smoke", "--device", "cpu",
         "--replicas", "2", "--max-len", str(CLUSTER["max_len"]),
         "--block-size", str(CLUSTER["block_size"]),
         "--prefill-chunk", str(CLUSTER["prefill_chunk"])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    url, pids, boot = None, [], []
    deadline = time.time() + 120
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError(f"cluster died at boot (rc={proc.poll()})")
        if line.startswith("worker ") and ": device " in line:
            boot.append(line.strip())
        if line.startswith("serving on "):
            url = line.split()[2]
        if line.startswith("worker pids: "):
            pids = [int(p) for p in line.split(":")[1].split()]
            break
    if url is None or not pids:
        proc.kill()
        raise RuntimeError("cluster never reported ready")
    yield proc, url, pids, boot
    if proc.poll() is None:
        proc.terminate()
        proc.wait(timeout=60)


def test_e2e_healthz_and_metrics(live_cluster):
    proc, url, pids, boot = live_cluster
    status, body = _http(url + "/healthz")
    health = json.loads(body)
    assert status == 200 and health["status"] == "ok"
    assert health["replicas"] == {"0": "live", "1": "live"}
    # the replicas' series arrive with their first heartbeat replies
    deadline = time.time() + 30
    while True:
        status, body = _http(url + "/metrics")
        series = parse_prometheus_text(body)
        launches = series.get("repro_serving_kernel_launches_total", [])
        if len(launches) == 6 or time.time() > deadline:
            break
        time.sleep(0.2)
    assert series["repro_serving_router_replicas_live"] == [({}, "2")]
    # each replica's kernel launch counters (0 on the CPU: plain versions)
    assert sorted((x["replica"], x["kernel"]) for x, _ in launches) == [
        (r, k) for r in "01" for k in ("flash_attention", "rmsnorm",
                                         "ssd_scan")]
    assert {v for _, v in launches} == {"0"}
    # each worker's boot line names its device, card and mesh
    assert sorted(b.split(":")[0] for b in boot) == ["worker 0", "worker 1"]
    assert all("device cpu (the host), mesh data 1 x model 1" in b
               for b in boot)


def test_e2e_generate_parity_with_single_process(live_cluster):
    """Greedy cluster outputs bit-identical to a single-process engine on
    the same seeded weights, over concurrent posts."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ContinuousBatchingEngine, Request

    proc, url, pids, boot = live_cluster
    arch = reduce_for_smoke(get_arch("qwen3-8b"))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, arch.vocab, size=10).tolist()
               for _ in range(4)]
    with ThreadPoolExecutor(4) as ex:
        got = list(ex.map(lambda p: _http(url + "/v1/generate",
                                          {"prompt": p,
                                           "max_new_tokens": 8}), prompts))
    assert all(status == 200 for status, _ in got)
    cluster_out = [json.loads(body) for _, body in got]

    params = T.init_lm(arch, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    eng = ContinuousBatchingEngine(arch, params, device="cpu", **CLUSTER)
    ref = eng.generate([Request(id=i, prompt=p, max_new_tokens=8)
                        for i, p in enumerate(prompts)])
    for out, want in zip(cluster_out, ref):
        assert out["token_ids"] == want.token_ids, \
            "cluster output diverged from single-process engine"
        assert out["finish_reason"] == want.finish_reason


def test_e2e_sse_stream_with_stop_string(live_cluster):
    proc, url, pids, boot = live_cluster
    # learn this prompt's greedy continuation, then stop on token #3's text
    status, body = _http(url + "/v1/generate",
                         {"prompt": [5, 6, 7, 8], "max_new_tokens": 6})
    toks = json.loads(body)["token_ids"]
    assert len(toks) == 6
    stop = f"t{toks[2]} "
    events = _sse_events(url + "/v1/generate",
                         {"prompt": [5, 6, 7, 8], "max_new_tokens": 6,
                          "stream": True, "stop": [stop]})
    done = events[-1]
    assert done["done"] and done["finish_reason"] == "stop"
    assert done["matched_stop"] == stop
    assert done["token_ids"] == toks[:2]       # trimmed at the match
    streamed = "".join(e.get("text", "") for e in events[:-1])
    assert stop not in streamed                # never streamed the match...
    for n in range(1, len(stop)):
        assert not streamed.endswith(stop[:n])  # ...nor a partial suffix
    assert streamed == done["text"]


def test_e2e_sigterm_clean_teardown(live_cluster):
    """MUST run last in this module: kills the shared cluster.  SIGTERM
    to the router => exit 0, no orphan workers."""
    proc, url, pids, boot = live_cluster
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, f"router exited {proc.returncode} on SIGTERM"
    assert "workers exited with [0, 0]" in out
    deadline = time.time() + 30
    alive = list(pids)
    while alive and time.time() < deadline:
        alive = [p for p in alive if _pid_alive(p)]
        time.sleep(0.2)
    assert not alive, f"orphan worker processes: {alive}"


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True
