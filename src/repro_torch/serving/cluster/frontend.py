"""HTTP/SSE frontend for the serving cluster (twin of
``repro/serving/cluster/frontend.py``) — stdlib ``http.server`` only.

Endpoints:

  POST /v1/generate   JSON body: ``prompt`` (list of token ids, required),
                      ``max_new_tokens``, ``priority``, the SamplingParams
                      fields (``temperature`` / ``top_k`` / ``top_p`` /
                      ``seed`` / ``stop_token_ids`` / ``stop`` /
                      ``logprobs`` — top-level or nested under a
                      ``sampling`` object) and ``stream``.
                      stream=false -> one JSON response;
                      stream=true  -> ``text/event-stream``: one
                      ``data: {"text": ...}`` event per released text
                      chunk, then a final ``data: {"done": true, ...}``
                      event with the trimmed token_ids / text /
                      finish_reason.
  GET  /metrics       aggregated Prometheus text: router-level series +
                      each replica's self-reported exposition (labeled
                      ``{replica="i"}``), via Router.prometheus_text.
  GET  /healthz       200 + per-replica states while any replica is
                      live; 503 once none are.

Stop strings are enforced HERE, at the detokenized boundary — the
engine/worker stay token-level.  Every generated token is decoded
(serving/detok) and fed through a ``StopStringMatcher`` whose buffered
emission guarantees a partial stop-string suffix is never streamed; on a
match the frontend cancels the request through the router (reason
"stop"), trims the matched text, and truncates ``token_ids`` to the
tokens that contributed text before the match.  Cancellation races are
benign: if the request finished on its own before the cancel landed, the
frontend still reports finish_reason "stop" and the trimmed output —
what the client observes is determined by the match, not the race.

Handler threads never poll the router — they park on a per-request
``queue.Queue`` fed by router callbacks (cheap, called under the router
lock) while the owning process's router thread does the transport work.

No torch in this module, like the rest of the router process.
"""
from __future__ import annotations

import json
import queue
import socketserver
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Optional

from repro_torch.serving.cluster.protocol import ClusterError
from repro_torch.serving.cluster.router import Router
from repro_torch.serving.detok import (Detokenizer, StopStringMatcher,
                                 default_detokenizer)

#: handler-side wait for the next router event before giving up on a
#: request (covers a cold worker's first steps)
EVENT_TIMEOUT_S = 300.0

SAMPLING_FIELDS = ("temperature", "top_k", "top_p", "seed",
                   "stop_token_ids", "stop", "logprobs")


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


#: per-field (predicate, description) — enforced at the HTTP boundary so
#: wrong-typed JSON is a 400 here, never a forwarded submit that a
#: worker has to reject (or, pre-fix, crash on)
_SAMPLING_CHECKS = {
    "temperature": (_is_num, "a number"),
    "top_p": (_is_num, "a number"),
    "top_k": (_is_int, "an int"),
    "seed": (lambda v: v is None or _is_int(v), "an int or null"),
    "logprobs": (lambda v: isinstance(v, bool), "a bool"),
    "stop_token_ids": (lambda v: isinstance(v, list)
                       and all(_is_int(t) for t in v), "a list of ints"),
    "stop": (lambda v: isinstance(v, list)
             and all(isinstance(s, str) and s for s in v),
             "a list of non-empty strings (a bare string would match "
             "per-character)"),
}


class _RequestSink:
    """Bridges router callbacks (router-thread side) to the handler
    thread: every event is one (kind, payload) tuple on a Queue."""

    def __init__(self):
        self.q: queue.Queue = queue.Queue()

    def on_token(self, rid: int, token: int, logprob) -> None:
        self.q.put(("token", token))

    def on_finish(self, msg: dict) -> None:
        self.q.put(("finish", msg))

    def on_error(self, exc: Exception) -> None:
        self.q.put(("error", exc))


def _parse_generate_body(body: dict) -> tuple[list[int], int, int, dict,
                                              bool, tuple]:
    prompt = body.get("prompt")
    if not isinstance(prompt, list) or not prompt \
            or not all(isinstance(t, int) for t in prompt):
        raise ValueError("'prompt' must be a non-empty list of token ids")
    max_new = body.get("max_new_tokens", 16)
    if not isinstance(max_new, int) or max_new < 1:
        raise ValueError("'max_new_tokens' must be an int >= 1")
    priority = body.get("priority", 0)
    if not isinstance(priority, int):
        raise ValueError("'priority' must be an int")
    # sampling fields are accepted at the body top level or nested under
    # a "sampling" object (the nested form wins on conflict)
    nested = body.get("sampling", {})
    if not isinstance(nested, dict):
        raise ValueError("'sampling' must be a JSON object")
    sampling = {k: body[k] for k in SAMPLING_FIELDS if k in body}
    sampling.update({k: nested[k] for k in SAMPLING_FIELDS if k in nested})
    for k, (ok, want) in _SAMPLING_CHECKS.items():
        if k in sampling and not ok(sampling[k]):
            raise ValueError(f"{k!r} must be {want} (got {sampling[k]!r})")
    stops = tuple(sampling.pop("stop", ()))
    stream = bool(body.get("stream", False))
    return prompt, max_new, priority, sampling, stream, stops


class _Handler(BaseHTTPRequestHandler):
    # set by make_handler(); class-level so http.server can instantiate
    router: Router = None
    detok: Detokenizer = None

    def log_message(self, fmt, *args):      # silence per-request stderr spam
        pass

    # -- plumbing ------------------------------------------------------
    def _json(self, code: int, obj: dict) -> None:
        payload = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _sse_start(self) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()

    def _sse_event(self, obj: dict) -> None:
        self.wfile.write(b"data: " + json.dumps(obj).encode("utf-8")
                         + b"\n\n")
        self.wfile.flush()

    # -- GET -----------------------------------------------------------
    def do_GET(self):
        if self.path == "/healthz":
            states = self.router.replica_states()
            live = sum(1 for s in states.values() if s["state"] == "live")
            self._json(200 if live else 503,
                       {"status": "ok" if live else "no live replicas",
                        "replicas": {str(k): v["state"]
                                     for k, v in states.items()},
                        "pending": self.router.pending_count})
        elif self.path == "/metrics":
            text = self.router.prometheus_text().encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(text)))
            self.end_headers()
            self.wfile.write(text)
        else:
            self._json(404, {"error": f"no such path {self.path!r}"})

    # -- POST /v1/generate ---------------------------------------------
    def do_POST(self):
        if self.path != "/v1/generate":
            self._json(404, {"error": f"no such path {self.path!r}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
            prompt, max_new, priority, sampling, stream, stops = \
                _parse_generate_body(body)
            matcher = StopStringMatcher(stops)     # validates stop strings
        except ValueError as e:
            self._json(400, {"error": str(e)})
            return

        sink = _RequestSink()
        try:
            rid = self.router.submit(prompt, max_new, priority=priority,
                                     sampling=sampling,
                                     on_token=sink.on_token,
                                     on_finish=sink.on_finish,
                                     on_error=sink.on_error)
        except (ClusterError, ValueError) as e:
            self._json(503 if isinstance(e, ClusterError) else 400,
                       {"error": str(e)})
            return
        self._consume(rid, sink, matcher, stream)

    def _consume(self, rid: int, sink: _RequestSink,
                 matcher: StopStringMatcher, stream: bool) -> None:
        """Drain the request's event queue to completion, running the
        detok/stop-string pipeline; emits SSE along the way when
        ``stream``.  A client disconnect mid-response (BrokenPipe /
        ConnectionReset on a write) cancels the request upstream so the
        engine does not generate the rest as wasted work — the
        disconnect-cancellation behavior documented on engine.cancel."""
        try:
            self._consume_events(rid, sink, matcher, stream)
        except OSError:
            self.router.cancel(rid, reason="disconnect")

    def _consume_events(self, rid: int, sink: _RequestSink,
                        matcher: StopStringMatcher, stream: bool) -> None:
        if stream:
            self._sse_start()
        tokens: list[int] = []
        tok_text_len: list[int] = []   # decoded length per token (for trim)
        emitted: list[str] = []        # text released by the matcher
        finish: Optional[dict] = None
        error: Optional[Exception] = None
        cancelled = False
        while True:
            try:
                kind, payload = sink.q.get(timeout=EVENT_TIMEOUT_S)
            except queue.Empty:
                error = ClusterError(f"no event for {EVENT_TIMEOUT_S:.0f}s "
                                     f"(rid {rid})")
                break
            if kind == "token":
                tokens.append(payload)
                text = self.detok.decode(payload)
                tok_text_len.append(len(text))
                safe = matcher.feed(text)
                if safe:
                    emitted.append(safe)
                    if stream:
                        self._sse_event({"text": safe})
                if matcher.matched is not None and not cancelled:
                    cancelled = True
                    self.router.cancel(rid, reason="stop")
            elif kind == "finish":
                finish = payload
                break
            else:
                error = payload
                break
        if error is not None:
            obj = {"error": str(error), "rid": rid}
            if stream:
                self._sse_event({"done": True, **obj})
            else:
                self._json(502, obj)
            return
        if matcher.matched is None:
            tail = matcher.flush()             # held-back text, no match
            if tail:
                emitted.append(tail)
                if stream:
                    self._sse_event({"text": tail})
        text = "".join(emitted)
        if matcher.matched is not None:
            # keep exactly the tokens that contributed text before the
            # match (the boundary token is kept: its text is split)
            keep, acc = 0, 0
            for ln in tok_text_len:
                if acc >= len(text):
                    break
                keep, acc = keep + 1, acc + ln
            token_ids = tokens[:keep]
            reason = "stop"
        else:
            token_ids = list(finish.get("token_ids", tokens))
            reason = finish.get("finish_reason", "length")
        done = {"done": True, "rid": rid, "token_ids": token_ids,
                "finish_reason": reason, "text": text,
                "matched_stop": matcher.matched,
                "prompt_len": finish.get("prompt_len"),
                "ttft_s": finish.get("ttft_s"),
                "tpot_s": finish.get("tpot_s"),
                "logprobs": finish.get("logprobs")}
        if stream:
            self._sse_event(done)
        else:
            done.pop("done")
            self._json(200, done)


class ClusterHTTPServer(socketserver.ThreadingMixIn, HTTPServer):
    """One HTTP server bound to a Router.  ``port=0`` binds an ephemeral
    port (read ``.server_address``).  Runs on the caller's thread via
    ``serve_forever()``; launch/serve_cluster.py puts it on a daemon
    thread next to the router poll loop."""

    daemon_threads = True

    def handle_error(self, request, client_address):
        # a client that disconnects mid-stream is routine (the handler
        # already cancelled its rid); only real bugs deserve a traceback
        import sys
        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError)):
            return
        super().handle_error(request, client_address)

    def __init__(self, router: Router, *, host: str = "127.0.0.1",
                 port: int = 0, detokenizer: Optional[Detokenizer] = None):
        handler = type("BoundHandler", (_Handler,), {
            "router": router,
            "detok": detokenizer or default_detokenizer()})
        super().__init__((host, port), handler)
        self.router = router

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"
