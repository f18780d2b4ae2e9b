"""Detokenization boundary (twin of ``repro/serving/detok.py``): token-id
streams -> text, and incremental stop-*string* matching with buffered
emission.

The engine is token-level end to end — ``SamplingParams.stop_token_ids``
finishes a request the step a stop id is sampled, because the check is a
set lookup on the sampled id.  Stop *strings* are different: a stop string
may span several tokens, start mid-token, or share a prefix with text the
client should receive, so it can only be matched over *decoded text*.
That matching lives at the frontend boundary (serving/cluster/frontend.py
for the HTTP/SSE server), built from the two pieces here:

``Detokenizer``
    Anything with ``decode(token_id) -> str``.  The repo carries no real
    tokenizer vocabulary, so ``default_detokenizer()`` maps every id to a
    deterministic word-like piece (``"t<id> "``) — enough for stop-string
    semantics, tests and the CI smoke to be exact; a deployment drops in
    its tokenizer by implementing ``decode``.

``StopStringMatcher``
    Incremental matcher with buffered emission.  ``feed(text)`` returns
    the longest prefix of the accumulated stream that is *safe to emit*:
    text that can no longer become part of a stop-string match.  The
    invariant (pinned in tests/test_torch_cluster.py): concatenated emissions
    never contain a stop string and never end in a nonempty proper prefix
    of one — so an SSE client never sees a partial stop-string suffix
    that a later token would have completed.  On a match, emission stops
    at the character before the stop string (the matched text is trimmed)
    and ``matched`` records which stop string fired.  ``flush()`` releases
    the held-back tail when the stream ends without a match.
"""
from __future__ import annotations

from typing import Optional, Protocol, Sequence


class Detokenizer(Protocol):
    def decode(self, token_id: int) -> str:
        """Text piece for one token id."""
        ...


class DefaultDetokenizer:
    """Deterministic id -> word-like piece mapping (``"t<id> "``): the
    stand-in for a real tokenizer vocabulary.  A stop string for token 7
    is ``"t7 "``; multi-token stop strings (``"t7 t9 "``) exercise the
    cross-token matching path."""

    def decode(self, token_id: int) -> str:
        return f"t{int(token_id)} "


def default_detokenizer() -> DefaultDetokenizer:
    return DefaultDetokenizer()


class StopStringMatcher:
    """Incremental stop-string matching with buffered emission (see the
    module docstring for the emission invariant)."""

    def __init__(self, stops: Sequence[str]):
        for s in stops:
            if not isinstance(s, str) or not s:
                raise ValueError(f"stop strings must be non-empty strings "
                                 f"(got {s!r})")
        self._stops = tuple(stops)
        self._buf = ""
        #: the stop string that fired, or None while the stream is live
        self.matched: Optional[str] = None

    @property
    def held(self) -> str:
        """Text currently withheld (a prefix of some stop string)."""
        return self._buf

    def _max_hold(self) -> int:
        """Length of the longest buffer suffix that is a nonempty proper
        prefix of any stop string — the text that must be withheld because
        a later token could complete a match."""
        hold = 0
        for s in self._stops:
            top = min(len(s) - 1, len(self._buf))
            for n in range(top, hold, -1):
                if self._buf.endswith(s[:n]):
                    hold = n
                    break
        return hold

    def feed(self, text: str) -> str:
        """Accumulate ``text``; return the text now safe to emit.  After a
        match every subsequent feed returns ""."""
        if self.matched is not None:
            return ""
        self._buf += text
        # earliest match across all stop strings wins (ties: the one
        # starting first; same start: the first in the stops tuple)
        best: Optional[tuple[int, str]] = None
        for s in self._stops:
            i = self._buf.find(s)
            if i != -1 and (best is None or i < best[0]):
                best = (i, s)
        if best is not None:
            i, s = best
            self.matched = s
            out, self._buf = self._buf[:i], ""
            return out
        hold = self._max_hold()
        cut = len(self._buf) - hold
        out, self._buf = self._buf[:cut], self._buf[cut:]
        return out

    def flush(self) -> str:
        """Release the withheld tail — call when the stream ended without
        a stop match (e.g. finish_reason "length")."""
        out, self._buf = self._buf, ""
        return out
