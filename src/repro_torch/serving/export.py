"""Metric exporters: atomic file writes, Prometheus text exposition, and
a periodic JSONL snapshot writer (copy of ``repro/serving/export.py``).

Three consumers are served:

  * humans / dashboards — ``prometheus_text(metrics)`` renders every
    counter, gauge and log-bucketed histogram registered in the metrics'
    ``Telemetry`` in the Prometheus text exposition format (histograms as
    cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``);
    ``parse_prometheus_text`` is the minimal round-trip parser the tests
    and the CI smoke job use to prove the output is well-formed;
  * offline analysis — ``SnapshotWriter`` appends one compact JSON line
    per ``every_s`` seconds of engine time (windowed signal vector +
    lifetime counters), rewriting the whole file through an atomic
    rename, so a crash mid-write can never leave a truncated line;
  * everything that writes JSON next to benchmark results —
    ``atomic_write_text`` is the shared temp-file + ``os.replace``
    primitive (``ServingMetrics.write`` and the tracer use it too: a
    crash mid-write leaves the previous file intact, never half a JSON).

All timestamps are engine-clock floats passed in by the caller; nothing
here reads a clock, so snapshot cadence is test-drivable.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Optional


def atomic_write_text(path, text: str) -> None:
    """Write ``text`` to ``path`` atomically: temp file in the same
    directory, flush + fsync, then ``os.replace``.  Readers see either
    the old file or the complete new one, never a truncated mix."""
    path = os.fspath(path)
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        # THE sanctioned raw write: this helper is what the atomic-write
        # rule tells everyone else to call (temp file, fsync, os.replace)
        with os.fdopen(fd, "w") as f:  # reprolint: disable=atomic-write
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _labels(labels: Optional[dict]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_prom_name(k)}="{v}"' for k, v in labels.items())
    return "{" + inner + "}"


def _num(x) -> str:
    if x is None:
        return "NaN"                  # Prometheus-legal "no observation"
    if x == float("inf"):
        return "+Inf"
    return repr(float(x))


def prometheus_text(metrics, *, namespace: str = "repro_serving",
                    labels: Optional[dict] = None) -> str:
    """Render a ServingMetrics (or anything with a ``.telemetry`` registry
    and a ``.summary()``) as Prometheus text exposition format."""
    tele = metrics.telemetry
    s = metrics.summary()
    lab = _labels(labels)
    lines: list[str] = []

    def emit(name, kind, value, help_txt, extra_labels=None):
        full = f"{namespace}_{_prom_name(name)}"
        lines.append(f"# HELP {full} {help_txt}")
        lines.append(f"# TYPE {full} {kind}")
        lines.append(f"{full}{_labels({**(labels or {}), **(extra_labels or {})})}"
                     f" {_num(value)}")

    # lifetime counters kept directly on the facade
    emit("requests_completed_total", "counter", s["completed"],
         "finished requests (engine lifetime)")
    emit("tokens_generated_total", "counter", s["total_tokens"],
         "generated tokens over finished requests")
    emit("preemptions_total", "counter", s["preemptions"],
         "recompute-preemptions")
    emit("engine_steps_total", "counter", s["engine_steps"], "engine steps")
    emit("prefill_chunks_total", "counter", s["prefill_chunks"],
         "prefill chunks executed")
    emit("decode_steps_total", "counter", s["decode_steps"],
         "batched decode steps executed")
    emit("requests_in_flight", "gauge", s["in_flight"],
         "submitted-but-unfinished requests")
    emit("prefix_hit_rate", "gauge", s["prefix_hit_rate"],
         "prefix-cache matched/looked-up tokens (lifetime)")
    # registry counters / gauges (scheduler refusals, re-plan triggers,
    # step-time EMA, ...)
    for name, c in sorted(tele.counters.items()):
        emit(f"{name}_total", "counter", c.value, f"telemetry counter {name}")
    for name, g in sorted(tele.gauges.items()):
        emit(name, "gauge", g.value, f"telemetry gauge {name}")
    # log-bucketed histograms -> cumulative le buckets + _sum/_count
    for name, h in sorted(tele.histograms.items()):
        full = f"{namespace}_{_prom_name(name)}"
        lines.append(f"# HELP {full} log-bucketed histogram {name}")
        lines.append(f"# TYPE {full} histogram")
        for le, cum in h.nonzero_buckets():
            l_ = _labels({**(labels or {}), "le": _num(le)})
            lines.append(f"{full}_bucket{l_} {cum}")
        inf = _labels({**(labels or {}), "le": "+Inf"})
        lines.append(f"{full}_bucket{inf} {h.count}")
        lines.append(f"{full}_sum{lab} {_num(h.total)}")
        lines.append(f"{full}_count{lab} {h.count}")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+"
    r"([-+]?(?:[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?|Inf|NaN))$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def parse_prometheus_text(text: str) -> dict:
    """Minimal exposition-format parser for validation: returns
    ``{metric_name: [(labels_dict, value_str)]}``, raising ValueError on
    any line that is neither a comment nor a well-formed sample."""
    out: dict[str, list] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno} is not a valid Prometheus "
                             f"sample: {line!r}")
        name, rawlabels, value = m.groups()
        labels = dict(_LABEL_RE.findall(rawlabels or ""))
        out.setdefault(name, []).append((labels, value))
    if not out:
        raise ValueError("no samples found")
    return out


# ---------------------------------------------------------------------------
# periodic JSONL snapshots
# ---------------------------------------------------------------------------

class SnapshotWriter:
    """Periodic JSONL snapshot stream with atomic whole-file rename.

    ``maybe_write(metrics, now)`` is called once per engine step (cheap:
    one float compare when the cadence hasn't elapsed); every ``every_s``
    seconds of engine-clock time it appends one compact snapshot line —
    the windowed signal vector plus lifetime counters — and atomically
    rewrites the file, so the on-disk JSONL is always complete and
    parseable even if the process dies mid-run.
    """

    def __init__(self, path, every_s: float = 1.0):
        if every_s <= 0:
            raise ValueError(f"every_s must be > 0 (got {every_s})")
        self.path, self.every_s = os.fspath(path), every_s
        self._lines: list[str] = []
        self._last: Optional[float] = None

    @property
    def n_snapshots(self) -> int:
        return len(self._lines)

    def maybe_write(self, metrics, now: float) -> bool:
        if self._last is not None and now - self._last < self.every_s:
            return False
        self.write(metrics, now)
        return True

    def write(self, metrics, now: Optional[float] = None) -> None:
        """Unconditional snapshot (also used as the final flush; ``now``
        defaults to the newest engine-clock stamp the metrics saw)."""
        if now is not None:
            self._last = now
        self._lines.append(json.dumps(metrics.snapshot(now)))
        atomic_write_text(self.path, "\n".join(self._lines) + "\n")
