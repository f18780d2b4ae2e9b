"""Atomic file writes for the serving metrics (host-only copy of the
``atomic_write_text`` helper of ``repro/serving/export.py``; its Prometheus
and JSONL exporters are not ported yet).

``ServingMetrics.write`` goes through ``atomic_write_text``: temp file in
the same directory, fsync, then ``os.replace`` — a crash mid-write leaves
the previous file intact, never a truncated JSON.
"""
from __future__ import annotations

import os
import tempfile


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
