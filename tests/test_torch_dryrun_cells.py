"""chip_smoke.py's dry-run cells on the CPU: each runs as ``python -m
repro_torch.launch.dryrun --arch A --shape S --no-save --device cpu`` in
a subprocess, on a fake group of 256 ranks, with status ``ok`` and a
counted cost (FLOPs, bytes, kernel calls) equal to the record
(``DRYRUN_CPU_COST``) that chip_smoke.py's phase 45 holds the card's
count to, exactly.  The qwen3-8b x decode_32k cell is checked in
``test_torch_dryrun.py``; the train cell also holds its memory: every
parameter and moment updated in place (``alias`` = the arguments less
this rank's tokens and labels).
"""
from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("arch,shape", [("qwen3-8b", "train_4k"),
                                        ("mamba2-780m", "long_500k")])
def test_smoke_cell_counts_as_recorded(arch, shape):
    cs = _smoke()
    assert (arch, shape) in cs.DRYRUN_CELLS
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--no-save", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=400)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(next(l for l in out.stdout.splitlines()
                          if l.startswith("record "))[7:])
    assert rec["status"] == "ok"
    assert rec["cost"] == cs.DRYRUN_CPU_COST[(arch, shape)]
    if shape == "train_4k":
        # 256 rows of 4096 int32 tokens and labels over 256 ranks
        batch = 2 * 256 * 4096 * 4 // 256
        mem = rec["memory"]
        assert mem["alias_size_in_bytes"] == \
            mem["argument_size_in_bytes"] - batch
        assert rec["cost"]["kernel_calls"]["rmsnorm_bwd"] == 4 * 36 + 1
