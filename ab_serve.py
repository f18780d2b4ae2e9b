#!/usr/bin/env python3
"""Serve qwen3-8b and mamba2-780m on one H100 through ``chip_smoke.py``'s
``serve_phase`` (its requests, settings and checks) in the tree this script
sits in, and print one line a model: ``AB <label> <cell> <tok/s> <TPOT
p50 s> <TTFT p50 s>``.

Serves are host-bound and vary between machines, so compare two trees
only within one call, in turns: unpack the other tree (``git archive
<commit>``) into a directory that ``.gitignore`` lists, copy this script
to its root, and run from each root in the order A, B, B, A:

    python3 ab_serve.py parent      # in the other tree
    python3 ab_serve.py change      # in this one
"""
import gc
import sys

import numpy as np
import torch

sys.path.insert(0, "src")
import chip_smoke  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

build.build()
report = {}
for name in ("qwen3-8b", "mamba2-780m"):
    out = chip_smoke.serve_phase(torch, np, report, name, get_arch(name))
    del out
    gc.collect()
    torch.cuda.empty_cache()
for cell, r in report.items():
    print("AB", sys.argv[1], cell.replace(" ", "/"), r["tok_per_s"],
          r["tpot_p50_s"], r["ttft_p50_s"], flush=True)
