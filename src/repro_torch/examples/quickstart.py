"""Quickstart: ASA-planned training of a small LM on the host mesh (twin
of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
        [--smoke]

``--smoke`` trains 2 steps of 4 sequences of 32 tokens instead of 100
steps of 16 x 128 (a quick check that it runs).
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import ArchConfig, Segment, ShapeSpec
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_host_mesh, shutdown
from repro_torch.runtime.trainer import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="2 steps of 4 x 32 tokens")
    args = ap.parse_args(argv)
    arch = ArchConfig(
        name="quickstart-20m", family="dense", n_layers=4, d_model=256,
        n_heads=8, n_kv_heads=4, d_ff=1024, vocab=4096,
        pattern=(Segment(("attn",), 4),), dtype="float32",
        param_dtype="float32")
    shape = (ShapeSpec("quickstart", seq_len=32, global_batch=4, kind="train")
             if args.smoke else
             ShapeSpec("quickstart", seq_len=128, global_batch=16, kind="train"))
    mesh = make_host_mesh(device=args.device)
    try:
        trainer = Trainer(arch, shape, mesh,
                          TrainConfig(lr=3e-3, warmup_steps=20,
                                      total_steps=200))
        print(trainer.plan.summary())

        params, opt_state = trainer.init_state()
        data = SyntheticLM(arch.vocab, shape.seq_len, shape.global_batch)
        params, opt_state, hist = trainer.train(
            params, opt_state, data, steps=2 if args.smoke else 100,
            log_every=1 if args.smoke else 10,
            on_metrics=lambda s, m: print(
                f"step {s:4d}  loss {m['loss']:.3f}  "
                f"grad_norm {m['grad_norm']:.2f}  "
                f"{m['step_time_s']*1e3:.0f}ms"))
        print(f"final loss: {hist[-1]['loss']:.3f} "
              f"(from {hist[0]['loss']:.3f})")
    finally:
        shutdown()


if __name__ == "__main__":
    main()
