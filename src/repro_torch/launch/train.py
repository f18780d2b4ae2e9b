"""Training launcher CLI (twin of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
        --smoke --steps 50 [--checkpoint-dir ckpts] [--opt8bit] \\
        [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen3-8b --smoke --device cpu       # 4 ranks on gloo

--smoke uses the reduced same-family config (CPU-runnable); without it the
full config is planned and trained on the host mesh: every rank of the
process group (one, or torchrun's), factored as (ranks, 1).  The flags,
the output lines and the exit codes are the reference's, plus
``--device`` (CUDA unless ``cpu`` is asked for; on CUDA the plan uses the
H100 profile).  Under torchrun only rank 0 prints.  With
``--checkpoint-dir`` a run resumes from the latest checkpoint there.
"""
from __future__ import annotations

import argparse

import torch.distributed as dist

from repro_torch.configs import ARCHS, get_arch, reduce_for_smoke
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.asa import AdaptiveScheduler
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_host_mesh, shutdown
from repro_torch.runtime.trainer import TrainConfig, Trainer, hardware_for


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--opt8bit", action="store_true")
    ap.add_argument("--replan-every", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    if args.smoke:
        arch = reduce_for_smoke(arch)
    shape = ShapeSpec("cli", args.seq_len, args.batch, "train")
    mesh = make_host_mesh(device=args.device)
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    try:
        sched = AdaptiveScheduler(
            hardware_for(mesh), faithful=False,
            opt_preset="adamw8bit" if args.opt8bit else "adamw32")
        trainer = Trainer(
            arch, shape, mesh,
            TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps,
                        replan_every=args.replan_every,
                        quantized_opt=args.opt8bit,
                        checkpoint_every=max(args.steps // 2, 1)),
            scheduler=sched, checkpoint_dir=args.checkpoint_dir)
        say(trainer.plan.summary())

        params, opt_state = trainer.init_state()
        if args.checkpoint_dir:
            params, opt_state = trainer.maybe_restore(params, opt_state)
            if trainer.step:
                say(f"resumed from step {trainer.step} "
                    f"(data offset {trainer.data_offset})")
        data = SyntheticLM(arch.vocab, args.seq_len, args.batch,
                           start_step=trainer.data_offset)
        params, opt_state, hist = trainer.train(
            params, opt_state, data, steps=args.steps,
            on_metrics=lambda s, m: say(
                f"step {s:5d}  loss {m['loss']:.4f}  "
                f"{m['step_time_s']*1e3:.0f} ms"))
        say(f"done: loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
        if trainer.ckpt:
            trainer.ckpt.wait()
    finally:
        shutdown()


if __name__ == "__main__":
    main()
