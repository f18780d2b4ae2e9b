"""Paper reproduction entry point (twin of
``examples/paper_repro_asa.py``): the Adaptive Scheduling Algorithm on
the paper's own setting (ResNet-50 / ViT-B/16, 8 GPUs, V100 profile),
then a small ViT trained on synthetic CIFAR-100-like images.

    PYTHONPATH=src python -m repro_torch.examples.paper_repro_asa
        [--device cpu] [--smoke]

Prints the cost model's Table I / Fig 6 counterparts beside the paper's
numbers, then trains the reduced ViT (d_model 128, 4 layers, 4 heads,
10 classes, batch 64) for 150 steps and fails unless its accuracy passes
0.5 at the last step.  ``--smoke`` trains 3 steps and checks nothing of
the accuracy.  Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch import device as _device
from repro_torch import tree
from repro_torch.data import SyntheticImages
from repro_torch.examples import paper_repro as PR
from repro_torch.models import vision as V
from repro_torch.optim import optimizers as O
from repro_torch.runtime import steps as ST

DEMO_VIT = V.ViTConfig(image_size=32, patch=4, d_model=128, n_layers=4,
                       n_heads=4, d_ff=512, n_classes=10)
DEMO_BATCH = 64
DEMO_STEPS = 150
DEMO_LR = 1e-3
DEMO_WEIGHT_DECAY = 0.01
DEMO_CLIP_NORM = 1.0
DEMO_LOG_EVERY = 30


def image_loss(apply_fn: Callable):
    """-> loss_fn(params, images, labels, _) = (mean NLL of log_softmax,
    accuracy), the reference demo's ``loss_fn``, in the form
    ``runtime.steps.loss_and_grads`` takes."""
    def loss_fn(params, images, labels, _frontend=None):
        logits = apply_fn(params, images)
        logp = F.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels[:, None].long()).mean()
        acc = (torch.argmax(logits, -1) == labels).float().mean()
        return nll, acc
    return loss_fn


def make_image_step(apply_fn: Callable):
    """The reference demo's train step for any image model ``apply_fn(params,
    images) -> logits``: loss and grads, ``clip_by_global_norm(grads, 1.0)``,
    ``adamw(1e-3, weight_decay=0.01)``, and the update written into the
    params.  -> (opt_init, step), with ``step(params, state, images, labels)
    -> (params, state, loss, acc)``."""
    opt_init, opt_update = O.adamw(DEMO_LR, weight_decay=DEMO_WEIGHT_DECAY)
    loss_fn = image_loss(apply_fn)

    def step(params, state, images, labels):
        loss, acc, grads = ST.loss_and_grads(loss_fn, params, images, labels)
        for i, g in enumerate(grads):
            grads[i] = g.float()
        grads, _ = O.clip_by_global_norm(grads, DEMO_CLIP_NORM)
        updates, state = opt_update(tree.unflatten(params, grads), state,
                                    params)
        return O.apply_updates(params, updates), state, loss, acc
    return opt_init, step


def cost_model_validation():
    print("=" * 70)
    print("Paper validation (cost model @ V100 profile, 8 GPUs)")
    print("=" * 70)
    for model in ("resnet50", "vit"):
        t1 = PR.table1(model)
        print(f"\n--- {model} ---")
        print(f"{'strategy':<10}{'ours':>9}{'paper':>9}")
        for k in ("DP", "MP", "HP", "adaptive"):
            print(f"{k:<10}{t1['ours_speedup'][k]:>8.2f}x"
                  f"{t1['paper_speedup'][k]:>8.2f}x")
        print(f"adaptive over best static: "
              f"{t1['ours_speedup']['adaptive'] / max(t1['ours_speedup'][k] for k in ('DP', 'MP', 'HP')):.3f} "
              f"(paper claims +15-18% over hybrid)")
    print("\nFig 6 per-component strategies (ResNet-50):",
          PR.fig6_strategy_map("resnet50"))


def small_scale_training(device, steps: int = DEMO_STEPS
                         ) -> list[tuple[float, float]]:
    """Accuracy-parity demo (paper Fig 4): train the paper's ViT (reduced)
    on synthetic CIFAR-100-like data.  -> [(loss, acc)] a step."""
    print("\n" + "=" * 70)
    print("Small-scale ViT training on synthetic CIFAR-100-like data")
    print("=" * 70)
    cfg = DEMO_VIT
    params = V.init_vit(cfg, device=device, seed=0)
    opt_init, step = make_image_step(lambda p, x: V.vit_apply(p, cfg, x))
    state = opt_init(params)
    data = SyntheticImages(n_classes=cfg.n_classes, batch=DEMO_BATCH)
    hist = []
    for i in range(steps):
        b = next(data)
        params, state, loss, acc = step(
            params, state, torch.as_tensor(b["images"], device=device),
            torch.as_tensor(b["labels"], device=device))
        hist.append((float(loss), float(acc)))
        if i % DEMO_LOG_EVERY == 0 or i == steps - 1:
            print(f"step {i:4d}  loss {hist[-1][0]:.3f}  "
                  f"acc {hist[-1][1]:.2%}")
    return hist


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="train 3 steps, no accuracy check")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    cost_model_validation()
    hist = small_scale_training(dev, steps=3 if args.smoke else DEMO_STEPS)
    if not args.smoke:
        if not hist[-1][1] > 0.5:
            raise RuntimeError(f"accuracy {hist[-1][1]:.2%} at step "
                               f"{len(hist) - 1}: synthetic CIFAR should be "
                               f"learnable")
        print("accuracy > 50% on 10-class synthetic data: converged")
    return hist


if __name__ == "__main__":
    main()
