"""Hyperparameter evolution (`sodt_tpu/train/evolve.py`).

A genetic search over the 28 training hyperparameters: a parent chosen
from the five fittest results so far (one of them by weight, or their
weighted mean), a clipped gaussian mutation with a per-hyperparameter
gain and bounds (`META`), one training run a generation, selection by the
trainer's fitness 0.9 x mAP@0.5 + 0.1 x mAP@0.5:0.95. Each generation
appends one row to `evolve.txt` (fitness, then the META values) and
writes its `hyp_gen{N}.yaml`; the fittest so far is `hyp_evolved.yaml`,
and `evolve.png` plots them all at the end where matplotlib is
installed. `mutate` draws from a `np.random.Generator` exactly as JAX's
does: at one seed and one evolve.txt both give the same hyperparameters
to the bit.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import yaml

from ..utils.general import resolve_config_path

# (mutation gain, lower bound, upper bound) per hyperparameter
META = {
    "lr0": (1, 1e-5, 1e-1),
    "lrf": (1, 0.01, 1.0),
    "momentum": (0.3, 0.6, 0.98),
    "weight_decay": (1, 0.0, 0.001),
    "warmup_epochs": (1, 0.0, 5.0),
    "warmup_momentum": (1, 0.0, 0.95),
    "warmup_bias_lr": (1, 0.0, 0.2),
    "box": (1, 0.02, 0.2),
    "cls": (1, 0.2, 4.0),
    "cls_pw": (1, 0.5, 2.0),
    "obj": (1, 0.2, 4.0),
    "obj_pw": (1, 0.5, 2.0),
    "iou_t": (0, 0.1, 0.7),
    "anchor_t": (1, 2.0, 8.0),
    "fl_gamma": (0, 0.0, 2.0),
    "hsv_h": (1, 0.0, 0.1),
    "hsv_s": (1, 0.0, 0.9),
    "hsv_v": (1, 0.0, 0.9),
    "degrees": (1, 0.0, 45.0),
    "translate": (1, 0.0, 0.9),
    "scale": (1, 0.0, 0.9),
    "shear": (1, 0.0, 10.0),
    "perspective": (0, 0.0, 0.001),
    "flipud": (1, 0.0, 1.0),
    "fliplr": (0, 0.0, 1.0),
    "mosaic": (1, 0.0, 1.0),
    "mixup": (1, 0.0, 1.0),
}


def mutate(hyp: dict, evolve_file: Path, rng: np.random.Generator,
           mp: float = 0.8, sigma: float = 0.2) -> dict:
    """One generation's hyperparameters: the parent from `evolve_file`
    where it exists (else `hyp`), mutated."""
    hyp = dict(hyp)
    if evolve_file.exists():
        rows = np.loadtxt(evolve_file, ndmin=2)
        n = min(5, len(rows))
        rows = rows[np.argsort(-rows[:, 0])][:n]       # the n fittest
        w = rows[:, 0] - rows[:, 0].min() + 1e-6
        parent = (rows[rng.choice(n, p=w / w.sum())]
                  if rng.random() < 0.5
                  else (rows * w[:, None]).sum(0) / w.sum())
        for i, k in enumerate(META):
            if k in hyp:
                hyp[k] = float(parent[i + 1])

    keys = [k for k in META if k in hyp]
    g = np.array([META[k][0] for k in keys], float)
    v = np.ones(len(keys))
    while (v == 1).all():
        # each hyperparameter's gain scales its perturbation
        v = (g * (rng.random(len(keys)) < mp) * rng.random()
             * rng.standard_normal(len(keys)) * sigma + 1).clip(0.3, 3.0)
    for k, gi, vi in zip(keys, g, v):
        if gi:
            lo, hi = META[k][1], META[k][2]
            hyp[k] = float(np.clip(hyp[k] * vi, lo, hi))
    return hyp


def log_generation(evolve_file: Path, fitness: float, hyp: dict):
    """Append one row: the fitness, then every META value (0 where the hyp
    lacks it), each as %.6g."""
    row = [fitness] + [float(hyp.get(k, 0.0)) for k in META]
    with open(evolve_file, "a") as f:
        f.write(" ".join(f"{x:.6g}" for x in row) + "\n")


def evolve(base_config, generations: int = 300, seed: int = 0):
    """The evolution loop: `base_config` is a TrainConfig; each generation
    trains in `<save_dir>/gen{N}` with mutated hyperparameters. Returns
    (best hyp, best fitness). Under several processes (`parallel.mesh`)
    every rank draws the same mutations from `seed`, rank 0 alone writes
    the files, and the others wait for them at a barrier."""
    from ..parallel.mesh import barrier, is_main
    from .trainer import train

    rng = np.random.default_rng(seed)
    save_dir = Path(base_config.save_dir)
    if is_main():
        save_dir.mkdir(parents=True, exist_ok=True)
    evolve_file = save_dir / "evolve.txt"
    with open(resolve_config_path(base_config.hyp)) as f:
        base_hyp = yaml.safe_load(f)

    best_fit, best_hyp = -1.0, dict(base_hyp)
    for gen in range(generations):
        hyp = mutate(base_hyp, evolve_file, rng)
        hyp_path = save_dir / f"hyp_gen{gen}.yaml"
        if is_main():
            hyp_path.write_text(yaml.dump(hyp))
        barrier()
        tc = dataclasses.replace(base_config, hyp=str(hyp_path),
                                 save_dir=str(save_dir / f"gen{gen}"))
        metrics = train(tc)
        fit = float(metrics.get("best_fitness", 0.0))
        if fit > best_fit:
            best_fit, best_hyp = fit, hyp
        if is_main():
            log_generation(evolve_file, fit, hyp)
            if best_hyp is hyp:
                (save_dir / "hyp_evolved.yaml").write_text(yaml.dump(hyp))
            print(f"evolve gen {gen}: fitness {fit:.4f} "
                  f"(best {best_fit:.4f})")
        barrier()
    if is_main():
        from ..utils.plots import plot_evolution
        plot_evolution(evolve_file, save_dir / "evolve.png")
    return best_hyp, best_fit
