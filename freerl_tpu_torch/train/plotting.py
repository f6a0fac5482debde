"""Learning-curve aggregation and plotting (counterpart:
``freerl_tpu/train/plotting.py``; numpy and matplotlib only).

The reference's plot_learning_curves.py:
  - exponential smoothing with alpha=0.9 (:26-40);
  - multi-seed mean +- std band saved as ``<algo>_<k>_seed.npy`` + PNG
    (:129-140);
  - multi-algorithm comparison chart ``compare_N.png`` (:143-151).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np


def exp_smooth(x: np.ndarray, alpha: float = 0.9) -> np.ndarray:
    out = np.zeros_like(x, dtype=np.float64)
    run = x[0]
    for i, v in enumerate(x):
        run = alpha * run + (1 - alpha) * v
        out[i] = run
    return out


def aggregate_seeds(curves: Sequence[np.ndarray], alpha: float = 0.9):
    """Smooth each seed curve then stack to (n_seeds, T) (truncated to the
    shortest run). Returns (stacked, mean, std)."""
    t = min(len(c) for c in curves)
    stacked = np.stack([exp_smooth(np.asarray(c[:t]), alpha) for c in curves])
    return stacked, stacked.mean(0), stacked.std(0)


def save_seed_stack(curves: Sequence[np.ndarray], label: str,
                    out_dir: str, alpha: float = 0.9) -> str:
    """Save the smoothed seeds as ``<label>_<k>_seed.npy`` (k, T); returns
    its path."""
    stacked, _, _ = aggregate_seeds(curves, alpha)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{label}_{len(curves)}_seed.npy")
    np.save(path, stacked)
    return path


def plot_learning_curve(curves: Sequence[np.ndarray], label: str,
                        out_dir: str, env_name: str,
                        goal: Optional[float] = None, alpha: float = 0.9):
    """Save ``<label>_<k>_seed.npy`` + PNG with the mean+-std band."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    save_seed_stack(curves, label, out_dir, alpha)
    _, mean, std = aggregate_seeds(curves, alpha)
    fig, ax = plt.subplots(figsize=(8, 4.5))
    x = np.arange(len(mean))
    ax.plot(x, mean, label=label)
    ax.fill_between(x, mean - std, mean + std, alpha=0.25)
    if goal is not None:
        ax.axhline(goal, color="red", ls="--", label=f"goal {goal}")
    ax.set_xlabel("episode")
    ax.set_ylabel("return")
    ax.set_title(env_name)
    ax.legend()
    fig.tight_layout()
    path = os.path.join(out_dir, f"{label}_{len(curves)}_seed.png")
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def plot_compare(curve_sets: Dict[str, Sequence[np.ndarray]], out_dir: str,
                 env_name: str, alpha: float = 0.9):
    """Multi-algorithm comparison (the reference's compare_N.png)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(9, 5))
    for label, curves in curve_sets.items():
        _, mean, std = aggregate_seeds(curves, alpha)
        x = np.arange(len(mean))
        ax.plot(x, mean, label=label)
        ax.fill_between(x, mean - std, mean + std, alpha=0.15)
    ax.set_xlabel("episode")
    ax.set_ylabel("return")
    ax.set_title(env_name)
    ax.legend()
    fig.tight_layout()
    path = os.path.join(out_dir, f"compare_{len(curve_sets)}.png")
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path
