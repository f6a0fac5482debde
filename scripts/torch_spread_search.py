"""Search for the recipe of the JAX package's N=3 simple_spread_v3 curves
that no script or log names: ``MADDPG_1_seed``, ``MAPPO_1_seed`` and
``MASAC_1_seed`` under ``results/learning_curves/simple_spread_v3/``, each
``(1, 600)``, one run smoothed (alpha 0.9) as
``freerl_tpu/train/plotting.py``'s ``aggregate_seeds`` stacks it.

    python3 scripts/torch_spread_search.py [--work build/spread_search]
        [--out results/torch/spread_search.json]

Each candidate runs the JAX package on the CPU as a command
(``JAX_PLATFORMS=cpu``), seed 0, cut to ``EPISODES`` episodes: its CLI at
its defaults (8 envs), the same with ``--fixed_reset``, and
``scripts/train_spread.py --algo ALGO`` (16 envs; MADDPG and MASAC, its
choices) with ``--out`` under ``--work``. The run's per-agent mean return
per episode, smoothed as the committed stack was (the port's
``exp_smooth``, the JAX package's copied), is held against the
committed stack's first ``FIRST`` episodes: a candidate is the recipe only
if they are equal bit for bit (the smoothing's first value is the first
episode's return, so a first episode that differs rules a candidate out).
One JSON line a candidate, and all of them in ``--out``.

The script imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from freerl_tpu_torch.train.plotting import exp_smooth  # noqa: E402

ENV = "simple_spread_v3"
ALGOS = ("MADDPG", "MAPPO", "MASAC")
# each candidate's run, cut, and how many of its first smoothed episodes
# must equal the committed stack's
EPISODES, FIRST = 40, 16


def candidates(algo: str, work: str) -> dict:
    """Each candidate's command and the glob of the raw curve it saves."""
    cli = [sys.executable, "-m", "freerl_tpu.cli", "--algo", algo,
           "--env_name", ENV, "--max_episodes", str(EPISODES), "--seed", "0",
           "--no_tensorboard"]
    out = {}
    for name, extra in (("cli", []), ("cli_fixed_reset", ["--fixed_reset"])):
        root = os.path.join(work, f"{algo}_{name}")
        out[name] = (cli + extra + ["--results_root", root],
                     os.path.join(root, ENV, "*", f"{algo}_seed_0.npy"))
    if algo != "MAPPO":
        root = os.path.join(work, f"{algo}_train_spread")
        out["train_spread"] = (
            [sys.executable, os.path.join(ROOT, "scripts", "train_spread.py"),
             "--algo", algo, "--episodes", str(EPISODES), "--out", root],
            os.path.join(root, ENV, f"{algo}_seed_0.npy"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--work", default=os.path.join(ROOT, "build",
                                                   "spread_search"))
    ap.add_argument("--out", default=os.path.join(
        ROOT, "results", "torch", "spread_search.json"))
    args = ap.parse_args(argv)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    rows = []
    for algo in ALGOS:
        committed = np.load(os.path.join(ROOT, "results", "learning_curves",
                                         ENV, f"{algo}_1_seed.npy"))[0]
        for name, (cmd, pattern) in candidates(algo, args.work).items():
            subprocess.run(cmd, cwd=ROOT, env=env, check=True,
                           capture_output=True)
            raw = np.load(sorted(glob.glob(pattern))[-1])
            curve = exp_smooth(raw.mean(axis=1))
            gap = np.abs(curve[:FIRST] - committed[:FIRST])
            rec = dict(algo=algo, candidate=name,
                       first=[float(x) for x in curve[:3]],
                       committed_first=[float(x) for x in committed[:3]],
                       equal_of_first=int((gap == 0).sum()), of=FIRST,
                       max_abs_gap=float(gap.max()),
                       recipe=bool((gap == 0).all()))
            rows.append(rec)
            print(json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(episodes=EPISODES, first=FIRST, candidates=rows), f,
                  indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
