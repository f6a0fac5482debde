"""The spread over seeds of ``chip_smoke.py``'s learning checks.

    python3 scripts/learning_seeds.py
        [--recipe cartpole|sac_pendulum|ppo_cartpole] [--device cpu]
        [--seeds 0-19]

Runs one recipe of ``chip_smoke.LEARNING_CHECKS``, the very one the check
runs: ``cartpole`` (the default; DQN, replay 20,000, batch 64, 8 envs, 4
updates per vector step, 250 episodes, read over the first 10 and the last
30), ``sac_pendulum`` (the JAX package's recipe of
``tests/test_continuous.py``: SAC, replay 50,000, 8 envs, start and random
steps 1000, 4 updates per vector step, 120 episodes, read over the first
and the last 20) or ``ppo_cartpole`` (the JAX package's recipe of
``tests/test_onpolicy.py``: PPO with adv_norm, horizon 1024, minibatch 64,
8 envs, 300 episodes through ``train_onpolicy``, read over the first 10
and the last 30). One JSON line per seed, then one with the smallest and
largest "last" mean. A check's threshold is set below that spread.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import LEARNING_CHECKS, recipe_run  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--recipe", choices=sorted(LEARNING_CHECKS),
                    default="cartpole")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", default="0-19", help="first-last, inclusive")
    args = ap.parse_args()
    first, last = (int(x) for x in args.seeds.split("-"))
    if args.device == "cpu":
        torch.set_num_threads(1)
    rec = LEARNING_CHECKS[args.recipe]
    n_first, n_last = rec["read"]
    means = []
    for seed in range(first, last + 1):
        _, _, run = recipe_run(rec, seed, args.device)
        _, returns, info = run()
        means.append(float(returns[-n_last:].mean()))
        print(json.dumps({"seed": seed,
                          f"first{n_first}": float(returns[:n_first].mean()),
                          f"last{n_last}": means[-1],
                          "env_steps": info["env_steps"]}), flush=True)
    print(json.dumps({"recipe": args.recipe, "device": args.device,
                      "seeds": args.seeds, f"last{n_last}_min": min(means),
                      f"last{n_last}_max": max(means),
                      "threshold": rec["threshold"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
