"""The spread over seeds of ``chip_smoke.py``'s learning checks.

    python3 scripts/learning_seeds.py
        [--recipe cartpole|sac_pendulum|ppo_cartpole|matd3_spread|
                  mappo_spread]
        [--device cpu] [--seeds 0-19] [--frozen]

Runs one recipe of ``chip_smoke.LEARNING_CHECKS``, the very one the check
runs: ``cartpole`` (the default; DQN, replay 20,000, batch 64, 8 envs, 4
updates per vector step, 250 episodes, read over the first 10 and the last
30), ``sac_pendulum`` (the JAX package's recipe of
``tests/test_continuous.py``: SAC, replay 50,000, 8 envs, start and random
steps 1000, 4 updates per vector step, 120 episodes, read over the first
and the last 20) or ``ppo_cartpole`` (the JAX package's recipe of
``tests/test_onpolicy.py``: PPO with adv_norm, horizon 1024, minibatch 64,
8 envs, 300 episodes through ``train_onpolicy``, read over the first 10
and the last 30) or ``matd3_spread`` (the JAX package's recipe of
``tests/test_marl.py``: MATD3 on simple_spread_v3, 8 envs, actor and
critic lr 1e-3, 300 episodes through ``train_marl``, read over the first
10 and the last 50, averaged over agents) or ``mappo_spread`` (the JAX
package's recipe of ``tests/test_marl_onpolicy.py``: MAPPO with
adv_norm on simple_spread_v3, 8 envs, horizon 512, K_epochs 5, minibatch
256, 400 episodes through ``train_onpolicy``, read over the first and the
last 40, averaged over agents). One JSON line per seed, then
one with the smallest and largest "last" mean. A check's threshold is set
below that spread. ``--frozen`` runs the recipe with every learning rate
at 0: the spread of a policy that does not learn, which a threshold must
stay above.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import LEARNING_CHECKS, algo_classes, recipe_run  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--recipe", choices=sorted(LEARNING_CHECKS),
                    default="cartpole")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", default="0-19", help="first-last, inclusive")
    ap.add_argument("--frozen", action="store_true",
                    help="every learning rate of the algo's config at 0")
    args = ap.parse_args()
    first, last = (int(x) for x in args.seeds.split("-"))
    if args.device == "cpu":
        torch.set_num_threads(1)
    rec = LEARNING_CHECKS[args.recipe]
    if args.frozen:
        cfg_cls = algo_classes(rec["algo"])[1]
        rec = dict(rec, algo_cfg=dict(rec["algo_cfg"], **{
            f.name: 0.0 for f in dataclasses.fields(cfg_cls)
            if f.name.endswith("_lr")}))
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
    print(json.dumps({"recipe": args.recipe, "frozen": args.frozen,
                      "device": args.device,
                      "seeds": args.seeds, f"last{n_last}_min": min(means),
                      f"last{n_last}_max": max(means),
                      "threshold": rec["threshold"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
