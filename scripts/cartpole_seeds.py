"""The spread of ``chip_smoke.py``'s CartPole learning check over seeds.

    python3 scripts/cartpole_seeds.py [--device cpu] [--seeds 0-19]

Runs the check's configuration (DQN, replay 20,000, batch 64, 8 envs,
4 updates per vector step, 250 episodes) once per seed and prints one JSON
line per seed with the mean return of the first 10 and the last 30
episodes, then one line with the smallest and largest last-30 mean. The
check's threshold is set below that spread.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from freerl_tpu_torch.algos import DQN, DQNConfig  # noqa: E402
from freerl_tpu_torch.envs import make  # noqa: E402
from freerl_tpu_torch.train import OffPolicyConfig, train_offpolicy  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", default="0-19", help="first-last, inclusive")
    args = ap.parse_args()
    first, last = (int(x) for x in args.seeds.split("-"))
    if args.device == "cpu":
        torch.set_num_threads(1)
    means = []
    for seed in range(first, last + 1):
        env = make("CartPole-v1", device=args.device)
        algo = DQN(env.dim_info, DQNConfig(buffer_size=20_000, batch_size=64),
                   device=args.device)
        cfg = OffPolicyConfig(seed=seed, num_envs=8, max_episodes=250,
                              start_steps=500, updates_per_burst=4,
                              chunk_size=128)
        _, returns, info = train_offpolicy(env, algo, cfg)
        means.append(float(returns[-30:].mean()))
        print(json.dumps({"seed": seed, "first10": float(returns[:10].mean()),
                          "last30": means[-1],
                          "env_steps": info["env_steps"]}), flush=True)
    print(json.dumps({"device": args.device, "seeds": args.seeds,
                      "last30_min": min(means), "last30_max": max(means)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
