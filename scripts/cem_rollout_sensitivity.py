"""How far float32 rounding alone moves a free-running CEM-GD3PG
population rollout on Pendulum-v1: the P=10 actors of
``chip_smoke.phase_card_vs_cpu_slice6`` (its defaults, 2x128), run once as
they are and once with their flat params scaled by 1 + eps, on one device.
Prints, per seed and eps, the largest observation difference over the
first 60 steps (relative to the magnitude, where above 1), the first step
past 1e-5, and the fitness difference (relative).

    python3 scripts/cem_rollout_sensitivity.py [--device cpu|cuda] [--seeds 4]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from freerl_tpu_torch.algos import CEMGD3PG, CEMDraws  # noqa: E402
from freerl_tpu_torch.envs import make  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seeds", type=int, default=4)
    args = p.parse_args()
    env = make("Pendulum-v1", device=args.device)
    for seed in range(args.seeds):
        algo = CEMGD3PG(env.dim_info, device=args.device)
        st = algo.init(torch.Generator(device=args.device).manual_seed(seed))
        rng = np.random.RandomState(seed)
        flat = algo.get_params(st.actor1)[None] * (
            1.0 + 0.3 * rng.randn(10, 1))
        draws = CEMDraws(torch.Generator(device=args.device).manual_seed(0)
                         ).population(env, 10, env.max_steps)
        ret0, tr0 = algo.eval_population(env, flat, draws)
        for eps in (1e-7, 3e-8):
            ret1, tr1 = algo.eval_population(env, flat * (1 + eps), draws)
            a, b = tr0.obs.double(), tr1.obs.double()
            err = ((a - b).abs() / a.abs().clamp(min=1.0)).flatten(1)
            per_step = err.max(1).values
            past = torch.nonzero(per_step > 1e-5)
            fit = float(((ret0 - ret1).abs()
                         / ret0.abs().clamp(min=1.0)).max())
            print(f"seed {seed} eps {eps:g}: max over 60 steps "
                  f"{float(per_step[:60].max()):.3g}, first step past 1e-5 "
                  f"{int(past[0]) if len(past) else None}, fitness "
                  f"{fit:.3g}")


if __name__ == "__main__":
    main()
