"""``scripts/torch_dp_scaling.py``'s sweep on the CPU: gloo ranks, one
process each, at 1 and 2 ranks with a few steps. Each row counts the env
steps its driver ran (whole chunks or iterations over all ranks) and a
finite rate. (Its curve jobs train for minutes; they run on the card.)"""
import math

import pytest

from scripts import torch_dp_scaling

# JAX script's per-rank envs; a budget below one chunk / iteration, so each
# driver runs exactly one: DQN 256 vector steps, PPO one T-128 iteration,
# MADDPG 64 vector steps (before learning starts at 500 env steps)
EPD, STEPS = 8, 64


@pytest.mark.parametrize("n_ranks", [1, 2])
def test_sweep_rows(n_ranks):
    rows = torch_dp_scaling.sweep(n_ranks, device="cpu", envs_per_device=EPD,
                                  steps=STEPS, timeout=180)
    assert set(rows) == set(torch_dp_scaling.SWEEPS)
    want = {"dqn": (EPD * n_ranks, 256, "updates"),
            "ppo": (EPD * n_ranks, 128, "iterations"),
            "maddpg": (2 * n_ranks, 64, "updates")}
    for job, (num_envs, vector_steps, count) in want.items():
        row = rows[job]
        assert row["n_ranks"] == n_ranks and row["num_envs"] == num_envs
        assert row["env_steps"] == num_envs * vector_steps
        assert math.isfinite(row["env_steps_per_s"])
        assert row["env_steps_per_s"] > 0
    assert rows["dqn"]["updates"] == 256 - 500 // (EPD * n_ranks)
    assert rows["ppo"]["iterations"] == 1
    assert rows["maddpg"]["updates"] == 0

