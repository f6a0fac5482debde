"""``chip_smoke.side_by_side``, the runner of the learning-check block, on
the CPU with two tiny recipes (``tests/_torch_learning_child.py``): the
checks run side by side, each in a spawned process, give the returns they
give one after another in this process; a check that raises, or outlives
the block's timeout, fails the block, naming it, and no child is left
but the helpers `chip_smoke.stop_children` stops."""
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_learning_child import tiny_check

torch.set_num_threads(1)


def test_side_by_side_gives_the_serial_returns():
    runs, wall = chip_smoke.side_by_side(tiny_check, ["dqn", "ppo"],
                                         args=("cpu",))
    assert set(runs) == {"dqn", "ppo"} and wall > 0
    for name, rec in runs.items():
        serial = tiny_check(name, "cpu")
        assert len(serial["returns"]) == 12
        np.testing.assert_array_equal(rec["out"]["returns"],
                                      serial["returns"])
        assert rec["out"]["env_steps"] == serial["env_steps"]
        assert rec["moved"] == [] and 0 < rec["seconds"] <= wall
    assert chip_smoke.stop_children() == {}


@pytest.mark.parametrize("name, why", [
    ("raises", "raises: exit code 1"),
    ("hangs", "hangs: still running after 10 s"),
])
def test_a_failed_check_fails_the_block(name, why):
    with pytest.raises(AssertionError, match=why):
        chip_smoke.side_by_side(tiny_check, ["dqn", name], args=("cpu",),
                                timeout=10.0)
    assert chip_smoke.stop_children() == {}


def test_moved_rngs_names_the_states_a_draw_moves():
    before = chip_smoke.global_rng_states()
    assert chip_smoke.moved_rngs(before, chip_smoke.global_rng_states()) \
        == []
    torch.rand(1)
    np.random.rand()
    assert chip_smoke.moved_rngs(before, chip_smoke.global_rng_states()) \
        == ["torch", "numpy"]


def test_the_block_runs_the_checks_and_the_recipes(monkeypatch):
    """``phase_learning_block`` runs every learning check, every phase of
    ``BLOCK_PHASES`` and every recipe of ``RECIPE_TABLES`` in one block
    (``block_task`` sends each name to ``phase_learning``, ``block_phase``
    or ``recipe``), sums the sum-tree launches by the checks' drivers, the
    phases' counts and the recipes' tables, keeps each walker recipe's K2
    and K3 launches by its tag, and fails on a recipe over
    ``N5_TIMEOUT_S`` or a moved random state, naming it."""
    from freerl_tpu_torch.train import golden

    monkeypatch.setattr(chip_smoke, "phase_learning",
                        lambda name: dict(line=f"check {name}", launches=1))
    walker = ("CEM_GD3PG_4_seed", "PPO_BipedalWalker")
    monkeypatch.setattr(chip_smoke, "recipe", lambda tag: dict(
        line=f"recipe {tag}", launches=2,
        **(dict(k2=5, k3=6) if tag in walker else {})))
    # each phase as it returns: launches as an int, in a dict, or none
    fakes = {name: ((lambda *a: dict(launches=4)) if args else
                    (lambda: 4) if key else (lambda: None), args, key)
             for name, (_, args, key) in chip_smoke.BLOCK_PHASES.items()}
    monkeypatch.setattr(chip_smoke, "BLOCK_PHASES", fakes)
    phases = [key for _, _, key in fakes.values()]
    assert phases.count("onpolicy") == 7 and phases.count(None) == 2
    seconds = {}

    def in_process(fn, names, args=(), timeout=None):
        return {n: dict(out=fn(n, *args), seconds=seconds.get(n, 1.0),
                        moved=[]) for n in names}, 3.0

    monkeypatch.setattr(chip_smoke, "side_by_side", in_process)
    got = chip_smoke.phase_learning_block()
    tables = {name: len(getattr(golden, table))
              for name, table, _ in chip_smoke.RECIPE_TABLES}
    assert tables == {"n5": len(golden.N5_RUNS), "spread": 1, "envelope": 1,
                      "pixel": 1, "gail": 1, "cem_bipedal": 1,
                      "ppo_bipedal": 1}
    drivers = [c.get("driver") for c in chip_smoke.LEARNING_CHECKS.values()]
    assert got == {"onpolicy": drivers.count("onpolicy") + 4 * 7,
                   "marl": drivers.count("marl"),
                   **{name: 2 * n for name, n in tables.items()},
                   "walker": {tag: (5, 6) for tag in walker}}
    seconds["ENVELOPE"] = chip_smoke.N5_TIMEOUT_S + 1
    with pytest.raises(AssertionError, match="ENVELOPE"):
        chip_smoke.phase_learning_block()
