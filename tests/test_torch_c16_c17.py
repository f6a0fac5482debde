"""C16 (MountainCarContinuous PPO ObsNorm) and C17 (DDPG OUNoise) by
ROADMAP queue C's rule for seeds, fixed before their runs: the recipe's
row over ``golden.DQN_LL_SEEDS16`` against JAX at this commit must pass
(a), and the two sides' per-seed final-50s must not differ, two-sided
Mann-Whitney p >= 0.05 (b). C17 met both: its 3-seed rows keep their
gates, read FAIL and sit in ``golden.UNDERPOWERED``, naming the 16-seed
row. C16's 16-seed row fails (a): C16 stays open, the 16-seed row with it
in ``golden.OPEN_FAULTS``."""
import pytest
import torch

from freerl_tpu_torch.train import golden
from scripts import torch_seed_spread as spread

torch.set_num_threads(1)

ENV = "MountainCarContinuous-v0"
GATE = ("window", "slack", "agg", "slack_mode", "overlap_gate", "floor",
        "regen", "smooth", "ref")


def _row(key: str):
    return next(r for r in golden.JAX_PARITY if golden.row_key(r) == key)


@pytest.mark.parametrize("label", ["PPO_ObsNorm", "DDPG_OUNoise"])
def test_16_seed_rows_take_the_3_seed_rows_recipe_and_gate(label):
    """Each 16-seed row is its 3-seed ``@jax_head`` row's recipe and gate
    over ``DQN_LL_SEEDS16``, and its seeds 0, 10 and 100 are the 3-seed
    row's, kept once."""
    row = _row(f"{ENV}/{label}_16_seed@jax_head")
    three = _row(f"{ENV}/{label}_3_seed@jax_head")
    for f in GATE:
        assert getattr(row, f) == getattr(three, f), f
    assert row.regen_seeds == golden.DQN_LL_SEEDS16
    assert row.regen_seeds[:3] == three.regen_seeds
    for s in three.regen_seeds:
        assert golden.seed_file("", row, s) == golden.seed_file("", three, s)


def test_c17_rows_are_underpowered_by_the_rule_for_seeds():
    """C17: the 16-seed row passes its best-seed gate and the two sides'
    final-50s do not differ; so both 3-seed rows keep their gates, read
    FAIL, and are held under ``UNDERPOWERED`` naming the 16-seed row."""
    key = f"{ENV}/DDPG_OUNoise_16_seed@jax_head"
    assert golden.check_against_jax(_row(key))["status"] == "pass"
    got = spread.spread(golden.OURS_ROOT, golden.JAX_HEAD_ROOT, ENV,
                        "DDPG_OUNoise_16_seed")
    assert got["mannwhitney"]["final50"]["p"] >= spread.P_MIN
    for ref in ("", "@jax_head"):
        held = f"{ENV}/DDPG_OUNoise_3_seed{ref}"
        assert golden.UNDERPOWERED[held] == key
        assert held not in golden.OPEN_FAULTS
        assert golden.check_against_jax(_row(held))["status"] == "FAIL"
    assert key not in golden.OPEN_FAULTS and not golden.must_fail(key)


def test_c16_stays_open_with_its_16_seed_row():
    """C16: the 16-seed row misses its mean gate (rule (a)), whatever its
    Mann-Whitney p; so C16 stays open, and the 16-seed row joins the
    3-seed rows in ``OPEN_FAULTS``, each reading FAIL."""
    key = f"{ENV}/PPO_ObsNorm_16_seed@jax_head"
    got = golden.check_against_jax(_row(key))
    assert got["status"] == "FAIL"
    assert got["ours"] < got["ref"] - got["slack"]
    for held in (key, f"{ENV}/PPO_ObsNorm_3_seed",
                 f"{ENV}/PPO_ObsNorm_3_seed@jax_head"):
        assert golden.OPEN_FAULTS[held] == "C16"
        assert held not in golden.UNDERPOWERED
        assert golden.check_against_jax(_row(held))["status"] == "FAIL"
