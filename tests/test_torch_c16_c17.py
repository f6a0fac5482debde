"""C16 (MountainCarContinuous PPO ObsNorm), C17 (DDPG OUNoise) and C18
(MAAC at N=5 on simple_spread_v3) by ROADMAP queue C's rules for seeds,
fixed before their runs: the recipe's row over more seeds against JAX at
this commit must pass (a), and the two sides' per-seed final-50s must not
differ, two-sided Mann-Whitney p >= 0.05 (b); C16's rule over 48 seeds
adds that the counts of solved seeds (final-50 >= 50) must not differ,
Fisher's exact p >= 0.05. C17 met its rule over 16 seeds and C18 over 16:
their 3-seed rows keep their gates and read FAIL, each where its rule put
it (``test_rows_are_held_as_their_rules_decided``, the one table of where
these rows are held). C16's 16- and 48-seed rows fail (a), so C16 stayed
open; after its ObsNorm path held to the JAX package's step by step
(``tests/test_torch_c16_lockstep.py``), its rule over 96 seeds a side
closed it: its 3-, 16- and 48-seed rows keep their gates and read FAIL in
``golden.UNDERPOWERED``, naming the 96-seed row."""
import json
import os

import numpy as np
import pytest
import torch

from freerl_tpu_torch.train import golden
from scripts import torch_seed_spread as spread

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = "MountainCarContinuous-v0"
MPE = "simple_spread_v3"
C16_48 = f"{ENV}/PPO_ObsNorm_48_seed@jax_head"
C16_96 = f"{ENV}/PPO_ObsNorm_96_seed@jax_head"
C17 = f"{ENV}/DDPG_OUNoise_16_seed@jax_head"
C18 = f"{MPE}/MAAC_N5_16_seed@jax_head"
GATE = ("window", "slack", "agg", "slack_mode", "overlap_gate", "floor",
        "regen", "smooth", "ref")
# C16's solved seeds: a smoothed final-50 at or above it reached the flag
SOLVED = 50.0


def _row(key: str):
    return next(r for r in golden.JAX_PARITY if golden.row_key(r) == key)


@pytest.mark.parametrize("env,label,seeds", [
    pytest.param(ENV, "PPO_ObsNorm", golden.DQN_LL_SEEDS16,
                 id="PPO_ObsNorm"),
    pytest.param(ENV, "DDPG_OUNoise", golden.DQN_LL_SEEDS16,
                 id="DDPG_OUNoise"),
    pytest.param(ENV, "PPO_ObsNorm", golden.DQN_LL_SEEDS48,
                 id="PPO_ObsNorm_48"),
    pytest.param(ENV, "PPO_ObsNorm", golden.DQN_LL_SEEDS96,
                 id="PPO_ObsNorm_96"),
    pytest.param(MPE, "MAAC_N5", golden.DQN_LL_SEEDS16, id="MAAC_N5")])
def test_16_seed_rows_take_the_3_seed_rows_recipe_and_gate(env, label,
                                                            seeds):
    """Each row over more seeds (16, or C16's 48 and 96) is its 3-seed
    ``@jax_head`` row's recipe and gate over the rule's seeds, and its
    seeds 0, 10 and 100 are the 3-seed row's, kept once; every seed of it
    ran on the card with no sum-tree launch and on the CPU with the JAX
    package."""
    row = _row(f"{env}/{label}_{len(seeds)}_seed@jax_head")
    three = _row(f"{env}/{label}_3_seed@jax_head")
    for f in GATE:
        assert getattr(row, f) == getattr(three, f), f
    assert row.regen_seeds == seeds
    assert row.regen_seeds[:3] == three.regen_seeds
    for s in three.regen_seeds:
        assert golden.seed_file("", row, s) == golden.seed_file("", three, s)
    for root, device in ((golden.OURS_ROOT, "cuda"),
                         (golden.JAX_HEAD_ROOT, "cpu")):
        with open(os.path.join(root, row.env, "provenance.json")) as f:
            prov = json.load(f)
        assert prov["stacks"][row.algo]["seeds"] == list(seeds)
        for s in seeds:
            rec = prov["seeds"][os.path.basename(golden.seed_file("", row,
                                                                  s))]
            if device == "cuda":
                assert rec["b1_launches"] == 0 and "H100" in rec["card"]
            else:
                assert rec["device"] == "cpu"


def test_c17_rows_are_underpowered_by_the_rule_for_seeds():
    """C17: the 16-seed row passes its best-seed gate and the two sides'
    final-50s do not differ: C17 closed."""
    assert golden.check_against_jax(_row(C17))["status"] == "pass"
    got = spread.spread(golden.OURS_ROOT, golden.JAX_HEAD_ROOT, ENV,
                        "DDPG_OUNoise_16_seed")
    assert got["mannwhitney"]["final50"]["p"] >= spread.P_MIN


def test_c16_stays_open_with_its_16_seed_row():
    """C16 over 16 seeds: the row misses its mean gate (rule (a)), whatever
    its Mann-Whitney p; so C16 stayed open then."""
    got = golden.check_against_jax(
        _row(f"{ENV}/PPO_ObsNorm_16_seed@jax_head"))
    assert got["status"] == "FAIL"
    assert got["ours"] < got["ref"] - got["slack"]


def test_c16_stays_open_by_its_rule():
    """C16 over 48 seeds a side: the port's mean final-50 misses the row's
    gate (36 of 48 seeds solve against 39 of 48), so rule (a) fails
    whatever rule (b) reads (Mann-Whitney p 0.744, Fisher's p 0.622): C16
    stayed open then."""
    got = golden.check_against_jax(_row(C16_48))
    assert got["status"] == "FAIL"
    assert got["ours"] < got["ref"] - got["slack"]
    sides = spread.spread(golden.OURS_ROOT, golden.JAX_HEAD_ROOT, ENV,
                          "PPO_ObsNorm_48_seed", below=SOLVED)
    solved = [len(sides[k]["seeds"]) - sides[k]["below"]
              for k in ("port", "jax_head")]
    assert solved == [36, 39]
    assert sides["mannwhitney"]["final50"]["p"] >= spread.P_MIN
    assert sides["fisher_below"]["p"] >= spread.P_MIN


def test_c16_closes_by_its_rule_over_96_seeds():
    """C16 over 96 seeds a side, the rule fixed once every step of the
    port's ObsNorm path held: the row passes its gate (the port's mean
    final-50 70.75 against JAX's 74.94, slack 5; 73 against 77 seeds
    solve) (a), and neither the final-50s nor the solved counts differ,
    Mann-Whitney p 0.465, Fisher's p 0.601 (b)."""
    got = golden.check_against_jax(_row(C16_96))
    assert got["status"] == "pass"
    sides = spread.spread(golden.OURS_ROOT, golden.JAX_HEAD_ROOT, ENV,
                          "PPO_ObsNorm_96_seed", below=SOLVED)
    solved = [len(sides[k]["seeds"]) - sides[k]["below"]
              for k in ("port", "jax_head")]
    assert solved == [73, 77]
    assert sides["mannwhitney"]["final50"]["p"] >= spread.P_MIN
    assert sides["fisher_below"]["p"] >= spread.P_MIN


def test_c18_closes_by_its_rule(monkeypatch):
    """C18 over 16 seeds a side: the row passes (a) and the final-50s do
    not differ, p 0.057 (b). JAX at this commit, over the committed row's
    three seeds, misses the committed gate too, and the stale reference's
    evidence is that stack."""
    assert golden.check_against_jax(_row(C18))["status"] == "pass"
    sides = spread.spread(golden.OURS_ROOT, golden.JAX_HEAD_ROOT, MPE,
                          "MAAC_N5_16_seed")
    assert sides["mannwhitney"]["final50"]["p"] >= spread.P_MIN
    committed = _row(f"{MPE}/MAAC_N5_3_seed")
    evidence = golden.STALE_REFERENCES[golden.row_key(committed)]
    head_stack = np.load(os.path.join(golden.JAX_HEAD_ROOT,
                                      committed.ref_path))
    np.testing.assert_array_equal(np.load(os.path.join(ROOT, evidence)),
                                  head_stack)
    monkeypatch.setattr(golden, "OURS_ROOT", golden.JAX_HEAD_ROOT)
    assert golden.check_against_jax(committed)["status"] == "FAIL"


@pytest.mark.parametrize("key,held,value", [
    (f"{ENV}/PPO_ObsNorm_3_seed", "UNDERPOWERED", C16_96),
    (f"{ENV}/PPO_ObsNorm_3_seed@jax_head", "UNDERPOWERED", C16_96),
    (f"{ENV}/PPO_ObsNorm_16_seed@jax_head", "UNDERPOWERED", C16_96),
    (C16_48, "UNDERPOWERED", C16_96),
    (C16_96, None, None),
    (f"{ENV}/DDPG_OUNoise_3_seed", "UNDERPOWERED", C17),
    (f"{ENV}/DDPG_OUNoise_3_seed@jax_head", "UNDERPOWERED", C17),
    (C17, None, None),
    (f"{MPE}/MAAC_N5_3_seed", "STALE_REFERENCES",
     f"results/torch/jax_head/{MPE}/MAAC_N5_3_seed.npy"),
    (f"{MPE}/MAAC_N5_3_seed@jax_head", "UNDERPOWERED", C18),
    (C18, None, None)])
def test_rows_are_held_as_their_rules_decided(key, held, value):
    """Each row of C16, C17 and C18 sits in the one set its rule put it in,
    with its C number, the row over more seeds that decided it, or the
    evidence of a stale reference, and reads FAIL there; held to nothing,
    it passes."""
    sets = {name: getattr(golden, name) for name in
            ("OPEN_FAULTS", "STALE_REFERENCES", "UNDERPOWERED")}
    assert [n for n, s in sets.items() if key in s] == (
        [held] if held else [])
    if held:
        assert sets[held][key] == value
    assert golden.must_fail(key) == bool(held)
    status = golden.check_against_jax(_row(key))["status"]
    assert status == ("FAIL" if held else "pass")
