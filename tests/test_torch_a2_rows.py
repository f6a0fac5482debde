"""The rows of ``golden.a2_rows``, against the JAX package's
``golden.SPECS``: the six SPECS rows with a recipe that no other parity row
held (CartPole and Pendulum DQN, CartPole REINFORCE, MountainCarContinuous
PPO and the two DDPG rows), each with its SPECS row's recipe, seeds and
gate, against the JAX package's committed stack of its own stem and against
JAX at this commit."""
import json
import os

import numpy as np
import pytest
import torch

from freerl_tpu.train import golden as jax_golden
from freerl_tpu_torch.train import golden

torch.set_num_threads(1)

A2 = golden.a2_rows()
GATE = ("window", "slack", "agg", "slack_mode", "overlap_gate", "floor")
# the JAX package's committed per-seed final-50 of each stem
COMMITTED = {
    "CartPole-v1/DQN_3_seed": [477.2, 477.5, 147.8],
    "Pendulum-v1/DQN_3_seed": [-175.3, -172.1, -169.2],
    "CartPole-v1/REINFORCE_3_seed": [467.4, 491.2, 493.0],
    "MountainCarContinuous-v0/PPO_ObsNorm_3_seed": [94.5, 94.7, 93.6],
    "MountainCarContinuous-v0/DDPG_simple_1_seed": [90.5],
    "MountainCarContinuous-v0/DDPG_OUNoise_3_seed": [89.3, 87.0, 85.6],
}


def test_the_a2_rows():
    """Each stem against the committed stack, then against JAX at this
    commit, longest run first; every row is a row of ``JAX_PARITY``."""
    want = [f"{env}/{stem}{ref}" for env, stem in golden.A2_STEMS
            for ref in ("", "@jax_head")]
    assert [golden.row_key(r) for r in A2] == want
    assert set(COMMITTED) == {f"{e}/{s}" for e, s in golden.A2_STEMS}
    keys = [golden.row_key(r) for r in golden.JAX_PARITY]
    assert set(want) <= set(keys) and len(keys) == len(set(keys))


@pytest.mark.parametrize("row", A2, ids=golden.row_key)
def test_a_row_takes_its_specs_rows_recipe_and_gate(row):
    """The JAX SPECS row's recipe, seeds and gate; stacked smoothed, as the
    JAX package's ``regenerate`` stacks them; the JAX curve of its own
    stem."""
    spec = next(s for s in jax_golden.SPECS
                if (s.env, s.algo) == (row.env, row.algo))
    for f in GATE + ("regen", "regen_seeds", "pending"):
        assert getattr(row, f) == getattr(spec, f), f
    assert row.regen and row.smooth
    assert row.ref_path == f"{row.env}/{row.algo}.npy"
    assert os.path.isfile(os.path.join(golden.JAX_CURVES_ROOT, row.ref_path))
    assert f"SPECS {row.env}/{row.algo}" in row.note


def test_the_committed_references():
    """The committed rows read the JAX package's stacks of their stems; the
    OUNoise row its own stem's, where SPECS takes the reference's
    ``DDPG_simple`` curve, as its note says."""
    got = {golden.row_key(r): golden.check_against_jax(r)["ref_seeds"]
           for r in A2 if r.ref == "committed"}
    assert got == COMMITTED
    ou = next(r for r in A2 if r.algo == "DDPG_OUNoise_3_seed")
    spec = golden.spec_of(ou.env, ou.algo)
    assert spec.ref_path.endswith("DDPG_simple_1_seed.npy")
    assert "DDPG_simple_1_seed.npy" in ou.note


def test_seed_files_are_one_recipes():
    """Every seed file that rows share (``golden.seed_file``: one label a
    stem, whatever its seed count) is a seed of one recipe: no two recipes
    of one env keep their seeds under one name, which ``kept_seed`` would
    refuse."""
    made = {}
    for row in golden.JAX_PARITY:
        for seed in row.regen_seeds if row.regen else ():
            path = golden.seed_file("r", row, seed)
            recipe = [a.format(seed=seed) for a in row.regen]
            assert made.setdefault(path, recipe) == recipe, path


@pytest.mark.parametrize("key", ["CartPole-v1/DQN_3_seed@jax_head",
                                 "MountainCarContinuous-v0/"
                                 "DDPG_OUNoise_3_seed@jax_head"])
def test_fixed_reset_rows_pin_the_jax_start(key):
    """The two fixed-reset rows: each seed's start in the port is the start
    the JAX package pinned for it, as the ``@jax_head`` provenance records
    it."""
    row = next(r for r in golden.JAX_PARITY if golden.row_key(r) == key)
    assert "--fixed_reset" in row.regen
    with open(os.path.join(golden.JAX_HEAD_ROOT, row.env,
                           "provenance.json")) as f:
        prov = json.load(f)["seeds"]
    for seed in row.regen_seeds:
        rec = prov[os.path.basename(golden.seed_file("", row, seed))]
        assert golden.same_start(rec["start"],
                                 golden.pinned_start(row, seed)), seed


@pytest.mark.parametrize("row", [r for r in A2 if r.ref == "jax_head"] + [
    r for r in golden.JAX_PARITY if "_16_seed" in r.algo and (
        r.env, r.algo.replace("_16_", "_3_")) in golden.SEEDS16_STEMS],
    ids=golden.row_key)
def test_jax_head_stacks_are_the_jax_packages_smoothing(row):
    """The JAX-at-HEAD stack of each row is the JAX package's own
    ``aggregate_seeds`` of its kept seeds, in the row's seed order, each
    made on the CPU by the JAX package's CLI on the row's recipe."""
    from freerl_tpu.train.plotting import aggregate_seeds

    root = os.path.join(golden.JAX_HEAD_ROOT, row.env)
    with open(os.path.join(root, "provenance.json")) as f:
        prov = json.load(f)
    rec = prov["stacks"][row.algo]
    assert rec["seeds"] == list(row.regen_seeds) and rec["smoothed"]
    curves = [np.load(os.path.join(root, "seeds", n)) for n in rec["files"]]
    want, _, _ = aggregate_seeds(curves)
    np.testing.assert_array_equal(np.load(os.path.join(root,
                                                       row.algo + ".npy")),
                                  want)
    for name in rec["files"]:
        seed = prov["seeds"][name]
        assert seed["device"] == "cpu" and seed["env_steps"] > 0
        assert golden.recipe_of(seed["command"]) == [
            a.format(seed=int(name.rsplit("_", 1)[1][:-4]))
            for a in row.regen]


@pytest.mark.parametrize("env,label", [("Pendulum-v1", "DQN"),
                                       ("CartPole-v1", "REINFORCE")])
def test_c14_c15_rows_are_underpowered_by_the_rule_for_seeds(env, label):
    """C14 (Pendulum DQN) and C15 (CartPole REINFORCE) by ROADMAP queue
    C's rule for seeds: the recipe's row over the 16 seeds passes, and the
    two sides' per-seed final-50s do not differ (Mann-Whitney p >= 0.05);
    so the two 3-seed rows keep their gates, are held to FAIL under
    ``UNDERPOWERED`` and name the 16-seed row."""
    from scripts import torch_seed_spread as spread

    key = f"{env}/{label}_16_seed@jax_head"
    row = next(r for r in golden.JAX_PARITY if golden.row_key(r) == key)
    three = next(r for r in A2 if golden.row_key(r) ==
                 f"{env}/{label}_3_seed@jax_head")
    for f in GATE + ("regen", "smooth", "ref"):
        assert getattr(row, f) == getattr(three, f), f
    assert row.regen_seeds == golden.DQN_LL_SEEDS16
    assert golden.check_against_jax(row)["status"] == "pass"
    got = spread.spread(golden.OURS_ROOT, golden.JAX_HEAD_ROOT, env,
                        f"{label}_16_seed")
    assert got["mannwhitney"]["final50"]["p"] >= spread.P_MIN
    for ref in ("", "@jax_head"):
        held = f"{env}/{label}_3_seed{ref}"
        assert golden.UNDERPOWERED[held] == key
        assert golden.must_fail(held) and held not in golden.OPEN_FAULTS


def test_c16_c17_rows_are_open_faults():
    """The MountainCarContinuous 3-seed rows that miss both references,
    C16's PPO ObsNorm and C17's DDPG OUNoise, are held to FAIL and read
    FAIL. Where each is held, as its rule decided, is one table:
    ``test_rows_are_held_as_their_rules_decided`` in
    ``tests/test_torch_c16_c17.py``."""
    env = "MountainCarContinuous-v0"
    rows = [r for r in A2 if golden.row_key(r).startswith(
        (f"{env}/PPO_ObsNorm_3_seed", f"{env}/DDPG_OUNoise_3_seed"))]
    assert len(rows) == 4
    for row in rows:
        assert golden.check_against_jax(row)["status"] == "FAIL"
        assert golden.must_fail(golden.row_key(row))
