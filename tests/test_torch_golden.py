"""The port's ``train/golden.py`` against the JAX package's: the same
specs and gates, ``check_all`` rows equal on the same artifacts, and
``regenerate`` through the port's CLI on the CPU into ``tmp_path`` (no
test writes into ``results/learning_curves/``). The port's curves have a
tree of their own: by default it lies outside the JAX package's
``results/learning_curves/``, which a regenerate leaves as it was."""
import dataclasses
import glob
import hashlib
import importlib.util
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from freerl_tpu.train import golden as jax_golden
from freerl_tpu_torch.train import golden

torch.set_num_threads(1)


def test_specs_and_gates_are_the_jax_packages():
    assert [dataclasses.astuple(s) for s in golden.SPECS] == [
        dataclasses.astuple(s) for s in jax_golden.SPECS]
    assert golden.SCALAR_GATES == jax_golden.SCALAR_GATES


def test_check_all_rows_equal_jax(monkeypatch):
    """Pointed at the JAX package's artifacts, the port's gates give the
    JAX rows; with its own defaults, no JAX artifact is read as ours: the
    rows read as the port's are those of its own committed curves, and
    none reads the JAX curve's numbers."""
    monkeypatch.setattr(golden, "REF_ROOT", jax_golden.REF_ROOT)
    own = golden.check_all()
    own_root = golden.OURS_ROOT
    ported = {(s.env, s.algo) for s in golden.SPECS if os.path.isfile(
        os.path.join(own_root, s.env, s.algo + ".npy"))}
    # a scalar gate reads the port's summary where its results tree has one
    ported |= {(g["name"], g["key"]) for g in golden.SCALAR_GATES
               if glob.glob(os.path.join(os.path.dirname(own_root),
                                         g["glob"].removeprefix("results/")))}
    monkeypatch.setattr(golden, "OURS_ROOT", jax_golden.OURS_ROOT)
    rows, want = golden.check_all(), jax_golden.check_all()
    assert rows == want
    assert len(rows) == len(golden.SPECS) + len(golden.SCALAR_GATES)
    assert not [r for r in rows if r["status"] == "FAIL"]
    read = {(r["env"], r["algo"]): r["ours_seeds"] for r in own
            if r["ours"] is not None}
    assert set(read) == ported
    # a saturated curve (CartPole's 500) gives both sides the same
    # final-window numbers; a JAX curve read as the port's is the same array
    same = [k for k in read if os.path.isfile(os.path.join(
        jax_golden.OURS_ROOT, *k) + ".npy") and np.array_equal(
        np.load(os.path.join(own_root, *k) + ".npy"),
        np.load(os.path.join(jax_golden.OURS_ROOT, *k) + ".npy"))]
    assert not same, f"JAX curves read as the port's: {same}"


def _spec():
    return golden.GoldenSpec(
        "CartPole-v1", "DQN_1_seed",
        "DQN_file/learning_curves/CartPole-v1/DQN_3_seed.npy",
        regen=("--algo", "DQN", "--env_name", "CartPole-v1",
               "--max_episodes", "25", "--num_envs", "4",
               "--buffer_size", "2048", "--seed", "{seed}"),
        regen_seeds=(0,))


def test_regenerate_through_the_port_cli(tmp_path, monkeypatch):
    """A 25-episode CartPole recipe on the CPU: a (1, >=25) stack and its
    plot under ``OURS_ROOT``; without matplotlib, the stack alone."""
    monkeypatch.setattr(golden, "OURS_ROOT", str(tmp_path))
    path = golden.regenerate(_spec(), results_root=str(tmp_path / "runs"),
                             device="cpu")
    stacked = np.load(tmp_path / "CartPole-v1" / "DQN_1_seed.npy")
    assert stacked.shape[0] == 1 and stacked.shape[1] >= 25
    assert np.isfinite(stacked).all()
    assert path.endswith(".png")
    monkeypatch.setattr(golden, "_has_matplotlib", lambda: False)
    monkeypatch.setattr(golden, "OURS_ROOT", str(tmp_path / "plain"))
    path = golden.regenerate(_spec(), results_root=str(tmp_path / "runs"),
                             device="cpu")
    assert path.endswith("DQN_1_seed.npy")
    assert np.load(path).shape[0] == 1


def _tree_digest(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


def test_default_root_leaves_the_jax_curves_alone(tmp_path, monkeypatch):
    """C6: the port's default curves root lies outside the JAX package's
    ``results/learning_curves/``; a default ``regenerate``, run from a copy
    of ``golden.py`` in a temporary repo root beside a copy of that tree,
    writes its stack under the port's root and leaves the tree as it
    was."""
    jax_root = os.path.realpath(jax_golden.OURS_ROOT)
    ours = os.path.realpath(golden.OURS_ROOT)
    assert os.path.commonpath([ours, jax_root]) != jax_root

    src = os.path.join(tmp_path, "freerl_tpu_torch", "train", "golden.py")
    os.makedirs(os.path.dirname(src))
    shutil.copy(golden.__file__, src)
    curves = os.path.join(tmp_path, "results", "learning_curves")
    shutil.copytree(jax_root, curves)
    before = _tree_digest(curves)
    spec = importlib.util.spec_from_file_location("_golden_copy", src)
    copy = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, copy)
    spec.loader.exec_module(copy)
    assert os.path.realpath(copy.OURS_ROOT).startswith(str(tmp_path))
    copy.regenerate(copy.GoldenSpec(*dataclasses.astuple(_spec())),
                    results_root=str(tmp_path / "runs"), device="cpu")
    assert _tree_digest(curves) == before
    stacked = np.load(os.path.join(copy.OURS_ROOT, "CartPole-v1",
                                   "DQN_1_seed.npy"))
    assert stacked.shape[0] == 1 and stacked.shape[1] >= 25


# ---------------------------------------------------------------------------
# parity with the JAX package's committed curves (golden.JAX_PARITY)
# ---------------------------------------------------------------------------
def _seeds(means, t=60, seed=0):
    """(k, t) curves whose final-50 means are ``means``."""
    rng = np.random.RandomState(seed)
    noise = rng.standard_normal((len(means), t))
    noise -= noise[:, -50:].mean(1, keepdims=True)
    return np.asarray(means, np.float64)[:, None] + noise


# (spec fields, port per-seed final means, JAX per-seed final means, the
# verdict): every branch of the gate, and both verdicts of each
PARITY_CASES = {
    "mean_pass": (dict(slack=50.0), [150, 170, 90], [81.5, 227.5, 181.8],
                  "pass"),
    "mean_fail": (dict(slack=50.0), [90, 110, 100], [81.5, 227.5, 181.8],
                  "FAIL"),
    "overlap_fail": (dict(slack=150.0), [40, 40, 40], [81.5, 227.5, 181.8],
                     "FAIL"),
    "overlap_off": (dict(slack=150.0, overlap_gate=False), [40, 40, 40],
                    [81.5, 227.5, 181.8], "pass"),
    "best_pass": (dict(slack=20.0, agg="best"), [10, 20, 200],
                  [100, 210, 220], "pass"),
    "best_fail": (dict(slack=10.0, agg="best"), [10, 20, 200],
                  [100, 210, 220], "FAIL"),
    "dist_within_std": (dict(slack_mode="dist"), [140, 150, 160],
                        [100, 160, 220], "pass"),
    "dist_seed_beats_mean": (dict(slack_mode="dist"), [0, 10, 170],
                             [100, 160, 220], "pass"),
    "dist_fail": (dict(slack_mode="dist"), [0, 10, 20], [100, 160, 220],
                  "FAIL"),
    "floor_pass": (dict(slack=50.0, floor=123.0), [150], [196.85], "pass"),
    "floor_fail": (dict(slack=50.0, floor=123.0), [115], [100.0], "FAIL"),
    "one_seed_mean_fail": (dict(slack=50.0, floor=123.0), [140], [196.85],
                           "FAIL"),
}


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_check_against_jax_is_the_jax_check(case, tmp_path, monkeypatch):
    """On synthetic curves, ``check_against_jax`` with the port's curve as
    "ours" and the JAX curve as the reference gives the row that the JAX
    package's ``check`` gives on the same two files."""
    fields, ours, ref, verdict = PARITY_CASES[case]
    for root, means, seed in (("ours", ours, 1), ("jax", ref, 2)):
        os.makedirs(tmp_path / root / "Env-v0")
        curves = _seeds(means, seed=seed)
        np.save(tmp_path / root / "Env-v0" / "X_k_seed.npy",
                curves[0] if len(means) == 1 else curves)
    row = golden.GoldenSpec("Env-v0", "X_k_seed", "Env-v0/X_k_seed.npy",
                            **fields)
    monkeypatch.setattr(golden, "OURS_ROOT", str(tmp_path / "ours"))
    monkeypatch.setattr(golden, "JAX_CURVES_ROOT", str(tmp_path / "jax"))
    monkeypatch.setattr(jax_golden, "OURS_ROOT", str(tmp_path / "ours"))
    monkeypatch.setattr(jax_golden, "REF_ROOT", str(tmp_path / "jax"))
    got = golden.check_against_jax(row)
    assert got == jax_golden.check(
        jax_golden.GoldenSpec(*dataclasses.astuple(row)))
    assert got["status"] == verdict


@pytest.mark.parametrize("row", golden.JAX_PARITY, ids=golden.row_key)
def test_missing_port_curve_reads_missing(row, tmp_path, monkeypatch):
    monkeypatch.setattr(golden, "OURS_ROOT", str(tmp_path))
    got = golden.check_against_jax(row)
    assert got["status"] == "missing" and got["ours"] is None
    # the JAX curve is read, where the row names one (SPECS' pixel row is
    # held by its floor alone)
    assert (got["ref"] is not None) == bool(row.ref_path or row.ref_paths)
    assert row.ref_path or row.floor is not None


def test_parity_rows_are_fixed():
    """The two rows' gates, their recipe (the JAX package's ``_DQN_LL``,
    seeds 0/10/100) and the JAX curves they read: north star final-1000
    196.85; DQN_3_seed per-seed final-50 81.5 / 227.5 / 181.8."""
    fast, three = golden.JAX_PARITY[:2]
    assert (fast.env, fast.algo, fast.window, fast.slack, fast.floor,
            fast.agg, fast.slack_mode) == (
        "LunarLander-v2", "DQN_fast_1_seed", 1000, 50.0, 123.0, "mean",
        "abs")
    assert (three.env, three.algo, three.window, three.slack, three.floor,
            three.agg, three.slack_mode, three.overlap_gate) == (
        "LunarLander-v2", "DQN_3_seed", 50, 50.0, None, "mean", "abs", True)
    assert three.regen == jax_golden._DQN_LL == golden.SPECS[0].regen
    assert three.regen_seeds == (0, 10, 100)
    assert round(golden.check_against_jax(fast)["ref"], 2) == 196.85
    ref = golden.check_against_jax(three)
    assert ref["ref_seeds"] == [81.5, 227.5, 181.8]
    assert round(ref["ref"], 1) == 163.6


def test_regen_argv_is_regenerates():
    """``regen_argv`` is the CLI argv ``regenerate`` passes for a seed."""
    spec = _spec()
    assert golden.regen_argv(spec, 7, "r", "cpu") == [
        "--algo", "DQN", "--env_name", "CartPole-v1", "--max_episodes", "25",
        "--num_envs", "4", "--buffer_size", "2048", "--seed", "7",
        "--results_root", os.path.join("r", "golden_runs"),
        "--no_tensorboard", "--device", "cpu"]


def _must_fail_reason(key: str) -> str:
    if key in golden.OPEN_FAULTS:
        return (f"{golden.OPEN_FAULTS[key]}: the committed port curve "
                "misses its gate (ROADMAP queue C)")
    if key in golden.UNDERPOWERED:
        return (f"the gate, not the port, misses "
                f"({golden.UNDERPOWERED[key]})")
    return (f"stale reference: the JAX package at this commit misses the "
            f"same gate ({golden.STALE_REFERENCES[key]})")


@pytest.mark.parametrize("row", [
    pytest.param(r, marks=pytest.mark.xfail(
        strict=True, reason=_must_fail_reason(golden.row_key(r))))
    if golden.must_fail(golden.row_key(r)) else r
    for r in golden.JAX_PARITY], ids=golden.row_key)
def test_committed_port_curves_pass(row):
    """The port's committed curves, each against the JAX curve its row
    names: every row has its curve, so a curve taken away fails here. A
    row under an open fault or a stale reference fails (strict); a row of
    ``NOT_COMPARABLE`` is read and gated, and its verdict held to
    nothing."""
    got = golden.check_against_jax(row)
    if golden.row_key(row) in golden.NOT_COMPARABLE:
        assert got["status"] in ("pass", "FAIL"), got
        return
    assert got["status"] == "pass", got


def test_held_rows_are_rows():
    """Every key that ``OPEN_FAULTS``, ``STALE_REFERENCES``,
    ``UNDERPOWERED`` and ``NOT_COMPARABLE`` hold names a row, or a scalar
    gate by its name, and no row is in two of them; an ``UNDERPOWERED`` row
    names its evidence, a row that shows it or a committed file."""
    keys = {golden.row_key(r) for r in golden.JAX_PARITY} | {
        g["name"] for g in golden.SCALAR_GATES}
    held = [set(golden.OPEN_FAULTS), set(golden.STALE_REFERENCES),
            set(golden.UNDERPOWERED), set(golden.NOT_COMPARABLE)]
    root = os.path.join(os.path.dirname(__file__), "..")
    assert all(v in keys or os.path.isfile(os.path.join(root, v))
               for v in golden.UNDERPOWERED.values())
    assert set().union(*held) <= keys
    assert sum(map(len, held)) == len(set().union(*held))


# ---------------------------------------------------------------------------
# references from the JAX package at this commit (golden.JAX_HEAD_ROOT)
# ---------------------------------------------------------------------------
def test_check_reads_the_rows_own_reference(tmp_path, monkeypatch):
    """A row keyed ``@jax_head`` reads its reference under
    ``JAX_HEAD_ROOT``; a row of the committed tree, and a plain
    ``GoldenSpec``, under ``JAX_CURVES_ROOT``, as before."""
    for root, means, seed in (("ours", [90, 110, 100], 1),
                              ("jax", [81.5, 227.5, 181.8], 2),
                              ("head", [0, 10, 240], 3)):
        os.makedirs(tmp_path / root / "Env-v0")
        np.save(tmp_path / root / "Env-v0" / "X_3_seed.npy",
                _seeds(means, seed=seed))
    monkeypatch.setattr(golden, "OURS_ROOT", str(tmp_path / "ours"))
    monkeypatch.setattr(golden, "JAX_CURVES_ROOT", str(tmp_path / "jax"))
    monkeypatch.setattr(golden, "JAX_HEAD_ROOT", str(tmp_path / "head"))
    spec = golden.GoldenSpec("Env-v0", "X_3_seed", "Env-v0/X_3_seed.npy",
                             slack=50.0)
    committed = golden.parity_row(spec)
    head = golden.parity_row(spec, ref="jax_head")
    assert [golden.row_key(r) for r in (spec, committed, head)] == [
        "Env-v0/X_3_seed", "Env-v0/X_3_seed", "Env-v0/X_3_seed@jax_head"]
    for row in (spec, committed):
        assert golden.check_against_jax(row)["ref_seeds"] == [81.5, 227.5,
                                                              181.8]
    got = golden.check_against_jax(head)
    assert got["ref_seeds"] == [0.0, 10.0, 240.0]
    assert got["status"] == "pass"
    assert golden.check_against_jax(committed)["status"] == "FAIL"


def test_old_rows_are_unchanged():
    """The first two rows, the north star and the golden row, keep their
    keys, tree and fields."""
    fast, three = golden.JAX_PARITY[:2]
    assert [golden.row_key(r) for r in (fast, three)] == [
        "LunarLander-v2/DQN_fast_1_seed", "LunarLander-v2/DQN_3_seed"]
    assert type(fast) is type(three) is golden.GoldenSpec
    assert golden.ref_root(three) == golden.JAX_CURVES_ROOT
    assert dataclasses.astuple(three) == dataclasses.astuple(
        dataclasses.replace(
            jax_golden.SPECS[0], ref_path="LunarLander-v2/DQN_3_seed.npy",
            note=three.note))


@pytest.mark.parametrize("stem,seeds", [
    ("DQN_3_seed", (0, 10, 100)),
    ("DQN_16_seed", (0, 10, 100, 1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 12, 13,
                     14))])
def test_jax_head_rows_take_specs0s_gate(stem, seeds):
    """The golden recipe's rows against the JAX package at this commit:
    SPECS[0]'s recipe, window, slack, agg, mode and overlap gate; 3 seeds,
    or 16 distinct ones."""
    row = next(r for r in golden.JAX_PARITY
               if golden.row_key(r) == f"LunarLander-v2/{stem}@jax_head")
    want = jax_golden.SPECS[0]
    for f in ("window", "slack", "agg", "slack_mode", "overlap_gate",
              "floor", "regen"):
        assert getattr(row, f) == getattr(want, f), f
    assert row.regen_seeds == seeds and len(set(seeds)) == len(seeds)
    assert row.ref_path == f"LunarLander-v2/{stem}.npy" and row.smooth
    assert golden.ref_root(row) == golden.JAX_HEAD_ROOT


@pytest.mark.parametrize("stem", ["DQN_3_seed", "DQN_16_seed"])
def test_jax_head_stacks_are_the_jax_packages_smoothing(stem):
    """The committed JAX-at-HEAD stacks are the JAX package's own
    ``aggregate_seeds`` of the committed seed curves, in the row's seed
    order, and the provenance names the CPU and every seed's command."""
    import json

    from freerl_tpu.train.plotting import aggregate_seeds

    root = os.path.join(golden.JAX_HEAD_ROOT, "LunarLander-v2")
    with open(os.path.join(root, "provenance.json")) as f:
        prov = json.load(f)
    rec = prov["stacks"][stem]
    curves = [np.load(os.path.join(root, "seeds", n)) for n in rec["files"]]
    want, _, _ = aggregate_seeds(curves)
    np.testing.assert_array_equal(np.load(os.path.join(root, stem + ".npy")),
                                  want)
    assert rec["files"] == [f"DQN_seed_{s}.npy" for s in rec["seeds"]]
    for name in rec["files"]:
        seed = prov["seeds"][name]
        assert seed["device"] == "cpu" and seed["env_steps"] > 0
        assert seed["command"].startswith("JAX_PLATFORMS=cpu python -m "
                                          "freerl_tpu.cli --algo DQN")


def test_jax_head_3_seed_stack_fails_the_committed_gate(monkeypatch):
    """Rule (a) of C9: the JAX package at this commit, in the port's place,
    misses SPECS[0]'s gate against the committed TPU curve, by the port's
    ``check`` and by the JAX package's own."""
    monkeypatch.setattr(golden, "OURS_ROOT", golden.JAX_HEAD_ROOT)
    got = golden.check_against_jax(golden.JAX_PARITY[1])
    assert got["status"] == "FAIL", got
    assert got["ref"] - golden.JAX_PARITY[1].slack > got["ours"]
    monkeypatch.setattr(jax_golden, "OURS_ROOT", golden.JAX_HEAD_ROOT)
    monkeypatch.setattr(jax_golden, "REF_ROOT", golden.JAX_CURVES_ROOT)
    spec = dataclasses.replace(jax_golden.SPECS[0],
                               ref_path="LunarLander-v2/DQN_3_seed.npy",
                               note=golden.JAX_PARITY[1].note)
    assert jax_golden.check(spec) == got


@pytest.mark.parametrize("held", ["open_fault", "stale_reference",
                                  "underpowered", "underpowered_file",
                                  "none", "not_comparable", "missing"])
def test_rows_held_to_fail(held, tmp_path, monkeypatch):
    """A row under an open fault or a stale reference, or whose gate, not
    the port, misses (shown by a row or by a file) must read FAIL:
    ``must_fail`` names it, and ``chip_smoke.py``'s ``golden vs jax``
    passes while it fails and fails the phase once it passes; a row held
    to nothing fails the phase when it fails; a row of ``NOT_COMPARABLE``
    passes the phase whatever it reads; a row whose curve is absent fails
    the phase."""
    import chip_smoke

    for root, means, seed in (("ours", [90, 110, 100], 1),
                              ("jax", [81.5, 227.5, 181.8], 2)):
        os.makedirs(tmp_path / root / "Env-v0")
        np.save(tmp_path / root / "Env-v0" / "X_3_seed.npy",
                _seeds(means, seed=seed))
    monkeypatch.setattr(golden, "OURS_ROOT", str(tmp_path / "ours"))
    monkeypatch.setattr(golden, "JAX_CURVES_ROOT", str(tmp_path / "jax"))
    row = golden.GoldenSpec("Env-v0", "X_3_seed", "Env-v0/X_3_seed.npy",
                            slack=50.0)
    monkeypatch.setattr(golden, "JAX_PARITY", [row])
    monkeypatch.setattr(golden, "SCALAR_GATES", [])
    monkeypatch.setattr(golden, "OPEN_FAULTS", {})
    monkeypatch.setattr(golden, "STALE_REFERENCES", {})
    monkeypatch.setattr(golden, "UNDERPOWERED", {})
    monkeypatch.setattr(golden, "NOT_COMPARABLE", {})
    if held == "open_fault":
        golden.OPEN_FAULTS["Env-v0/X_3_seed"] = "C99"
    elif held == "stale_reference":
        golden.STALE_REFERENCES["Env-v0/X_3_seed"] = "Env-v0/evidence.json"
    elif held == "underpowered":
        golden.UNDERPOWERED["Env-v0/X_3_seed"] = "Env-v0/X_48_seed"
    elif held == "underpowered_file":
        golden.UNDERPOWERED["Env-v0/X_3_seed"] = "Env-v0/greedy.json"
    elif held == "not_comparable":
        golden.NOT_COMPARABLE["Env-v0/X_3_seed"] = "starts differ"
    elif held == "missing":
        os.remove(tmp_path / "ours" / "Env-v0" / "X_3_seed.npy")
        assert golden.check_against_jax(row)["status"] == "missing"
        with pytest.raises(AssertionError):
            chip_smoke.phase_golden_vs_jax()
        return
    assert golden.check_against_jax(row)["status"] == "FAIL"
    assert golden.must_fail("Env-v0/X_3_seed") == (
        held in ("open_fault", "stale_reference", "underpowered",
                 "underpowered_file"))
    if held == "none":
        with pytest.raises(AssertionError):
            chip_smoke.phase_golden_vs_jax()
        return
    chip_smoke.phase_golden_vs_jax()
    np.save(tmp_path / "ours" / "Env-v0" / "X_3_seed.npy",
            _seeds([150, 170, 160], seed=3))
    assert golden.check_against_jax(row)["status"] == "pass"
    if held == "not_comparable":
        chip_smoke.phase_golden_vs_jax()
        return
    with pytest.raises(AssertionError):
        chip_smoke.phase_golden_vs_jax()
