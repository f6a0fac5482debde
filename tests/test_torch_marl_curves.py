"""``scripts/torch_marl_curves.py`` against the JAX package's
``scripts/marl_curves.py``: the same table, the same CLI argv (read by
running a copy of the JAX script with its CLI stubbed, so nothing is written
into ``results/learning_curves/``), each algo's two parity rows with the
gate of the JAX ``SPECS`` row of its stem, and the curve both CLIs save for
a multi-agent run, stacked as the JAX package's committed MARL curves."""
import dataclasses
import hashlib
import importlib.util
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import freerl_tpu.cli
from freerl_tpu.train import golden as jax_golden
from freerl_tpu_torch.train import golden
from scripts import marl_curves as jax_marl
from scripts import torch_golden_card as card
from scripts import torch_marl_curves as marl

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE = ("window", "agg", "slack_mode", "overlap_gate", "floor")
# each row's (slack, floor, committed JAX final-50): the SPECS row's gate,
# with the slack fixed where SPECS gives the stem no reference curve
TABLE = {"MATD3": (5.0, -25.0, -18.7), "HAPPO": (5.0, -25.0, -21.2),
         "MAT": (8.0, -28.0, -23.5), "IPPO": (2.4, -22.0, -2.7),
         "MAAC": (5.0, -20.0, -16.6), "RMAPPO": (8.0, -28.0, -24.1)}


def test_runs_are_the_jax_scripts():
    assert golden.MARL_RUNS == jax_marl.RUNS
    assert marl.RUNS is golden.MARL_RUNS
    assert list(golden.MARL_RUNS) == list(TABLE)


def _digest(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def jax_argvs(tmp_path_factory):
    """Every argv the JAX script passes its CLI, by algo: a copy of the
    script, in a temporary repo root, run with a stub CLI that saves a
    short ``(episodes, n_agents)`` curve."""
    tmp = tmp_path_factory.mktemp("marl")
    os.makedirs(tmp / "scripts")
    shutil.copy(jax_marl.__file__, tmp / "scripts" / "marl_curves.py")
    spec = importlib.util.spec_from_file_location(
        "_marl_copy", tmp / "scripts" / "marl_curves.py")
    copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy)
    seen = {}

    def stub(argv):
        seen[argv[1]] = list(argv)
        run_dir = tmp / "runs" / argv[1]
        os.makedirs(run_dir, exist_ok=True)
        np.save(run_dir / f"{argv[1]}_seed_0.npy", np.zeros((4, 3)))
        return str(run_dir)

    before = _digest(os.path.join(ROOT, "results", "learning_curves"))
    mp = pytest.MonkeyPatch()
    mp.setattr(freerl_tpu.cli, "run", stub)
    mp.setattr(sys, "argv", ["marl_curves.py", "--results_root", "R"])
    try:
        assert copy.main() == 0
    finally:
        mp.undo()
    # the JAX script's copy wrote into its own root only
    assert _digest(os.path.join(ROOT, "results", "learning_curves")) == \
        before
    assert os.path.isfile(tmp / "results" / "learning_curves" /
                          "simple_adversary_v3" / "IPPO_1_seed.npy")
    return seen


@pytest.mark.parametrize("algo", list(TABLE))
def test_argv_is_the_jax_scripts(algo, jax_argvs):
    assert golden.marl_argv(algo, 0, "R") == jax_argvs[algo]
    argv = golden.marl_argv(algo, 0)
    assert "--fixed_reset" not in argv and "--updates_per_burst" not in argv


@pytest.mark.parametrize("algo", list(TABLE))
def test_rows_take_the_jax_gate(algo):
    """Both rows of an algo: the stem the JAX script writes, seed 0, its
    argv (with ``{seed}``), a raw stack, and the gate of the JAX SPECS row
    of the stem, with the slack of ``TABLE``."""
    env_name = golden.MARL_RUNS[algo][0]
    stem = f"{algo}_1_seed"
    want = next(s for s in jax_golden.SPECS if (s.env, s.algo) ==
                (env_name, stem))
    rows = [r for r in golden.JAX_PARITY if (r.env, r.algo) ==
            (env_name, stem)]
    assert [r.ref for r in rows] == ["committed", "jax_head"]
    slack, floor, _ = TABLE[algo]
    for row in rows:
        assert [getattr(row, f) for f in GATE] == [
            getattr(want, f) for f in GATE]
        assert (row.slack, row.floor) == (slack, floor)
        if want.ref_path:
            assert row.slack == want.slack
        assert row.regen_seeds == (0,) and not row.smooth
        assert row.ref_path == f"{env_name}/{stem}.npy" and not row.pending
        assert [a.format(seed=0) for a in row.regen] == golden.marl_argv(
            algo, 0)
        assert stem in row.note
    assert golden.row_key(rows[1]) == golden.row_key(rows[0]) + "@jax_head"


def test_rows_read_the_committed_jax_curves():
    """The committed-reference rows read the curves the JAX script wrote,
    one run each (final-50 as committed)."""
    got = {r.algo.removesuffix("_1_seed"):
           golden.check_against_jax(r)["ref_seeds"]
           for r in golden.JAX_PARITY
           if getattr(r, "ref", "committed") == "committed"
           and r.note.startswith("marl_curves ")}
    assert got == {a: [v[2]] for a, v in TABLE.items()}


@pytest.mark.parametrize("algo", list(TABLE))
def test_committed_and_jax_head_first_episodes_agree(algo):
    """The JAX package's committed curve of an algo and its rerun at this
    commit, stacked as the port stacks it (the per-agent mean of the
    CLI's ``(episodes, n_agents)`` curve), begin with the same ten
    episodes, bit for bit: the committed file holds that quantity in that
    layout, one row a run."""
    committed, head = golden.marl_rows(algo)
    stack = np.load(os.path.join(golden.JAX_CURVES_ROOT, committed.env,
                                 committed.algo + ".npy"))
    rerun = np.load(os.path.join(golden.JAX_HEAD_ROOT, head.env,
                                 head.algo + ".npy"))
    seed = np.load(golden.seed_file(golden.JAX_HEAD_ROOT, head, 0))
    assert stack.shape == rerun.shape == (1, golden.MARL_RUNS[algo][1])
    assert seed.ndim == 2 and seed.shape[0] == stack.shape[1]
    np.testing.assert_array_equal(rerun[0], seed.mean(axis=1))
    np.testing.assert_array_equal(rerun[:, :10], stack[:, :10])


def test_both_clis_save_one_curve_layout(tmp_path):
    """MATD3 at 8 episodes from one seed through the JAX package's CLI and
    the port's, on the CPU: one ``(episodes, n_agents)`` curve each, of the
    same shape and episode count, which ``golden.stack_curves`` stacks
    raw as one row of per-agent means."""
    from freerl_tpu_torch import cli

    argv = golden.marl_argv("MATD3", 0)
    argv[argv.index("--max_episodes") + 1] = "8"
    curves = []
    for name, run in (("jax", freerl_tpu.cli.run), ("port", cli.run)):
        extra = ["--device", "cpu"] if name == "port" else []
        run_dir = run(argv + ["--results_root", str(tmp_path / name),
                              "--no_tensorboard"] + extra)
        curves.append(np.load(os.path.join(run_dir, "MATD3_seed_0.npy")))
    jax_curve, port_curve = curves
    assert jax_curve.shape == port_curve.shape == (8, 3)
    assert np.isfinite(port_curve).all()
    row = golden.marl_rows("MATD3")[0]
    path = golden.stack_curves(row, [port_curve], str(tmp_path / "stack"))
    stack = np.load(path)
    assert os.path.basename(path) == "MATD3_1_seed.npy"
    np.testing.assert_array_equal(stack, port_curve.mean(axis=1)[None])


def test_unknown_algos_are_refused():
    assert marl.row_keys(["MAAC"]) == ["simple_spread_v3/MAAC_1_seed"]
    with pytest.raises(KeyError):
        marl.row_keys(["QMIX"])


def test_cpu_run_writes_only_under_its_root(tmp_path, monkeypatch, capsys):
    """HAPPO's one seed on the CPU, cut to 3 episodes, through the script
    and the card runner: the seed kept and stacked raw under the results
    root it is given, every row printed, and nothing written into the JAX
    package's curves or the port's committed tree."""
    monkeypatch.setattr(golden, "OURS_ROOT", str(tmp_path / "curves"))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the CLI child's threads
    row = golden.marl_rows("HAPPO")[0]
    tiny = list(row.regen)
    tiny[tiny.index("--max_episodes") + 1] = "3"
    monkeypatch.setattr(golden, "JAX_PARITY", [
        dataclasses.replace(r, regen=tuple(tiny))
        if r.algo == "HAPPO_1_seed" else r for r in golden.JAX_PARITY])
    trees = [os.path.join(ROOT, "results", "learning_curves"),
             os.path.join(ROOT, "results", "torch")]
    before = [_digest(t) for t in trees]
    rc = marl.main(["--only", "HAPPO", "--device", "cpu", "--results_root",
                    str(tmp_path / "runs"), "--log_dir",
                    str(tmp_path / "l")])
    out = capsys.readouterr().out
    assert [_digest(t) for t in trees] == before
    stack = np.load(tmp_path / "curves" / "simple_spread_v3" /
                    "HAPPO_1_seed.npy")
    kept = np.load(tmp_path / "curves" / "simple_spread_v3" / "seeds" /
                   "HAPPO_seed_0.npy")
    assert kept.shape == (3, 3)
    np.testing.assert_array_equal(stack, kept.mean(axis=1)[None])
    assert os.path.isfile(tmp_path / "l" / "curves" / "simple_spread_v3" /
                          "HAPPO_1_seed.npy")
    assert "simple_spread_v3/HAPPO_1_seed@jax_head" in out
    assert card.parity_row("simple_spread_v3/HAPPO_1_seed").regen == tuple(
        tiny)
    assert rc in (0, 1)        # a 3-episode curve may miss the gate
