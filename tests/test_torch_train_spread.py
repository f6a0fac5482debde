"""``scripts/torch_train_spread.py`` against the JAX package's
``scripts/train_spread.py``: the run's table, the CLI argv that builds the
algorithm config and the ``MARLConfig`` the JAX script builds (read by
running a copy of the JAX script with its ``train_marl`` stubbed, so
nothing is written into ``results/learning_curves/``),
``golden.bin_curve`` against the committed 40,000-episode curve and its
600-point stack, the two parity rows and their gate, and the script on
the CPU."""
import dataclasses
import hashlib
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import freerl_tpu.train.marl
import freerl_tpu_torch.train
from freerl_tpu.train import golden as jax_golden
from freerl_tpu_torch import cli
from freerl_tpu_torch.train import golden
from scripts import torch_golden_card as card
from scripts import torch_jax_head as head
from scripts import torch_train_spread as spread
from scripts import train_spread as jax_spread

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = "simple_spread_v3"
KEY = f"{ENV}/MASAC_40k_1_seed"


def _digest(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


class _Built(Exception):
    pass


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """What the JAX script builds at its defaults: a copy of the script, in
    a temporary repo root, run with its ``train_marl`` stubbed (it records
    the env, the algo and the ``MARLConfig`` and returns a short
    ``(episodes, n_agents)`` curve), and the files the copy wrote under its
    ``--out``."""
    tmp = tmp_path_factory.mktemp("spread")
    os.makedirs(tmp / "scripts")
    shutil.copy(jax_spread.__file__, tmp / "scripts" / "train_spread.py")
    spec = importlib.util.spec_from_file_location(
        "_spread_copy", tmp / "scripts" / "train_spread.py")
    copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy)
    seen = {}

    def stub(env, algo, cfg, on_chunk=None):
        seen.update(env=env, algo=algo, cfg=cfg)
        return None, np.zeros((8, env.n_agents), np.float32), {}

    trees = [os.path.join(ROOT, "results")]
    before = [_digest(t) for t in trees]
    mp = pytest.MonkeyPatch()
    mp.setattr(freerl_tpu.train.marl, "train_marl", stub)
    mp.setattr(sys, "argv", ["train_spread.py", "--out", str(tmp / "out")])
    try:
        copy.main()
    finally:
        mp.undo()
    # the JAX script's copy wrote into its own root only
    assert [_digest(t) for t in trees] == before
    seen["files"] = sorted(_digest(tmp / "out"))
    return seen


def _port_built(argv, tmp_path):
    """The env, algo and ``MARLConfig`` the port's CLI builds from
    ``argv`` on the CPU, its ``train_marl`` stopped before training."""
    seen = {}

    def stub(env, algo, cfg, on_chunk=None):
        seen.update(env=env, algo=algo, cfg=cfg)
        raise _Built()

    mp = pytest.MonkeyPatch()
    mp.setattr(freerl_tpu_torch.train, "train_marl", stub)
    try:
        with pytest.raises(_Built):
            cli.run(argv + ["--results_root", str(tmp_path), "--device",
                            "cpu", "--no_tensorboard"])
    finally:
        mp.undo()
    return seen


def test_runs_are_the_jax_scripts(jax_run):
    """``SPREAD_RUNS`` is the JAX script's run at its defaults: MASAC on
    simple_spread_v3, 40,000 episodes, seed 0, 16 envs, chunk 128, one
    learner step a vector step; the copy saved its raw curve and its
    smoothed stack under its ``--out``."""
    assert spread.RUNS is golden.SPREAD_RUNS
    assert list(golden.SPREAD_RUNS) == ["MASAC_40k"]
    algo, env_name, episodes, seed, envs, chunk, upb = \
        golden.SPREAD_RUNS["MASAC_40k"]
    cfg = jax_run["cfg"]
    assert type(jax_run["algo"]).__name__ == algo == "MASAC"
    assert (env_name, episodes, seed, envs, chunk, upb) == (
        ENV, 40_000, 0, 16, 128, 1)
    assert (cfg.max_episodes, cfg.seed, cfg.num_envs, cfg.chunk_size,
            cfg.updates_per_burst) == (episodes, seed, envs, chunk, upb)
    assert jax_run["files"] == [f"{ENV}/MASAC_1_seed.npy",
                                f"{ENV}/MASAC_1_seed.png",
                                f"{ENV}/MASAC_seed_0.npy"]


def test_argv_builds_the_jax_scripts_configs(jax_run, tmp_path):
    """The port's CLI, given ``spread_argv``, builds the algorithm config
    and the ``MARLConfig`` the JAX script builds, field by field (batch
    256, replay 1e6, the three lrs 1e-4, 16 envs, chunk 128, one update a
    vector step), on the env the script makes: three agents, random
    resets."""
    argv = golden.spread_argv("MASAC_40k", 0)
    got = _port_built(argv, tmp_path)
    want_algo = dataclasses.asdict(jax_run["algo"].cfg)
    assert dataclasses.asdict(got["algo"].cfg) == want_algo
    assert dataclasses.asdict(got["cfg"]) == dataclasses.asdict(
        jax_run["cfg"])
    assert (want_algo["batch_size"], want_algo["buffer_size"],
            want_algo["actor_lr"], want_algo["critic_lr"],
            want_algo["alpha_lr"], want_algo["num_envs"]) == (
        256, 1_000_000, 1e-4, 1e-4, 1e-4, 16)
    assert type(got["algo"]).__name__ == "MASAC"
    assert got["env"].n_agents == jax_run["env"].n_agents == 3
    assert "--fixed_reset" not in argv
    assert not hasattr(got["env"], "_reset_draw")
    assert golden.spread_argv("MASAC_40k", 0, "R") == argv[:10] + [
        "--results_root", "R", "--no_tensorboard"] + argv[10:]


def test_bin_curve_is_the_committed_binning():
    """``bin_curve`` of the committed raw 40,000-episode run is the
    committed 600-point stack, bit for bit; the bins hold 66 or 67
    episodes, and the gate's final-50 of the bins is not the raw
    final-50."""
    raw = np.load(os.path.join(golden.JAX_CURVES_ROOT, ENV,
                               "MASAC_seed_0.npy"))
    stack = np.load(os.path.join(golden.JAX_CURVES_ROOT, ENV,
                                 "MASAC_40k_1_seed.npy"))
    assert raw.shape == (40_000, 3) and stack.shape == (1, 600)
    binned = golden.bin_curve(raw)
    assert binned.dtype == stack.dtype
    np.testing.assert_array_equal(binned, stack[0])
    edges = np.linspace(0, 40_000, 601).astype(int)
    assert set(np.diff(edges)) == {66, 67}
    assert round(float(stack[0, -50:].mean()), 3) == -7.571
    assert round(float(raw[-50:].mean()), 2) == -7.72
    np.testing.assert_array_equal(golden.bin_curve(np.arange(10.0), 3),
                                  [1.0, 4.0, 7.5])


@pytest.mark.parametrize("ref", ["committed", "jax_head"])
def test_rows_take_the_gate(ref):
    """Both rows: the JAX SPECS row's stem and window (50 of the 600
    bins), slack 2.8 (the bar against the committed stack -10.37, the
    FreeRL reference's -10.4 that the SPECS row holds the JAX package
    to), the recipe ``spread_argv`` with ``{seed}``, seed 0, the binned
    stack, no reference-tree paths."""
    want = next(s for s in jax_golden.SPECS if (s.env, s.algo) ==
                (ENV, "MASAC_40k_1_seed"))
    row = next(r for r in golden.JAX_PARITY if golden.row_key(r) == (
        KEY if ref == "committed" else f"{KEY}@jax_head"))
    assert row == golden.spread_rows("MASAC_40k")[
        ["committed", "jax_head"].index(ref)]
    assert (row.window, row.agg, row.slack_mode, row.overlap_gate,
            row.floor) == (want.window, want.agg, want.slack_mode,
                           want.overlap_gate, want.floor)
    assert (row.window, row.slack, row.bins) == (50, 2.8, 600)
    assert row.regen == tuple(golden.spread_argv("MASAC_40k", "{seed}"))
    assert row.regen_seeds == (0,) and not row.smooth
    assert row.ref_paths == () and not row.pending
    assert row.ref_path == f"{ENV}/MASAC_40k_1_seed.npy"
    if ref == "committed":
        bar = golden.check_against_jax(row)["ref"] - row.slack
        assert round(bar, 2) == -10.37
    assert golden.seed_file("", row, 0) == os.path.join(
        ENV, "seeds", "MASAC_40k_seed_0.npy")


def test_jax_head_runs_the_recipe_through_the_jax_cli():
    """``scripts/torch_jax_head.py`` takes the ``@jax_head`` row: its
    command is the JAX package's CLI with the recipe."""
    row = head.head_row(f"{KEY}@jax_head")
    argv = head.jax_argv(row, 0, "W")
    assert argv[1:3] == ["-m", "freerl_tpu.cli"]
    assert golden.recipe_of(" ".join(["python", *argv[1:]])) == \
        golden.spread_argv("MASAC_40k", 0)


def test_unknown_tags_are_refused():
    assert spread.row_keys(["MASAC_40k"]) == [KEY]
    with pytest.raises(KeyError):
        spread.row_keys(["MADDPG_40k"])
    with pytest.raises(KeyError):
        spread.main(["--probe", "4", "--only", "MADDPG_40k", "--device",
                     "cpu"])


def _tiny(monkeypatch):
    """The run cut for the CPU: 10 episodes of 4 envs, a replay of 4,096,
    and random actions all through (``--start_steps`` past the run: the
    learner is ``chip_smoke.spread_recipe``'s to drive)."""
    monkeypatch.setitem(golden.SPREAD_RUNS, "MASAC_40k",
                        ("MASAC", ENV, 10, 0, 4, 128, 1))
    monkeypatch.setattr(golden, "SPREAD_CONFIG_ARGV",
                        ["--batch_size", "32", "--buffer_size", "4096",
                         "--start_steps", "1000000"])
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the CLI child's threads


def test_probe_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``--probe``: seed 0 for a few episodes, its speed and the seconds a
    seed of the table's episodes it projects; its run dir under
    ``--runs_root`` and no curve kept under the port's tree."""
    _tiny(monkeypatch)
    tree = os.path.join(ROOT, "results")
    before = _digest(tree)
    rc = spread.main(["--probe", "4", "--device", "cpu", "--log_dir",
                      str(tmp_path / "l"), "--runs_root",
                      str(tmp_path / "runs")])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert rc == 0 and _digest(tree) == before
    rec, tail = lines
    assert rec["tag"] == "MASAC_40k" and rec["rc"] == 0
    assert rec["episodes"] >= 4 and rec["b1_launches"] == 0
    # the table's episodes (10, cut) at the probe's rate, plus start-up
    assert rec["s_per_episode"] > 0 and abs(rec["projected_s_a_seed"] - (
        10 * rec["s_per_episode"] + rec["seconds"] - rec["loop_s"])) < 0.2
    assert os.listdir(tmp_path / "runs") == [ENV]
    assert tail["card"] is None and tail["left_running"] == {}


def test_cpu_run_writes_only_under_its_root(tmp_path, monkeypatch, capsys):
    """The run on the CPU, cut (4 envs, 8 bins), through the script and the
    card runner: the raw ``(episodes, 3)`` curve kept as the row's seed,
    its ``bin_curve`` stacked beside it under the results root it is
    given, every row printed, and nothing written into the JAX package's
    curves or the port's committed tree."""
    _tiny(monkeypatch)
    monkeypatch.setattr(golden, "OURS_ROOT", str(tmp_path / "curves"))
    tiny = tuple(golden.spread_argv("MASAC_40k", "{seed}"))
    monkeypatch.setattr(golden, "JAX_PARITY", [
        dataclasses.replace(r, regen=tiny, bins=8)
        if r.algo == "MASAC_40k_1_seed" else r for r in golden.JAX_PARITY])
    tree = os.path.join(ROOT, "results")
    before = _digest(tree)
    rc = spread.main(["--device", "cpu", "--results_root",
                      str(tmp_path / "runs"), "--log_dir",
                      str(tmp_path / "l")])
    out = capsys.readouterr().out
    assert _digest(tree) == before
    kept = np.load(tmp_path / "curves" / ENV / "seeds" /
                   "MASAC_40k_seed_0.npy")
    assert kept.ndim == 2 and kept.shape[1] == 3 and len(kept) >= 10
    stack = np.load(tmp_path / "curves" / ENV / "MASAC_40k_1_seed.npy")
    np.testing.assert_array_equal(stack, golden.bin_curve(kept, 8)[None])
    with open(tmp_path / "curves" / ENV / "provenance.json") as f:
        prov = json.load(f)
    assert prov["stacks"]["MASAC_40k_1_seed"]["bins"] == 8
    assert prov["seeds"]["MASAC_40k_seed_0.npy"]["b1_launches"] == 0
    assert os.path.isfile(tmp_path / "l" / "curves" / ENV /
                          "MASAC_40k_1_seed.npy")
    assert f"{KEY}@jax_head" in out
    assert card.parity_row(KEY).regen == tiny
    assert rc in (0, 1)        # a 10-episode curve may miss the gate


def test_n3_spread_rows_have_no_recipe():
    """The JAX package's N=3 spread curves with no recipe in SPECS or a log
    (``MADDPG_1_seed``, ``MAPPO_1_seed``, ``MASAC_1_seed``): no candidate
    that ``scripts/torch_spread_search.py`` ran with the JAX package at
    this commit gives the committed stack's first episodes, so none of the
    three is a row. The JSON was made at the script's constants."""
    from scripts import torch_spread_search as search

    with open(os.path.join(ROOT, "results", "torch",
                           "spread_search.json")) as f:
        found = json.load(f)
    assert (found["episodes"], found["first"]) == (search.EPISODES,
                                                   search.FIRST)
    tried = {(c["algo"], c["candidate"]) for c in found["candidates"]}
    assert tried == {(a, c) for a in ("MADDPG", "MAPPO", "MASAC")
                     for c in ("cli", "cli_fixed_reset", "train_spread")
                     } - {("MAPPO", "train_spread")}
    for c in found["candidates"]:
        committed = np.load(os.path.join(golden.JAX_CURVES_ROOT, ENV,
                                         f"{c['algo']}_1_seed.npy"))[0]
        assert c["committed_first"] == [float(x) for x in committed[:3]]
        assert not c["recipe"] and c["equal_of_first"] == 0
        assert f"{ENV}/{c['algo']}_1_seed" not in {
            golden.row_key(r) for r in golden.JAX_PARITY}


def test_jax_head_seed_is_the_jax_scripts_run():
    """JAX at this commit ran the recipe's CLI argv on the CPU for 40,000
    episodes: its first episodes are the committed raw run's within 0.006
    (the committed run is a TPU's, whose matmuls round otherwise; two
    seeds part by whole units), its smoothed first episodes are the JAX
    script's own run's (``spread_search.json``: ``train_spread.py --algo
    MASAC``) bit for bit, and its stack is the seed's ``bin_curve``."""
    from freerl_tpu_torch.train.plotting import exp_smooth

    row = golden.spread_rows("MASAC_40k")[1]
    seed = np.load(golden.seed_file(golden.JAX_HEAD_ROOT, row, 0))
    raw = np.load(os.path.join(golden.JAX_CURVES_ROOT, ENV,
                               "MASAC_seed_0.npy"))
    assert seed.shape == raw.shape == (40_000, 3)
    np.testing.assert_allclose(seed[:16], raw[:16], rtol=0, atol=0.006)
    with open(os.path.join(ROOT, "results", "torch",
                           "spread_search.json")) as f:
        script = next(c for c in json.load(f)["candidates"]
                      if c["algo"] == "MASAC"
                      and c["candidate"] == "train_spread")
    assert [float(x) for x in exp_smooth(seed.mean(1))[:3]] == \
        script["first"]
    stack = np.load(os.path.join(golden.JAX_HEAD_ROOT, row.ref_path))
    np.testing.assert_array_equal(stack, golden.bin_curve(seed)[None])
    with open(os.path.join(golden.JAX_HEAD_ROOT, ENV,
                           "provenance.json")) as f:
        prov = json.load(f)
    rec = prov["seeds"]["MASAC_40k_seed_0.npy"]
    assert golden.recipe_of(rec["command"]) == golden.spread_argv(
        "MASAC_40k", 0) and rec["device"] == "cpu"
    assert prov["stacks"][row.algo]["bins"] == 600
    assert golden.kept_seed(golden.JAX_HEAD_ROOT, row, 0)


def test_port_run_is_kept_raw_and_binned():
    """The port's 40,000-episode run on the card: its raw ``(40000, 3)``
    curve kept as the row's seed, made by the recipe with no sum-tree
    launch, and the committed stack its ``bin_curve``; both rows pass."""
    row = golden.spread_rows("MASAC_40k")[0]
    seed = np.load(golden.seed_file(golden.OURS_ROOT, row, 0))
    assert seed.shape == (40_000, 3) and np.isfinite(seed).all()
    stack = np.load(os.path.join(golden.OURS_ROOT, row.ref_path))
    np.testing.assert_array_equal(stack, golden.bin_curve(seed)[None])
    with open(os.path.join(golden.OURS_ROOT, ENV, "provenance.json")) as f:
        rec = json.load(f)["seeds"]["MASAC_40k_seed_0.npy"]
    assert golden.recipe_of(rec["command"]) == golden.spread_argv(
        "MASAC_40k", 0)
    assert rec["b1_launches"] == 0 and "H100" in rec["card"]
    assert rec["episodes"] >= 40_000
    for r in golden.spread_rows("MASAC_40k"):
        assert golden.check_against_jax(r)["status"] == "pass"


def test_chip_smoke_spread_recipe_on_the_cpu():
    """``chip_smoke.py``'s cut of the run on the CPU: the script's config
    built by the CLI, 3 chunks of 16 envs with a learner step on every
    vector step past ``start_steps``, a finite ``(episodes, 3)`` record,
    its bin means, no sum-tree launch."""
    import chip_smoke

    got = chip_smoke.spread_recipe("MASAC_40k", "cpu")
    assert got["launches"] == 0 and "353 updates, record (240, 3)" in \
        got["line"]
