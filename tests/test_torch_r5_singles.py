"""``scripts/torch_r5_singles.py`` against the JAX package's
``scripts/r5_singles.py``: the same table, the same CLI argv for every seed
(read by running a copy of the JAX script with its CLI stubbed, so nothing
is written into ``results/learning_curves/``), and each tag's two parity
rows with the gate of the JAX ``SPECS`` row of its stem."""
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

import freerl_tpu.cli
from freerl_tpu.train import golden as jax_golden
from freerl_tpu_torch.train import golden
from scripts import r5_singles as jax_r5
from scripts import torch_golden_card as card
from scripts import torch_r5_singles as r5

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE = ("window", "slack", "agg", "slack_mode", "overlap_gate", "floor")
TAGS = [t for t in r5.RUNS if t not in golden.R5_LATER]


def test_runs_are_the_jax_scripts():
    assert r5.RUNS == jax_r5.RUNS
    assert golden.R5_LATER == ("PPO_BipedalWalker",)


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
    """Every argv the JAX script passes its CLI, by (tag, seed): a copy of
    the script, in a temporary repo root, run with ``--force`` and a stub
    CLI that saves a short curve."""
    tmp = tmp_path_factory.mktemp("r5")
    os.makedirs(tmp / "scripts")
    shutil.copy(jax_r5.__file__, tmp / "scripts" / "r5_singles.py")
    spec = importlib.util.spec_from_file_location(
        "_r5_copy", tmp / "scripts" / "r5_singles.py")
    copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy)
    seen = {}

    def stub(argv):
        tag = next(t for t, (a, e, *_ ) in copy.RUNS.items()
                   if [a, e] == [argv[1], argv[3]])
        seed = int(argv[argv.index("--seed") + 1])
        seen[(tag, seed)] = list(argv)
        run_dir = tmp / "runs" / f"{tag}_{seed}"
        os.makedirs(run_dir, exist_ok=True)
        np.save(run_dir / f"{argv[1]}_seed_{seed}.npy", np.zeros(4))
        return str(run_dir)

    before = _digest(os.path.join(ROOT, "results", "learning_curves"))
    mp = pytest.MonkeyPatch()
    mp.setattr(freerl_tpu.cli, "run", stub)
    mp.setattr(sys, "argv", ["r5_singles.py", "--force", "--results_root",
                             "R"])
    try:
        assert copy.main() == 0
    finally:
        mp.undo()
    # C6: the JAX script's copy wrote into its own root only
    assert _digest(os.path.join(ROOT, "results", "learning_curves")) == \
        before
    assert os.path.isfile(tmp / "results" / "learning_curves" /
                          "Taxi-v3" / "DQN_1_seed.npy")
    return seen


@pytest.mark.parametrize("tag", list(r5.RUNS))
def test_argv_is_the_jax_scripts(tag, jax_argvs):
    for seed in r5.RUNS[tag][3]:
        assert golden.r5_argv(tag, seed, 8, "R") == jax_argvs[(tag, seed)]


@pytest.mark.parametrize("tag", TAGS)
def test_rows_take_the_jax_gate(tag):
    """Both rows of a tag: the stem the JAX script writes, its seeds and
    argv (with ``{seed}``), raw stacks, and the gate of the JAX SPECS row
    of the stem (DDPG_discrete's 3-draw and FrozenLake's 10-seed rows where
    the script writes another stem, both named in the note)."""
    algo, env_name, stem, seeds, _ = r5.RUNS[tag]
    ours = f"{stem}_{len(seeds)}_seed"
    gate = {"DDPG_discrete_CartPole": "DDPG_discrete_3_seed",
            "DQN_FrozenLake": "DQN_10_seed"}.get(tag, ours)
    want = next(s for s in jax_golden.SPECS if (s.env, s.algo) ==
                (env_name, gate))
    rows = [r for r in golden.JAX_PARITY if (r.env, r.algo) ==
            (env_name, ours)]
    assert [r.ref for r in rows] == ["committed", "jax_head"]
    for row in rows:
        assert [getattr(row, f) for f in GATE] == [
            getattr(want, f) for f in GATE]
        assert row.regen_seeds == seeds and not row.smooth
        assert row.ref_path == f"{env_name}/{ours}.npy" and not row.pending
        argv = golden.r5_argv(tag, 7, 8, "R")
        i = argv.index("--results_root")
        assert [a.format(seed=7) for a in row.regen] == argv[:i] + argv[
            i + 3:]
        assert gate in row.note and ours in row.note
    assert golden.row_key(rows[1]) == golden.row_key(rows[0]) + "@jax_head"


def test_rows_read_the_committed_jax_stacks():
    """The committed-reference rows read the stacks the JAX script wrote
    (final-50 as committed); the walker's tag has no row."""
    got = {golden.row_key(r): golden.check_against_jax(r)["ref_seeds"]
           for r in golden.JAX_PARITY
           if getattr(r, "ref", "committed") == "committed"
           and r.note.startswith("r5 ")}
    assert got["Taxi-v3/DQN_1_seed"] == [-261.4]
    assert got["Pendulum-v1/DDPG_simple_3_seed"] == [-232.1, -242.0,
                                                     -126.9]
    assert got["CartPole-v1/DDPG_discrete_1_seed"] == [205.9]
    assert len(got) == len(TAGS)
    assert not any(r.env == "BipedalWalker-v3" for r in golden.JAX_PARITY)


def test_jobs_skip_and_force(tmp_path, monkeypatch):
    """A tag is the row its seeds run for; the card runner makes one job a
    seed, the port's CLI on the JAX script's argv, and none for a seed
    kept already unless it is forced; the walker's tag is refused."""
    monkeypatch.setattr(golden, "OURS_ROOT", str(tmp_path))
    keys = r5.row_keys(["DQN_FrozenLake"])
    assert keys == ["FrozenLake-v1/DQN_3_seed"]
    row = card.parity_row(keys[0])
    assert row == golden.r5_rows("DQN_FrozenLake")[0]
    jobs = card.make_jobs(None, keys, 1, "cuda", "R", True)
    assert [j["seed"] for j in jobs] == [0, 10, 100]
    argv = jobs[1]["argv"]
    assert argv[:3] == [sys.executable, "-m", "freerl_tpu_torch.cli"]
    assert argv[3:] == [a.format(seed=10) for a in row.regen] + [
        "--results_root", os.path.join("R", "golden_runs"),
        "--no_tensorboard", "--device", "cuda"]
    for seed in row.regen_seeds:
        path = golden.seed_file(str(tmp_path), row, seed)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, np.zeros(4))
        golden.update_provenance(str(tmp_path), row.env, seeds={
            os.path.basename(path): dict(command=" ".join(
                ["python", "-m", "freerl_tpu_torch.cli",
                 *golden.regen_argv(row, seed, "R", "cuda")]),
                start=golden.pinned_start(row, seed))})
    assert card.make_jobs(None, keys, 1, "cuda", "R", True) == []
    assert len(card.make_jobs(None, keys, 1, "cuda", "R", False)) == 3
    with pytest.raises(ValueError):
        r5.main(["--only", "PPO_BipedalWalker", "--device", "cpu"])
    with pytest.raises(KeyError):
        r5.row_keys(["DQN_Atari"])


def test_cpu_run_stacks_raw(tmp_path, monkeypatch, capsys):
    """Taxi's one seed on the CPU at 2 envs, cut to 3 episodes, through
    the script and the card runner: the seed kept, stacked raw (the JAX
    script's stack), and every row printed."""
    monkeypatch.setattr(golden, "OURS_ROOT", str(tmp_path / "curves"))
    tiny = ("--algo", "DQN", "--env_name", "Taxi-v3", "--max_episodes", "3",
            "--num_envs", "2", "--seed", "{seed}", "--fixed_reset",
            "--batch_size", "32", "--buffer_size", "4096", "--start_steps",
            "100")
    monkeypatch.setattr(golden, "JAX_PARITY", [
        dataclasses.replace(r, regen=tiny) if r.env == "Taxi-v3" else r
        for r in golden.JAX_PARITY])
    rc = r5.main(["--only", "DQN_Taxi", "--device", "cpu", "--results_root",
                  str(tmp_path / "runs"), "--log_dir", str(tmp_path / "l")])
    out = capsys.readouterr().out
    stack = np.load(tmp_path / "curves" / "Taxi-v3" / "DQN_1_seed.npy")
    kept = np.load(tmp_path / "curves" / "Taxi-v3" / "seeds" /
                   "DQN_seed_100.npy")
    assert stack.shape == (1, len(kept)) and len(kept) >= 3
    np.testing.assert_array_equal(stack[0], kept)       # raw, not smoothed
    assert os.path.isfile(tmp_path / "l" / "curves" / "Taxi-v3" /
                          "DQN_1_seed.npy")
    assert "Taxi-v3/DQN_1_seed@jax_head" in out
    assert rc in (0, 1)        # a 3-episode curve may miss the gate


def test_gate_rows_are_dataclass_copies():
    """``parity_row`` keeps every field of the spec it copies."""
    row = golden.parity_row(golden.SPECS[0], ref="jax_head")
    n = len(dataclasses.fields(golden.GoldenSpec))
    assert dataclasses.astuple(row)[:n] == dataclasses.astuple(
        golden.SPECS[0])
    assert (row.ref, row.smooth, row.bins, row.then_sweep,
            row.curve_file, row.script, row.rule) == (
        "jax_head", True, 0, False, "", "", "")


def test_fixed_reset_starts_are_each_packages_own_draw():
    """``--fixed_reset`` pins the start the JAX package draws from the
    seed, in both packages: the port recomputes the JAX env's draw from
    ``jax.random.PRNGKey(seed)`` on the host, so Pendulum seed 0 starts at
    theta 2.1508 on each side (the port drew its own, theta -0.024 on the
    CPU, before)."""
    import jax

    from freerl_tpu.envs import make as jax_make
    from freerl_tpu.envs.base import FixedResetWrapper as JaxFixedReset
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.envs.base import FixedResetWrapper

    port = FixedResetWrapper(make("Pendulum-v1", device="cpu"), 0)
    theta, theta_dot = port._reset_draw[0].tolist()
    jstate, _ = JaxFixedReset(jax_make("Pendulum-v1"), 0).reset(
        jax.random.PRNGKey(5))
    assert theta == pytest.approx(2.1508, abs=1e-4)
    assert theta_dot == pytest.approx(-0.9854, abs=1e-4)
    assert theta == float(jstate.theta)
    assert theta_dot == float(jstate.theta_dot)


def test_not_comparable_rows_are_the_fixed_reset_rows_whose_starts_differ():
    """``golden.NOT_COMPARABLE`` holds every fixed-reset row of which some
    seed starts from another state in the port than in the JAX package,
    and no other row. Every seed's pinned draw is the JAX env's, bit for
    bit, and its start observation lies within one float32 ulp of the JAX
    package's, so the set is empty."""
    from tests.test_torch_jax_prng import (jax_reset_draw, start_pair,
                                           within_one_ulp)
    import jax

    want, seen = set(), {}
    for row in golden.JAX_PARITY:
        if "--fixed_reset" not in row.regen:
            continue
        for seed in {golden.start_seed(row, s) for s in row.regen_seeds}:
            if (row.env, seed) not in seen:
                jobs, obs, draw = start_pair(row.env, seed)
                jdraw = jax_reset_draw(row.env, jax.random.PRNGKey(seed))
                seen[(row.env, seed)] = (
                    np.array_equal(draw[0].numpy(), jdraw.reshape(
                        draw.shape[1:]))
                    and within_one_ulp(obs.reshape(-1), jobs.reshape(-1)))
            if not seen[(row.env, seed)]:
                want.add(golden.row_key(row))
    assert want == set(golden.NOT_COMPARABLE) == set()
    # CartPole, Pendulum, LunarLander and MountainCarContinuous 3 starts
    # each (SAC_16_seed's all pin seed 0's), FrozenLake 16, Taxi 1,
    # MountainCar 12 (0-9, 10, 100), MountainCarContinuous 13 more (DDPG
    # OUNoise over 16 seeds), simple_spread_v3 and simple_adversary_v3 3
    # each (the N=5 matrix; IPPO_L100's pin seed 100's; each recipe's
    # starts at its own agent count: tests/test_torch_r5_marl_n5.py), and
    # simple_spread_v3 13 more (MAAC_N5 over 16 seeds)
    assert len(seen) == 4 * 3 + 16 + 1 + 12 + 13 + 2 * 3 + 13


def test_reset_starts_script_on_the_cpu(capsys):
    """``scripts/torch_reset_starts.py`` prints the start each fixed-reset
    row's seeds pin, and whether it is the JAX package's as the
    ``@jax_head`` provenance records it: FrozenLake's one start state for
    every seed, and Pendulum seed 0 at the JAX package's theta 2.1508,
    theta_dot -0.9854; every recorded JAX start is the port's. Without a
    card it refuses."""
    from scripts import torch_reset_starts as starts

    assert starts.main(["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["device"] == "cpu" and got["card"] is None
    assert got["starts"]["FrozenLake-v1"] == {
        str(s): [0.0] for s in golden.DQN_LL_SEEDS16}
    cos, sin, theta_dot = got["starts"]["Pendulum-v1"]["0"]
    assert np.arctan2(sin, cos) == pytest.approx(2.1508, abs=1e-4)
    assert theta_dot == pytest.approx(-0.9854, abs=1e-4)
    same = [v for env in got["same_as_jax"].values() for v in env.values()]
    assert None not in same and all(same)
    assert set(got["starts"]) == {golden.row_key(r).split("/")[0]
                                  for r in golden.JAX_PARITY
                                  if "--fixed_reset" in r.regen}
    if not torch.cuda.is_available():
        assert starts.main([]) == 1


@pytest.mark.parametrize("tag", ["PPO_CartPole", "PPO_LunarLander",
                                 "DQN_Taxi", "DDPG_discrete_CartPole",
                                 "SAC_discrete_CartPole"])
def test_committed_and_jax_head_first_episodes_agree(tag):
    """The committed round-5 stack and the JAX package rerun at this commit
    begin every seed with the same first three episodes (returns equal, or
    within 1e-6 relative where LunarLander's float32 physics ran on other
    chips): both start each episode from the one state the seed pins, the
    state the port now pins, so both reference columns hold the port's
    task."""
    committed, head = golden.r5_rows(tag)
    stack = np.load(os.path.join(golden.JAX_CURVES_ROOT, committed.env,
                                 committed.algo + ".npy"))
    for i, seed in enumerate(committed.regen_seeds):
        rerun = np.load(golden.seed_file(golden.JAX_HEAD_ROOT, head, seed))
        np.testing.assert_allclose(rerun[:3], stack[i, :3], rtol=1e-6,
                                   atol=0)
