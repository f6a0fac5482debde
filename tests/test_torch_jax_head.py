"""The measuring scripts of the golden-curve rows on the CPU:
``scripts/torch_jax_head.py`` (the JAX package's CLI run as a command, its
seeds kept and stacked with provenance), ``scripts/torch_seed_spread.py``
(the spread of both sides on a fixed toy input), the per-card choice of
``scripts/torch_per_card.py`` and ``scripts/torch_golden_card.py``'s
``--per_card`` and its reuse of kept seeds."""
import json
import os
import sys

import numpy as np
import pytest
import torch
from scipy.stats import mannwhitneyu

from chip_smoke import child_processes
from freerl_tpu_torch.train import golden
from freerl_tpu_torch.train.plotting import aggregate_seeds
from scripts import torch_golden_card as card
from scripts import torch_jax_head as head
from scripts import torch_per_card as per_card
from scripts import torch_seed_spread as spread

torch.set_num_threads(1)

TINY = golden.parity_row(golden.GoldenSpec(
    "CartPole-v1", "DQN_2_seed", "CartPole-v1/DQN_2_seed.npy",
    regen=("--algo", "DQN", "--env_name", "CartPole-v1",
           "--max_episodes", "12", "--num_envs", "4",
           "--buffer_size", "2048", "--seed", "{seed}"),
    regen_seeds=(3, 4)), ref="jax_head")


def test_head_rows_and_argv():
    """Only a ``@jax_head`` row with a recipe is taken; its command is the
    JAX package's CLI on the row's recipe, one run dir per seed."""
    row = head.head_row("LunarLander-v2/DQN_16_seed@jax_head")
    argv = head.jax_argv(row, 5, "W")
    assert argv[:3] == [sys.executable, "-m", "freerl_tpu.cli"]
    assert argv[3:] == [a.format(seed=5) for a in golden.SPECS[0].regen] + [
        "--results_root", os.path.join("W", "LunarLander-v2", "seed_5"),
        "--no_tensorboard"]
    with pytest.raises(ValueError):
        head.head_row("LunarLander-v2/DQN_3_seed")
    with pytest.raises(KeyError):
        head.head_row("LunarLander-v2/DQN_9_seed@jax_head")


def test_run_log_is_parsed():
    text = ("model_dir: /x/DQN_4\nsomething\n"
            "episodes: 507  env_steps: 475136  steps/s: 339\n")
    assert golden.parse_run_log(text) == dict(
        run_dir="/x/DQN_4", episodes=507, env_steps=475136, steps_per_s=339)


def test_jax_cli_runs_kept_and_stacked(tmp_path, monkeypatch, capsys):
    """Two seeds of a tiny recipe through the JAX package's CLI on the CPU:
    each seed's raw curve kept, the stack the JAX package's smoothing of
    them, and the provenance of each; a kept seed is not run again."""
    monkeypatch.setattr(golden, "JAX_PARITY", golden.JAX_PARITY + [TINY])
    out = tmp_path / "out"
    args = ["CartPole-v1/DQN_2_seed@jax_head", "--jobs", "2", "--out",
            str(out), "--work", str(tmp_path / "work")]
    assert head.main(args) == 0
    kept = [np.load(out / "CartPole-v1" / "seeds" / f"DQN_seed_{s}.npy")
            for s in (3, 4)]
    want, _, _ = aggregate_seeds(kept)
    np.testing.assert_array_equal(
        np.load(out / "CartPole-v1" / "DQN_2_seed.npy"), want)
    prov = json.load(open(out / "CartPole-v1" / "provenance.json"))
    assert prov["stacks"]["DQN_2_seed"] == dict(
        seeds=[3, 4], smoothed=True,
        files=["DQN_seed_3.npy", "DQN_seed_4.npy"])
    for s in (3, 4):
        rec = prov["seeds"][f"DQN_seed_{s}.npy"]
        assert rec["device"] == "cpu" and rec["episodes"] >= 12
        assert rec["command"].startswith("JAX_PLATFORMS=cpu python -m "
                                         "freerl_tpu.cli --algo DQN")
        assert f"--seed {s}" in rec["command"] and rec["jax"]
    capsys.readouterr()
    assert head.main(args) == 0
    assert "[start]" not in capsys.readouterr().out


def _tree(root, seeds, finals, early, steps):
    """A side of the spread: raw curves whose final-50 and episodes 10-40
    are flat at the given values, their smoothed stack, and provenance."""
    env = os.path.join(root, "Env-v0")
    os.makedirs(os.path.join(env, "seeds"))
    curves = []
    for s, f, e in zip(seeds, finals, early):
        c = np.full(120, -100.0)
        c[10:41] = e
        c[-50:] = f
        c[-51] = f          # the smoothing starts level with the window
        curves.append(c)
        np.save(os.path.join(env, "seeds", f"DQN_seed_{s}.npy"), c)
    stack, _, _ = aggregate_seeds(curves)
    np.save(os.path.join(env, "DQN_3_seed.npy"), stack)
    files = [f"DQN_seed_{s}.npy" for s in seeds]
    with open(os.path.join(env, "provenance.json"), "w") as f:
        json.dump({"stacks": {"DQN_3_seed": {"seeds": list(seeds),
                                             "files": files}},
                   "seeds": {n: {"env_steps": k}
                             for n, k in zip(files, steps)}}, f)
    return stack[:, -50:].mean(1)


def test_seed_spread_on_a_toy_input(tmp_path, capsys):
    """Three seeds a side: the per-seed statistics, the break-out share,
    the two-sided Mann-Whitney p (3 against 3, fully separated: the exact
    p is 2 / C(6, 3) = 0.1) and Fisher's exact p of the break-out counts
    (2 of 3 against 0 of 3: 0.4)."""
    ours = _tree(tmp_path / "a", (0, 1, 2), [200.0, 150.0, -80.0],
                 [-150.0, -160.0, -170.0], [100, 200, 300])
    ref = _tree(tmp_path / "b", (0, 1, 2), [-50.0, -60.0, -70.0],
                [-100.0, -110.0, -120.0], [400, 500, 600])
    assert spread.main(["--env", "Env-v0", "--stem", "DQN_3_seed", "--ours",
                        str(tmp_path / "a"), "--ref", str(tmp_path / "b")]
                       ) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["port"]["final50_raw"] == [200.0, 150.0, -80.0]
    np.testing.assert_allclose(got["port"]["final50"], ours)
    np.testing.assert_allclose(got["jax_head"]["final50"], ref)
    assert got["port"]["breakout_share"] == pytest.approx(2 / 3)
    assert (got["port"]["breakouts"], got["jax_head"]["breakouts"]) == (2, 0)
    assert got["fisher_breakouts"]["table"] == [[2, 1], [0, 3]]
    assert got["fisher_breakouts"]["p"] == pytest.approx(0.4)
    assert got["jax_head"]["breakout_share"] == 0.0
    assert got["port"]["early_mean"] == [-150.0, -160.0, -170.0]
    assert got["jax_head"]["env_steps"] == [400, 500, 600]
    assert got["port"]["mean_final50"] == pytest.approx(float(ours.mean()))
    assert got["mannwhitney"]["early"]["p"] == pytest.approx(0.1)
    assert got["mannwhitney"]["early"]["U"] == 0.0
    want = mannwhitneyu(ours, ref, alternative="two-sided")
    assert got["mannwhitney"]["final50"]["p"] == pytest.approx(want.pvalue)
    want = mannwhitneyu([200.0, 150.0, -80.0], [-50.0, -60.0, -70.0],
                        alternative="two-sided")
    assert got["mannwhitney"]["final50_raw"] == dict(
        U=6.0, p=pytest.approx(want.pvalue))


@pytest.mark.parametrize("growths,want", [
    ((1.0, 0.85, 1.0, 1.22), 8), ((1.0, 1.1, 1.3, 1.9), 2),
    ((1.0, 1.25, 1.3, 2.0), 1)])
def test_per_card_choice(growths, want):
    """The largest K whose per-process time grows by less than 25 %."""
    rows = [dict(k=k, growth=g) for k, g in zip((1, 2, 4, 8), growths)]
    assert per_card.choose_k(rows) == want


@pytest.fixture
def cpu_rows(tmp_path, monkeypatch):
    tiny = golden.parity_row(TINY, ref="committed")
    monkeypatch.setattr(golden, "JAX_PARITY", golden.JAX_PARITY + [tiny])
    monkeypatch.setattr(golden, "OURS_ROOT", str(tmp_path / "curves"))
    return ["--device", "cpu", "CartPole-v1/DQN_2_seed", "--results_root",
            str(tmp_path / "res"), "--log_dir", str(tmp_path / "logs")]


def test_per_card_runs_jobs_together(cpu_rows, tmp_path, capsys):
    """``--per_card 2`` on the CPU starts both seeds before either ends;
    each seed is kept with its provenance and the stack is copied out."""
    assert card.main(cpu_rows + ["--per_card", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    marks = [ln.split()[0] for ln in out if ln.startswith("[")]
    assert marks[:2] == ["[start]", "[start]"]
    prov = json.load(open(tmp_path / "curves" / "CartPole-v1" /
                          "provenance.json"))
    assert sorted(prov["seeds"]) == ["DQN_seed_3.npy", "DQN_seed_4.npy"]
    assert prov["seeds"]["DQN_seed_3.npy"]["card"] is None
    assert os.path.isfile(tmp_path / "logs" / "curves" / "CartPole-v1" /
                          "seeds" / "DQN_seed_4.npy")
    assert not child_processes()


def _keep(spec, seed, curve, recipe=None):
    """Keep ``curve`` as ``spec``'s seed under ``golden.OURS_ROOT``, its
    provenance naming ``recipe`` (the row's own by default)."""
    kept = golden.seed_file(golden.OURS_ROOT, spec, seed)
    os.makedirs(os.path.dirname(kept), exist_ok=True)
    np.save(kept, curve)
    argv = [a.format(seed=seed) for a in (recipe or spec.regen)]
    golden.update_provenance(golden.OURS_ROOT, spec.env, seeds={
        os.path.basename(kept): dict(command=" ".join(
            ["python", "-m", "freerl_tpu_torch.cli", *argv,
             "--results_root", "r", "--no_tensorboard", "--device", "cpu"]))})


def test_reuse_stacks_kept_seeds(cpu_rows, tmp_path, capsys):
    """By default a kept seed is not run again: only the other seed runs,
    and the stack holds the kept curve as it was; ``--force`` runs it
    again."""
    spec = card.parity_row("CartPole-v1/DQN_2_seed")
    _keep(spec, 3, np.arange(30, dtype=np.float32))
    assert [j["seed"] for j in card.make_jobs(
        None, ["CartPole-v1/DQN_2_seed"], 1, "cpu", "r", True)] == [4]
    assert card.main(cpu_rows) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [j["name"] for j in last["jobs"]] == [
        "CartPole-v1_DQN_2_seed_seed_4"]
    stack = np.load(tmp_path / "curves" / "CartPole-v1" / "DQN_2_seed.npy")
    want, _, _ = aggregate_seeds([np.arange(30, dtype=np.float32),
                                  np.load(golden.seed_file(
                                      golden.OURS_ROOT, spec, 4))])
    np.testing.assert_array_equal(stack, want)
    assert len(card.make_jobs(None, ["CartPole-v1/DQN_2_seed"], 1, "cpu",
                              "r", False)) == 2


def test_a_seed_of_another_recipe_is_refused(cpu_rows):
    """A kept seed file that another recipe made under the same name (the
    rows of one label share it), or that has no provenance record, is
    neither reused nor stacked: the runner stops."""
    spec = card.parity_row("CartPole-v1/DQN_2_seed")
    assert not golden.kept_seed(golden.OURS_ROOT, spec, 3)
    other = [a.replace("12", "500") for a in spec.regen]
    _keep(spec, 3, np.zeros(30), recipe=other)
    with pytest.raises(ValueError, match="not a seed of"):
        golden.kept_seed(golden.OURS_ROOT, spec, 3)
    with pytest.raises(ValueError):
        card.main(cpu_rows)
    _keep(spec, 3, np.zeros(30))
    assert golden.kept_seed(golden.OURS_ROOT, spec, 3)
    os.remove(os.path.join(golden.OURS_ROOT, spec.env, "provenance.json"))
    with pytest.raises(ValueError, match="no provenance record"):
        golden.kept_seed(golden.OURS_ROOT, spec, 3)


def test_a_fixed_reset_seed_from_another_start_is_refused(tmp_path,
                                                          monkeypatch):
    """A kept seed of a ``--fixed_reset`` recipe is taken only where its
    record names the start the port pins now (``golden.same_start``): a
    record with no start, or with another one (the port's own torch draw
    of Pendulum seed 0, theta -0.024, before it pinned the JAX package's),
    stops the runner, which ``--force`` runs again."""
    monkeypatch.setattr(golden, "OURS_ROOT", str(tmp_path))
    key = "Pendulum-v1/TD3_1_seed"
    row = card.parity_row(key)
    path = golden.seed_file(str(tmp_path), row, 0)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, np.zeros(4))
    rec = dict(command=" ".join(["python", "-m", "freerl_tpu_torch.cli",
                                 *golden.regen_argv(row, 0, "R", "cuda")]))

    def record(**start):
        golden.update_provenance(str(tmp_path), row.env, seeds={
            os.path.basename(path): dict(rec, **start)})

    record()
    with pytest.raises(ValueError, match="no start record"):
        golden.kept_seed(str(tmp_path), row, 0)
    with pytest.raises(ValueError, match="another start"):
        card.make_jobs(None, [key], 1, "cuda", "R", True)
    assert len(card.make_jobs(None, [key], 1, "cuda", "R", False)) == 1
    old = [float(np.cos(-0.0235)), float(np.sin(-0.0235)), 0.5364]
    record(start=old)
    with pytest.raises(ValueError, match="another start"):
        golden.kept_seed(str(tmp_path), row, 0)
    pinned = golden.pinned_start(row, 0)
    assert np.arctan2(pinned[1], pinned[0]) == pytest.approx(2.1508,
                                                             abs=1e-4)
    record(start=pinned)
    assert golden.kept_seed(str(tmp_path), row, 0)
    assert card.make_jobs(None, [key], 1, "cuda", "R", True) == []
    one_ulp = [float(np.nextafter(np.float32(x), np.float32(9)))
               for x in pinned]
    record(start=one_ulp)
    assert golden.kept_seed(str(tmp_path), row, 0)
    assert golden.kept_seed(str(tmp_path), row, 0, start=one_ulp)
    three_ulps = [float(np.float32(x) + 3 * np.spacing(np.float32(x)))
                  for x in pinned]
    with pytest.raises(ValueError, match="another start"):
        golden.kept_seed(str(tmp_path), row, 0, start=three_ulps)
    with pytest.raises(ValueError, match="another start"):
        golden.kept_seed(str(tmp_path), row, 0, start=old)
    assert golden.pinned_start(golden.SPECS[0], 0) is None


def test_jax_starts_are_the_ports():
    """The start the JAX package pins, read from the env its own CLI builds
    for a recipe (in a JAX process), is the start the port pins for it;
    a recipe without ``--fixed_reset`` has none."""
    rows = [head.head_row("Pendulum-v1/SAC_1_seed@jax_head"),
            head.head_row("CartPole-v1/PPO_3_seed@jax_head")]
    tasks = [(rows[0], 0), (rows[1], 10), (golden.JAX_PARITY[3], 0)]
    starts = head.jax_starts(tasks)
    assert set(starts) == {("Pendulum-v1/SAC_1_seed@jax_head", 0),
                           ("CartPole-v1/PPO_3_seed@jax_head", 10)}
    for (key, seed), start in starts.items():
        row = rows[0] if key.startswith("Pendulum") else rows[1]
        assert golden.same_start(start, golden.pinned_start(row, seed))
    cos, sin, _ = starts[("Pendulum-v1/SAC_1_seed@jax_head", 0)]
    assert np.arctan2(sin, cos) == pytest.approx(2.1508, abs=1e-4)


def test_recipe_of_a_recorded_command():
    """The recipe of a provenance command: the words after ``-m MODULE``
    without where and how the run ran."""
    assert golden.recipe_of(
        "JAX_PLATFORMS=cpu python -m freerl_tpu.cli --algo DQN --seed 0 "
        "--results_root build/x --no_tensorboard") == [
            "--algo", "DQN", "--seed", "0"]
    assert golden.recipe_of(
        "python -m freerl_tpu_torch.cli --algo PPO --fixed_reset "
        "--results_root r --no_tensorboard --device cuda --horizon 2048"
    ) == ["--algo", "PPO", "--fixed_reset", "--horizon", "2048"]


@pytest.mark.parametrize("root", ["learning_curves", "jax_head"])
def test_committed_seeds_ran_their_rows_recipes(root):
    """Every seed of every recipe row is kept under the port's tree, and
    every seed of a ``@jax_head`` row under the JAX-at-HEAD tree, made by
    the row's own recipe."""
    base = (golden.OURS_ROOT if root == "learning_curves"
            else golden.JAX_HEAD_ROOT)
    n = 0
    for row in golden.JAX_PARITY:
        if not row.regen or (root == "jax_head" and getattr(
                row, "ref", "committed") != "jax_head"):
            continue
        for seed in row.regen_seeds:
            assert golden.kept_seed(base, row, seed), (golden.row_key(row),
                                                       seed)
            n += 1
    assert n > 0
