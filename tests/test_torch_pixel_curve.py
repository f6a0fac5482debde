"""``scripts/torch_pixel_curve.py`` against the JAX package's
``scripts/pixel_curve.py``: ``golden.PIXEL_RUNS`` against the configs the
JAX script builds (its ``main()`` run in this process with
``train_offpolicy`` replaced by a recorder), the two rows' gates against
SPECS, ``golden.seed_rule`` (ROADMAP A3.5's rule), the runners' job kind
for a row whose recipe is a script's argv, the JAX side writing only under
its work dir, the shim and ``chip_smoke.pixel_recipe`` on the CPU at a
small size, and the port's seeds trained on the card.

Tolerances: none; configs, counts and verdicts are compared exactly."""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import freerl_tpu.train as jax_train
from freerl_tpu.train import golden as jax_golden
from freerl_tpu_torch.train import golden
from scripts import torch_golden_card as card
from scripts import torch_jax_head as head
from scripts import torch_pixel_curve as pixel
from tests.test_torch_envelope_e2e import _digest, _stub

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = "PixelCartPole-v1"
KEYS = [f"{ENV}/DQN_seed_0", f"{ENV}/DQN_16_seed@jax_head"]


class _Recorded(Exception):
    pass


def _jax_configs(monkeypatch, seed: int):
    """The ``DQNConfig`` and ``OffPolicyConfig`` scripts/pixel_curve.py's
    ``main()`` hands ``train_offpolicy`` for ``--seed``, stopped there:
    nothing is trained or saved."""
    from scripts import pixel_curve

    got = {}

    def recorder(env, algo, cfg):
        got.update(env=env, dqn=algo.cfg, loop=cfg)
        raise _Recorded

    monkeypatch.setattr(jax_train, "train_offpolicy", recorder)
    monkeypatch.setattr(sys, "argv", ["pixel_curve.py", "--seed", str(seed)])
    with pytest.raises(_Recorded):
        pixel_curve.main()
    return got


def _same_fields(port_cfg, jax_cfg) -> None:
    """Every field the two configs share is equal; every field only the
    JAX config has is at its default."""
    mine = dataclasses.asdict(port_cfg)
    theirs = dataclasses.asdict(jax_cfg)
    default = dataclasses.asdict(type(jax_cfg)())
    for k, v in theirs.items():
        if k in mine:
            want = tuple(v) if isinstance(v, (list, tuple)) else v
            have = mine[k]
            have = tuple(have) if isinstance(have, (list, tuple)) else have
            assert have == want, (k, have, want)
        else:
            assert v == default[k], k


def test_pixel_runs_are_the_jax_scripts(monkeypatch):
    """``golden.PIXEL_RUNS`` through ``torch_pixel_curve.configs`` is what
    the JAX script builds, field by field, for two seeds; the script's
    explicit arguments are the table's."""
    for seed in (0, 7):
        got = _jax_configs(monkeypatch, seed)
        dqn, loop = pixel.configs(seed, got["env"].obs_shape)
        _same_fields(dqn, got["dqn"])
        _same_fields(loop, got["loop"])
        assert got["env"].name == golden.PIXEL_RUNS["DQN_pixel"][0]
        assert (loop.seed, dqn.obs_shape) == (seed, (48, 48, 2))
    env, dqn_kw, loop_kw = golden.PIXEL_RUNS["DQN_pixel"]
    assert dqn_kw == dict(buffer_size=100_000, batch_size=64,
                          conv_arch="small", cnn_features=128)
    assert loop_kw == dict(num_envs=8, max_episodes=400, start_steps=1000,
                           updates_per_burst=4, chunk_size=128)


def test_rows_take_the_specs_floor():
    """``DQN_seed_0`` is SPECS' row (floor 35.0, window 50, no reference
    curve) over the port's seed 0, in ``JAX_PARITY``; ``DQN_16_seed`` is
    held by ``seed_rule`` against JAX at this commit over the 16 seeds, in
    ``RUN_ONLY`` while fewer than ``MIN_SEEDS`` JAX seeds are kept. Both
    stack raw and run the script, whose recipe is ``--seed``."""
    spec = jax_golden.SPECS[[(s.env, s.algo) for s in jax_golden.SPECS]
                            .index((ENV, "DQN_seed_0"))]
    one, sixteen = golden.pixel_rows()
    assert (spec.floor, spec.window, spec.ref_path) == (35.0, 50, "")
    assert [golden.row_key(r) for r in (one, sixteen)] == KEYS
    for row in (one, sixteen):
        assert (row.floor, row.window, row.smooth, row.script, row.regen) == (
            35.0, 50, False, "pixel_curve", ("--seed", "{seed}"))
    assert (one.ref_path, one.regen_seeds, one.rule) == ("", (0,), "")
    assert (sixteen.regen_seeds, sixteen.ref, sixteen.rule) == (
        golden.DQN_LL_SEEDS16, "jax_head", "seeds")
    assert one in golden.JAX_PARITY and sixteen in golden.RUN_ONLY
    assert sixteen not in golden.JAX_PARITY
    # one seed file a seed for both rows
    assert golden.seed_file("r", one, 0) == golden.seed_file("r", sixteen, 0)


def _keep(root, row, seed, final, command=None):
    path = golden.seed_file(str(root), row, seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, np.full(60, float(final)))
    golden.update_provenance(str(root), row.env, seeds={
        os.path.basename(path): dict(command=command or (
            f"python -m scripts.torch_pixel_curve --seed {seed} "
            f"--device cuda"))})


# (port final-50s, JAX final-50s, verdict): seeds 0..k-1 on both sides
RULE_CASES = {
    "waiting": ([40.0] * 7, [40.0] * 7, "waiting"),
    "pass": ([40 + i for i in range(8)], [41 + i for i in range(8)],
             "pass"),
    "port_below_floor": ([30 + i % 3 for i in range(8)],
                         [30 + i % 3 for i in range(8)], "FAIL"),
    "apart": ([40 + i for i in range(8)], [60 + i for i in range(8)],
              "FAIL"),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_seed_rule(case, tmp_path, monkeypatch):
    """``seed_rule`` over the seeds both sides keep: 'waiting' under
    ``MIN_SEEDS``; else both means at the floor or above and a two-sided
    Mann-Whitney p of at least ``P_MIN``. A seed only one side keeps is
    left out, and ``check_against_jax`` gives the rule's row."""
    ours, theirs, verdict = RULE_CASES[case]
    monkeypatch.setattr(golden, "OURS_ROOT", str(tmp_path / "ours"))
    monkeypatch.setattr(golden, "JAX_HEAD_ROOT", str(tmp_path / "head"))
    row = golden.pixel_rows()[1]
    seeds = row.regen_seeds
    for i, (a, b) in enumerate(zip(ours, theirs)):
        _keep(tmp_path / "ours", row, seeds[i], a)
        _keep(tmp_path / "head", row, seeds[i], b,
              f"PYTHONPATH=. JAX_PLATFORMS=cpu python -m scripts.pixel_curve "
              f"--cpu --seed {seeds[i]}")
    _keep(tmp_path / "ours", row, seeds[-1], 10.0)     # the port's only
    got = golden.check_against_jax(row)
    assert got["status"] == verdict and got["seeds"] == list(
        seeds[:len(ours)])
    assert got["ours"] == pytest.approx(np.mean(ours))
    assert got["ref"] == pytest.approx(np.mean(theirs))
    assert (got["p"] is None) == (verdict == "waiting")


def test_card_runs_the_script_a_seed(tmp_path):
    """``torch_golden_card.make_jobs`` on the two rows: one job a seed for
    both (16), each the port's script on ``--device``, whose recorded
    command gives the row's recipe; the stack of a row with every seed
    kept is raw."""
    jobs = card.make_jobs(None, KEYS, 0, "cuda", str(tmp_path))
    assert [j["seed"] for j in jobs] == list(golden.DQN_LL_SEEDS16)
    for j in jobs:
        assert j["script"] == "pixel_curve"
        assert j["argv"][1:] == ["-m", "scripts.torch_pixel_curve", "--seed",
                                 str(j["seed"]), "--device", "cuda"]
        cmd = " ".join(["python", *j["argv"][1:]])
        assert golden.recipe_of(cmd) == ["--seed", str(j["seed"])]


_FAKE_PYTHON = """
import os, sys
import numpy as np

args = sys.argv[1:]
assert args[:3] == ["-m", "scripts.pixel_curve", "--cpu"], args
assert os.environ["JAX_PLATFORMS"] == "cpu"
assert os.environ["PYTHONPATH"]
seed = int(args[args.index("--seed") + 1])
out = os.path.join("results", "learning_curves", "PixelCartPole-v1")
os.makedirs(out, exist_ok=True)
np.save(os.path.join(out, f"DQN_seed_{seed}.npy"),
        np.full(400, float(seed), np.float32))
print("pixel DQN final-30:", float(seed), "start-10:", 9.8, "info:",
      {"elapsed_s": 12.5, "env_steps": 12288, "updates": 5644,
       "env_steps_per_s": 983.0, "episodes": 400, "xla": os.environ.get(
           "XLA_FLAGS")})
"""


def test_jax_side_writes_only_under_its_work_dir(tmp_path, monkeypatch,
                                                 capsys):
    """``scripts/torch_jax_head.py`` on the 16-seed row, the interpreter
    stubbed by a fake JAX script that saves its curve under its working
    directory's ``results/learning_curves/``, as scripts/pixel_curve.py
    does: each seed runs in a directory of its own under ``--work``, with
    XLA on one thread under ``--one_thread``; its curve is kept and stacked
    raw under ``--out`` with the counts it printed, and the repo's
    ``results/`` tree, the JAX package's committed curves with it, is left
    byte for byte as it was."""
    row = dataclasses.replace(golden.pixel_rows()[1], regen_seeds=(0, 7))
    monkeypatch.setattr(golden, "RUN_ONLY", [row])
    _stub(tmp_path / "python", _FAKE_PYTHON)
    monkeypatch.setattr(sys, "executable", str(tmp_path / "python"))
    monkeypatch.setattr(head, "jax_version", lambda: "0.0")
    tree = os.path.join(ROOT, "results")
    before = _digest(tree)
    out_root, work = tmp_path / "out", tmp_path / "work"
    rc = head.main([KEYS[1], "--out", str(out_root), "--work", str(work),
                    "--jobs", "2", "--one_thread"])
    capsys.readouterr()
    assert rc == 0 and _digest(tree) == before
    assert sorted(os.listdir(tmp_path)) == ["out", "python", "work"]
    for s in (0, 7):
        made = head.script_curve(row, s, head.script_dir(str(work), row, s))
        assert os.path.isfile(made)
    with open(out_root / ENV / "provenance.json") as f:
        prov = json.load(f)
    for s in (0, 7):
        rec = prov["seeds"][f"DQN_seed_{s}.npy"]
        assert golden.recipe_of(rec["command"]) == ["--seed", str(s)]
        assert rec["xla_flags"] == head.ONE_THREAD and rec["device"] == "cpu"
        assert (rec["env_steps"], rec["updates"], rec["episodes"],
                rec["loop_s"]) == (12288, 5644, 400, 12.5)
        assert golden.kept_seed(str(out_root), row, s)
    np.testing.assert_array_equal(
        np.load(out_root / ENV / "DQN_16_seed.npy"),
        np.stack([np.full(400, 0.0), np.full(400, 7.0)]).astype(np.float32))


def _small(monkeypatch):
    """``PIXEL_RUNS`` at a replay of 2,048, 64 start steps and chunks of 16
    (the test's size; the learner, envs and trunk are the recipe's)."""
    env, dqn, off = golden.PIXEL_RUNS["DQN_pixel"]
    monkeypatch.setitem(golden.PIXEL_RUNS, "DQN_pixel", (
        env, dict(dqn, buffer_size=2048),
        dict(off, start_steps=64, chunk_size=16, host_sync_every=1)))


def test_shim_keeps_a_seed_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The shim on the CPU, cut to 2 episodes: the raw curve and its
    record (command, device, counts, no sum-tree launch) kept under
    ``--root``, nothing written into the repo's results tree, and a cut
    run is no seed of the row's recipe. Without a card, ``--device
    cuda`` exits non-zero."""
    _small(monkeypatch)
    tree = os.path.join(ROOT, "results")
    before = _digest(tree)
    root = tmp_path / "curves"
    assert pixel.main(["--seed", "3", "--device", "cpu", "--episodes", "2",
                       "--root", str(root)]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert _digest(tree) == before
    row = golden.pixel_rows()[0]
    curve = np.load(golden.seed_file(str(root), row, 3))
    with open(root / ENV / "provenance.json") as f:
        rec = json.load(f)["seeds"]["DQN_seed_3.npy"]
    assert rec == {k: v for k, v in line.items() if k != "seed"}
    assert len(curve) == 2 <= rec["episodes"] and rec["b1_launches"] == 0
    assert rec["device"] == "cpu" and rec["card"] is None
    assert rec["updates"] > 0 and rec["env_steps"] % 8 == 0
    assert golden.recipe_of(rec["command"]) == ["--seed", "3", "--episodes",
                                                "2"]
    with pytest.raises(ValueError):
        golden.kept_seed(str(root), row, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pixel.main(["--seed", "3", "--root", str(root)]) == 1


def test_recipe_on_the_cpu(monkeypatch):
    """``chip_smoke.pixel_recipe`` at the test's size: the learner steps
    on every vector step past the start steps, finite returns, no sum-tree
    launch, and no global random state moved (it runs side by side)."""
    import chip_smoke

    _small(monkeypatch)
    before = chip_smoke.global_rng_states()
    got = chip_smoke.pixel_recipe("DQN_pixel", "cpu")
    assert chip_smoke.moved_rngs(before, chip_smoke.global_rng_states()) == []
    assert got["launches"] == 0
    assert "2 chunks, 256 env steps, 96 updates" in got["line"]


def test_port_seeds_on_the_card_are_kept():
    """The port's 16 seeds of the script, trained on the card: each kept by
    the rows' recipe (its record names the card, 400 or more episodes and
    no sum-tree launch; the kept curve is its first 400 episodes, finite),
    both rows stacked raw, and ``DQN_seed_0`` passes SPECS' floor."""
    one, sixteen = golden.pixel_rows()
    root = os.path.join(golden.OURS_ROOT, ENV)
    with open(os.path.join(root, "provenance.json")) as f:
        prov = json.load(f)
    curves = []
    for s in sixteen.regen_seeds:
        assert golden.kept_seed(golden.OURS_ROOT, sixteen, s)
        rec = prov["seeds"][f"DQN_seed_{s}.npy"]
        assert rec["b1_launches"] == 0 and "H100" in rec["card"]
        assert rec["episodes"] >= 400 and rec["updates"] > 0
        curve = np.load(golden.seed_file(golden.OURS_ROOT, sixteen, s))
        assert curve.shape == (400,) and np.isfinite(curve).all()
        assert rec["final50"] == round(float(curve[-50:].mean()), 4)
        curves.append(curve)
    for row, n in ((one, 1), (sixteen, 16)):
        np.testing.assert_array_equal(
            np.load(os.path.join(root, row.algo + ".npy")),
            np.stack(curves[:n]))
        assert prov["stacks"][row.algo]["seeds"] == list(row.regen_seeds)
    got = golden.check_against_jax(one)
    assert got["status"] == "pass" and got["ours"] >= one.floor
