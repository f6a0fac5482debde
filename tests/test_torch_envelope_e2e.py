"""``scripts/torch_envelope_e2e.py`` against the JAX package's ENVELOPE
protocol: ``golden.ENVELOPE_RUNS`` and ``envelope_argv`` against the
command ``scripts/envelope_seed_sweep.sh`` runs (a copy of the shell
script, its ``python`` stubbed), the two rows' gates and stacking, the
port's 100-preference sweep against ``scripts/envelope_e2e.sweep`` from one
JAX ENVELOPE state carried across with ``convert.py``, and the shim and
the JAX side writing only under the roots they are given."""
import dataclasses
import hashlib
import json
import os
import shutil
import stat
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from freerl_tpu.train import golden as jax_golden
from freerl_tpu_torch.train import golden
from scripts import torch_envelope_e2e as port
from scripts import torch_golden_card as card
from scripts import torch_jax_head as head

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = "deep-sea-treasure-v0"
KEYS = [f"{ENV}/ENVELOPE_16_seed@jax_head",
        f"{ENV}/ENVELOPE_sweep_16_seed@jax_head"]


def _digest(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


def _stub(path, body: str) -> None:
    """An executable Python script at ``path`` run by this interpreter."""
    with open(path, "w") as f:
        f.write(f"#!{sys.executable}\n{body}")
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)


def test_runs_are_the_shell_scripts_recipe(tmp_path):
    """A copy of ``envelope_seed_sweep.sh`` run with ``python`` stubbed (it
    records its argv and does nothing): for each of the script's seeds the
    training command is ``python -u -m freerl_tpu.cli`` with
    ``envelope_argv(seed, "results/golden_runs")``, and the sweep after
    it ``scripts/envelope_e2e.sweep(run_dir, None)``."""
    os.makedirs(tmp_path / "repo" / "scripts")
    shutil.copy(os.path.join(ROOT, "scripts", "envelope_seed_sweep.sh"),
                tmp_path / "repo" / "scripts")
    os.makedirs(tmp_path / "bin")
    calls = tmp_path / "calls.jsonl"
    _stub(tmp_path / "bin" / "python",
          "import json, sys\n"
          f"open({str(calls)!r}, 'a').write(json.dumps(sys.argv[1:]) + "
          "'\\n')\n")
    env = dict(os.environ, PATH=f"{tmp_path / 'bin'}:{os.environ['PATH']}")
    subprocess.run(["bash", str(tmp_path / "repo" / "scripts" /
                                "envelope_seed_sweep.sh"), "",
                    str(tmp_path / "log")], env=env, check=True,
                   capture_output=True, timeout=60)
    seen = [json.loads(x) for x in calls.read_text().splitlines()]
    train = [c for c in seen if c[:3] == ["-u", "-m", "freerl_tpu.cli"]]
    sweeps = [c for c in seen if c[:2] == ["-u", "-c"]]
    assert [c[c.index("--seed") + 1] for c in train] == [
        "10", "100", "1", "2", "3"]
    for c in train:
        seed = c[c.index("--seed") + 1]
        assert c[3:] == golden.envelope_argv(seed, "results/golden_runs")
    assert len(sweeps) == 5 and all(
        "from scripts.envelope_e2e import sweep" in c[2]
        and ", None)" in c[2] for c in sweeps)
    algo, env_name, episodes, num_envs, upb, _ = golden.ENVELOPE_RUNS[
        "ENVELOPE"]
    assert (algo, env_name, episodes, num_envs, upb) == (
        "ENVELOPE", ENV, 5000, 1, 1)


@pytest.mark.parametrize("key,stem,curve_file", [
    (KEYS[0], "ENVELOPE_1_seed", ""),
    (KEYS[1], "ENVELOPE_sweep_1_seed", "reward.npy")])
def test_rows_take_the_specs_gates(key, stem, curve_file):
    """Each row: its JAX SPECS row's window, slack and floor (the curve's
    50 / 2.0 / none, the sweep's 100 / 9.4 / -2.81), held on the best of
    the 16 seeds against JAX at this commit only, the shell recipe with
    ``{seed}``, stacked raw, one run a seed swept after training; the
    committed best-of-28 stacks are no row, and until JAX at this commit
    has run the recipe neither row is held (``golden.RUN_ONLY``)."""
    want = next(s for s in jax_golden.SPECS if (s.env, s.algo) == (ENV,
                                                                  stem))
    row = golden.recipe_row(key)
    assert row in golden.envelope_rows() and row in golden.RUN_ONLY
    assert (row.window, row.slack, row.floor) == (
        want.window, want.slack, want.floor)
    assert (row.window, row.slack, row.floor) == (
        (50, 2.0, None) if curve_file == "" else (100, 9.4, -2.81))
    assert row.agg == "best" and not row.smooth and row.bins == 0
    assert row.regen == tuple(golden.envelope_argv("{seed}"))
    assert row.regen_seeds == golden.DQN_LL_SEEDS16
    assert row.then_sweep and row.curve_file == curve_file
    assert row.ref_path == f"{ENV}/{row.algo}.npy" and not row.pending
    held = {golden.row_key(r) for r in golden.JAX_PARITY}
    assert f"{ENV}/{stem}" not in held and key not in held


def test_rows_stack_raw(tmp_path):
    """The curve row stacks each seed's raw per-episode returns cut to the
    shortest; the sweep row each seed's 100 returns; a seed's curve is
    read from its run dir's ``<ALGO>_seed_<s>.npy`` or ``reward.npy``."""
    curve_row, sweep_row = golden.envelope_rows()
    run = tmp_path / "run"
    os.makedirs(run)
    rng = np.random.default_rng(0)
    np.save(run / "ENVELOPE_seed_3.npy", rng.normal(size=5003)
            .astype(np.float32))
    np.save(run / "reward.npy", rng.normal(size=100).astype(np.float32))
    c = golden.seed_curve(curve_row, str(run), 3)
    r = golden.seed_curve(sweep_row, str(run), 3)
    assert c.shape == (5003,) and r.shape == (100,)
    out = golden.stack_curves(curve_row, [c, c[:5000]], str(tmp_path))
    np.testing.assert_array_equal(np.load(out), np.stack([c[:5000]] * 2))
    out = golden.stack_curves(sweep_row, [r, r], str(tmp_path))
    np.testing.assert_array_equal(np.load(out), np.stack([r, r]))
    assert golden.seed_file("", sweep_row, 3) == os.path.join(
        ENV, "seeds", "ENVELOPE_sweep_seed_3.npy")


def test_card_runs_one_job_a_seed_for_both_rows(tmp_path, monkeypatch):
    """The card runner makes one job a seed that feeds both rows: the
    port's CLI with the recipe, then the sweep (``--and_sweep``), whose
    recorded command reads back as the recipe; a chained command's recipe
    stops at its ``&&``."""
    monkeypatch.setattr(golden, "OURS_ROOT", str(tmp_path))
    jobs = card.make_jobs(None, KEYS, 0, "cpu", "R", reuse=True)
    assert len(jobs) == 16
    for j, seed in zip(jobs, golden.DQN_LL_SEEDS16):
        assert j["row"] == KEYS[0] and j["also"] == [KEYS[1]]
        assert j["argv"][1:4] == card.SWEEP_RUNNER
        command = " ".join(["python", *j["argv"][1:]])
        assert golden.recipe_of(command) == golden.envelope_argv(seed)
        assert golden.recipe_of(command + " && python -c x y") == \
            golden.envelope_argv(seed)


def _jax_state():
    from freerl_tpu.algos.envelope import Envelope, EnvelopeConfig
    from freerl_tpu.envs import make

    env = make(ENV)
    algo = Envelope(env.dim_info, env.reward_dim, EnvelopeConfig())
    return env, algo, algo.init(jax.random.PRNGKey(0))


def test_sweep_matches_the_jax_scripts(tmp_path, monkeypatch, capsys):
    """The port's sweep (``--model_dir``) against ``envelope_e2e.sweep``
    from one JAX ENVELOPE state carried across with ``convert.py``: the
    100 scalarized returns, the 100 vector returns, the four metrics and
    the files each writes, equal but for the preferences counted where
    JAX's two best scalarized Q values lie within 1e-5 on the way (ties an
    argmax may break either way)."""
    import jax.numpy as jnp

    from freerl_tpu.train.runio import save_checkpoint as jax_save
    from freerl_tpu_torch.algos.envelope import Envelope, EnvelopeConfig
    from freerl_tpu_torch.convert import envelope_state_from_flax
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.train.runio import save_checkpoint
    from scripts import envelope_e2e

    jenv, jalgo, jstate = _jax_state()
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jax_save(str(jdir / "checkpoint"), jstate)
    seen = {}
    jit = jax.jit

    def recording(fn):
        compiled = jit(fn)

        def call(*args):
            seen["out"] = compiled(*args)
            return seen["out"]
        return call

    monkeypatch.setattr(jax, "jit", recording)
    want = envelope_e2e.sweep(str(jdir), None)
    monkeypatch.setattr(jax, "jit", jit)
    jrets, jvecs = map(np.asarray, seen["out"])

    env = make(ENV, device="cpu")
    algo = Envelope(env.dim_info, env.reward_dim, EnvelopeConfig(),
                    device="cpu")
    state = algo.init(torch.Generator().manual_seed(0))
    envelope_state_from_flax(state, jax.tree.map(np.asarray, jstate))
    save_checkpoint(str(pdir / "checkpoint"), state)
    capsys.readouterr()
    assert port.main(["--model_dir", str(pdir), "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.splitlines()[-1])
    penv, palgo, pstate = port.load_state(str(pdir), "cpu")
    rets, vecs = port.rollout(palgo, pstate, penv, port.preferences())

    # the preferences whose JAX trajectory meets a near-tie of its argmax
    ws = jnp.asarray(port.preferences())

    @jax.jit
    def near_ties(ws):
        def step(carry, _):
            s, obs, done, tied = carry
            wq, _ = jalgo._scalarized_q(jstate.params, obs, ws)
            top = jnp.sort(wq, axis=1)
            tied = tied | (~done & (top[:, -1] - top[:, -2] <= 1e-5))
            s, obs, _, term, trunc = jax.vmap(
                lambda s_, a_: jenv.step(s_, a_, jax.random.PRNGKey(0)))(
                s, jnp.argmax(wq, axis=-1))
            return (s, obs, done | term | trunc, tied), None

        s, obs = jax.vmap(lambda _: jenv.reset(jax.random.PRNGKey(0)))(ws)
        none = jnp.zeros(len(ws), bool)
        return jax.lax.scan(step, (s, obs, none, none), None,
                            length=jenv.max_steps)[0][3]

    tied = np.asarray(near_ties(ws))
    print(f"preferences near a tie: {int(tied.sum())} of {len(ws)}")
    keep = ~tied
    np.testing.assert_array_equal(rets[keep], jrets[keep])
    np.testing.assert_array_equal(vecs[keep], jvecs[keep])
    np.testing.assert_array_equal(np.load(pdir / "reward.npy")[keep],
                                  np.load(jdir / "reward.npy")[keep])
    if not tied.any():
        assert got == want
        with open(pdir / "sweep_summary.json") as f:
            assert json.load(f) == want
    # the state makes a sweep worth holding: some preferences reach a
    # treasure of the front, others do not
    assert 0 < want["precision"] < 1 and np.isfinite(rets).all()


def test_shim_writes_only_under_its_roots(tmp_path, monkeypatch, capsys):
    """The shim on the CPU, cut (one seed of 2 episodes at a replay of
    2,000, random actions all through: ``--start_steps`` past the run, the
    learner is ``chip_smoke.envelope_recipe``'s and
    ``tests/test_torch_envelope.py``'s to drive): one process trains and
    sweeps the seed; its raw curve and
    its 100 sweep returns kept under the curves root it is given, with the
    sweep's summary and no sum-tree launch in the provenance, both rows
    stacked raw, and nothing written into the repo's results tree."""
    monkeypatch.setitem(golden.ENVELOPE_RUNS, "ENVELOPE", (
        "ENVELOPE", ENV, 2, 1, 1, ["--batch_size", "32", "--buffer_size",
                                   "2000", "--start_steps", "1000000",
                                   "--save_freq", "2"]))
    monkeypatch.setattr(golden, "DQN_LL_SEEDS16", (3,))
    monkeypatch.setattr(golden, "OURS_ROOT", str(tmp_path / "curves"))
    rows = golden.envelope_rows()
    monkeypatch.setattr(golden, "RUN_ONLY", rows)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    tree = os.path.join(ROOT, "results")
    before = _digest(tree)
    rc = port.main(["--device", "cpu", "--results_root",
                    str(tmp_path / "runs"), "--log_dir",
                    str(tmp_path / "l")])
    out = capsys.readouterr().out
    assert _digest(tree) == before
    assert rc in (0, 1)        # a 2-episode curve may miss its gate
    last = json.loads(out.splitlines()[-1])
    assert [j["rc"] for j in last["jobs"]] == [0]
    with open(tmp_path / "curves" / ENV / "provenance.json") as f:
        prov = json.load(f)
    for s in (3,):
        curve = np.load(golden.seed_file(golden.OURS_ROOT, rows[0], s))
        swept = np.load(golden.seed_file(golden.OURS_ROOT, rows[1], s))
        assert len(curve) >= 2 and swept.shape == (100,)
        for r in rows:
            rec = prov["seeds"][os.path.basename(golden.seed_file("", r, s))]
            assert rec["b1_launches"] == 0 and "precision" in rec["sweep"]
            assert golden.recipe_of(rec["command"]) == [
                a.format(seed=s) for a in r.regen]
            assert golden.kept_seed(golden.OURS_ROOT, r, s)
    assert np.load(tmp_path / "curves" / ENV /
                   "ENVELOPE_sweep_1_seed.npy").shape == (1, 100)
    assert os.path.isfile(tmp_path / "l" / "curves" / ENV /
                          "ENVELOPE_1_seed.npy")


_FAKE_PYTHON = """
import json, os, sys
import numpy as np

args = sys.argv[1:]
if args[:2] == ["-m", "freerl_tpu.cli"]:
    root = args[args.index("--results_root") + 1]
    seed = int(args[args.index("--seed") + 1])
    run = os.path.join(root, "deep-sea-treasure-v0", "ENVELOPE_1")
    os.makedirs(run, exist_ok=True)
    np.save(os.path.join(run, f"ENVELOPE_seed_{seed}.npy"),
            np.full(6, float(seed), np.float32))
    print(f"model_dir: {run}")
    print("episodes: 6  env_steps: 300  steps/s: 70")
elif args[0] == "-c" and "envelope_e2e" in args[1]:
    run = args[2]
    np.save(os.path.join(run, "reward.npy"), np.zeros(100, np.float32))
    with open(os.path.join(run, "sweep_summary.json"), "w") as f:
        json.dump({"precision": 0.5}, f)
else:
    print("0.0")
"""


def test_jax_side_writes_only_under_its_roots(tmp_path, monkeypatch,
                                              capsys):
    """``scripts/torch_jax_head.py`` on the ENVELOPE rows, the interpreter
    stubbed (a fake CLI writes a run dir, a fake sweep its two files): one
    command a seed for both rows, then ``envelope_e2e.sweep(run_dir,
    None)`` on its run dir, recorded as one chained command whose recipe
    is the row's; the seeds' curves and sweep returns kept and stacked
    under ``--out``, run dirs under ``--work``, nothing else written."""
    monkeypatch.setattr(golden, "DQN_LL_SEEDS16", (0, 7))
    rows = golden.envelope_rows()
    monkeypatch.setattr(golden, "RUN_ONLY", rows)
    _stub(tmp_path / "python", _FAKE_PYTHON)
    monkeypatch.setattr(sys, "executable", str(tmp_path / "python"))
    tree = os.path.join(ROOT, "results")
    before = _digest(tree)
    out_root, work = tmp_path / "out", tmp_path / "work"
    rc = head.main([golden.row_key(r) for r in rows] + [
        "--out", str(out_root), "--work", str(work), "--jobs", "2"])
    capsys.readouterr()
    assert rc == 0 and _digest(tree) == before
    assert sorted(os.listdir(tmp_path)) == ["out", "python", "work"]
    with open(out_root / ENV / "provenance.json") as f:
        prov = json.load(f)
    for s in (0, 7):
        for r in rows:
            rec = prov["seeds"][os.path.basename(golden.seed_file("", r, s))]
            assert " && " in rec["command"] and rec["sweep"] == {
                "precision": 0.5}
            assert golden.recipe_of(rec["command"]) == [
                a.format(seed=s) for a in r.regen]
        np.testing.assert_array_equal(
            np.load(golden.seed_file(str(out_root), rows[0], s)),
            np.full(6, float(s), np.float32))
    assert np.load(out_root / ENV / "ENVELOPE_sweep_2_seed.npy").shape == (
        2, 100)
    assert dataclasses.asdict(rows[0])["then_sweep"]


def test_port_seeds_on_the_card_are_kept():
    """The port's seeds of the recipe trained and swept on the card, all
    16 (13 in one call; seeds 1, 12 and 14, cut there at its deadline, in
    a call of their own): each kept for both rows by the recipe, with its
    sweep's summary, no sum-tree launch and the card named; the curve is
    5,000 episodes or more and the sweep 100 finite returns whose mean is
    the summary's. Both rows are stacked raw from the kept seeds."""
    curve_row, sweep_row = golden.envelope_rows()
    with open(os.path.join(golden.OURS_ROOT, ENV, "provenance.json")) as f:
        prov = json.load(f)
    kept = [s for s in curve_row.regen_seeds
            if golden.kept_seed(golden.OURS_ROOT, curve_row, s)]
    assert kept == list(golden.DQN_LL_SEEDS16)
    for s in kept:
        assert golden.kept_seed(golden.OURS_ROOT, sweep_row, s)
        rec = prov["seeds"][f"ENVELOPE_sweep_seed_{s}.npy"]
        assert rec["b1_launches"] == 0 and "H100" in rec["card"]
        assert rec == prov["seeds"][f"ENVELOPE_seed_{s}.npy"] | {
            "final50": rec["final50"]}
        swept = np.load(golden.seed_file(golden.OURS_ROOT, sweep_row, s))
        assert swept.shape == (100,) and np.isfinite(swept).all()
        assert float(swept.mean()) == pytest.approx(
            rec["sweep"]["sweep_mean_scalarized_return"], abs=1e-5)
        assert all(0 <= rec["sweep"][k] <= 1 for k in ("precision",
                                                       "recall", "CR"))
        curve = np.load(golden.seed_file(golden.OURS_ROOT, curve_row, s))
        assert len(curve) >= 5000 and rec["episodes"] >= 5000
    for row in (curve_row, sweep_row):
        stack = np.load(os.path.join(golden.OURS_ROOT, ENV,
                                     row.algo + ".npy"))
        seeds = [np.load(golden.seed_file(golden.OURS_ROOT, row, s))
                 for s in kept]
        t = min(len(c) for c in seeds)
        np.testing.assert_array_equal(stack, np.stack([c[:t]
                                                       for c in seeds]))
        assert prov["stacks"][row.algo]["seeds"] == kept


def test_probe_projects_each_seed(tmp_path):
    """``--probe``'s projections: the probe's seconds an env step times a
    seed's env steps, plus its start-up; the steps from the JAX package's
    run of the seed at this commit where one is kept, else from the
    recipe's committed TPU log (the larger of two runs of a seed), else the
    most that log holds."""
    logged = port.logged_env_steps()
    assert (logged[2], logged[5], logged[12]) == (146_944, 35_840, 34_048)
    assert 0 not in logged and 14 not in logged
    os.makedirs(tmp_path / ENV)
    with open(tmp_path / ENV / "provenance.json", "w") as f:
        json.dump({"seeds": {"ENVELOPE_seed_10.npy": {"env_steps": 1000}}},
                  f)
    got = port.projections(dict(loop_s=50.0, env_steps=5000, seconds=60.0),
                           head_root=str(tmp_path))
    seeds = got["seeds"]
    assert got["s_per_env_step"] == 0.01 and got["startup_s"] == 10.0
    assert seeds["10"] == dict(env_steps=1000, source="jax_head",
                               projected_s=20.0)
    assert seeds["2"]["source"] == "log" and seeds["0"] == dict(
        env_steps=146_944, source="log_max", projected_s=1479.4)
    assert got["longest_s"] == 1479.4 and len(seeds) == 16
