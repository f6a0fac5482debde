"""``scripts/torch_gail_e2e.py`` against the JAX package's
``scripts/gail_e2e.py``: the four stages' configs and arguments against
what the JAX script builds (its ``main()`` run in this process with its
training, evaluation and expert-set calls replaced by recorders), the
artifact set and ``golden.check_scalar`` on a two-iteration CPU run, the
expert the port evaluates and rolls into its expert set against the JAX
script's ``expert.evaluate_action`` (one PPO expert carried across with
``convert.py``, its observation normalizer included), the JAX side's runs
kept under ``results/torch/jax_head/gail/``, and ``chip_smoke.gail_recipe``
on the CPU.

Tolerances: configs, arguments, keys and counts exactly; the expert's
actions within 1e-5 and its evaluation returns within 1e-3 (float32
rounding of 200 Pendulum steps under one policy, as in the env tests)."""
import dataclasses
import glob
import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import freerl_tpu.algos.gail as jax_gail_mod
from freerl_tpu.algos.ppo import PPO as JaxPPO
from freerl_tpu.envs import make as jax_make
from freerl_tpu.train import golden as jax_golden
from freerl_tpu.train.evaluate import evaluate as jax_eval
from freerl_tpu_torch.algos import PPO, collect_expert_data
from freerl_tpu_torch.convert import net_params_from_flax
from freerl_tpu_torch.envs import make
from freerl_tpu_torch.train import evaluate, golden
from scripts import torch_gail_e2e as e2e
from scripts import torch_jax_head as head
from tests.test_torch_envelope_e2e import _digest
from tests.test_torch_pixel_curve import _same_fields

torch.set_num_threads(1)

# the modules, not the names ``freerl_tpu.train`` exports in their place
jax_evaluate_mod = importlib.import_module("freerl_tpu.train.evaluate")
jax_onpolicy_mod = importlib.import_module("freerl_tpu.train.onpolicy")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE = golden.SCALAR_GATES[0]
JAX_RUN = os.path.join(ROOT, "results", "gail", "Pendulum-v1", "GAIL",
                       "20260821-044018")


def _record_jax_main(monkeypatch, tmp_path, argv) -> dict:
    """What scripts/gail_e2e.py's ``main()`` hands its stages, its training
    and evaluation replaced by recorders; the script runs to its end and
    writes its artifact set under ``tmp_path``."""
    from scripts import gail_e2e

    got = {"evaluate": [], "collect": None}

    def train_onpolicy(env, algo, cfg):
        got.update(expert=algo.cfg, expert_loop=cfg, env=env)
        return None, np.zeros(60, np.float32), {}

    def evaluate_(env, act, **kw):
        got["evaluate"].append(kw)
        return np.full(kw["n_episodes"], -150.0, np.float32)

    def collect(env, act, n, **kw):
        got["collect"] = dict(n=n, seed=kw["seed"],
                              out=os.path.basename(kw["out_path"]))
        return None

    def train_gail(env, gail, data, **kw):
        got.update(gail_ppo=gail.ppo.cfg, gail_cfg=gail.cfg, gail_kw=kw)
        return None, np.zeros(kw["num_iterations"], np.float32), []

    monkeypatch.setattr(jax_onpolicy_mod, "train_onpolicy", train_onpolicy)
    monkeypatch.setattr(jax_evaluate_mod, "evaluate", evaluate_)
    monkeypatch.setattr(jax_gail_mod, "collect_expert_data", collect)
    monkeypatch.setattr(jax_gail_mod, "train_gail", train_gail)
    monkeypatch.setattr(sys, "argv", ["gail_e2e.py", "--out",
                                      str(tmp_path / "jax"), *argv])
    assert gail_e2e.main() == 0
    return got


@pytest.mark.parametrize("argv", [[], ["--expert_episodes", "40", "--seed",
                                       "3", "--gail_iters", "5"]])
def test_stages_are_the_jax_scripts(argv, tmp_path, monkeypatch):
    """The expert's ``PPOConfig`` and ``OnPolicyConfig``, GAIL's
    ``PPOConfig`` and ``GAILConfig``, ``train_gail``'s arguments, the two
    evaluations and the expert set's arguments: the port's shim builds
    what the JAX script builds, field by field (the JAX expert's
    ``critic_lr``, a field its PPO never reads, is the one the port leaves
    out); the script's defaults are ``golden.GAIL_RUNS``'."""
    got = _record_jax_main(monkeypatch, tmp_path, argv)
    args = dict(golden.GAIL_RUNS["GAIL_Pendulum_eval"])
    for flag, value in zip(argv[::2], argv[1::2]):
        args[flag[2:]] = int(value)
    expert, loop = e2e.expert_configs(args["expert_episodes"], args["seed"])
    assert got["expert"].critic_lr == 3e-4
    assert not hasattr(expert, "critic_lr")
    _same_fields(expert, dataclasses.replace(got["expert"],
                                             critic_lr=type(got["expert"])()
                                             .critic_lr))
    _same_fields(loop, got["expert_loop"])
    ppo, gail = e2e.gail_configs()
    _same_fields(ppo, got["gail_ppo"])
    _same_fields(gail, got["gail_cfg"])
    assert got["gail_kw"] == dict(num_iterations=args["gail_iters"],
                                  num_envs=8, seed=args["seed"] + 1)
    assert got["evaluate"] == [dict(n_episodes=10, seed0=1000)] * 2
    assert got["collect"] == dict(n=args["n_expert_transitions"],
                                  seed=args["seed"], out="expert_data.npz")
    assert got["env"].name == "Pendulum-v1"


def test_two_iteration_cpu_run_is_read_by_check_scalar(tmp_path,
                                                       monkeypatch, capsys):
    """The shim on the CPU, cut to 8 expert episodes, 2 GAIL iterations and
    2,000 expert pairs, into ``--out``: the JAX script's artifact set, each
    with the keys the JAX script writes (its committed run's), a
    ``run.json`` with each stage's seconds and no sum-tree launch, and
    ``golden.check_scalar`` reads the run's summary for the gate; nothing
    is written into the repo's results tree. Without a card, ``--device
    cuda`` exits non-zero."""
    tree = os.path.join(ROOT, "results")
    before = _digest(tree)
    out = tmp_path / "gail"
    assert e2e.main(["--device", "cpu", "--expert_episodes", "8",
                     "--gail_iters", "2", "--n_expert_transitions", "2000",
                     "--out", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert _digest(tree) == before
    run_dir, = glob.glob(str(out / "Pendulum-v1" / "GAIL" / "*"))
    assert sorted(os.listdir(run_dir)) == sorted(os.listdir(JAX_RUN) + [
        "run.json"])
    for name in ("summary.json", "config.json"):
        with open(os.path.join(run_dir, name)) as f, \
                open(os.path.join(JAX_RUN, name)) as g:
            mine, theirs = json.load(f), json.load(g)
        assert set(theirs) <= set(mine), name
    for name in ("eval_rewards.npz", "expert_data.npz"):
        with np.load(os.path.join(run_dir, name)) as a, \
                np.load(os.path.join(JAX_RUN, name)) as b:
            assert sorted(a.files) == sorted(b.files), name
            assert all(a[k].dtype == b[k].dtype for k in a.files), name
    with np.load(os.path.join(run_dir, "expert_data.npz")) as d:
        assert d["states"].shape == (2000, 3)
    with open(os.path.join(run_dir, "run.json")) as f:
        rec = json.load(f)
    assert rec["b1_launches"] == 0 and rec["gail_iterations"] == 2
    assert (rec["expert_episodes"], rec["expert_iterations"]) == (8, 4)
    assert set(rec["seconds"]) == {"expert", "expert_data", "gail", "eval"}
    row = golden.check_scalar(GATE, root=str(tmp_path))
    assert row["status"] in ("pass", "FAIL")
    assert row["ours"] == line["gail_eval_avg"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert e2e.main(["--out", str(out)]) == 1


def _expert_pair():
    """One PPO expert with the JAX script's config on Pendulum-v1, its
    observation normalizer fed a spread of raw observations, in both
    packages: the port's carried across from the JAX one's params and
    stats."""
    jenv, env = jax_make("Pendulum-v1"), make("Pendulum-v1", device="cpu")
    cfg, _ = e2e.expert_configs(3000, 0)
    jcfg = type(JaxPPO(jenv.dim_info).cfg)(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    jalgo = JaxPPO(jenv.dim_info, jcfg)
    jstate = jalgo.init(jax.random.PRNGKey(5))
    algo = PPO(env.dim_info, cfg, device="cpu")
    state = algo.init(torch.Generator().manual_seed(0))
    state.actor.load_state_dict(net_params_from_flax(jax.tree.map(
        np.asarray, jstate.actor_params)))
    state.critic.load_state_dict(net_params_from_flax(jax.tree.map(
        np.asarray, jstate.critic_params)))
    rng = np.random.RandomState(1)
    raw = np.concatenate([np.cos(th := rng.uniform(-np.pi, np.pi, 512)),
                          np.sin(th), rng.uniform(-8, 8, 512)]).reshape(
        3, 512).T.astype(np.float32)
    jstate = jstate.replace(obs_rms=jstate.obs_rms.update(jnp.asarray(raw)))
    state.obs_rms = state.obs_rms.update(torch.from_numpy(raw))
    return (jenv, lambda o: jalgo.evaluate_action(jstate, o),
            env, lambda o: algo.evaluate_action(state, o))


def test_expert_acts_as_the_jax_expert():
    """The expert the port evaluates and rolls into its expert set acts as
    the JAX script's ``expert.evaluate_action``: the same deterministic
    actions on the same raw observations; the 10-episode evaluation from
    seed 1000 with the JAX run's reset draws fed in gives the JAX
    evaluation's returns; and every pair of the port's expert set holds
    the action the JAX expert takes on its state."""
    jenv, jact, env, act = _expert_pair()
    obs = np.random.RandomState(2).randn(64, 3).astype(np.float32) * 3
    np.testing.assert_allclose(act(torch.from_numpy(obs)).numpy(),
                               np.asarray(jact(jnp.asarray(obs))),
                               atol=1e-5)
    want = jax_eval(jenv, jact, n_episodes=10, seed0=1000)

    def reset(key):
        k1, k2 = jax.random.split(key)
        return jnp.stack([
            jax.random.uniform(k1, (), jnp.float32, -jnp.pi, jnp.pi),
            jax.random.uniform(k2, (), jnp.float32, -1.0, 1.0)])

    keys = jax.random.split(jax.random.PRNGKey(1000), 10)
    draws = (torch.from_numpy(np.array(jax.vmap(reset)(keys))),
             [None] * env.max_steps)
    got = evaluate(env, act, n_episodes=10, draws=draws)
    assert len(set(np.round(want, 3).tolist())) > 1
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    data = collect_expert_data(env, act, 512, seed=0)
    np.testing.assert_allclose(
        data.actions.numpy(),
        np.asarray(jact(jnp.asarray(data.states.numpy()))), atol=1e-5)


def test_jax_side_is_kept():
    """The JAX package's scripts/gail_e2e.py at this commit, seeds 0-7 on
    the CPU, kept by ``torch_jax_head.py --gail``: each seed's summary,
    eval returns and curves, and a record of its command (the script's
    own defaults but the seed and ``--out``), the JAX version, the device
    and the two evaluations, which are the summary's."""
    root = os.path.join(golden.JAX_HEAD_ROOT, "gail", "Pendulum-v1")
    with open(os.path.join(root, "provenance.json")) as f:
        prov = json.load(f)["seeds"]
    assert sorted(prov) == [f"GAIL_seed_{s}" for s in range(8)]
    for s in range(8):
        keep = head.gail_dir(golden.JAX_HEAD_ROOT, s)
        assert sorted(os.listdir(keep)) == sorted(head.GAIL_KEPT)
        rec = prov[f"GAIL_seed_{s}"]
        with open(os.path.join(keep, "summary.json")) as f:
            summary = json.load(f)
        assert rec["device"] == "cpu" and rec["seconds"] > 0
        assert rec["command"].endswith(
            f"python -m scripts.gail_e2e --cpu --seed {s} --out "
            f"'<work>/gail/seed_{s}'")
        for k in ("expert_eval_avg", "gail_eval_avg"):
            assert rec[k] == summary[k]
        assert len(np.load(os.path.join(keep, "gail_true_reward_curve.npy"))
                   ) == golden.GAIL_RUNS["GAIL_Pendulum_eval"]["gail_iters"]


def test_gate_is_the_jax_packages():
    """The gate the port's summary is held to is the JAX package's."""
    assert GATE == jax_golden.SCALAR_GATES[0]
    assert GATE["name"] in golden.GAIL_RUNS


def test_recipe_on_the_cpu():
    """``chip_smoke.gail_recipe`` on the CPU: the four stages cut to 8
    expert episodes and 2 GAIL iterations, the artifact set whole and read
    by ``check_scalar``, no sum-tree launch, and no global random state
    moved (it runs side by side)."""
    import chip_smoke

    before = chip_smoke.global_rng_states()
    got = chip_smoke.gail_recipe("GAIL_Pendulum_eval", "cpu")
    assert chip_smoke.moved_rngs(before, chip_smoke.global_rng_states()) == []
    assert got["launches"] == 0
    assert "8 expert episodes in 4 iterations" in got["line"]


def test_port_seed_on_the_card_is_held_by_c20():
    """The port's seed 0 of scripts/gail_e2e.py at its defaults, trained on
    the card: the whole artifact set under the port's results tree, its
    run record (the card, 3,000 expert episodes in 1,500 iterations, 800
    GAIL iterations, no sum-tree launch), and ``golden.check_scalar``
    reading its summary for the gate: FAIL, the gate held to fail under
    C20 (``golden.OPEN_FAULTS``)."""
    run_dir, = glob.glob(os.path.join(e2e.DEFAULT_OUT, "Pendulum-v1", "GAIL",
                                      "*"))
    assert sorted(os.listdir(run_dir)) == sorted(os.listdir(JAX_RUN) + [
        "run.json"])
    with open(os.path.join(run_dir, "run.json")) as f:
        rec = json.load(f)
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    assert rec["b1_launches"] == 0 and "H100" in rec["card"]
    assert (rec["expert_episodes"], rec["expert_iterations"],
            rec["gail_iterations"]) == (3000, 1500, 800)
    assert len(np.load(os.path.join(run_dir, "gail_true_reward_curve.npy"))
               ) == 800
    row = golden.check_scalar(GATE)
    assert row["ours"] == summary["gail_eval_avg"]
    assert golden.OPEN_FAULTS[GATE["name"]] == "C20"
    assert golden.must_fail(GATE["name"]) and row["status"] == "FAIL"
    assert not golden.breaks_hold(GATE["name"], row["status"])


@pytest.mark.parametrize("gail_eval,held,fails", [
    (-150.0, False, False), (-402.8, False, True), (-402.8, True, False),
    (-150.0, True, True)])
def test_gate_is_held_in_golden_vs_jax(gail_eval, held, fails, tmp_path,
                                       monkeypatch):
    """``chip_smoke.py``'s ``golden vs jax`` holds the GAIL gate as it holds
    a row: a summary that misses the gate fails the phase unless an open
    fault holds it, a held gate that passes fails it, and a missing
    summary fails it."""
    import chip_smoke

    run = tmp_path / "gail" / "Pendulum-v1" / "GAIL" / "20000101-000000"
    os.makedirs(run)
    with open(run / "summary.json", "w") as f:
        json.dump({"gail_eval_avg": gail_eval}, f)
    monkeypatch.setattr(golden, "OURS_ROOT", str(tmp_path / "curves"))
    monkeypatch.setattr(golden, "JAX_PARITY", [])
    monkeypatch.setattr(golden, "OPEN_FAULTS",
                        {GATE["name"]: "C20"} if held else {})
    if fails:
        with pytest.raises(AssertionError, match=GATE["name"]):
            chip_smoke.phase_golden_vs_jax()
    else:
        chip_smoke.phase_golden_vs_jax()
    os.remove(run / "summary.json")
    with pytest.raises(AssertionError, match="missing"):
        chip_smoke.phase_golden_vs_jax()


def test_c20_rule_reads_both_sides(tmp_path):
    """``scripts/torch_seed_spread.py --gail``: each side's runs by seed (a
    stamped run dir by its ``config.json``, a ``GAIL_seed_<s>`` dir by its
    name), the Mann-Whitney p over the seeds both keep, and C20's rule:
    p >= 0.05 over at least 8 seeds a side; two runs of one seed refused."""
    from scripts import torch_seed_spread as spread

    def keep(d, value, seed=None):
        os.makedirs(d)
        with open(d / "summary.json", "w") as f:
            json.dump({"gail_eval_avg": value,
                       "expert_eval_avg": value / 2}, f)
        if seed is not None:
            with open(d / "config.json", "w") as f:
                json.dump({"seed": seed}, f)

    ours, ref = tmp_path / "ours", tmp_path / "ref"
    keep(ours / "Pendulum-v1" / "GAIL" / "20000101-000000", -400.0, 0)
    for s in range(1, 9):
        keep(ours / "Pendulum-v1" / f"GAIL_seed_{s}", -300.0 - 10 * s)
    for s in range(8):
        keep(ref / "Pendulum-v1" / f"GAIL_seed_{s}", -310.0 - 10 * s)
    got = spread.gail_rule(str(ours), str(ref))
    assert got["seeds"] == list(range(8)) and got["port"][0] == -400.0
    assert got["closes"] and got["mannwhitney"]["p"] >= 0.05
    assert got["past_gate_port"] == got["past_gate_jax"] == []
    assert got["expert"]["port"][0] == -200.0
    assert got["expert"]["mannwhitney"] == got["mannwhitney"]
    for s in range(8):
        os.remove(ref / "Pendulum-v1" / f"GAIL_seed_{s}" / "summary.json")
        keep(ref / "Pendulum-v1" / f"run_{s}", -150.0, s)
    got = spread.gail_rule(str(ours), str(ref))
    assert not got["closes"] and got["mannwhitney"]["p"] < 0.05
    assert got["past_gate_jax"] == list(range(8))
    keep(ours / "Pendulum-v1" / "GAIL" / "20000101-000001", -400.0, 0)
    with pytest.raises(ValueError, match="two GAIL runs of seed 0"):
        spread.gail_evals(str(ours))


def test_c20_stays_open_over_8_seeds_a_side():
    """C20's rule over the committed runs: the port's seeds 0-7 of
    scripts/gail_e2e.py at its defaults on the card (seed 0 the gate's
    run, 1-7 kept as ``GAIL_seed_<s>``, each with its card record, 800
    GAIL iterations and no sum-tree launch), scored on the JAX package's
    held-out episodes, against the JAX package's seeds 0-7 at this commit:
    p 0.161, experts p >= 0.05. Each run names its tree: Pendulum's step
    before ``envs/classic.py:fma32``, so the rule has not yet run on the
    tree that rounds as JAX, and C20 stays open in ``golden.OPEN_FAULTS``
    until it has. The runs the generator's episodes scored, kept beside
    them, read p 0.0030 (experts 0.00016)."""
    from scripts import torch_seed_spread as spread

    for s in range(8):
        run, = (glob.glob(os.path.join(e2e.DEFAULT_OUT, "Pendulum-v1", "GAIL",
                                       "*")) if s == 0 else
                [os.path.join(e2e.DEFAULT_OUT, "Pendulum-v1",
                              f"GAIL_seed_{s}")])
        with open(os.path.join(run, "run.json")) as f:
            rec = json.load(f)
        assert "H100" in rec["card"] and rec["b1_launches"] == 0
        assert (rec["expert_episodes"], rec["gail_iterations"]) == (3000, 800)
        assert "before" in rec["tree"] and "fma32" in rec["tree"]
    ref = os.path.join(golden.JAX_HEAD_ROOT, "gail")
    got = spread.gail_rule(e2e.DEFAULT_OUT, ref)
    assert got["seeds"] == list(range(8))
    assert got["mannwhitney"]["p"] == pytest.approx(0.1605, abs=1e-4)
    assert got["expert"]["mannwhitney"]["p"] >= 0.05
    assert golden.OPEN_FAULTS[GATE["name"]] == "C20"
    assert GATE["name"] not in golden.STALE_REFERENCES
    before = spread.gail_rule(os.path.join(
        os.path.dirname(e2e.DEFAULT_OUT), "gail_generator_eval"), ref)
    assert before["mannwhitney"]["p"] < 0.05
    assert before["expert"]["mannwhitney"]["p"] < 0.05
