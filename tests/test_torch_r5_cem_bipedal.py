"""``scripts/torch_r5_cem_bipedal.py`` against the JAX package's
``scripts/r5_cem_bipedal.py``: the same recipe (read by running a copy of
the JAX script with its library stubbed, so nothing is written into
``results/learning_curves/``), the row of ``golden.cem_bipedal_rows`` with
SPECS' gate of its stem, the card runner's job, a draw's record, and two
episodes of the script's function on the CPU against the JAX package's
``train_cem_gd3pg`` on the same draws.

The walker's episodes are cut to one step there. From the recipe's pinned
start a knee reaches its upper limit exactly within two steps, and
whether the next step's ``rel >= hi`` holds there is decided by the last
bit of float32 rounding, which the two frameworks round apart (row 1 of a
population reads knee-R speed 0.1466 in JAX and -0.0 in the port at step
2; the walker's own tests, ``tests/test_torch_bipedal.py``, teacher-force
every step for that reason). So one-step episodes: the population
evaluation of 10 rows, two fused 4-lane episodes, their learner bursts
(``start_steps`` cut to 5), every draw JAX's. The loop at the length of
its chunks is held on a replayed walk instead: both sides replay the JAX
walker's own 47-step walk to a crash whatever the actions, so 64-step
episodes run the auto-reset inside the chunk and three bursts of 47
learner steps, each step held against the JAX package's ``learn``
teacher-forced (``test_bursts_over_a_replayed_walk_match_jax``).

Tolerances: every net within 1e-5, as the existing CEM tests hold it
(``tests/test_torch_cem_es.py``: float32 matmul and Adam rounding in two
frameworks); the returns and the fitness EMAs within rtol 1e-5 and atol
2e-5, the walker tests' tolerance for a reward (a walker reward is the
difference of two shaping values near 20, whose float32 ulp is 1.9e-6).
"""
import dataclasses
import importlib.util
import json
import multiprocessing as mp
import os
import shutil
import sys
import types

import jax
import numpy as np
import pytest
import torch

import freerl_tpu.algos.cem_gd3pg as jax_cem
import freerl_tpu.envs as jax_envs
import freerl_tpu.envs.base as jax_base
from freerl_tpu.train import golden as jax_golden
from freerl_tpu_torch.algos import CEMGD3PG, CEMGD3PGConfig
from freerl_tpu_torch.algos.cem_gd3pg import CEMDraws, RolloutDraws
from freerl_tpu_torch.convert import (cem_gd3pg_state_from_flax,
                                     net_params_from_flax)
from freerl_tpu_torch.core import jax_prng
from freerl_tpu_torch.envs.base import Env, FixedResetWrapper
from freerl_tpu_torch.train import golden
from scripts import r5_cem_bipedal as jax_script
from scripts import torch_golden_card as card
from scripts import torch_r5_cem_bipedal as cem
from tests.test_torch_cem_es import assert_states_close

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEM = cem.STEM
GATE = ("window", "slack", "agg", "slack_mode", "overlap_gate", "floor")


@pytest.fixture(scope="module")
def jax_calls(tmp_path_factory):
    """What a copy of the JAX script passes its library for ``--runs 4``:
    the env it makes, the seed it pins, the config and each draw's
    ``train_cem_gd3pg`` arguments."""
    tmp = tmp_path_factory.mktemp("cem")
    os.makedirs(tmp / "scripts")
    shutil.copy(jax_script.__file__, tmp / "scripts" / "r5_cem_bipedal.py")
    spec = importlib.util.spec_from_file_location(
        "_cem_copy", tmp / "scripts" / "r5_cem_bipedal.py")
    copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy)
    seen = dict(envs=[], pinned=[], configs=[], train=[])

    def make(name):
        seen["envs"].append(name)
        return types.SimpleNamespace(dim_info=None)

    def pin(env, seed=0):
        seen["pinned"].append(seed)
        return env

    def config(**kw):
        seen["configs"].append(kw)
        return kw

    def train(env, algo, **kw):
        kw.pop("on_episode")
        seen["train"].append(kw)
        return None, np.zeros(60), {}

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_envs, "make", make)
    mp.setattr(jax_base, "FixedResetWrapper", pin)
    mp.setattr(jax_cem, "CEMGD3PGConfig", config)
    mp.setattr(jax_cem, "CEMGD3PG", lambda dim_info, cfg: None)
    mp.setattr(jax_cem, "train_cem_gd3pg", train)
    mp.setattr(sys, "argv", ["r5_cem_bipedal.py", "--runs", "4"])
    try:
        assert copy.main() == 0
    finally:
        mp.undo()
    assert os.path.isfile(tmp / "results" / "learning_curves" /
                          "BipedalWalker-v3" / "CEM_GD3PG_4_seed.npy")
    return seen


def test_recipe_is_the_jax_scripts(jax_calls, monkeypatch):
    """``golden.CEM_BIPEDAL_RUNS`` is the JAX script's recipe, and the
    port's ``train`` runs it: the env, its pinned start, the config and
    each draw's arguments (seed ``1000 * run``)."""
    env_name, reset_seed, cfg, args = golden.CEM_BIPEDAL_RUNS[STEM]
    assert jax_calls["envs"] == [env_name] * 4
    assert jax_calls["pinned"] == [reset_seed] * 4
    assert jax_calls["configs"] == [cfg] * 4
    assert jax_calls["train"] == [
        dict(args, seed=golden.cem_bipedal_seed(run)) for run in range(4)]
    seen = []

    def train(env, algo, **kw):
        seen.append((env, algo, kw))
        return types.SimpleNamespace(step=0), np.zeros(3), {}

    import freerl_tpu_torch.algos.cem_gd3pg as port_cem
    monkeypatch.setattr(port_cem, "train_cem_gd3pg", train)
    for run in range(4):
        cem.train(run, "cpu")
    for run, (env, algo, kw) in enumerate(seen):
        assert isinstance(env, FixedResetWrapper) and env.name == env_name
        assert env.max_steps == 1600
        want = env.env.key_reset_draw(jax_prng.prng_key(reset_seed))
        assert torch.equal(env._reset_draw, want)
        assert algo.cfg == CEMGD3PGConfig(**cfg)
        assert {k: v for k, v in kw.items()
                if k not in ("draws", "on_episode")} == dict(
            args, seed=golden.cem_bipedal_seed(run))


def test_row_takes_the_specs_gate():
    """The row: SPECS' gate of the stem (window 50, slack 300, floor
    -110.5, best draw), the JAX package's committed 4-draw stack as its
    reference, runs 0-3 through the port's script, stacked raw."""
    want = next(s for s in jax_golden.SPECS if (s.env, s.algo) ==
                ("BipedalWalker-v3", STEM))
    rows = [r for r in golden.JAX_PARITY + golden.RUN_ONLY
            if (r.env, r.algo) == ("BipedalWalker-v3", STEM)]
    assert rows == golden.cem_bipedal_rows() and len(rows) == 1
    row = rows[0]
    assert [getattr(row, f) for f in GATE] == [getattr(want, f)
                                               for f in GATE]
    assert (row.window, row.slack, row.floor, row.agg) == (50, 300.0, -110.5,
                                                           "best")
    assert row.ref_path == f"BipedalWalker-v3/{STEM}.npy" and not row.smooth
    assert row.script == "r5_cem_bipedal" and row.regen_seeds == (0, 1, 2, 3)
    assert golden.row_key(row) == f"BipedalWalker-v3/{STEM}"
    ref = np.load(os.path.join(golden.JAX_CURVES_ROOT, row.ref_path))
    assert ref.shape == (4, 500)
    assert [round(float(x), 1) for x in ref[:, -50:].mean(1)] == [
        81.9, 143.2, 13.5, 74.5]


def test_card_runner_runs_the_script(tmp_path, monkeypatch):
    """The card runner makes one job a draw, the port's script with
    ``--run``; a draw kept already is not run again unless forced; the
    record a draw keeps names its recipe."""
    monkeypatch.setattr(golden, "OURS_ROOT", str(tmp_path))
    key = f"BipedalWalker-v3/{STEM}"
    jobs = card.make_jobs(None, [key], 1, "cuda", "R", True)
    assert [j["seed"] for j in jobs] == [0, 1, 2, 3]
    assert jobs[2]["argv"] == [sys.executable, "-m",
                               "scripts.torch_r5_cem_bipedal", "--run", "2",
                               "--device", "cuda"]

    def fake(run, device, **kw):
        returns = np.arange(kw["max_episodes"], dtype=np.float64) + run
        return dict(state=types.SimpleNamespace(step=40), returns=returns,
                    info=dict(env_steps=1234, episodes=len(returns)),
                    launches=0, k2=0, k3=0, seconds=1.0)

    monkeypatch.setattr(cem, "train", fake)
    rec = cem.run_draw(2, 500, "cpu", str(tmp_path))
    row = golden.cem_bipedal_rows()[0]
    assert golden.recipe_of(rec["command"]) == ["--run", "2"]
    assert rec["train_seed"] == 2000 and rec["b1_launches"] == 0
    assert rec["learner_steps"] == 40 and rec["final50"] == 476.5
    assert golden.kept_seed(str(tmp_path), row, 2)
    assert not golden.kept_seed(str(tmp_path), row, 1)
    assert [j["seed"] for j in card.make_jobs(None, [key], 1, "cuda", "R",
                                              True)] == [0, 1, 3]
    assert len(card.make_jobs(None, [key], 1, "cuda", "R", False)) == 4
    cut = cem.run_draw(1, 20, "cpu", str(tmp_path))
    assert golden.recipe_of(cut["command"]) == ["--run", "1", "--episodes",
                                                "20"]
    with pytest.raises(ValueError):
        golden.kept_seed(str(tmp_path), row, 1)


def _record_seeds(root, worker, n):
    for k in range(n):
        golden.update_provenance(root, "Env-v0",
                                 seeds={f"w{worker}_{k}.npy": {"k": k}})


def test_draws_finishing_together_keep_every_record(tmp_path):
    """The draws of a row run in processes of their own and each writes
    its record into the env's ``provenance.json`` when it ends: more
    writers than cores, at once, keep every record (the file is rewritten
    under a lock)."""
    ctx = mp.get_context("spawn")
    workers = (os.cpu_count() or 1) + 2
    procs = [ctx.Process(target=_record_seeds, args=(str(tmp_path), w, 20))
             for w in range(workers)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    assert not any(p.is_alive() for p in procs)
    assert all(p.exitcode == 0 for p in procs)
    with open(tmp_path / "Env-v0" / "provenance.json") as f:
        prov = json.load(f)
    assert len(prov["seeds"]) == workers * 20 and prov["stacks"] == {}


def test_the_draws_against_the_committed_draws():
    """``torch_seed_spread.py --committed`` on the row: the port's kept
    draws against the JAX package's committed stack, draw by draw, the
    final-50 of each raw curve, and the two-sided Mann-Whitney p over the
    4 a side (ROADMAP A5: the gap it does not decide)."""
    from scripts import torch_seed_spread as spread

    got = spread.committed(golden.OURS_ROOT, golden.JAX_CURVES_ROOT,
                           "BipedalWalker-v3", STEM)
    want = np.load(os.path.join(golden.JAX_CURVES_ROOT, "BipedalWalker-v3",
                                f"{STEM}.npy"))[:, -50:].mean(1)
    np.testing.assert_allclose(got["jax"], want)
    for run, final in enumerate(got["port"]):
        raw = np.load(os.path.join(golden.OURS_ROOT, "BipedalWalker-v3",
                                   "seeds", f"CEM_GD3PG_seed_{run}.npy"))
        assert final == pytest.approx(float(raw[-50:].mean()))
    assert got["mannwhitney"]["U"] == 2.0
    assert got["mannwhitney"]["p"] == pytest.approx(0.1142857, abs=1e-6)


def test_no_card_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cem.main(["--run", "0"]) == 1
    assert cem.main(["--probe", "2"]) == 1


class WalkerJaxDraws(CEMDraws):
    """The draws the JAX ``train_cem_gd3pg(seed=seed)`` makes, in its key
    order, on the pinned walker: the action noise and the replay indices
    (every reset is pinned, so its draws are placeholders, and the walker's
    step draws nothing)."""

    def __init__(self, seed):
        super().__init__(torch.Generator().manual_seed(0))
        self.key = jax.random.split(jax.random.PRNGKey(seed))[1]

    def _split(self):
        k, self.key = jax.random.split(self.key)
        return k

    @staticmethod
    def _pinned(rows, steps, reset=True):
        placeholder = torch.zeros(rows, 210)
        return (placeholder if reset else None), [None] * steps, [
            placeholder] * steps

    def population(self, env, P, T):
        self._split()
        return RolloutDraws(*self._pinned(P, T))

    def chunk(self, env, first, steps):
        if first:
            _, self.ck = jax.random.split(self._split())
        normal = []
        for _ in range(steps):
            self.ck, kn, _ = jax.random.split(self.ck, 3)
            normal.append(torch.from_numpy(np.array(
                jax.random.normal(kn, (4, 4)))))
        return RolloutDraws(*self._pinned(4, steps, first),
                            torch.stack(normal))

    def burst(self, n_upd, half_b, size, size_domain):
        k = self._split()
        idx1, idx2 = [], []
        for _ in range(n_upd):
            k, k1, k2 = jax.random.split(k, 3)
            idx1.append(np.asarray(jax.random.randint(k1, (half_b,), 0, size)))
            idx2.append(np.asarray(jax.random.randint(k2, (half_b,), 0,
                                                      size_domain)))
        return (torch.from_numpy(np.stack(idx1)).long(),
                torch.from_numpy(np.stack(idx2)).long())


def test_two_episodes_match_jax():
    """Draw 1 (training seed 1000) of the recipe for 2 one-step episodes:
    the env steps, the learner steps, the returns, the float32 fitness
    EMAs and every net against the JAX package's run on its draws."""
    run, T, episodes, start = 1, 1, 2, 5
    seed = golden.cem_bipedal_seed(run)
    env_name, reset_seed, cfg, _ = golden.CEM_BIPEDAL_RUNS[STEM]
    walker = jax_envs.make(env_name)
    walker.max_steps = T
    jenv = jax_base.FixedResetWrapper(walker, seed=reset_seed)
    jalgo = jax_cem.CEMGD3PG(jenv.dim_info, jax_cem.CEMGD3PGConfig(**cfg))
    jinit = jalgo.init(jax.random.split(jax.random.PRNGKey(seed))[0])
    np.random.seed(seed)
    jstate, jreturns, jinfo = jax_cem.train_cem_gd3pg(
        jenv, jalgo, max_episodes=episodes, seed=seed, start_steps=start,
        full_ratio=True)

    class Seeded(CEMGD3PG):
        def init(self, generator):
            state = super().init(generator)
            cem_gd3pg_state_from_flax(state, jax.tree.map(np.asarray, jinit))
            return state

    r = cem.train(run, "cpu", algo_cls=Seeded, draws=WalkerJaxDraws(seed),
                  max_steps=T, max_episodes=episodes, start_steps=start)
    state, returns, info = r["state"], r["returns"], r["info"]
    assert info["env_steps"] == jinfo["env_steps"] == 10 * T + episodes * T
    np.testing.assert_allclose(returns, jreturns, rtol=1e-5, atol=2e-5)
    for name in ("f1_total", "f2_total"):
        np.testing.assert_allclose(float(getattr(state, name)),
                                   float(getattr(jstate, name)), rtol=1e-5,
                                   atol=2e-5)
    assert state.step == int(jstate.step) == episodes * T
    assert r["launches"] == r["k2"] == r["k3"] == 0
    assert_states_close(state, jstate, "after 2 episodes")


# the walker's torque cost a unit of |action|: 0.00035 * MOTORS_TORQUE
TORQUE = np.float32(0.00035 * 80.0)


def _cost(a, absolute):
    """The torque cost of (..., 4) actions, summed in joint order."""
    return (TORQUE * absolute(a[..., 0]) + TORQUE * absolute(a[..., 1])
            + TORQUE * absolute(a[..., 2]) + TORQUE * absolute(a[..., 3]))


@pytest.fixture(scope="module")
def walk():
    """The JAX walker's walk from the recipe's pinned start under action
    (1, 1, 1, 1) until its hull touches the ground (47 steps): the
    observations (48, 24), the rewards with the walk's own torque cost
    taken off (the crash step's -100 kept), and the terminated flags."""
    env_name, reset_seed, _, _ = golden.CEM_BIPEDAL_RUNS[STEM]
    env = jax_base.FixedResetWrapper(jax_envs.make(env_name),
                                     seed=reset_seed)
    step = jax.jit(env.step)
    state, obs = env.reset(jax.random.PRNGKey(0))
    ones = np.ones(4, np.float32)
    obs_l, rew_l, term_l = [np.asarray(obs)], [], []
    while not (term_l and term_l[-1]):
        state, obs, r, term, _ = step(state, ones, jax.random.PRNGKey(0))
        obs_l.append(np.asarray(obs))
        term_l.append(bool(term))
        rew_l.append(np.float32(r) if term_l[-1]
                     else np.float32(r) + _cost(ones, np.abs))
        assert len(term_l) < 64, "the walk did not crash"
    return (np.stack(obs_l).astype(np.float32),
            np.asarray(rew_l, np.float32), np.asarray(term_l))


class JaxWalk(jax_base.Env):
    """The JAX side's stub walker: replays ``walk`` whatever the actions,
    its reward less the acting torque cost; pinned resets."""

    def __init__(self, walk, dim_info, max_steps):
        self.obs, self.reward, self.term = (jax.numpy.asarray(x)
                                            for x in walk)
        self.dim_info, self.max_steps = dim_info, max_steps

    def reset(self, key):
        return jax.numpy.zeros((), jax.numpy.int32), self.obs[0]

    def step(self, t, action, key):
        term = self.term[t]
        reward = jax.numpy.where(
            term, self.reward[t],
            self.reward[t] - _cost(action, jax.numpy.abs))
        truncated = (t + 1 >= self.max_steps) & ~term
        return t + 1, self.obs[t + 1], reward, term, truncated


@dataclasses.dataclass
class WalkState:
    t: torch.Tensor


class TorchWalk(Env):
    """The port's stub walker: the same replay as ``JaxWalk``, on the
    CPU."""

    def __init__(self, walk, dim_info, max_steps):
        super().__init__("cpu")
        self.obs, self.reward, self.term = (torch.from_numpy(np.array(x))
                                            for x in walk)
        self.dim_info, self.max_steps = dim_info, max_steps

    def reset(self, draw):
        t = torch.zeros(draw.shape[0], dtype=torch.int32)
        return WalkState(t), self.obs[t.long()]

    def step(self, state, action, step_draw=None):
        t = state.t.long()
        term = self.term[t]
        reward = torch.where(term, self.reward[t],
                             self.reward[t] - _cost(action, torch.abs))
        truncated = (state.t + 1 >= self.max_steps) & ~term
        return (WalkState(state.t + 1), self.obs[t + 1], reward, term,
                truncated)


NETS = ("actor1", "actor2", "actor1_target", "actor2_target", "domain",
        "critic", "critic_target")
OPTS = (("actor1_opt", "actor1"), ("actor2_opt", "actor2"),
        ("critic_opt", "critic"))


def load_jax_learner(state, jstate) -> None:
    """JAX's nets and Adam moments and counts into the port's learner
    state, in place (the fitness EMAs and the step count stay the
    port's)."""
    for name in NETS:
        getattr(state, name).load_state_dict(net_params_from_flax(
            jax.tree.map(np.asarray, getattr(jstate, name))))
    for opt_name, net_name in OPTS:
        adam = getattr(jstate, opt_name)[1][0]
        count = int(adam.count)
        mu, nu = (net_params_from_flax(jax.tree.map(np.asarray, m))
                  for m in (adam.mu, adam.nu))
        opt = getattr(state, opt_name)
        opt.state.clear()
        for key, p in getattr(state, net_name).named_parameters():
            if count:
                opt.state[p] = {"step": torch.tensor(float(count)),
                                "exp_avg": mu[key].clone(),
                                "exp_avg_sq": nu[key].clone()}


def assert_adam_close(state, jstate, lr, what) -> None:
    """Every net of the port's state against JAX's after one Adam step
    from the same state: within 1e-5 bar one weight in 10,000 a net, and
    none past the learning rate (ROADMAP's rule for the parity tests: an
    Adam step on a gradient that is float noise moves a weight by up to
    the lr in either framework)."""
    for name in NETS:
        want = net_params_from_flax(jax.tree.map(np.asarray,
                                                 getattr(jstate, name)))
        got = getattr(state, name).state_dict()
        assert sorted(got) == sorted(want)
        d = torch.cat([(got[k] - want[k]).abs().flatten() for k in want])
        past = int((d > 1e-5).sum())
        assert float(d.max()) <= lr and past <= d.numel() // 10_000, (
            f"{what} {name}: {past} of {d.numel()} past 1e-5, max "
            f"{float(d.max())}")


def test_bursts_over_a_replayed_walk_match_jax(walk, monkeypatch):
    """Draw 1 of the recipe for 3 episodes of 64 steps on a replayed
    walker walk (``walk``: 47 steps to a crash, then the auto-reset rolls
    17 steps into the next episode within the chunk), the same replay on
    both sides, so the walker's float32 rounding cannot part them: the
    population evaluation of 10 rows x 64 steps, the fused 4-lane
    episodes, their domain chunks and 3 learner bursts of 47 steps, every
    draw JAX's.

    Against JAX's ``train_cem_gd3pg`` on the same replay: the env steps,
    the learner steps, and the first episode's return and fitness EMAs
    (before a learner step acts on them) at this file's tolerances. The
    learner is held step by step, teacher-forced: each of the port's 141
    steps starts from JAX's nets and Adam state, and the JAX package's
    ``learn`` takes the same batch from the same state; every net after
    every step held by ROADMAP's Adam rule (``assert_adam_close``): from
    the first step one actor weight in 16,384, whose gradient is about
    Adam's eps (1e-8) and differs by a few percent in the two frameworks'
    rounding, moves 1.7e-5 apart. Free-running, such steps compound: the
    two learners part after about a dozen steps (the critic from 4.6e-7
    to 2.5e-4 between steps 12 and 14, 1.4e-3 by step 47), while the port
    with each batch's rows in another order stays within 1e-7 of itself
    over all 47 steps."""
    run, T, episodes, start = 1, 64, 3, 5
    seed = golden.cem_bipedal_seed(run)
    env_name, _, cfg, _ = golden.CEM_BIPEDAL_RUNS[STEM]
    jenv = JaxWalk(walk, jax_envs.make(env_name).dim_info, T)
    jalgo = jax_cem.CEMGD3PG(jenv.dim_info, jax_cem.CEMGD3PGConfig(**cfg))
    jinit = jalgo.init(jax.random.split(jax.random.PRNGKey(seed))[0])
    np.random.seed(seed)
    jstate, jreturns, jinfo = jax_cem.train_cem_gd3pg(
        jenv, jalgo, max_episodes=episodes, seed=seed, start_steps=start,
        full_ratio=True)
    jlearn = jax.jit(jalgo.learn)
    cfg_lr = max(jalgo.cfg.actor_lr, jalgo.cfg.critic_lr)
    held = []

    class Lockstep(CEMGD3PG):
        def init(self, generator):
            state = super().init(generator)
            cem_gd3pg_state_from_flax(state, jax.tree.map(np.asarray, jinit))
            self.j = jinit
            return state

        def learn(self, state, batch, is_f1_more, delta):
            if state.step == 0 or self.burst_start:
                # the domain policy the episode chose, as the loop set it
                self.j = self.j.replace(domain=getattr(
                    self.j, "actor1" if is_f1_more else "actor2"))
                self.burst_start = False
            load_jax_learner(state, self.j)
            state, _ = super().learn(state, batch, is_f1_more, delta)
            self.j, _ = jlearn(self.j, jax_cem.Transition(**{
                f: jax.numpy.asarray(getattr(batch, f).numpy())
                for f in ("obs", "action", "reward", "next_obs", "done",
                          "episode_done")}), jax.numpy.bool_(is_f1_more),
                jax.numpy.float32(delta))
            assert_adam_close(state, self.j, cfg_lr, f"learner step "
                              f"{state.step}")
            held.append(state.step)
            return state, {}

        def learn_burst(self, *args, **kw):
            self.burst_start = True
            return super().learn_burst(*args, **kw)

    env = TorchWalk(walk, cem.make_env("cpu").dim_info, T)
    monkeypatch.setattr(cem, "make_env", lambda device, max_steps=None: env)
    r = cem.train(run, "cpu", algo_cls=Lockstep, draws=WalkerJaxDraws(seed),
                  max_episodes=episodes, start_steps=start)
    state, returns, info = r["state"], r["returns"], r["info"]
    crash = len(walk[1])
    assert crash == 47
    assert info["env_steps"] == jinfo["env_steps"] == 10 * T + episodes * crash
    assert state.step == int(jstate.step) == episodes * crash
    assert held == list(range(1, episodes * crash + 1))
    assert len(returns) == len(jreturns) == episodes
    np.testing.assert_allclose(returns[0], jreturns[0], rtol=1e-5, atol=2e-5)
