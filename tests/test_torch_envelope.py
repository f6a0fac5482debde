"""The port's ENVELOPE (DQN and DDPG) and deep-sea-treasure against the
JAX package, from the same params, inputs and draws.

- deep-sea-treasure: 200 teacher-forced auto-resetting steps, exact;
- the homotopy beta table bit-equal to the JAX ``fori_loop`` after adds
  that terminate 0 to 256 rows, through the step at which beta reaches
  ``beta_uplim``;
- the add-time priorities (1e-5) and the stored rows (exact);
- ``sample``'s Gumbel-top-k indices equal to ``lax.top_k``'s with
  ``size`` below and above ``batch_size`` (the ``-inf`` ties lowest index
  first, folded modulo ``size``);
- three ``update`` steps, three ``EnvelopeDDPG`` learner steps, both
  algos' ``explore``: params within 1e-5 (float32 matmul and Adam rounding
  in two frameworks), actions equal;
- one ``train_offpolicy`` vector step through the loop's new
  ``add_transition`` hook, every draw JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.algos.base import ExploreCtx as JaxExploreCtx
from freerl_tpu.algos.envelope import Envelope as JaxEnvelope
from freerl_tpu.algos.envelope import EnvelopeConfig as JaxEnvelopeConfig
from freerl_tpu.algos.envelope import EnvelopeDDPG as JaxEnvelopeDDPG
from freerl_tpu.algos.envelope import random_preference as jax_preference
from freerl_tpu.core.types import DimInfo as JaxDimInfo
from freerl_tpu.envs import make as jax_make
from freerl_tpu.envs import vec_step_auto_reset as jax_vec_step
from freerl_tpu_torch.algos import (Envelope, EnvelopeConfig, EnvelopeDDPG,
                                    ExploreCtx, random_preference)
from freerl_tpu_torch.algos.envelope import beta_table
from freerl_tpu_torch.convert import envelope_state_from_flax
from freerl_tpu_torch.core.types import DimInfo, Transition
from freerl_tpu_torch.envs import make, step_auto_reset
from freerl_tpu_torch.envs.mo import DSTState
from freerl_tpu_torch.train import loop
from tests.test_torch_dqn import _flax_params, _jax_t, _torch_t

torch.set_num_threads(1)

ATOL = 1e-5
R = 2
DI = dict(obs_dim=2, action_dim=4)
DI_C = dict(obs_dim=3, action_dim=1, is_continue=True, max_action=2.0)
CFG = dict(hidden=(16, 16), batch_size=16, buffer_size=64, weight_num=3,
           max_episodes=100)


def _t(x):
    return torch.from_numpy(np.array(x))


def make_pair(ddpg=False, **extra):
    kw = dict(CFG, **extra)
    di = DI_C if ddpg else DI
    jcls, cls = ((JaxEnvelopeDDPG, EnvelopeDDPG) if ddpg
                 else (JaxEnvelope, Envelope))
    jalgo = jcls(JaxDimInfo(**di), R, JaxEnvelopeConfig(**kw))
    jstate = jalgo.init(jax.random.PRNGKey(0))
    algo = cls(DimInfo(**di), R, EnvelopeConfig(**kw), device="cpu")
    state = algo.init(torch.Generator().manual_seed(0))
    envelope_state_from_flax(state, jax.tree.map(np.asarray, jstate))
    return jalgo, jstate, algo, state


def assert_nets_close(state, jstate, what=""):
    if hasattr(jstate, "params"):
        pairs = (("net", "params"), ("target_net", "target_params"))
    else:
        pairs = (("actor", "actor_params"), ("actor_target", "actor_target"),
                 ("critic", "critic_params"),
                 ("critic_target", "critic_target"))
    from freerl_tpu_torch.convert import net_params_from_flax

    for name, jname in pairs:
        want = net_params_from_flax(_flax_params(getattr(jstate, jname)))
        got = getattr(state, name).state_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       atol=ATOL, err_msg=f"{what} {name}.{k}")


def mo_batch(n, seed, n_done=None, obs_dim=2, continuous=False):
    rng = np.random.RandomState(seed)
    done = np.zeros(n, bool)
    if n_done is None:
        done = rng.rand(n) < 0.2
    else:
        done[rng.permutation(n)[:n_done]] = True
    action = (rng.uniform(-2, 2, (n, 1)).astype(np.float32) if continuous
              else rng.randint(0, 4, n).astype(np.int32))
    return dict(obs=rng.randn(n, obs_dim).astype(np.float32),
                action=action,
                reward=rng.randn(n, R).astype(np.float32),
                next_obs=rng.randn(n, obs_dim).astype(np.float32),
                done=done, episode_done=done | (rng.rand(n) < 0.1))


# ---------------------------------------------------------------------------
def test_deep_sea_treasure_matches_jax():
    """200 auto-resetting steps of 16 envs from the JAX env's state: the
    grid walk, the seabed, the vector rewards, the flags."""
    n = 16
    jenv, env = jax_make("deep-sea-treasure-v0"), make(
        "deep-sea-treasure-v0", device="cpu")
    assert (env.reward_dim, env.record_weights) == (2, (0.5, 0.5))
    jstate, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0),
                                                      n))
    jstate = jstate.replace(t=jnp.asarray(np.arange(n) * 7 % 100, jnp.int32))
    jstep = jax.jit(lambda s, a, k: jax_vec_step(jenv, s, a, k, n))
    rng = np.random.RandomState(0)
    for t in range(200):
        action = rng.choice(4, n, p=[0.15, 0.45, 0.15, 0.25]).astype(np.int32)
        want = jstep(jstate, jnp.asarray(action), jax.random.PRNGKey(t))
        state = DSTState(*(_t(getattr(jstate, f.name))
                           for f in dataclasses.fields(DSTState)))
        got = step_auto_reset(env, state, _t(action), None,
                              env.draw_reset(n, None))
        for field in ("next_obs", "carry_obs", "reward", "terminated",
                      "truncated"):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)),
                                          err_msg=f"step {t}: {field}")
        for f in dataclasses.fields(DSTState):
            np.testing.assert_array_equal(getattr(got.state, f.name).numpy(),
                                          np.asarray(getattr(want.state,
                                                             f.name)))
        jstate = want.state


def test_random_preference_matches_jax():
    key = jax.random.PRNGKey(4)
    normals = jax.random.normal(key, (64, R))
    got = random_preference(_t(normals)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_preference(key, R, (64,))),
                               rtol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


def test_beta_table_matches_the_fori_loop():
    """Adds that terminate 0, 1, 7, 200, 256, 37 and 0 rows (1 to 501
    bumps: beta reaches beta_uplim at the 501st): beta and its delta
    bit-equal to the JAX ``add_with_priority``'s after each; the
    priorities within 1e-5, the stored rows exact."""
    jalgo, jstate, algo, state = make_pair(
        buffer_size=1024, max_episodes=500)
    betas, _ = beta_table(algo.cfg)
    assert len(betas) == 502 and betas[-1] == 1.0 and betas[-2] < 1.0
    ex = {k: v[0] for k, v in mo_batch(1, 0).items()}
    jbuf = jalgo.make_buffer(_jax_t(ex))
    buf = algo.make_buffer(_torch_t(ex))
    jadd = jax.jit(jalgo.add_with_priority)
    total = 0
    for i, n_done in enumerate((0, 1, 7, 200, 256, 37, 0)):
        b = mo_batch(256, i, n_done)
        key = jax.random.PRNGKey(10 + i)
        jstate, jbuf = jadd(jstate, jbuf, _jax_t(b), key)
        state, buf = algo.add_with_priority(
            state, buf, _torch_t(b), _t(jax.random.normal(key, (256, R))))
        total += n_done
        assert int(state.bumps) == total
        assert state.beta.numpy().tobytes() == np.asarray(
            jstate.beta).tobytes(), (total, float(state.beta))
        assert state.beta_delta.numpy().tobytes() == np.asarray(
            jstate.beta_delta).tobytes()
        np.testing.assert_allclose(buf.priorities.numpy(),
                                   np.asarray(jbuf.priorities), atol=ATOL,
                                   rtol=1e-5)
        for f in dataclasses.fields(Transition):
            np.testing.assert_array_equal(
                getattr(buf.data, f.name).numpy(),
                np.asarray(getattr(jbuf.data, f.name)))
        assert (buf.pos, buf.size) == (int(jbuf.pos), int(jbuf.size))
    assert float(state.beta) == 1.0


@pytest.mark.parametrize("size", [5, 16, 40], ids=["below", "equal",
                                                    "above"])
def test_sample_indices_match_top_k(size):
    """``sample`` from the same priorities and Gumbel noise: the same rows
    in the same order as JAX's ``lax.top_k``, with ``size`` below, at and
    above ``batch_size`` (16)."""
    jalgo, jstate, algo, state = make_pair()
    b = mo_batch(size, 3)
    b["obs"] = np.arange(2 * size, dtype=np.float32).reshape(size, 2)
    ex = {k: v[0] for k, v in b.items()}
    jbuf = jalgo.make_buffer(_jax_t(ex))
    jstate, jbuf = jalgo.add_with_priority(jstate, jbuf, _jax_t(b),
                                           jax.random.PRNGKey(1))
    buf = algo.make_buffer(_torch_t(ex))
    buf.add_with(_torch_t(b), _t(jbuf.priorities[:size]))
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = jalgo.sample(jbuf, key, 16)
        gumbel = _t(jax.random.gumbel(key, (jbuf.capacity,)))
        idx = algo.sample_idx(buf, gumbel, 16)
        assert int(idx.max()) < size
        np.testing.assert_array_equal(buf.gather(idx).obs.numpy(),
                                      np.asarray(want.obs))


def test_sample_stable_order_differs_from_topk():
    """The tie order the sampler must keep: ``lax.top_k`` lists equal
    entries lowest index first, as a stable descending sort does."""
    x = np.array([1, -np.inf, 3, -np.inf, -np.inf, 2, -np.inf], np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(x), 6)[1])
    got = torch.sort(_t(x), descending=True, stable=True).indices[:6]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [2, 5, 0, 1, 3, 4])


@pytest.mark.parametrize("grad_clip", [None, 0.05], ids=["no_clip", "clip"])
def test_envelope_updates_match_jax(grad_clip):
    jalgo, jstate, algo, state = make_pair(grad_clip=grad_clip)
    jupdate = jax.jit(jalgo.update)
    for i in range(3):
        b = mo_batch(16, i)
        key = jax.random.PRNGKey(20 + i)
        jstate, jm, _ = jupdate(jstate, _jax_t(b), key)
        state, m, _ = algo.update(state, _torch_t(b),
                                  _t(jax.random.normal(key, (3, R))))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert_nets_close(state, jstate, f"update {i}")
    assert state.step == int(jstate.step) == 3


def test_envelope_ddpg_learn_steps_match_jax():
    """Three learner steps from a uniform replay: the sampled rows, both
    nets, their targets and beta's own recurrence."""
    jalgo, jstate, algo, state = make_pair(ddpg=True)
    b = mo_batch(48, 0, obs_dim=3, continuous=True)
    ex = {k: v[0] for k, v in b.items()}
    jbuf = jalgo.make_buffer(_jax_t(ex)).add(_jax_t(b))
    buf = algo.make_buffer(_torch_t(ex)).add(_torch_t(b))
    jlearn = jax.jit(lambda s, bf, k: jalgo.learn_step(s, bf, k, 1))
    for i in range(3):
        key = jax.random.PRNGKey(30 + i)
        jstate, _, jm = jlearn(jstate, jbuf, key)
        k_s, k_w, _ = jax.random.split(key, 3)
        idx = _t(jax.random.randint(k_s, (16,), 0, 48)).long()
        state, m, _ = algo.update(state, buf.gather(idx),
                                  _t(jax.random.normal(k_w, (3, R))))
        np.testing.assert_allclose(float(m["critic_loss"]),
                                   float(jm["critic_loss"]), rtol=1e-5)
        assert_nets_close(state, jstate, f"step {i}")
        assert state.beta.numpy().tobytes() == np.asarray(
            jstate.beta).tobytes()
        assert state.beta_delta.numpy().tobytes() == np.asarray(
            jstate.beta_delta).tobytes()


def _jax_ctx(b, steps, random_steps=0):
    return JaxExploreCtx(total_env_steps=jnp.int32(steps),
                         episodes=jnp.int32(3),
                         done_prev=jnp.zeros((b,), jnp.bool_),
                         random_steps=random_steps)


def _ctx(b, steps, random_steps=0):
    return ExploreCtx(total_env_steps=steps,
                      episodes=torch.tensor(3), done_prev=torch.zeros(
                          b, dtype=torch.bool), random_steps=random_steps)


@pytest.mark.parametrize("ddpg", [False, True], ids=["dqn", "ddpg"])
@pytest.mark.parametrize("warmup", [False, True], ids=["policy", "warmup"])
def test_explore_matches_jax(ddpg, warmup):
    jalgo, jstate, algo, state = make_pair(ddpg=ddpg, epsilon=0.3,
                                           epsilon_decay=True)
    n, di = 64, DI_C if ddpg else DI
    obs = np.random.RandomState(0).randn(n, di["obs_dim"]).astype(np.float32)
    key = jax.random.PRNGKey(5)
    random_steps = 100 if warmup else 0
    _, want = jalgo.explore(jstate, jnp.asarray(obs), key,
                            _jax_ctx(n, 50, random_steps))
    k1, k2, k3 = jax.random.split(key, 3)
    pref = _t(jax.random.normal(k1, (n, R)))
    if ddpg:
        draws = loop_draws(preference=pref,
                           normal=_t(jax.random.normal(k2, (n, 1))),
                           random=_t(jax.random.uniform(
                               k3, (n, 1), jnp.float32, -2.0, 2.0)))
    else:
        draws = loop_draws(preference=pref,
                           uniform=_t(jax.random.uniform(k2, (n,))),
                           random=_t(jax.random.randint(k3, (n,), 0, 4)))
    _, got = algo.explore_with(state, torch.from_numpy(obs), draws,
                               _ctx(n, 50, random_steps))
    if ddpg:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def loop_draws(**kw):
    from freerl_tpu_torch.algos import ExploreDraws

    return ExploreDraws(**kw)


# ---------------------------------------------------------------------------
class JaxDrawn(Envelope):
    """The port's Envelope fed the draws of one JAX loop step (``keys``:
    the step's k, k_act and k_learn)."""

    keys = None

    def draw_explore(self, b, generator, ctx):
        k_q, k_e, k_r = jax.random.split(self.keys["act"], 3)
        return loop_draws(preference=_t(jax.random.normal(k_q, (b, R))),
                          uniform=_t(jax.random.uniform(k_e, (b,))),
                          random=_t(jax.random.randint(k_r, (b,), 0, 4)))

    def draw_priority(self, b, generator):
        return _t(jax.random.normal(jax.random.fold_in(self.keys["k"], 13),
                                    (b, R)))

    def draw_sample(self, buffer, generator):
        k_s, _ = jax.random.split(jax.random.fold_in(self.keys["learn"], 0))
        return _t(jax.random.gumbel(k_s, (buffer.capacity,)))

    def draw_update(self, batch, generator):
        _, k_u = jax.random.split(jax.random.fold_in(self.keys["learn"], 0))
        return _t(jax.random.normal(k_u, (self.cfg.weight_num, R)))


def test_vector_step_through_add_transition_hook():
    """Three vector steps of the off-policy loop on deep-sea-treasure (8
    envs, a learner step each, the first with fewer stored rows than the
    batch): the loop routes the add through ``add_transition``; actions,
    priorities, stored rows, beta, the episode record and the learner's
    params held against the same steps of the JAX package's loop body."""
    n = 8
    kw = dict(CFG, epsilon=0.5)
    jenv = jax_make("deep-sea-treasure-v0")
    env = make("deep-sea-treasure-v0", device="cpu")
    jalgo = JaxEnvelope(JaxDimInfo(**DI), R, JaxEnvelopeConfig(**kw))
    jstate = jalgo.init(jax.random.PRNGKey(0))
    algo = JaxDrawn(DimInfo(**DI), R, EnvelopeConfig(**kw), device="cpu")
    state = algo.init(torch.Generator().manual_seed(0))
    envelope_state_from_flax(state, jax.tree.map(np.asarray, jstate))
    example = loop.example_transition(env, algo)
    assert example.reward.shape == (R,)
    jbuf = jalgo.make_buffer(_jax_t({f.name: np.asarray(
        getattr(example, f.name)) for f in dataclasses.fields(Transition)}),
        num_envs=n)
    jenv_state, jobs = jax.vmap(jenv.reset)(jax.random.split(
        jax.random.PRNGKey(1), n))
    env_state, obs = env.reset(env.draw_reset(n, None))
    cfg = loop.OffPolicyConfig(num_envs=n, start_steps=0)
    record_cap = 64
    c = loop.LoopCarry(
        algo_state=state, buffer=algo.make_buffer(example, num_envs=n),
        env_state=env_state, obs=obs, ep_return=torch.zeros(n),
        done_prev=torch.zeros(n, dtype=torch.bool),
        ep_counter=torch.zeros((), dtype=torch.int64),
        episode_returns=torch.zeros(record_cap + 1))
    key = jax.random.PRNGKey(2)
    jrun = jnp.zeros(n)
    for t in range(3):
        k, k_act, k_step, k_learn = jax.random.split(key, 4)
        ctx = JaxExploreCtx(total_env_steps=jnp.int32(t * n),
                            episodes=jnp.int32(0),
                            done_prev=jnp.zeros((n,), jnp.bool_))
        jstate, action = jalgo.explore(jstate, jobs, k_act, ctx)
        out = jax_vec_step(jenv, jenv_state, action, k_step, n)
        trans = _jax_t(dict(obs=jobs, action=action, reward=out.reward,
                            next_obs=out.next_obs, done=out.terminated,
                            episode_done=out.episode_done))
        jstate, jbuf = jalgo.add_transition(jstate, jbuf, trans,
                                            jax.random.fold_in(k, 13))
        jstate, jbuf, _ = jalgo.learn_step(jstate, jbuf,
                                           jax.random.fold_in(k_learn, 0), n)
        jrun = np.where(np.asarray(out.episode_done), 0.0, jrun + np.asarray(
            out.reward) @ np.float32([0.5, 0.5]))
        algo.keys = dict(k=k, act=k_act, learn=k_learn)
        loop.vector_step(env, algo, cfg, c, None, record_cap)
        np.testing.assert_array_equal(c.buffer.data.action[:c.buffer.size]
                                      .numpy(), np.asarray(
                                          jbuf.data.action[:int(jbuf.size)]))
        np.testing.assert_array_equal(c.buffer.data.reward.numpy(),
                                      np.asarray(jbuf.data.reward))
        np.testing.assert_allclose(c.buffer.priorities.numpy(),
                                   np.asarray(jbuf.priorities), atol=ATOL,
                                   rtol=1e-5)
        assert c.algo_state.beta.numpy().tobytes() == np.asarray(
            jstate.beta).tobytes()
        assert_nets_close(c.algo_state, jstate, f"step {t}")
        jenv_state, jobs, key = out.state, out.carry_obs, k
    assert c.update_count == 3 and c.total_steps == 3
    np.testing.assert_allclose(c.ep_return.numpy(), np.asarray(jrun))


def test_envelope_trains_through_train_offpolicy():
    """A short ENVELOPE run on deep-sea-treasure through the port's
    ``train_offpolicy``: the record is the raw rewards scalarized with
    (0.5, 0.5), so every return lies in [0.5 * (0 - 100), 0.5 * (23.7 -
    1)]."""
    env = make("deep-sea-treasure-v0", device="cpu")
    algo = Envelope(env.dim_info, env.reward_dim,
                    EnvelopeConfig(hidden=(16, 16), batch_size=16,
                                   buffer_size=512, max_episodes=100),
                    device="cpu")
    cfg = loop.OffPolicyConfig(num_envs=8, max_episodes=16, start_steps=64,
                               chunk_size=25, max_env_steps=2_000)
    state, returns, info = loop.train_offpolicy(env, algo, cfg)
    assert info["updates"] > 0 and len(returns) >= 1
    assert returns.min() >= -50.0 and returns.max() <= 0.5 * 22.7 + 1e-5
    assert int(state.bumps) >= 0 and float(state.beta) >= 0.95
