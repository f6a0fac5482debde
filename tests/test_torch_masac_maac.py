"""The port's MASAC and MAAC against the JAX package: one learner step of
each from the same params, replay and draws; exploration.

Parameters move with ``convert.marl_state_from_flax``. The draws are
recomputed from the JAX learner step's key. MASAC, per agent i: ``(k_s,
k_next, k_new)`` give the replay indices, the next actions' normals
(``fold_in(k_next, j)``), agent i's own fresh action (``k_new``) and the
others' (``fold_in(k_new, 1000 + j)``). MAAC: ``(k_s, k_u)`` give one
batch's indices and each agent's Gumbel noise (``fold_in(k_u, i)``).
Tolerance: as ``tests/test_torch_maddpg.py`` (atol 1e-5; ``log_alphas``
too). MASAC runs on 2-agent spread and on the heterogeneous world comm;
MAAC on discrete spread with 3 agents, so each agent attends over two.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.algos import maac as jax_maac
from freerl_tpu.algos import masac as jax_masac
from freerl_tpu.algos.base import ExploreCtx as JaxExploreCtx
from freerl_tpu.envs import mpe as jax_mpe
from freerl_tpu_torch.algos import (MAAC, MASAC, ExploreCtx, LearnDraws,
                                    MAACConfig, MASACConfig)
from freerl_tpu_torch.envs import mpe
from freerl_tpu_torch.core.types import Transition
from freerl_tpu_torch.train.marl import example_transition
from tests.test_torch_maddpg import (ATOL, BATCH, HIDDEN, ROWS,
                                     assert_metrics_close,
                                     assert_states_close, buffers, env_pair,
                                     np_rows, port_state_of, t)

torch.set_num_threads(1)


def jax_masac_draws(algo, key, size):
    n, p, b, ad = algo.n_agents, algo.act_pad, algo.cfg.batch_size, \
        algo.act_dims
    idx = np.zeros((n, b), np.int64)
    nxt = np.zeros((n, b, n, p), np.float32)
    new = np.zeros((n, b, n, p), np.float32)
    for i in range(n):
        k_s, k_next, k_new, key = jax.random.split(key, 4)
        idx[i] = jax.random.randint(k_s, (b,), 0, size)
        for j in range(n):
            nxt[i, :, j, :ad[j]] = jax.random.normal(
                jax.random.fold_in(k_next, j), (b, ad[j]))
            k = k_new if j == i else jax.random.fold_in(k_new, 1000 + j)
            new[i, :, j, :ad[j]] = jax.random.normal(k, (b, ad[j]))
    return LearnDraws(idx=t(idx), next=t(nxt), new=t(new))


def jax_maac_draws(algo, key, size):
    n, p, b = algo.n_agents, algo.act_pad, algo.cfg.batch_size
    k_s, k_u = jax.random.split(key)
    gumbel = np.zeros((b, n, p), np.float32)
    for i, d in enumerate(algo.act_dims):
        gumbel[:, i, :d] = jax.random.gumbel(jax.random.fold_in(k_u, i),
                                             (b, d))
    return LearnDraws(idx=t(jax.random.randint(k_s, (b,), 0, size)),
                      gumbel=t(gumbel))


# name: (env, JAX algo, JAX config, port algo, port config, extra, draws)
VARIANTS = {
    "masac": ("spread", jax_masac.MASAC, jax_masac.MASACConfig, MASAC,
              MASACConfig, dict(), jax_masac_draws),
    "masac_world_comm": ("world_comm", jax_masac.MASAC,
                         jax_masac.MASACConfig, MASAC, MASACConfig, dict(),
                         jax_masac_draws),
    "maac": ("spread3_disc", jax_maac.MAAC, jax_maac.MAACConfig, MAAC,
             MAACConfig, dict(attention_dim=32), jax_maac_draws),
}


def make(name):
    env_name, jcls, jcfg, cls, cfg, extra, draws = VARIANTS[name]
    if env_name == "spread3_disc":
        jenv = jax_mpe.SimpleSpread(N=3, continuous_actions=False)
        env = mpe.SimpleSpread(N=3, continuous_actions=False, device="cpu")
    else:
        jenv, env = env_pair(env_name)
    kw = dict(extra, hidden=HIDDEN, batch_size=BATCH, buffer_size=256)
    return (jenv, env, jcls(jenv, jcfg(**kw)), cls(env, cfg(**kw),
                                                   device="cpu"), draws)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_learn_step_matches_jax(name):
    """One learner step from carried-over params and the same replay, with
    the JAX step's draws fed in: every net and target, the temperatures and
    the losses. MASAC's agents go in order, each target and actor loss
    reading the actors already updated in this step."""
    jenv, env, jalgo, algo, draws = make(name)
    jstate = jalgo.init(jax.random.PRNGKey(0))
    state = port_state_of(algo, jstate)
    jbuf, buf = buffers(jalgo, jenv, algo, env)
    key = jax.random.PRNGKey(11)
    jstate, _, jm = jax.jit(lambda s, b, k: jalgo.learn_step(s, b, k, ROWS))(
        jstate, jbuf, key)
    state, m = algo.update(state, buf, draws(algo, key, ROWS))
    assert_metrics_close(m, jm, name)
    lr = max(algo.cfg.actor_lr, algo.cfg.critic_lr)
    assert_states_close(state, port_state_of(algo, jstate), name, lr=lr)
    assert state.step == int(jstate.step) == 1


def test_masac_draws_and_temperatures():
    """``draw_update``'s shapes; each agent's temperature takes its own
    unclipped Adam step, whose first step moves it by the lr, 1e-4."""
    _, env, _, algo, _ = make("masac")
    state = algo.init(torch.Generator().manual_seed(0))
    buf = algo.make_buffer(example_transition(env), num_envs=ROWS).add(
        Transition(**{k: torch.from_numpy(v)
                      for k, v in np_rows(env, ROWS, 0).items()}))
    draws = algo.draw_update(buf, torch.Generator().manual_seed(1))
    assert draws.idx.shape == (2, BATCH)
    assert draws.next.shape == draws.new.shape == (2, BATCH, 2, 5)
    before = [float(la.detach()) for la in state.log_alphas]
    assert before == pytest.approx([np.log(0.01)] * 2)
    state, _ = algo.update(state, buf, draws)
    assert all(int(o.state[la]["step"]) == 1
               for o, la in zip(state.alpha_opts, state.log_alphas))
    # one float32 ulp at |log alpha| ~4.6 is 4.8e-7
    assert all(abs(a - float(b.detach())) == pytest.approx(1e-4, abs=1e-6)
               for a, b in zip(before, state.log_alphas))


@pytest.mark.parametrize("name", ["masac", "maac"])
def test_explore_matches_jax(name):
    """Exploration from the JAX explore's draws: sampled actions of the
    right shape and range, and the warm-up's uniform actions."""
    jenv, env, jalgo, algo, _ = make(name)
    jstate = jalgo.init(jax.random.PRNGKey(0))
    state = port_state_of(algo, jstate)
    n, a, p = 16, algo.n_agents, algo.act_pad
    obs = np.random.RandomState(0).randn(n, a, env.dim_info.obs_dim
                                         ).astype(np.float32)
    key = jax.random.PRNGKey(7)
    k_a, k_r = jax.random.split(key)
    for total, random_steps in ((0, 0), (8, 64)):
        jctx = JaxExploreCtx(total_env_steps=jnp.int32(total),
                             episodes=jnp.int32(0),
                             done_prev=jnp.zeros(n, bool),
                             random_steps=random_steps)
        _, want = jax.jit(jalgo.explore)(jstate, jnp.asarray(obs), key, jctx)
        ctx = ExploreCtx(total_env_steps=total, episodes=torch.tensor(0),
                         done_prev=torch.zeros(n, dtype=torch.bool),
                         random_steps=random_steps)
        draws = algo.draw_explore(n, torch.Generator().manual_seed(0), ctx)
        noise = np.zeros((n, a, p), np.float32)
        for i, d in enumerate(algo.act_dims):
            k = jax.random.fold_in(k_a, i)
            noise[:, i, :d] = (jax.random.normal(k, (n, d)) if name == "masac"
                               else jax.random.gumbel(k, (n, d)))
        if name == "masac":
            assert draws.normal.shape == (n, a, p)
            draws.normal = t(noise)
            if random_steps:
                draws.random = t(jax.random.uniform(k_r, (n, a, p),
                                                    jnp.float32, -1.0, 1.0))
        else:
            assert draws.gumbel.shape == (n, a, p)
            draws.gumbel = t(noise)
            if random_steps:
                draws.random = t(jax.random.randint(k_r, (n, a), 0, p))
        assert (draws.random is not None) == (random_steps > 0)
        _, got = algo.explore_with(state, torch.from_numpy(obs), draws, ctx)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        if name == "masac":
            assert got.shape == (n, a, p) and got.abs().max() <= 1.0
        else:
            assert got.shape == (n, a) and got.min() >= 0 and got.max() < p


def test_maac_refuses_continuous_and_masac_discrete():
    _, cont = env_pair("spread")
    _, disc = env_pair("spread_disc")
    with pytest.raises(ValueError, match="discrete"):
        MAAC(cont, device="cpu")
    with pytest.raises(ValueError, match="continuous"):
        MASAC(disc, device="cpu")
