"""The port's GAIL against the JAX package: the discriminator (flax's
``nn.Dense`` init and LayerNorm) through ``convert.py``, the reward
relabel, ``train_d`` (vanilla, and WGAN-GP with LayerNorm: the gradient
penalty of ``vmap(grad(D))`` as one ``autograd.grad``), the expert data
pipeline, and the slice: one whole ``train_gail`` iteration with every
draw JAX's.

Tolerances: forwards and rewards within 1e-6 (rtol 1e-6 on rewards);
Adam steps within 1e-5 (float32 rounding in two frameworks; a WGAN-GP
step differentiates twice).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.algos.gail import GAIL as JaxGAIL
from freerl_tpu.algos.gail import ExpertData as JaxExpertData
from freerl_tpu.algos.gail import GAILConfig as JaxGAILConfig
from freerl_tpu.algos.gail import train_gail as jax_train_gail
from freerl_tpu.algos.ppo import PPOConfig as JaxPPOConfig
from freerl_tpu.envs import make as jax_make
from freerl_tpu_torch.algos import (GAIL, Discriminator, ExpertData,
                                    GAILConfig, GAILDraws, PPOConfig,
                                    collect_expert_data, init_logging,
                                    train_gail)
from freerl_tpu_torch.algos.gail import IterationDraws
from freerl_tpu_torch.convert import (gail_disc_params_from_flax,
                                      gail_state_from_flax,
                                      net_params_from_flax)
from freerl_tpu_torch.core.types import DimInfo
from freerl_tpu_torch.envs import make
from tests.test_torch_dqn import _flax_params
from tests.test_torch_ppo import jax_perms

torch.set_num_threads(1)

ATOL = 1e-5
DI = dict(obs_dim=3, action_dim=1, is_continue=True, max_action=2.0)
PPO_KW = dict(horizon=64, K_epochs=2, minibatch_size=16, hidden=(16, 16))
VARIANTS = {"vanilla": dict(), "wgan_gp_ln": dict(gp_coef=10.0,
                                                  d_layernorm=True)}


def _t(x):
    return torch.from_numpy(np.array(x))


def make_pair(variant, **extra):
    kw = dict(VARIANTS[variant], d_hidden=(16, 16), d_batch_size=32, **extra)
    jenv = jax_make("Pendulum-v1")
    jgail = JaxGAIL(jenv.dim_info, JaxPPOConfig(**PPO_KW), JaxGAILConfig(**kw))
    jstate = jgail.init(jax.random.PRNGKey(0))
    gail = GAIL(DimInfo(**DI), PPOConfig(**PPO_KW), GAILConfig(**kw),
                device="cpu")
    state = gail.init(torch.Generator().manual_seed(0))
    gail_state_from_flax(state, jax.tree.map(np.asarray, jstate))
    return jgail, jstate, gail, state


def sa_batch(n, seed, shift=0.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3).astype(np.float32) + shift,
            np.tanh(rng.randn(n, 1)).astype(np.float32))


def assert_disc_close(disc, jparams, what=""):
    want = gail_disc_params_from_flax(_flax_params(jparams))
    got = disc.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=ATOL, err_msg=f"{what} {k}")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_discriminator_and_reward_match_jax(variant):
    jgail, jstate, gail, state = make_pair(variant)
    s, a = sa_batch(64, 1)
    sa = jnp.asarray(np.concatenate([s, a], -1))
    want = jgail.disc.apply({"params": jstate.d_params}, sa)
    got = state.disc(torch.from_numpy(np.array(sa))).detach()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    want_r = jgail.compute_reward(jstate.d_params, jnp.asarray(s),
                                  jnp.asarray(a))
    got_r = gail.compute_reward(state.disc, _t(s), _t(a))
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=1e-6,
                               atol=1e-6)
    # the port's own init: flax's lecun_normal kernels, zero biases
    fresh = Discriminator(4, (16, 16), variant != "vanilla",
                          torch.Generator().manual_seed(0), device="cpu")
    assert not fresh.head.bias.any()
    assert (fresh.norms is not None) == (variant != "vanilla")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_d_matches_jax(variant):
    """Three D steps on expert and policy batches: params and metrics."""
    jgail, jstate, gail, state = make_pair(variant)
    step = jax.jit(jgail.train_d)
    for i in range(3):
        es, ea = sa_batch(32, 10 + i, 1.0)
        ps, pa = sa_batch(32, 20 + i, -1.0)
        jstate, jm = step(jstate, *map(jnp.asarray, (es, ea, ps, pa)))
        state, m = gail.train_d(state, *map(_t, (es, ea, ps, pa)))
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        assert_disc_close(state.disc, jstate.d_params, f"step {i}")
    betas = state.d_opt.param_groups[0]["betas"]
    assert betas == ((0.5, 0.9) if variant != "vanilla" else (0.9, 0.999))


def test_expert_data_pipeline(tmp_path):
    """``collect_expert_data`` rolls the given policy on 16 envs and saves
    the pairs; ``from_npz`` loads them as the JAX package's does;
    ``init_logging`` writes the config."""
    env = make("Pendulum-v1", device="cpu")
    path = str(tmp_path / "e.npz")
    data = collect_expert_data(env, lambda obs: -obs[:, 2:3], 100,
                               out_path=path)
    assert data.states.shape == (100, 3) and data.actions.shape == (100, 1)
    np.testing.assert_array_equal(data.actions.numpy(),
                                  -data.states[:, 2:3].numpy())
    loaded = ExpertData.from_npz(path, device="cpu")
    jloaded = JaxExpertData.from_npz(path)
    np.testing.assert_array_equal(loaded.states.numpy(),
                                  np.asarray(jloaded.states))
    s, a = loaded.sample(torch.Generator().manual_seed(0), 32)
    assert s.shape == (32, 3) and a.shape == (32, 1)
    run_dir = init_logging(str(tmp_path / "logs"), {"algo": "GAIL"})
    assert os.path.exists(os.path.join(run_dir, "config.json"))


def _pendulum_reset(k):
    k1, k2 = jax.random.split(k)
    return jnp.stack([jax.random.uniform(k1, (), jnp.float32, -jnp.pi, jnp.pi),
                      jax.random.uniform(k2, (), jnp.float32, -1.0, 1.0)])


class JaxDraws(GAILDraws):
    """The draws of the JAX ``train_gail(seed=seed)``, in its key order."""

    def __init__(self, seed):
        super().__init__(torch.Generator().manual_seed(0))
        _, self.k_env, self.k_loop = jax.random.split(jax.random.PRNGKey(seed),
                                                      3)

    def reset(self, env, num_envs):
        return _t(jax.vmap(_pendulum_reset)(jax.random.split(self.k_env,
                                                             num_envs)))

    def iteration(self, gail, env, num_envs, T, n_expert):
        self.k_loop, k_roll, k_d, k_upd = jax.random.split(self.k_loop, 4)
        action, reset = [], []
        for t in range(T):
            kk = jax.random.fold_in(k_roll, t)
            action.append(_t(jax.random.normal(kk, (num_envs, 1))))
            reset.append(_t(jax.vmap(
                lambda k: _pendulum_reset(jax.random.split(k)[1]))(
                jax.random.split(kk, num_envs))))
        e_idx, p_idx = [], []
        cfg = gail.cfg
        for i in range(cfg.d_steps_per_iter):
            ke, kp = jax.random.split(jax.random.fold_in(k_d, i))
            e_idx.append(np.asarray(jax.random.randint(
                ke, (cfg.d_batch_size,), 0, n_expert)))
            p_idx.append(np.asarray(jax.random.randint(
                kp, (cfg.d_batch_size,), 0, T * num_envs)))
        return IterationDraws(
            action=action, step=[None] * T, reset=reset,
            expert_idx=torch.from_numpy(np.stack(e_idx)).long(),
            policy_idx=torch.from_numpy(np.stack(p_idx)).long(),
            perms=jax_perms(k_upd, gail.ppo.cfg.K_epochs, T * num_envs))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_gail_iteration_matches_jax(variant):
    """One whole iteration at 4 envs (16 steps, one D step, one PPO update
    of 2 epochs), from the JAX init and with every JAX draw: the metrics,
    the generator's nets and the discriminator."""
    seed, n = 3, 4
    kw = dict(VARIANTS[variant], d_hidden=(16, 16), d_batch_size=32)
    jenv, env = jax_make("Pendulum-v1"), make("Pendulum-v1", device="cpu")
    jgail = JaxGAIL(jenv.dim_info, JaxPPOConfig(**PPO_KW),
                    JaxGAILConfig(**kw))
    rng = np.random.RandomState(0)
    states = rng.randn(100, 3).astype(np.float32)
    actions = np.tanh(rng.randn(100, 1)).astype(np.float32)
    jstate, jrecord, jhist = jax_train_gail(
        jenv, jgail, JaxExpertData(jnp.asarray(states), jnp.asarray(actions)),
        num_iterations=1, num_envs=n, seed=seed)
    jinit = jgail.init(jax.random.split(jax.random.PRNGKey(seed), 3)[0])

    class Seeded(GAIL):
        def init(self, generator):
            state = super().init(generator)
            gail_state_from_flax(state, jax.tree.map(np.asarray, jinit))
            return state

    gail = Seeded(DimInfo(**DI), PPOConfig(**PPO_KW), GAILConfig(**kw),
                  device="cpu")
    state, record, hist = train_gail(
        env, gail, ExpertData(_t(states), _t(actions)), num_iterations=1,
        num_envs=n, seed=seed, draws=JaxDraws(seed))
    np.testing.assert_allclose(record, jrecord, rtol=1e-6)
    for k, v in jhist[0].items():
        np.testing.assert_allclose(hist[0][k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert_disc_close(state.disc, jstate.d_params)
    for net, jp in ((state.ppo_state.actor, jstate.ppo_state.actor_params),
                    (state.ppo_state.critic, jstate.ppo_state.critic_params)):
        want = net_params_from_flax(_flax_params(jp))
        for k, v in net.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=ATOL,
                                       err_msg=k)
    assert state.step == int(jstate.step) == 1
