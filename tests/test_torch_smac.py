"""The port's SMAC-protocol bridge (``envs/smac.py``) against the JAX
package's.

``FakeSmacEnv`` is numpy on both sides and draws from the same
``default_rng`` stream, so under one seed and one action sequence the
availability, state, rewards, done flags and invalid-action counts must be
equal. ``HostSmacVecEnv``'s ``[raw_obs, state?, mask]`` layout and its
auto-resets are held exactly against the JAX bridge's ``_host_reset`` /
``_host_step``, with and without ``use_state``. Then masked MAPPO, and
HAPPO with the state-augmented critic, train through ``train_onpolicy``
and never send an unavailable action.
"""
import numpy as np
import pytest
import torch

from freerl_tpu.envs import smac as jax_smac
from freerl_tpu_torch.algos import (HAPPO, MAPPO, HAPPOConfig,
                                    MAPPOConfig)
from freerl_tpu_torch.envs.smac import FakeSmacEnv, HostSmacVecEnv
from freerl_tpu_torch.train import OnPolicyConfig, train_onpolicy

torch.set_num_threads(1)

N_ENVS, N_STEPS = 4, 40


def act(avail: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """A random action per agent, some outside the agent's mask."""
    return rng.integers(0, avail.shape[-1], avail.shape[:-1])


def test_fake_smac_equals_jax():
    port = FakeSmacEnv(n_agents=3, n_actions=5, episode_limit=7, seed=11)
    jax = jax_smac.FakeSmacEnv(n_agents=3, n_actions=5, episode_limit=7,
                               seed=11)
    assert port.get_env_info() == jax.get_env_info()
    rng = np.random.default_rng(0)
    for e in (port, jax):
        e.reset(seed=4)
    for t in range(N_STEPS):
        for get in ("get_obs", "get_state", "get_avail_actions"):
            np.testing.assert_array_equal(getattr(port, get)(),
                                          getattr(jax, get)())
        a = act(port.get_avail_actions(), rng)
        out = port.step(a)
        assert out == jax.step(a) and out[1] == (t % 7 == 6)
        if out[1]:
            for e in (port, jax):
                e.reset()
    assert port.invalid_actions_received == jax.invalid_actions_received > 0


@pytest.mark.parametrize("use_state", [False, True])
def test_host_smac_layout_equals_jax(use_state):
    def make():
        return FakeSmacEnv(n_agents=3, n_actions=5, episode_limit=6)

    def jmake():
        return jax_smac.FakeSmacEnv(n_agents=3, n_actions=5,
                                    episode_limit=6)

    env = HostSmacVecEnv(make, N_ENVS, use_state=use_state, device="cpu")
    jenv = jax_smac.HostSmacVecEnv(jmake, N_ENVS, use_state=use_state)
    for k in ("n_agents", "n_actions", "max_steps", "state_dim",
              "agent_obs_dims", "agent_act_dims", "action_space_01"):
        assert getattr(env, k) == getattr(jenv, k), k
    assert env.dim_info.obs_dim == 5 + (16 if use_state else 0) + 5

    obs = env._host_reset(7)
    np.testing.assert_array_equal(obs, jenv._host_reset(7))
    assert obs.shape == (N_ENVS, 3, env.dim_info.obs_dim)
    # the mask on the tail, the state (broadcast to every agent) before it
    np.testing.assert_array_equal(obs[..., -5:], obs[..., :5])
    if use_state:
        np.testing.assert_array_equal(obs[:, 0, 5:20],
                                      obs[:, :, :5].reshape(N_ENVS, 15))
        np.testing.assert_array_equal(obs[:, 1, 5:21], obs[:, 2, 5:21])
    rng = np.random.default_rng(1)
    dones = 0
    for _ in range(N_STEPS):
        a = act(obs[..., -5:], rng)
        got, want = env._host_step(a), jenv._host_step(a)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        obs = got[1]
        dones += int(got[3].sum())
    assert dones == N_ENVS * (N_STEPS // 6)
    assert env.invalid_actions_received == jenv.invalid_actions_received > 0

    state, t_obs = env.vec_reset(torch.Generator().manual_seed(0), N_ENVS)
    out = env.vec_step_auto_reset(state, torch.zeros((N_ENVS, 3),
                                                     dtype=torch.int64),
                                  None, N_ENVS)
    assert out.reward.shape == (N_ENVS, 3) and out.terminated.shape == (
        N_ENVS,) and out.next_obs.shape == t_obs.shape


@pytest.mark.parametrize("variant", ["mappo_masked", "happo_state"])
def test_masked_training_never_sends_an_unavailable_action(variant):
    use_state = variant == "happo_state"
    env = HostSmacVecEnv(lambda: FakeSmacEnv(n_agents=3, n_actions=5,
                                             episode_limit=25),
                         N_ENVS, use_state=use_state, device="cpu")
    kw = dict(masked=True, mask_dim=5, state_dim=env.state_dim,
              num_envs=N_ENVS, horizon=100, K_epochs=2, minibatch_size=50,
              hidden=(32,), adv_norm=True)
    algo = (HAPPO(env, HAPPOConfig(**kw), device="cpu") if use_state
            else MAPPO(env, MAPPOConfig(**kw), device="cpu"))
    cfg = OnPolicyConfig(num_envs=N_ENVS, horizon=100, max_env_steps=200,
                         max_episodes=10**6)
    state, returns, info = train_onpolicy(env, algo, cfg)
    assert info["iterations"] == 2 and info["env_steps"] == 200
    assert returns.shape == (info["episodes"], 3) and info["episodes"] == 8
    assert np.isfinite(returns).all() and (returns >= 0).all()
    # the shared reward is tiled over the agents
    np.testing.assert_array_equal(returns[:, 0], returns[:, 2])
    assert env.invalid_actions_received == 0
