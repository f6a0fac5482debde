"""Determinism of the port on the CPU (the port's counterparts of the JAX
package's tests/test_determinism.py, with its configs and seeds): one seed
gives one run, bit for bit, in the episode record and in every tensor of
the final algo state; two seeds give two runs; the pixel paths (DQN and
PPO through the conv trunks) too. The card is held to the same, on every
training path, in ``chip_smoke.py``'s ``determinism`` phase."""
import numpy as np
import torch

from freerl_tpu_torch.algos import DQN, PPO, DQNConfig, PPOConfig
from freerl_tpu_torch.distributed.dp import state_tensors
from freerl_tpu_torch.envs import make
from freerl_tpu_torch.train import (OffPolicyConfig, OnPolicyConfig,
                                    train_offpolicy, train_onpolicy)

torch.set_num_threads(1)


def _dqn_cartpole(seed, max_episodes):
    env = make("CartPole-v1", device="cpu")
    algo = DQN(env.dim_info, DQNConfig(buffer_size=4096, batch_size=32),
               device="cpu")
    state, returns, _ = train_offpolicy(env, algo, OffPolicyConfig(
        seed=seed, num_envs=4, max_episodes=max_episodes, start_steps=200,
        chunk_size=64))
    return state, returns


def _assert_same_run(a, b):
    (s1, r1), (s2, r2) = a, b
    np.testing.assert_array_equal(r1, r2)
    t1, t2 = state_tensors(s1), state_tensors(s2)
    assert len(t1) == len(t2) > 0
    for x, y in zip(t1, t2):
        assert torch.equal(x, y)


def test_offpolicy_training_is_deterministic():
    _assert_same_run(_dqn_cartpole(7, 40), _dqn_cartpole(7, 40))


def test_onpolicy_training_is_deterministic():
    env = make("Pendulum-v1", device="cpu")

    def run():
        algo = PPO(env.dim_info, PPOConfig(horizon=256, K_epochs=2,
                                           num_envs=4), device="cpu")
        state, returns, _ = train_onpolicy(env, algo, OnPolicyConfig(
            seed=3, num_envs=4, max_episodes=16, horizon=256))
        return state, returns

    _assert_same_run(run(), run())


def test_pixel_dqn_training_is_deterministic():
    """DQN through the small conv trunk on PixelCartPole-v1."""
    env = make("PixelCartPole-v1", device="cpu")

    def run():
        algo = DQN(env.dim_info, DQNConfig(
            buffer_size=2_000, batch_size=16, hidden=(16,),
            obs_shape=env.obs_shape, conv_arch="small", cnn_features=16),
            device="cpu")
        state, returns, info = train_offpolicy(env, algo, OffPolicyConfig(
            seed=5, num_envs=4, max_episodes=10**6, max_env_steps=4 * 48,
            start_steps=64, chunk_size=16))
        assert info["updates"] > 0
        return state, returns

    _assert_same_run(run(), run())


def test_conv_ppo_training_is_deterministic():
    """PPO with the actor's and the critic's small conv trunks on
    PixelCartPole-v1: one update of two epochs."""
    env = make("PixelCartPole-v1", device="cpu")

    def run():
        algo = PPO(env.dim_info, PPOConfig(
            horizon=64, K_epochs=2, minibatch_size=32, num_envs=4,
            hidden=(16,), obs_shape=env.obs_shape, cnn_features=16),
            device="cpu")
        state, returns, info = train_onpolicy(env, algo, OnPolicyConfig(
            seed=2, num_envs=4, horizon=64, max_env_steps=64,
            max_episodes=10**6))
        assert info["iterations"] == 1
        return state, returns

    _assert_same_run(run(), run())


def test_different_seeds_differ():
    (_, r1), (_, r2) = _dqn_cartpole(0, 20), _dqn_cartpole(1, 20)
    n = min(len(r1), len(r2))
    assert not np.array_equal(r1[:n], r2[:n])
