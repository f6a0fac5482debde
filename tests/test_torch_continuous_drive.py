"""DDPG, TD3 and SAC end to end on the CPU through ``train_offpolicy``:
continuous control on LunarLanderContinuous-v2 and Pendulum-v1, and the
discrete variants on CartPole-v1 (discrete DDPG through
``explore_stored``).

Each run is short (8 envs, 128 vector steps, a 16-wide net). The checks:
the learner ran the expected number of steps, every loss is finite, the
episode record holds one finite return per finished episode inside the
env's range, and the buffer holds what the critic trains on: actions
within +-max_action, probabilities, one-hots or indices.
"""
import numpy as np
import pytest
import torch

from freerl_tpu_torch.algos import (DDPG, SAC, TD3, DDPGConfig, SACConfig,
                                    TD3Config)
from freerl_tpu_torch.envs import make
from freerl_tpu_torch.train import OffPolicyConfig, train_offpolicy

torch.set_num_threads(1)

SMALL = dict(buffer_size=4096, batch_size=32, hidden=(16, 16))
DDPG_ALL = dict(weight_decay=True, ou_noise=True, obs_norm=True,
                net_init=True, popart=True, noise_init_scale=1.0, num_envs=8)

RUNS = {
    "ddpg_all/LunarLanderContinuous": ("LunarLanderContinuous-v2", DDPG,
                                       DDPGConfig(**SMALL, **DDPG_ALL)),
    "td3/LunarLanderContinuous": ("LunarLanderContinuous-v2", TD3,
                                  TD3Config(**SMALL)),
    "sac/LunarLanderContinuous": ("LunarLanderContinuous-v2", SAC,
                                  SACConfig(**SMALL)),
    "sac_ou/Pendulum": ("Pendulum-v1", SAC,
                        SACConfig(**SMALL, ou_noise=True, num_envs=8)),
    "ddpg_disc/CartPole": ("CartPole-v1", DDPG, DDPGConfig(**SMALL)),
    "ddpg_disc_gumbel/CartPole": ("CartPole-v1", DDPG,
                                  DDPGConfig(**SMALL, discrete_gumbel=True)),
    "sac_disc/CartPole": ("CartPole-v1", SAC, SACConfig(**SMALL)),
}

# the range one episode's return can take in each env; LunarLander's has
# no lower bound, as its shaping charges an unwrapped hull angle
BOUNDS = {
    "LunarLanderContinuous-v2": (-np.inf, 400.0),
    "Pendulum-v1": (-200 * (np.pi ** 2 + 6.4 + 0.004), 0.0),
    "CartPole-v1": (1.0, 500.0),
}


def probe(cls):
    """The algo, keeping each learner step's metrics and the buffer."""
    class Probe(cls):
        def learn_step(self, state, buffer, generator, num_envs):
            state, buffer, metrics = super().learn_step(state, buffer,
                                                        generator, num_envs)
            self.metrics.append(metrics)
            self.buffer = buffer
            return state, buffer, metrics

    return Probe


@pytest.mark.parametrize("run", list(RUNS))
def test_train_offpolicy_continuous_family(run):
    name, cls, cfg = RUNS[run]
    env = make(name, device="cpu")
    algo = probe(cls)(env.dim_info, cfg, device="cpu")
    algo.metrics, algo.buffer = [], None
    loop = OffPolicyConfig(num_envs=8, start_steps=64, chunk_size=32,
                           random_steps=128, max_env_steps=1024,
                           max_episodes=10**6)
    _, returns, info = train_offpolicy(env, algo, loop)
    assert info["env_steps"] == 1024
    assert info["updates"] == len(algo.metrics) == 128 - 8
    for key in algo.metrics[0]:
        assert bool(torch.isfinite(torch.stack(
            [m[key] for m in algo.metrics])).all()), key
    assert info["episodes"] == len(returns)
    lo, hi = BOUNDS[name]
    assert np.isfinite(returns).all()
    if len(returns):
        assert returns.min() >= lo and returns.max() <= hi
    action = algo.buffer.data.action[:algo.buffer.size]
    if env.dim_info.is_continue:
        assert action.shape[1:] == (env.dim_info.action_dim,)
        assert float(action.abs().max()) <= env.dim_info.max_action
    elif isinstance(algo, DDPG):
        # the behaviour probs, or the one-hot of the action taken
        np.testing.assert_allclose(action.sum(1).numpy(), 1.0, atol=1e-5)
        if cfg.discrete_gumbel:
            assert set(action.unique().tolist()) == {0.0, 1.0}
    else:
        assert action.dtype == torch.int32 and action.dim() == 1
