"""The DQN family end to end on the CPU: ``train_offpolicy`` with each
trick, all six together (Rainbow), and the classic and tabular envs.

Each run is short (8 envs, 256 vector steps, a 32-wide net). The checks:
every loss is finite, the learner ran the expected number of steps, the
episode record holds one finite return per finished episode, and each
return lies in its env's range. An untrained MountainCar episode ends at
its -200 truncation return.
"""
import numpy as np
import pytest
import torch

from freerl_tpu_torch.algos import DQN, DQNConfig
from freerl_tpu_torch.envs import make
from freerl_tpu_torch.train import OffPolicyConfig, train_offpolicy

torch.set_num_threads(1)

RAINBOW = dict(double=True, dueling=True, per=True, per_sampler="tree",
               noisy=True, n_step=3, categorical=True)

RUNS = {
    "MountainCar-v0/double": ("MountainCar-v0", dict(double=True)),
    "MountainCar-v0/dueling": ("MountainCar-v0", dict(dueling=True)),
    "MountainCar-v0/noisy": ("MountainCar-v0", dict(noisy=True)),
    "MountainCar-v0/n_step": ("MountainCar-v0", dict(n_step=3)),
    "MountainCar-v0/categorical": ("MountainCar-v0", dict(categorical=True)),
    "MountainCar-v0/rainbow": ("MountainCar-v0", RAINBOW),
    "FrozenLake-v1/n_step": ("FrozenLake-v1", dict(n_step=3)),
    "Taxi-v3/n_step": ("Taxi-v3", dict(n_step=3, double=True)),
    "Pendulum-v1-dis16/double_dueling": ("Pendulum-v1",
                                         dict(double=True, dueling=True)),
    "CartPole-v1/per_cumsum_nstep": ("CartPole-v1",
                                     dict(per=True, n_step=3)),
}

# the range one episode's return can take in each env
BOUNDS = {
    "MountainCar-v0": (-200.0, -200.0),           # untrained: truncated
    "FrozenLake-v1": (0.0, 1.0),
    "Taxi-v3": (-2000.0, 20.0),
    "Pendulum-v1-dis16": (-200 * (np.pi ** 2 + 6.4 + 0.004), 0.0),
    "CartPole-v1": (1.0, 500.0),
}


class ProbeDQN(DQN):
    """Keeps every learner step's loss."""

    losses: list

    def learn_step(self, state, buffer, generator, num_envs):
        state, buffer, metrics = super().learn_step(state, buffer, generator,
                                                    num_envs)
        self.losses.append(metrics["loss"])
        return state, buffer, metrics


@pytest.mark.parametrize("run", list(RUNS))
def test_train_offpolicy_family(run):
    name, tricks = RUNS[run]
    env = make(name, dis_to_con=True, device="cpu")
    algo = ProbeDQN(env.dim_info, DQNConfig(buffer_size=2048, batch_size=32,
                                            hidden=(32,), **tricks),
                    device="cpu")
    algo.losses = []
    cfg = OffPolicyConfig(num_envs=8, start_steps=64, chunk_size=64,
                          max_env_steps=2048, max_episodes=10**6)
    _, returns, info = train_offpolicy(env, algo, cfg)
    assert info["env_steps"] == 2048
    assert info["updates"] == len(algo.losses) == 256 - 8
    assert bool(torch.isfinite(torch.stack(algo.losses)).all())
    assert info["episodes"] == len(returns) > 0
    lo, hi = BOUNDS[env.name]
    assert np.isfinite(returns).all()
    assert returns.min() >= lo - 1e-3 and returns.max() <= hi + 1e-3, (
        returns.min(), returns.max())
