"""The port's classic-control envs step for step against gymnasium (the
port's counterparts of the JAX package's tests/test_envs.py gymnasium
tests, with their seeds, action patterns and tolerances). Each port env
runs a batch of one, reset to gymnasium's start state. Skipped where
gymnasium is not installed."""
import numpy as np
import pytest
import torch

from freerl_tpu_torch.envs import make

torch.set_num_threads(1)


def _row(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32))[None]


def test_cartpole_matches_gymnasium():
    gym = pytest.importorskip("gymnasium")
    genv = gym.make("CartPole-v1").unwrapped
    genv.reset(seed=0)
    env = make("CartPole-v1", device="cpu")
    state, _ = env.reset(_row(genv.state))
    for t in range(50):
        a = t % 2
        gobs, gr, gterm, _, _ = genv.step(a)
        state, obs, r, term, _ = env.step(
            state, torch.tensor([a], dtype=torch.int32), None)
        np.testing.assert_allclose(obs[0].numpy(), gobs, rtol=1e-4,
                                   atol=1e-5)
        assert float(r[0]) == gr
        assert bool(term[0]) == gterm
        if gterm:
            break


def test_mountaincar_matches_gymnasium():
    gym = pytest.importorskip("gymnasium")
    genv = gym.make("MountainCar-v0").unwrapped
    genv.reset(seed=3)
    pos, vel = np.asarray(genv.state, dtype=np.float32)
    assert vel == 0.0
    env = make("MountainCar-v0", device="cpu")
    state, _ = env.reset(torch.tensor([pos]))
    for t in range(100):
        a = [0, 2][t % 2]
        gobs, gr, gterm, _, _ = genv.step(a)
        state, obs, r, term, _ = env.step(
            state, torch.tensor([a], dtype=torch.int32), None)
        np.testing.assert_allclose(obs[0].numpy(), gobs, rtol=1e-4,
                                   atol=1e-6)
        assert float(r[0]) == gr
        assert bool(term[0]) == gterm


def test_pendulum_matches_gymnasium():
    gym = pytest.importorskip("gymnasium")
    genv = gym.make("Pendulum-v1").unwrapped
    genv.reset(seed=1)
    env = make("Pendulum-v1", device="cpu")
    state, _ = env.reset(_row(genv.state))
    rng = np.random.RandomState(0)
    for _ in range(50):
        a = rng.uniform(-2, 2, size=(1,)).astype(np.float32)
        gobs, gr, _, _, _ = genv.step(a)
        state, obs, r, _, _ = env.step(state, torch.from_numpy(a)[None],
                                       None)
        np.testing.assert_allclose(obs[0].numpy(), gobs, rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(float(r[0]), gr, rtol=1e-3, atol=1e-4)
