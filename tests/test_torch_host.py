"""The port's host env bridge (``envs/host.py``) against the JAX package's.

``_host_reset`` and ``_host_step`` of the two bridges are fed one seed and
one action sequence on gymnasium's CartPole-v1 and must agree exactly,
auto-resets included. Also: worker processes equal in-process stepping,
an env with duck-typed spaces and no gymnasium (``chip_smoke.py``'s
``NumpyCartPole``, itself exactly gymnasium's CartPole-v1), and
``train_offpolicy`` through the bridge, whose record must equal the raw
rewards' sums.
"""
import threading

import numpy as np
import pytest
import torch

gym = pytest.importorskip("gymnasium")

from chip_smoke import NumpyCartPole, RawLog, expected_record  # noqa: E402
from freerl_tpu.envs.host import HostVecEnv as JaxHostVecEnv  # noqa: E402
from freerl_tpu_torch.algos import DQN, DQNConfig  # noqa: E402
from freerl_tpu_torch.envs import vec_reset, vec_step_auto_reset  # noqa: E402
from freerl_tpu_torch.envs.host import (HostVecEnv, dim_info_of,  # noqa: E402
                                        draw_seed)
from freerl_tpu_torch.train import (OffPolicyConfig,  # noqa: E402
                                    train_offpolicy)

torch.set_num_threads(1)

N_ENVS, N_STEPS = 4, 50


def make_cartpole():
    return gym.make("CartPole-v1")


def actions(t):
    """Mostly one side, so poles fall and envs auto-reset within 50
    steps."""
    return np.array([(t + i) % 5 == 0 for i in range(N_ENVS)], np.int64)


def run_host(env, seed=123):
    out = [env._host_reset(seed)]
    for t in range(N_STEPS):
        out.extend(env._host_step(actions(t)))
    return out


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_host_reset_and_step_equal_jax():
    jenv = JaxHostVecEnv(make_cartpole, num_envs=N_ENVS)
    env = HostVecEnv(make_cartpole, num_envs=N_ENVS, device="cpu")
    assert env.dim_info == type(env.dim_info)(**vars(jenv.dim_info))
    assert (env.max_steps, env.reward_threshold, env.name) == (
        jenv.max_steps, jenv.reward_threshold, jenv.name) == (
        500, 475.0, "CartPole-v1")
    got, want = run_host(env), run_host(jenv)
    assert_same(got, want)
    dones = sum(int((o[3] | o[4]).sum()) for o in
                [got[1 + 5 * t: 6 + 5 * t] for t in range(N_STEPS)])
    assert dones >= N_ENVS      # auto-resets were exercised


def test_vec_protocol_seed_and_tensors():
    """The drivers' entry points: the reset seed is the generator's draw
    over [0, 2**31 - 1), and results come back as tensors with the true
    next obs apart from the post-reset carry obs."""
    env = HostVecEnv(make_cartpole, num_envs=N_ENVS, device="cpu")
    twin = HostVecEnv(make_cartpole, num_envs=N_ENVS, device="cpu")
    seed = draw_seed(torch.Generator().manual_seed(5))
    assert 0 <= seed < 2**31 - 1
    state, obs = vec_reset(env, torch.Generator().manual_seed(5), N_ENVS)
    np.testing.assert_array_equal(obs.numpy(), twin._host_reset(seed))
    for t in range(N_STEPS):
        out = vec_step_auto_reset(env, state, torch.from_numpy(actions(t)),
                                  None, N_ENVS)
        want = twin._host_step(actions(t))
        for field, w in zip(("next_obs", "carry_obs", "reward",
                             "terminated", "truncated"), want):
            got = getattr(out, field)
            assert isinstance(got, torch.Tensor)
            np.testing.assert_array_equal(got.numpy(), w)
        state = out.state
    assert state.tick == N_STEPS
    with pytest.raises(ValueError, match="fixed-size"):
        vec_reset(env, torch.Generator(), N_ENVS + 1)


def test_workers_equal_in_process():
    env = HostVecEnv(make_cartpole, num_envs=N_ENVS, num_workers=2,
                     device="cpu")
    try:
        got = run_host(env)
        procs = list(env._procs)
    finally:
        env.close()
    assert not any(p.is_alive() for p in procs)
    assert_same(got, run_host(HostVecEnv(make_cartpole, num_envs=N_ENVS,
                                         device="cpu")))


def test_duck_typed_env_without_gymnasium():
    """``NumpyCartPole`` has no gymnasium class anywhere: its spaces are
    plain namespaces. Through the bridge it gives exactly what
    gymnasium's CartPole-v1 gives, in process and (pickled without
    cloudpickle's help: a module-level class) in workers."""
    env = HostVecEnv(NumpyCartPole, num_envs=N_ENVS, device="cpu")
    assert env.dim_info == dim_info_of(gym.make("CartPole-v1")
                                       .observation_space,
                                       gym.make("CartPole-v1").action_space)
    assert env.max_steps == 500 and env.name == "NumpyCartPole-v1"
    want = run_host(HostVecEnv(make_cartpole, num_envs=N_ENVS, device="cpu"))
    assert_same(run_host(env), want)
    workers = HostVecEnv(NumpyCartPole, num_envs=N_ENVS, num_workers=2,
                         device="cpu")
    try:
        assert_same(run_host(workers), want)
    finally:
        workers.close()


def test_spaces_and_pickling_errors():
    from types import SimpleNamespace

    box = dim_info_of(SimpleNamespace(shape=(3,)),
                      SimpleNamespace(shape=(2,), high=np.array([2.0, 2.0])))
    assert (box.obs_dim, box.action_dim, box.is_continue,
            box.max_action) == (3, 2, True, 2.0)
    with pytest.raises(TypeError, match="unsupported action space"):
        dim_info_of(SimpleNamespace(shape=(3,)), SimpleNamespace())
    from freerl_tpu_torch.envs import _host_worker

    lock = threading.Lock()
    with pytest.raises(TypeError, match="cannot pickle"):
        _host_worker.dumps(lambda: lock)


def test_train_offpolicy_through_the_bridge():
    env = RawLog(HostVecEnv(make_cartpole, num_envs=N_ENVS, device="cpu"))
    algo = DQN(env.dim_info, DQNConfig(buffer_size=2048, batch_size=32,
                                       hidden=(16,)), device="cpu")
    cfg = OffPolicyConfig(num_envs=N_ENVS, chunk_size=16, start_steps=32,
                          max_env_steps=320, max_episodes=10**6)
    state, returns, info = train_offpolicy(env, algo, cfg)
    steps = info["env_steps"] // N_ENVS
    assert steps == len(env.raw) == 80
    assert info["updates"] == sum(1 for t in range(1, steps + 1)
                                  if t * N_ENVS > cfg.start_steps)
    assert state.step == info["updates"]
    assert len(returns) == info["episodes"] > 0
    assert np.isfinite(returns).all()
    np.testing.assert_array_equal(returns, expected_record(env.raw))
