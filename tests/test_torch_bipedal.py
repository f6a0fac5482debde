"""The port's BipedalWalker-v3 against the JAX package's.

Reset is fed the draws the JAX reset makes from its key (the terrain
walk's 200 uniforms, then the (5, 2) spawn noise). The step is compared
teacher-forced: a JAX trajectory is recorded under random torques, and
from each recorded state the port's one step must give JAX's next state,
observation, reward and flags. A free-running comparison would drift: the
solver is chaotic over hundreds of steps. Tolerances: reset rtol 1e-5 /
atol 1e-6 (the terrain walk's float32 sums); one step rtol 1e-5 / atol
2e-5 on states of magnitude ~10 (16 Gauss-Seidel velocity iterations of
float32 rounding in two frameworks), done flags exact. A stiff step (legs
and hull pressed into the ground at a crash) can amplify that rounding a
hundredfold: at most 2 of the ~1,000 env-steps compared may differ by up
to 5e-3. (This trajectory has one such step, where the spins differ by
1.5e-3; there a float64 run of the port's step lands far closer to the
port's float32 result than to JAX's.)
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.envs.bipedal import BipedalWalker as JaxWalker
from freerl_tpu_torch.envs import make
from freerl_tpu_torch.envs.bipedal import (TERRAIN_HEIGHT, BipedalWalker,
                                           WalkerState)

torch.set_num_threads(1)

N_ENVS, N_STEPS = 16, 100
STEP_TOL = dict(rtol=1e-5, atol=2e-5)


def jax_reset_draw(key):
    """The draws ``JaxWalker.reset(key)`` makes, as the port's (210,) row:
    the terrain scan's key chain, then the spawn noise."""
    k_t, k_n = jax.random.split(key)

    def walk(k, _):
        k, kr = jax.random.split(k)
        return k, jax.random.uniform(kr, (), jnp.float32, -1.0, 1.0)

    _, us = jax.lax.scan(walk, k_t, None, length=200)
    noise = jax.random.uniform(k_n, (5, 2), jnp.float32, -1e-3, 1e-3)
    return jnp.concatenate([us, noise.reshape(-1)])


def to_torch(js) -> WalkerState:
    return WalkerState(**{f.name: torch.from_numpy(np.array(getattr(js, f.name)))
                          for f in dataclasses.fields(WalkerState)})


@pytest.fixture(scope="module")
def jax_run():
    """16 JAX resets, a 100-step trajectory under uniform torques, and the
    jitted batch step."""
    jenv = JaxWalker()
    keys = jax.random.split(jax.random.PRNGKey(0), N_ENVS)
    draws = jax.jit(jax.vmap(jax_reset_draw))(keys)
    js, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
    step = jax.jit(jax.vmap(jenv.step))
    rng = np.random.RandomState(0)
    traj = []
    for _ in range(N_STEPS):
        a = rng.uniform(-1, 1, (N_ENVS, 4)).astype(np.float32)
        out = step(js, jnp.asarray(a), keys)
        traj.append((js, a, out))
        js = out[0]
    return np.array(draws), jobs, traj, lambda s, a: step(s, a, keys)


def test_reset_matches_jax(jax_run):
    draws, jobs, traj, _ = jax_run
    js0 = traj[0][0]
    env = BipedalWalker(device="cpu")
    s, obs = env.reset(torch.from_numpy(draws))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=1e-5,
                               atol=1e-6)
    for f in dataclasses.fields(WalkerState):
        np.testing.assert_allclose(getattr(s, f.name).numpy(),
                                   np.asarray(getattr(js0, f.name)),
                                   rtol=1e-5, atol=1e-6, err_msg=f.name)


def test_teacher_forced_steps_match_jax(jax_run):
    """From recorded JAX states, the port's step: the next state's every
    field, the observation, the reward and both flags. Every fourth step,
    and every step where a hull crashes."""
    traj = jax_run[2]
    env = BipedalWalker(device="cpu")
    worst, contacts, crashes, n, stiff = 0.0, 0, 0, 0, []
    for t, (js, a, (js2, jobs, jr, jterm, jtrunc)) in enumerate(traj):
        if t % 4 and not bool(jnp.any(jr == -100.0)):
            continue
        n += 1
        s2, obs, r, term, trunc = env.step(to_torch(js), torch.from_numpy(a))
        got = [obs, r] + [getattr(s2, f.name)
                          for f in dataclasses.fields(WalkerState)]
        want = [jobs, jr] + [getattr(js2, f.name)
                             for f in dataclasses.fields(WalkerState)]
        got = np.concatenate([g.numpy().reshape(N_ENVS, -1) for g in got], 1)
        want = np.concatenate([np.asarray(w, np.float32).reshape(N_ENVS, -1)
                               for w in want], 1)
        err = np.abs(got.astype(np.float64) - want)
        within = err <= STEP_TOL["atol"] + STEP_TOL["rtol"] * np.abs(want)
        for row in np.flatnonzero(~within.all(1)):
            stiff.append((t, int(row), float(err[row].max())))
        worst = max(worst, float(err[within].max()))
        np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
        np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))
        contacts += int((obs[:, 8] + obs[:, 13]).sum())
        crashes += int((r == -100.0).sum())
    print(f"teacher-forced {n} of {N_STEPS} steps x {N_ENVS} envs: max abs "
          f"err {worst:.3e} within tolerance; stiff (step, env, err) "
          f"{stiff}; {contacts} leg contacts, {crashes} crashes")
    assert len(stiff) <= 2 and all(e <= 5e-3 for *_, e in stiff), stiff
    assert contacts > 0 and crashes > 0


def test_truncation_and_flags(jax_run):
    """A state one step before the 1600-step horizon truncates unless it
    terminates; the same as the JAX step."""
    _, _, traj, step = jax_run
    js, a, _ = traj[5]
    js = js.replace(t=jnp.full((N_ENVS,), 1599, jnp.int32))
    _, _, _, jterm, jtrunc = step(js, jnp.asarray(a))
    _, _, _, term, trunc = BipedalWalker(device="cpu").step(
        to_torch(js), torch.from_numpy(a))
    np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))
    np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
    assert bool((trunc | term).all())


def test_layout_terrain_and_motors():
    """The JAX package's sanity checks: obs layout and lidar fractions,
    a gentle start pad then a varying terrain, hips that answer the motor
    torque and a knee inside its limits."""
    env = make("BipedalWalker-v3", device="cpu")
    assert env.dim_info.obs_dim == 24 and env.dim_info.action_dim == 4
    assert env.draw_step(2, torch.Generator()) is None
    s, o = env.reset(env.draw_reset(4, torch.Generator().manual_seed(3)))
    assert o.shape == (4, 24) and float(o[:, 0].abs().max()) < 0.1
    assert bool((o[:, 14:] <= 1.0).all() and (o[:, 14:] > 0).all())
    terr = s.terrain.numpy()
    assert np.abs(terr[:, :15] - TERRAIN_HEIGHT).max() < 0.2
    assert terr.std(axis=1).min() > 0.0
    fwd = torch.tensor([[1.0, 0.0, 1.0, 0.0], [-1.0, 0.0, -1.0, 0.0]])
    s = dataclasses.replace(s, **{f.name: getattr(s, f.name)[:1].expand(
        (2,) + getattr(s, f.name).shape[1:]).clone()
        for f in dataclasses.fields(WalkerState)})
    for _ in range(10):
        s, o, *_ = env.step(s, fwd)
    assert float(o[0, 4]) != float(o[1, 4])
    assert -1.8 < float(o[0, 6]) < 0.1


def test_dis_to_con_dqn_smoke():
    """The reference's DQN path: 2**4 = 16 discrete actions through the
    bridge, a few episodes of train_offpolicy."""
    from freerl_tpu_torch.algos import DQN, DQNConfig
    from freerl_tpu_torch.train import OffPolicyConfig, train_offpolicy

    env = make("BipedalWalker-v3", dis_to_con=True, bins_per_dim=2,
               device="cpu")
    assert env.dim_info.action_dim == 16
    assert env.to_continuous(torch.tensor([0, 5, 15])).tolist() == [
        [-1.0] * 4, [1.0, -1.0, 1.0, -1.0], [1.0] * 4]
    algo = DQN(env.dim_info, DQNConfig(buffer_size=20_000, batch_size=64),
               device="cpu")
    cfg = OffPolicyConfig(num_envs=16, max_episodes=4, start_steps=300,
                          chunk_size=32, host_sync_every=1)
    _, returns, info = train_offpolicy(env, algo, cfg)
    print(f"dis_to_con DQN: {info}")
    assert len(returns) >= 4 and np.isfinite(returns).all()
    assert info["updates"] > 0
