"""The port's classic-control and tabular envs, and the env wrappers,
against the JAX package.

Each rollout runs 200 auto-resetting steps of 16 envs with a fixed action
pattern. Every step starts from the JAX env's state, and the port is fed
the draws the JAX env made: the reset draws recomputed from its keys, and
for the tabular envs the Gumbel noise behind ``jax.random.categorical``.
Some rows start a few steps before the truncation horizon. Tolerances:
rtol 1e-5 / atol 1e-6 for the classic envs (float32 rounding of sin/cos and
divisions); the tabular envs and the discrete-to-continuous decoding are
exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.core.types import DimInfo as JaxDimInfo
from freerl_tpu.envs import make as jax_make
from freerl_tpu.envs import vec_reset as jax_vec_reset
from freerl_tpu.envs import vec_step_auto_reset as jax_vec_step
from freerl_tpu.envs.base import DisToConWrapper as JaxDisToCon
from freerl_tpu_torch.core.types import DimInfo
from freerl_tpu_torch.envs import (DisToConWrapper, Env, FixedResetWrapper,
                                   make, register, step_auto_reset, vec_reset,
                                   vec_step_auto_reset)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
N_ENVS, N_STEPS = 16, 200
TABULAR = ("FrozenLake-v1", "FrozenLake-v1-not-slippery", "Taxi-v3")


def _make(name, which):
    kwargs = {}
    if name.endswith("-not-slippery"):
        name, kwargs = "FrozenLake-v1", dict(is_slippery=False)
    dis = name.endswith("-dis")
    name = name.removesuffix("-dis")
    if which == "jax":
        return jax_make(name, dis_to_con=dis, **kwargs)
    return make(name, dis_to_con=dis, device="cpu", **kwargs)


def _jax_reset_draw(name, jenv, k):
    """The draw ``jenv.reset(k)`` makes, in the form the port's reset takes."""
    if name.startswith("CartPole"):
        return jax.random.uniform(k, (4,), jnp.float32, -0.05, 0.05)
    if name.startswith("MountainCar"):
        return jax.random.uniform(k, (), jnp.float32, -0.6, -0.4)
    if name.startswith("Pendulum"):
        k1, k2 = jax.random.split(k)
        return jnp.stack([
            jax.random.uniform(k1, (), jnp.float32, -jnp.pi, jnp.pi),
            jax.random.uniform(k2, (), jnp.float32, -1.0, 1.0)])
    return jax.random.randint(k, (), 0, len(jenv.start_states))


def _jax_draws(name, jenv, key, n):
    """(step draw or None, reset draw) behind ``vec_step_auto_reset``."""
    def one(k):
        k_step, k_reset = jax.random.split(k)
        step = (jax.random.gumbel(k_step, (jenv.next_state.shape[2],),
                                  jnp.float32)
                if name in TABULAR else jnp.zeros(()))
        return step, _jax_reset_draw(name, jenv, k_reset)

    step, reset = jax.vmap(one)(jax.random.split(key, n))
    step = torch.from_numpy(np.array(step)) if name in TABULAR else None
    return step, torch.from_numpy(np.array(reset))


def _policy(name, t, obs):
    """A fixed action pattern per env (B,); for the continuous envs (B, 1)."""
    rows = np.arange(N_ENVS)
    if name.startswith("MountainCarContinuous"):
        return np.where(obs[:, 1] > 0, 1.0, -1.0).astype(np.float32)[:, None]
    if name.startswith("MountainCar"):        # pump energy: reaches the goal
        return np.where(obs[:, 1] > 0, 2, 0).astype(np.int32)
    if name == "Pendulum-v1":
        return (((t + rows) % 5 - 2) * 1.25).astype(np.float32)[:, None]
    n_actions = {"CartPole-v1": 2, "Pendulum-v1-dis": 16, "Taxi-v3": 6}.get(
        name, 4)
    action = (t // 3 + 7 * rows) % n_actions
    if name.startswith("FrozenLake"):       # keep the late rows off the holes
        action = np.where(rows % 4 == 3, 0, action)
    return action.astype(np.int32)


def _to_torch(state_cls, js):
    out = {}
    for f in dataclasses.fields(state_cls):
        x = torch.from_numpy(np.array(getattr(js, f.name)))
        out[f.name] = x.to(torch.int64) if f.name == "s" else x
    return state_cls(**out)


ROLLOUTS = ["CartPole-v1", "MountainCar-v0", "MountainCarContinuous-v0",
            "Pendulum-v1", "Pendulum-v1-dis", *TABULAR]


@pytest.mark.parametrize("name", ROLLOUTS)
def test_rollout_matches_jax(name):
    jenv, env = _make(name, "jax"), _make(name, "torch")
    key = jax.random.PRNGKey(0)
    js, jobs = jax_vec_reset(jenv, key, N_ENVS)
    # rows 3, 7, 11, 15 start 5 steps before the truncation horizon
    t0 = np.where(np.arange(N_ENVS) % 4 == 3, jenv.max_steps - 5, 0)
    js = js.replace(t=jnp.asarray(t0, jnp.int32))
    reset_draws = jax.vmap(lambda k: _jax_reset_draw(name, jenv, k))(
        jax.random.split(key, N_ENVS))
    _, obs = env.reset(torch.from_numpy(np.array(reset_draws)))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), **TOL)

    inner = env.env if isinstance(env, DisToConWrapper) else env
    state_cls = type(inner.reset(inner.draw_reset(1, torch.Generator()))[0])
    exact = name in TABULAR
    jstep = jax.jit(lambda s, a, k: jax_vec_step(jenv, s, a, k, N_ENVS))
    seen = dict(terminated=0, truncated=0)
    obs = np.asarray(jobs)
    for t in range(N_STEPS):
        action = _policy(name, t, obs)
        key = jax.random.fold_in(jax.random.PRNGKey(1), t)
        jout = jstep(js, jnp.asarray(action), key)
        step_draw, reset_draw = _jax_draws(name, jenv, key, N_ENVS)
        out = step_auto_reset(env, _to_torch(state_cls, js),
                              torch.from_numpy(action), step_draw, reset_draw)
        for field in ("next_obs", "carry_obs", "reward", "terminated",
                      "truncated"):
            got = getattr(out, field).numpy()
            want = np.asarray(getattr(jout, field))
            assert got.shape == want.shape, field
            if exact or got.dtype == bool:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"step {t}: {field}")
            else:
                np.testing.assert_allclose(got, want, **TOL,
                                           err_msg=f"step {t}: {field}")
        for f in dataclasses.fields(state_cls):
            got = getattr(out.state, f.name).numpy()
            want = np.asarray(getattr(jout.state, f.name))
            if exact or f.name == "t":
                np.testing.assert_array_equal(got, want, err_msg=f.name)
            else:
                np.testing.assert_allclose(got, want, **TOL, err_msg=f.name)
        seen["terminated"] += int(out.terminated.sum())
        seen["truncated"] += int(out.truncated.sum())
        js, obs = jout.state, np.asarray(jout.carry_obs)
    assert seen["truncated"] > 0, seen
    if not name.startswith(("Pendulum", "Taxi")):
        assert seen["terminated"] > 0, seen


class _Box(Env):
    """A stand-in continuous env with a 3-D action box."""

    dim_info = DimInfo(obs_dim=2, action_dim=3, is_continue=True,
                       max_action=1.5)
    name = "Box"


class _JaxBox:
    dim_info = JaxDimInfo(obs_dim=2, action_dim=3, is_continue=True,
                          max_action=1.5)
    max_steps, reward_threshold, name = 1000, None, "Box"


@pytest.mark.parametrize("case", ["pendulum_16", "box_3x3", "box_2x2"])
def test_dis_to_con_decoding_matches_jax(case):
    if case == "pendulum_16":
        jenv = jax_make("Pendulum-v1", dis_to_con=True)
        env = make("Pendulum-v1", dis_to_con=True, device="cpu")
        assert env.name == jenv.name == "Pendulum-v1-dis16"
    else:
        k = int(case[-1])
        jenv = JaxDisToCon(_JaxBox(), bins_per_dim=k)
        env = DisToConWrapper(_Box(device="cpu"), bins_per_dim=k)
        assert env.name == jenv.name == f"Box-dis{k ** 3}"
    assert env.dim_info.action_dim == jenv.dim_info.action_dim
    assert not env.dim_info.is_continue
    a = np.arange(env.dim_info.action_dim, dtype=np.int32)
    np.testing.assert_array_equal(
        env.to_continuous(torch.from_numpy(a)).numpy(),
        np.asarray(jax.vmap(jenv.to_continuous)(jnp.asarray(a))))


@pytest.mark.parametrize("name", ["LunarLander-v2", "CartPole-v1",
                                  "MountainCar-v0", "Pendulum-v1",
                                  "FrozenLake-v1", "Taxi-v3"])
def test_fixed_reset_pins_every_reset(name):
    env = FixedResetWrapper(make(name, device="cpu"), seed=3)
    assert env.dim_info == env.env.dim_info and env.name == env.env.name
    g = torch.Generator().manual_seed(0)
    _, obs = vec_reset(env, g, 8)
    assert torch.equal(obs, obs[:1].expand_as(obs))
    _, again = vec_reset(FixedResetWrapper(make(name, device="cpu"), seed=3),
                         torch.Generator().manual_seed(1), 4)
    assert torch.equal(again, obs[:4])
    # auto-resets land on the same start state
    state, carry = vec_reset(env, g, 8)
    n_actions = env.dim_info.action_dim
    resets = 0
    for t in range(600):
        out = vec_step_auto_reset(env, state, torch.full((8,), t % n_actions),
                                  g, 8)
        done = out.episode_done
        if bool(done.any()):
            assert torch.equal(out.carry_obs[done],
                               obs[:1].expand(int(done.sum()), -1))
            resets += int(done.sum())
        state = out.state
    assert resets > 0


def test_make_registry_and_dis_to_con():
    for name in ("CartPole-v1", "MountainCar-v0", "FrozenLake-v1", "Taxi-v3",
                 "LunarLander-v2"):
        env = make(name, dis_to_con=True, device="cpu")   # discrete: unwrapped
        assert not isinstance(env, DisToConWrapper) and env.name == name
    for name in ("MountainCarContinuous-v0", "Pendulum-v1"):
        env = make(name, dis_to_con=True, n_bins=8, device="cpu")
        assert isinstance(env, DisToConWrapper)
        assert env.dim_info.action_dim == 8 and env.name == f"{name}-dis8"
    assert make("FrozenLake-v1", is_slippery=False,
                device="cpu").n_outcomes == 1
    for name in ("deep-sea-treasure-v0", "PixelCartPole-v1"):
        assert make(name, device="cpu").name == name
    with pytest.raises(KeyError, match="Unknown env"):
        make("NoSuchEnv-v0", device="cpu")

    class Tiny(make("CartPole-v1", device="cpu").__class__):
        name = "Tiny-v0"

    register("Tiny-v0", Tiny)
    assert make("Tiny-v0", device="cpu").name == "Tiny-v0"


@pytest.mark.parametrize("name", ["FrozenLake-v1", "Taxi-v3"])
def test_tabular_tables_match_jax(name):
    jenv, env = jax_make(name), make(name, device="cpu")
    for field in ("next_state", "reward", "prob", "terminal"):
        np.testing.assert_array_equal(getattr(env, field).numpy(),
                                      np.asarray(getattr(jenv, field)))
    np.testing.assert_array_equal(env.start_states.numpy(),
                                  np.asarray(jenv.start_states))
    # the port's own Gumbel draws pick outcomes with the table's odds
    g = torch.Generator().manual_seed(0)
    n = 30000
    state, _ = vec_reset(env, g, n)
    out = env.step(state, torch.zeros(n, dtype=torch.int64),
                   env.draw_step(n, g))
    if name == "FrozenLake-v1":      # from S, "left": stay, down, or stay
        assert set(out[0].s.tolist()) == {0, 4}
        np.testing.assert_allclose(float((out[0].s == 4).float().mean()),
                                   1 / 3, atol=0.01)
