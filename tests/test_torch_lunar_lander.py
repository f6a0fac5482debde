"""The port's batched LunarLander against the JAX env.

Every random draw of the JAX env (the reset force and the engine
dispersion) is recomputed from the same keys with ``jax.random`` and fed to
the port, so the two step the same physics from the same state. Tolerance:
rtol 1e-5 / atol 1e-6 (float32 rounding of sin/cos and divisions). The
reward is a difference of two shaping potentials of magnitude ~100, so it
carries their rounding: atol 1e-4 for it (1e-5 of ~10, a tenth of the
potential's scale).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.envs import vec_reset as jax_vec_reset
from freerl_tpu.envs.base import step_auto_reset as jax_step_auto_reset
from freerl_tpu.envs.lunar_lander import LanderState as JaxLanderState
from freerl_tpu.envs.lunar_lander import LunarLander as JaxLunarLander
from freerl_tpu_torch.envs import make, step_auto_reset, vec_reset
from freerl_tpu_torch.envs.lunar_lander import (HELIPAD_Y, INITIAL_RANDOM,
                                                LEG_DOWN, SCALE, LanderState)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
REWARD_TOL = dict(rtol=1e-5, atol=1e-4)


# -- the JAX env's draws, recomputed from its keys --------------------------
def jax_reset_draw(key):
    """The initial force LunarLander.reset(key) draws."""
    k1, _ = jax.random.split(key)
    return jax.random.uniform(k1, (2,), jnp.float32, -INITIAL_RANDOM,
                              INITIAL_RANDOM)


def jax_step_draw(key):
    """The dispersion LunarLander.step(state, action, key) draws."""
    k1, _ = jax.random.split(jax.random.fold_in(key, 7))
    return jax.random.uniform(k1, (2,), jnp.float32, -1.0, 1.0) / SCALE


@jax.jit
def jax_vec_reset_draws(key):
    return jax.vmap(jax_reset_draw)(jax.random.split(key, 16))


def jax_auto_reset_draws(key, n):
    """(disp, f) that ``vec_step_auto_reset(env, s, a, key, n)`` draws."""
    def one(k):
        k_step, k_reset = jax.random.split(k)
        return jax_step_draw(k_step), jax_reset_draw(k_reset)

    disp, f = jax.vmap(one)(jax.random.split(key, n))
    return torch.from_numpy(np.array(disp)), torch.from_numpy(np.array(f))


def to_torch_state(s) -> LanderState:
    return LanderState(**{f.name: torch.from_numpy(np.array(getattr(s, f.name)))
                          for f in dataclasses.fields(LanderState)})


def assert_state_close(ts: LanderState, js):
    for f in dataclasses.fields(LanderState):
        np.testing.assert_allclose(getattr(ts, f.name).numpy(),
                                   np.asarray(getattr(js, f.name)),
                                   err_msg=f.name, **TOL)


def mixed_states(n=16, seed=0):
    """Free flight, touchdowns at several speeds and angles, resting
    landers about to sleep, and landers at the truncation horizon."""
    rng = np.random.RandomState(seed)
    ground = HELIPAD_Y + LEG_DOWN
    kind = np.arange(n) % 4
    y = np.where(kind == 0, 8.0 + rng.rand(n) * 4,
                 ground + 0.03 * rng.randn(n))
    y = np.where(kind == 2, ground, y)
    vy = np.where(kind == 1, -2.0 - 6.0 * rng.rand(n), 0.2 * rng.randn(n))
    vy = np.where(kind == 2, 0.0, vy)
    s = dict(
        x=10.0 + 2 * rng.randn(n), y=y, vx=np.where(kind == 2, 0.0,
                                                  0.5 * rng.randn(n)),
        vy=vy, angle=np.where(kind == 2, 0.0, 0.2 * rng.randn(n)),
        omega=np.where(kind == 2, 0.0, 0.3 * rng.randn(n)),
        leg1=(kind == 2).astype(np.float32), leg2=(kind == 2).astype(np.float32),
        prev_shaping=-50 * rng.rand(n),
        rest_time=np.where(kind == 2, 0.3, 0.0),
    )
    state = {k: jnp.asarray(v, jnp.float32) for k, v in s.items()}
    state["t"] = jnp.asarray(np.where(kind == 3, 990, 10), jnp.int32)
    return JaxLanderState(**state)


# --------------------------------------------------------------------------
def test_reset_matches_jax():
    key = jax.random.PRNGKey(3)
    jenv, env = JaxLunarLander(), make("LunarLander-v2", device="cpu")
    js, jobs = jax_vec_reset(jenv, key, 16)
    f = torch.from_numpy(np.array(jax_vec_reset_draws(key)))
    ts, obs = env.reset(f)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), **TOL)
    assert_state_close(ts, js)


def test_auto_reset_steps_match_jax():
    """20 batched auto-resetting steps at B=16, each from the JAX state:
    flight, touchdowns, crashes, sleeps into 'landed', truncation resets."""
    jenv, env = JaxLunarLander(), make("LunarLander-v2", device="cpu")
    step = jax.jit(jax.vmap(lambda s, a, k: jax_step_auto_reset(jenv, s, a, k)))
    js = mixed_states()
    rng = np.random.RandomState(1)
    seen = dict(term=0, trunc=0, contact=0)
    for t in range(20):
        action = rng.randint(0, 4, 16).astype(np.int32)
        action[2::4] = 0                          # resting landers idle
        key = jax.random.PRNGKey(100 + t)
        jout = step(js, jnp.asarray(action), jax.random.split(key, 16))
        disp, f = jax_auto_reset_draws(key, 16)
        out = step_auto_reset(env, to_torch_state(js),
                              torch.from_numpy(action), disp, f)
        for name in ("next_obs", "carry_obs", "reward"):
            np.testing.assert_allclose(
                getattr(out, name).numpy(), np.asarray(getattr(jout, name)),
                err_msg=f"step {t}: {name}",
                **(REWARD_TOL if name == "reward" else TOL))
        for name in ("terminated", "truncated"):
            np.testing.assert_array_equal(
                getattr(out, name).numpy(), np.asarray(getattr(jout, name)),
                err_msg=f"step {t}: {name}")
        assert_state_close(out.state, jout.state)
        seen["term"] += int(out.terminated.sum())
        seen["trunc"] += int(out.truncated.sum())
        seen["contact"] += int(out.next_obs[:, 6:].sum())
        js = jout.state
    assert min(seen.values()) > 0, seen


def test_free_rollout_matches_jax():
    """Both envs roll 20 steps on their own from the same reset, with the
    same actions and dispersions (errors may accumulate here)."""
    jenv, env = JaxLunarLander(), make("LunarLander-v2", device="cpu")
    jstep = jax.jit(jax.vmap(jenv.step))
    key = jax.random.PRNGKey(4)
    js, jobs = jax_vec_reset(jenv, key, 16)
    ts, obs = env.reset(torch.from_numpy(np.array(jax_vec_reset_draws(key))))
    rng = np.random.RandomState(2)
    for t in range(20):
        action = rng.randint(0, 4, 16).astype(np.int32)
        keys = jax.random.split(jax.random.PRNGKey(200 + t), 16)
        js, jobs, jr, jterm, jtrunc = jstep(js, jnp.asarray(action), keys)
        disp = torch.from_numpy(np.array(jax.vmap(jax_step_draw)(keys)))
        ts, obs, r, term, trunc = env.step(ts, torch.from_numpy(action), disp)
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs),
                                   err_msg=f"step {t}", **TOL)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr),
                                   err_msg=f"step {t}", **REWARD_TOL)
        np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
        np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))


def test_reset_distribution():
    """The port's own draws: initial velocities uniform in +-F/m*dt, the
    same distribution as the JAX env's (compared by deciles)."""
    n = 20000
    env = make("LunarLander-v2", device="cpu")
    g = torch.Generator().manual_seed(0)
    state, obs = vec_reset(env, g, n)
    assert obs.shape == (n, 8)
    bound = INITIAL_RANDOM / env.mass * 0.02
    v = torch.stack([state.vx, state.vy], 1).numpy()
    assert np.abs(v).max() <= bound
    np.testing.assert_allclose(v.mean(0), 0.0, atol=0.02 * bound)
    np.testing.assert_allclose(v.std(0), bound / np.sqrt(3), rtol=0.03)
    _, jobs = jax_vec_reset(JaxLunarLander(), jax.random.PRNGKey(0), n)
    deciles = np.linspace(0.1, 0.9, 9)
    for col in (2, 3):
        np.testing.assert_allclose(
            np.quantile(obs[:, col].numpy(), deciles),
            np.quantile(np.asarray(jobs)[:, col], deciles),
            atol=0.03 * float(np.abs(jobs[:, col]).max()))
    assert torch.all(obs[:, [0, 4, 5, 6, 7]] == 0)


def heuristic(obs):
    """The classic PD landing controller (gymnasium's demo heuristic),
    over a batch."""
    angle_targ = np.clip(obs[:, 0] * 0.5 + obs[:, 2] * 1.0, -0.4, 0.4)
    hover_targ = 0.55 * np.abs(obs[:, 0])
    angle_todo = (angle_targ - obs[:, 4]) * 0.5 - obs[:, 5] * 1.0
    hover_todo = (hover_targ - obs[:, 1]) * 0.5 - obs[:, 3] * 0.5
    legs = (obs[:, 6] > 0) | (obs[:, 7] > 0)
    angle_todo = np.where(legs, 0.0, angle_todo)
    hover_todo = np.where(legs, -obs[:, 3] * 0.5, hover_todo)
    a = np.zeros(obs.shape[0], np.int64)
    a = np.where(angle_todo > 0.05, 1, a)
    a = np.where(angle_todo < -0.05, 3, a)
    main = (hover_todo > np.abs(angle_todo)) & (hover_todo > 0.05)
    return np.where(main, 2, a)


def test_heuristic_lands():
    """The PD controller lands every lander of a batch, with returns
    comparable to Box2D's (the JAX env's calibration test)."""
    env = make("LunarLander-v2", device="cpu")
    g = torch.Generator().manual_seed(0)
    n = 5
    state, obs = vec_reset(env, g, n)
    total = np.zeros(n)
    last_r = np.zeros(n)
    live = np.ones(n, bool)
    for _ in range(1000):
        action = torch.from_numpy(heuristic(obs.numpy()))
        state, obs, r, term, trunc = env.step(state, action,
                                              env.draw_step(n, g))
        r = r.numpy()
        total += np.where(live, r, 0.0)
        last_r = np.where(live, r, last_r)
        live &= ~(term.numpy() | trunc.numpy())
        if not live.any():
            break
    assert not live.any()
    assert (last_r == 100.0).all(), last_r
    assert total.mean() > 200


def test_rest_is_stable_and_terminates_landed():
    env = make("LunarLander-v2", device="cpu")
    n = 8
    one = torch.ones(n)
    s = LanderState(x=10.0 * one, y=(HELIPAD_Y + LEG_DOWN) * one,
                    vx=0 * one, vy=0 * one, angle=0 * one, omega=0 * one,
                    leg1=one, leg2=one, prev_shaping=0 * one,
                    rest_time=0 * one, t=torch.zeros(n, dtype=torch.int32))
    g = torch.Generator().manual_seed(0)
    zero = torch.zeros(n, dtype=torch.int64)
    for t in range(30):
        s, o, r, term, trunc = env.step(s, zero, env.draw_step(n, g))
        if bool(term.all()):
            break
    assert t == 24                           # 0.5 s sleep timer at 50 fps
    assert (r == 100.0).all()
    assert float(s.vy.abs().max()) < 1e-3


def test_make_registry():
    env = make("LunarLander-v2", device="cpu")
    assert env.dim_info.obs_dim == 8 and env.dim_info.action_dim == 4
    assert env.device == torch.device("cpu")
    with pytest.raises(KeyError, match="Unknown env"):
        make("NoSuchEnv-v0", device="cpu")


def test_vec_wrappers_are_seeded():
    env = make("LunarLander-v2", device="cpu")
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(7)
        state, obs = vec_reset(env, g, 16)
        from freerl_tpu_torch.envs import vec_step_auto_reset
        out = vec_step_auto_reset(env, state, torch.full((16,), 2), g, 16)
        outs.append(torch.cat([obs, out.next_obs, out.reward[:, None]], 1))
    assert outs[0].shape == (16, 17)
    assert torch.equal(outs[0], outs[1])
