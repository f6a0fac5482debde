"""The port's LunarLanderContinuous-v2 against the JAX env, with the JAX
env's reset forces and engine dispersions recomputed from its keys and fed
in (the draws of the discrete env: both share one physics).

Actions cover every branch of the engine map: main engine off (a0 <= 0)
and throttled, side engines off (|a1| <= 0.5) and on either side, and
values outside [-1, 1] that the env clips. Tolerances as for the discrete
env: rtol 1e-5 / atol 1e-6 for state and observations, atol 1e-4 for the
reward (a difference of two shaping potentials of magnitude ~100).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from freerl_tpu.envs.base import step_auto_reset as jax_step_auto_reset
from freerl_tpu.envs.lunar_lander import \
    LunarLanderContinuous as JaxLunarLanderContinuous
from freerl_tpu_torch.envs import make, step_auto_reset, vec_reset
from freerl_tpu_torch.envs.lunar_lander import LunarLanderContinuous
from tests.test_torch_lunar_lander import (REWARD_TOL, TOL, assert_state_close,
                                           jax_auto_reset_draws, jax_step_draw,
                                           jax_vec_reset_draws, mixed_states,
                                           to_torch_state)

torch.set_num_threads(1)


def actions(rng, n=16):
    """(n, 2) actions over the engine map's branches, some out of range."""
    a = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
    a[0::4, 0] = -0.3                 # main engine off
    a[1::4, 1] = 0.2                  # side engines off
    a[2::8] = [1.0, -1.0]             # full main, full left
    a[6::8] = [0.0, 0.5]              # both exactly at their thresholds
    return a


def test_engine_powers_match_jax():
    rng = np.random.RandomState(0)
    a = actions(rng, 64)
    got = LunarLanderContinuous._engine_powers(torch.from_numpy(a))
    jenv = JaxLunarLanderContinuous()
    want = jax.vmap(lambda x: jenv._engine_powers(x, None))(jnp.asarray(a))
    for g, w, name in zip(got, want, ("main", "side", "direction")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_auto_reset_steps_match_jax():
    """20 auto-resetting steps at B=16, each from the JAX state: flight,
    touchdowns, crashes, sleeps and truncation resets."""
    jenv, env = JaxLunarLanderContinuous(), make("LunarLanderContinuous-v2",
                                                 device="cpu")
    assert env.dim_info.is_continue and env.dim_info.action_dim == 2
    step = jax.jit(jax.vmap(lambda s, a, k: jax_step_auto_reset(jenv, s, a, k)))
    js = mixed_states()
    rng = np.random.RandomState(1)
    seen = dict(term=0, trunc=0, contact=0)
    for t in range(20):
        action = actions(rng)
        action[2::4] = 0.0                       # resting landers idle
        key = jax.random.PRNGKey(300 + t)
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
                getattr(out, name).numpy(), np.asarray(getattr(jout, name)))
        assert_state_close(out.state, jout.state)
        seen["term"] += int(out.terminated.sum())
        seen["trunc"] += int(out.truncated.sum())
        seen["contact"] += int(out.next_obs[:, 6:].sum())
        js = jout.state
    assert min(seen.values()) > 0, seen


def test_free_rollout_matches_jax():
    """Both envs roll 30 steps on their own from the same reset."""
    jenv, env = JaxLunarLanderContinuous(), make("LunarLanderContinuous-v2",
                                                 device="cpu")
    jstep = jax.jit(jax.vmap(jenv.step))
    key = jax.random.PRNGKey(5)
    js, jobs = jax.vmap(jenv.reset)(jax.random.split(key, 16))
    ts, obs = env.reset(torch.from_numpy(np.array(jax_vec_reset_draws(key))))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), **TOL)
    rng = np.random.RandomState(2)
    for t in range(30):
        action = actions(rng)
        keys = jax.random.split(jax.random.PRNGKey(400 + t), 16)
        js, jobs, jr, jterm, jtrunc = jstep(js, jnp.asarray(action), keys)
        disp = torch.from_numpy(np.array(jax.vmap(jax_step_draw)(keys)))
        ts, obs, r, term, trunc = env.step(ts, torch.from_numpy(action), disp)
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs),
                                   err_msg=f"step {t}", **TOL)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr),
                                   err_msg=f"step {t}", **REWARD_TOL)
        np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))


def test_own_draws_are_seeded():
    env = make("LunarLanderContinuous-v2", device="cpu")
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(7)
        state, obs = vec_reset(env, g, 16)
        from freerl_tpu_torch.envs import vec_step_auto_reset
        out = vec_step_auto_reset(env, state, torch.full((16, 2), 0.7), g, 16)
        outs.append(torch.cat([obs, out.next_obs, out.reward[:, None]], 1))
    assert torch.equal(outs[0], outs[1])
