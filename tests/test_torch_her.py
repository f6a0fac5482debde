"""The port's goal env (``envs/goal.py``) and HER training loop
(``train/her.py``) against the JAX package.

GoalPendulum: resets from the JAX reset's draws (the Pendulum's, then the
goal's two uniforms) and 200 auto-resetting steps, in both reward modes;
tolerance rtol 1e-5 / atol 1e-6 (the Pendulum's sin/cos rounding), the
sparse reward exact. ``relabel_future`` from the JAX uniforms, for one
trajectory and for a batch as ``train_her`` relabels it: equal, as it is
gathers and one comparison. A short ``train_her`` run, and the ring's
scatter path when one add outgrows the ring (last writer wins, as XLA's
scatter does on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.buffers.uniform import ReplayBuffer as JaxReplayBuffer
from freerl_tpu.envs import vec_step_auto_reset as jax_vec_step
from freerl_tpu.envs.goal import GoalPendulum as JaxGoalPendulum
from freerl_tpu.train.her import relabel_future as jax_relabel_future
from freerl_tpu_torch.algos import DDPG, DDPGConfig
from freerl_tpu_torch.buffers import ReplayBuffer
from freerl_tpu_torch.envs import make, step_auto_reset
from freerl_tpu_torch.train import HERConfig, relabel_future, train_her
from tests.test_torch_dqn import _jax_t, _np_batch, _torch_t

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
N = 16


def t(x):
    return torch.from_numpy(np.array(x))


def jax_reset_draw(key):
    """The draw ``GoalPendulum.reset(key)`` makes, in the port's form:
    (theta, theta_dot, goal cos uniform, goal speed uniform)."""
    k_in, k_goal = jax.random.split(key)
    k1, k2 = jax.random.split(k_in)
    g1, g2 = jax.random.split(k_goal)
    return jnp.stack([
        jax.random.uniform(k1, (), jnp.float32, -jnp.pi, jnp.pi),
        jax.random.uniform(k2, (), jnp.float32, -1.0, 1.0),
        jax.random.uniform(g1, (), jnp.float32, 0.0, 1.0),
        jax.random.uniform(g2, (), jnp.float32, 0.0, 1.0)])


def to_jax_state(jenv, s):
    from freerl_tpu.envs.classic import PendulumState
    from freerl_tpu.envs.goal import GoalPendulumState
    return GoalPendulumState(
        inner=PendulumState(theta=jnp.asarray(s.theta.numpy()),
                            theta_dot=jnp.asarray(s.theta_dot.numpy()),
                            t=jnp.asarray(s.t.numpy())),
        goal=jnp.asarray(s.goal.numpy()))


@pytest.mark.parametrize("mode", ["her", "shaping"])
def test_goal_pendulum_matches_jax(mode):
    jenv = JaxGoalPendulum(reward_mode=mode)
    env = make("GoalPendulum-v1", device="cpu", reward_mode=mode)
    assert env.dim_info.obs_dim == 6 and env.dim_info.max_action == 2.0
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, N)
    js, jobs = jax.vmap(jenv.reset)(keys)
    state, obs = env.reset(t(jax.vmap(jax_reset_draw)(keys)))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), **TOL)
    np.testing.assert_allclose(state.goal.numpy(), np.asarray(js.goal), **TOL)
    step = jax.jit(lambda s, a, k: jax_vec_step(jenv, s, a, k, N))
    rng = np.random.RandomState(1)
    hits = 0
    for i in range(200):
        action = rng.uniform(-2.5, 2.5, (N, 1)).astype(np.float32)
        key = jax.random.PRNGKey(10 + i)
        jout = step(to_jax_state(jenv, state), jnp.asarray(action), key)
        resets = jax.vmap(lambda k: jax_reset_draw(jax.random.split(k)[1]))(
            jax.random.split(key, N))
        out = step_auto_reset(env, state, torch.from_numpy(action), None,
                              t(resets))
        for name in ("next_obs", "carry_obs"):
            np.testing.assert_allclose(getattr(out, name).numpy(),
                                       np.asarray(getattr(jout, name)),
                                       err_msg=f"step {i} {name}", **TOL)
        if mode == "her":
            np.testing.assert_array_equal(out.reward.numpy(),
                                          np.asarray(jout.reward))
            hits += int((out.reward == 0).sum())
        else:
            np.testing.assert_allclose(out.reward.numpy(),
                                       np.asarray(jout.reward), **TOL)
        np.testing.assert_array_equal(out.truncated.numpy(),
                                      np.asarray(jout.truncated))
        state = out.state
    assert mode == "shaping" or hits > 0


def test_goal_reward_uses_the_current_observation():
    """The reward of (o, a, o') is the goal distance of o, and the HER
    hooks read and replace the goal slice."""
    env = make("GoalPendulum-v1", device="cpu")
    g = torch.Generator().manual_seed(0)
    state, obs = env.reset(env.draw_reset(4, g))
    at_goal = env.with_goal(obs, env.achieved(obs))
    assert torch.equal(env.achieved(at_goal), obs[:, :3])
    state.goal = obs[:, :3].clone()                  # every goal reached now
    _, nxt, r, _, _ = env.step(state, torch.full((4, 1), 2.0), None)
    assert torch.equal(r, torch.zeros(4))
    assert torch.equal(nxt[:, 3:], state.goal)


@pytest.mark.parametrize("shape", [(20, 4, 5), (20, 4, 30)],
                         ids=["window_5", "window_past_end"])
def test_relabel_future_matches_jax(shape):
    """One trajectory, then a batch of trajectories as ``train_her``
    relabels them (the JAX ``train_her`` vmaps over envs)."""
    T, k, sample_range = shape
    env, jenv = make("GoalPendulum-v1", device="cpu"), JaxGoalPendulum()
    rng = np.random.RandomState(2)
    obs = rng.randn(3, T, 6).astype(np.float32)
    action = rng.randn(3, T, 1).astype(np.float32)
    next_obs = rng.randn(3, T, 6).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    u = jax.vmap(lambda kk: jax.random.uniform(kk, (T, k)))(keys)
    want = jax.vmap(
        lambda o, a, n, kk: jax_relabel_future(jenv, o, a, n, kk, k,
                                               sample_range))(
        jnp.asarray(obs), jnp.asarray(action), jnp.asarray(next_obs), keys)
    one = relabel_future(env, t(obs[0]), t(action[0]), t(next_obs[0]), t(u[0]),
                         sample_range)
    many = relabel_future(env, t(obs), t(action), t(next_obs), t(u),
                          sample_range)
    for name in ("obs", "action", "reward", "next_obs", "done",
                 "episode_done"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_array_equal(getattr(one, name).numpy(), w[0])
        np.testing.assert_array_equal(getattr(many, name).numpy(),
                                      w.reshape((-1,) + w.shape[2:]))
    assert many.obs.shape == (3 * T * k, 6)


def test_add_past_capacity_keeps_the_last_rows():
    """A scatter add of more rows than the ring holds: the port writes the
    last ``capacity`` rows, what XLA's last-writer-wins scatter keeps."""
    ex = {key: v[0] for key, v in _np_batch(1, 0).items()}
    jbuf = JaxReplayBuffer.create(24, _jax_t(ex))
    tbuf = ReplayBuffer.create(24, _torch_t(ex))
    for i, n in enumerate((10, 60, 7)):
        b = _np_batch(n, seed=20 + i)
        jbuf = jbuf.add(_jax_t(b))
        tbuf.add(_torch_t(b))
        assert (tbuf.pos, tbuf.size) == (int(jbuf.pos), int(jbuf.size))
        for name in ("obs", "action", "reward", "done"):
            np.testing.assert_array_equal(getattr(tbuf.data, name).numpy(),
                                          np.asarray(getattr(jbuf.data, name)))


def test_train_her_runs():
    env = make("GoalPendulum-v1", device="cpu")

    class Probe(DDPG):
        def learn_step(self, state, buffer, generator, num_envs):
            state, buffer, m = super().learn_step(state, buffer, generator,
                                                  num_envs)
            self.losses.append(m["critic_loss"])
            self.buffer = buffer
            return state, buffer, m

    algo = Probe(env.dim_info, DDPGConfig(buffer_size=20_000, batch_size=32,
                                          hidden=(16, 16)), device="cpu")
    algo.losses = []
    cfg = HERConfig(num_envs=4, max_episodes=10, updates_per_episode=8,
                    start_steps=1000)
    state, returns, info = train_her(env, algo, cfg)
    # 3 episodes of 4 envs; learning starts once 1000 env steps are in
    assert info == dict(info, env_steps=2400, episodes=10)
    assert len(returns) == 10 and np.isfinite(returns).all()
    assert returns.min() >= -200 and returns.max() <= 0
    assert len(algo.losses) == state.step == 16
    assert bool(torch.isfinite(torch.stack(algo.losses)).all())
    # each episode adds 800 real and 3200 relabeled rows
    assert algo.buffer.size == 12_000 and algo.buffer.align == 0
