"""The port's MPE scenarios and masked env against the JAX package's.

Resets are fed the draws the JAX reset makes (its agent and landmark
positions, and the adversary's goal). Steps are compared teacher-forced:
a JAX trajectory runs under random actions, and from each of its states
the port's one step must give JAX's next state, observation, reward and
flags. Tolerance 1e-5 absolute (the contact force sums E terms, which two
frameworks may add in another order); flags exact. Also: the world comm
channel and forest concealment on a crafted state, the masked wrapper,
the adversary's padding, and ``step_auto_reset`` on ``(B, A, O)``
observations (ROADMAP queue C, fault C3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.envs import masked as jax_masked
from freerl_tpu.envs import mpe as jax_mpe
from freerl_tpu.envs.base import step_auto_reset as jax_step_auto_reset
from freerl_tpu_torch.envs import make, step_auto_reset
from freerl_tpu_torch.envs import masked, mpe

torch.set_num_threads(1)

ATOL = 1e-5
N_ENVS, N_STEPS = 8, 30

# (name, JAX class, port class, kwargs): the four scenarios in both
# action modes (world comm is continuous only)
CASES = {
    "spread": ("SimpleSpread", dict()),
    "spread_disc": ("SimpleSpread", dict(continuous_actions=False)),
    "adversary": ("SimpleAdversary", dict()),
    "adversary_disc": ("SimpleAdversary", dict(continuous_actions=False)),
    "tag": ("SimpleTag", dict()),
    "tag_disc": ("SimpleTag", dict(continuous_actions=False)),
    "world_comm": ("SimpleWorldComm", dict()),
}


def pair(case):
    cls, kw = CASES[case]
    return getattr(jax_mpe, cls)(**kw), getattr(mpe, cls)(device="cpu", **kw)


def to_torch(js, env):
    fields = {f.name: torch.from_numpy(np.array(getattr(js, f.name)))
              for f in dataclasses.fields(env.state_cls)}
    fields["goal"] = fields["goal"].to(torch.int64)
    return env.state_cls(**fields)


def reset_draw(js):
    """The port's reset draw from a batch of JAX reset states."""
    pos = np.asarray(js.pos)
    goal = np.asarray(js.goal, np.float32)[:, None]
    return torch.from_numpy(np.concatenate([pos.reshape(len(pos), -1), goal],
                                           axis=1))


def random_actions(jenv, rng, n):
    a = jenv.n_agents
    if jenv.continuous_actions:
        # past both ends of the box, so the clip acts too
        return rng.uniform(-0.2, 1.2, (n, a, jenv.dim_info.action_dim)
                           ).astype(np.float32)
    return rng.randint(0, 5, (n, a)).astype(np.int32)


def assert_step(got, want, what):
    state, obs, reward, term, trunc = got
    jstate, jobs, jreward, jterm, jtrunc = want
    for f in dataclasses.fields(state):
        np.testing.assert_allclose(getattr(state, f.name).numpy(),
                                   np.asarray(getattr(jstate, f.name)),
                                   atol=ATOL, err_msg=f"{what} {f.name}")
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=ATOL,
                               err_msg=f"{what} obs")
    np.testing.assert_allclose(reward.numpy(), np.asarray(jreward), atol=ATOL,
                               err_msg=f"{what} reward")
    assert term.tolist() == np.asarray(jterm).tolist(), what
    assert trunc.tolist() == np.asarray(jtrunc).tolist(), what


@pytest.mark.parametrize("case", list(CASES))
def test_reset_and_teacher_forced_steps_match_jax(case):
    """Reset from JAX's draws, then 30 teacher-forced steps (past the
    25-step truncation) under random actions."""
    jenv, env = pair(case)
    keys = jax.random.split(jax.random.PRNGKey(0), N_ENVS)
    js, jobs = jax.vmap(jenv.reset)(keys)
    state, obs = env.reset(reset_draw(js))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=ATOL)
    for f in dataclasses.fields(state):
        np.testing.assert_allclose(getattr(state, f.name).numpy(),
                                   np.asarray(getattr(js, f.name)))
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.RandomState(1)
    for t in range(N_STEPS):
        a = random_actions(jenv, rng, N_ENVS)
        want = jstep(js, jnp.asarray(a), keys)
        got = env.step(to_torch(js, env), torch.from_numpy(a), None)
        assert_step(got, want, f"{case} step {t}")
        js = want[0]
    assert bool(np.asarray(js.t).min() == N_STEPS)


def test_draw_reset_ranges_and_goal():
    env = make("simple_adversary_v3", device="cpu")
    d = env.draw_reset(4096, torch.Generator().manual_seed(0))
    pos = d[:, :-1].reshape(4096, env.n_entities, 2)
    assert d.shape == (4096, 2 * 5 + 1)
    assert pos[:, :3].abs().max() <= 1.0 and pos[:, 3:].abs().max() <= 0.9
    assert set(d[:, -1].tolist()) == {0.0, 1.0}
    state, _ = env.reset(d)
    assert state.goal.dtype == torch.int64 and int(state.t.sum()) == 0
    spread = make("simple_spread_v3", device="cpu")
    d = spread.draw_reset(64, torch.Generator().manual_seed(0))
    assert (d[:, -1] == 0).all()


def test_world_comm_channel_and_forest_concealment():
    """A crafted state: agents 1 and 4 share forest 0, agent 2 is alone in
    forest 1, the rest are outside. The observations equal JAX's, agent 1
    sees agent 4 but not agent 2, the leader sees all, and the leader's
    comm action (clipped) reaches every adversary's observation tail."""
    jenv, env = pair("world_comm")
    pos = np.zeros((11, 2), np.float32)
    pos[:6] = [[0.5, 0.5], [-0.6, 0.0], [0.6, -0.6], [0.0, 0.9],
               [-0.62, 0.05], [0.2, 0.2]]
    pos[6:] = [[0.9, 0.9], [0.1, -0.1], [-0.1, 0.1], [-0.6, 0.02],
               [0.6, -0.62]]
    js = jax_mpe.WorldCommState(pos=jnp.asarray(pos), vel=jnp.ones((11, 2)),
                                goal=jnp.int32(0), t=jnp.int32(0),
                                comm=jnp.zeros(4))
    jbatch = jax.tree.map(lambda x: x[None], js)
    state = to_torch(jbatch, env)
    np.testing.assert_allclose(env.observation(state).numpy(),
                               np.asarray(jenv._observations(js))[None],
                               atol=ATOL)
    inf = env._in_forest(state)[0]
    assert inf[1, 0] and inf[4, 0] and inf[2, 1] and not inf[0].any()
    obs = env.observation(state)[0]
    # agent 1's other_rel (after vel, pos, 5 entities): others 0, 2, 3, 4, 5
    other = obs[1, 14:24].reshape(5, 2)
    assert other[1].abs().sum() == 0 and other[3].abs().sum() > 0
    assert (env.observation(state)[0, 0, 14:24] != 0).all()
    a = np.full((1, 6, 9), 0.5, np.float32)
    a[0, 0, 5:] = [1.5, 0.25, -0.5, 0.75]
    _, jobs, _, _, _ = jax.jit(jenv.step)(js, jnp.asarray(a[0]), None)
    _, obs, _, _, _ = env.step(state, torch.from_numpy(a), None)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs)[None], atol=ATOL)
    for i in range(4):
        assert obs[0, i, 30:34].tolist() == [1.0, 0.25, 0.0, 0.75]


def test_masked_spread_matches_jax():
    """The mask on the obs tail, with agents placed past the arena bound,
    then teacher-forced discrete steps of the wrapper."""
    jenv, env = jax_masked.MaskedSpread(), masked.MaskedSpread(device="cpu")
    assert env.agent_obs_dims == jenv.agent_obs_dims == (23, 23, 23)
    assert (dataclasses.astuple(env.dim_info)
            == dataclasses.astuple(jenv.dim_info)) and env.name == jenv.name
    keys = jax.random.split(jax.random.PRNGKey(3), N_ENVS)
    js, _ = jax.vmap(jenv.reset)(keys)
    js = js.replace(pos=js.pos.at[:, 0].set(jnp.array([1.3, -1.25])))
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.RandomState(2)
    for t in range(N_STEPS):
        a = rng.randint(0, 5, (N_ENVS, 3)).astype(np.int32)
        want = jstep(js, jnp.asarray(a), keys)
        got = env.step(to_torch(js, env.env), torch.from_numpy(a), None)
        assert_step(got, want, f"masked step {t}")
        if t == 0:
            assert got[1][:, 0, -5:].tolist()[0] == [1.0, 0.0, 1.0, 1.0, 0.0]
        js = want[0]


def test_adversary_padding_and_make():
    env = make("simple_adversary_v3", device="cpu")
    assert env.agent_obs_dims == (8, 10, 10)
    _, obs = env.reset(env.draw_reset(16, torch.Generator().manual_seed(0)))
    assert obs.shape == (16, 3, 10) and (obs[:, 0, 8:] == 0).all()
    assert (obs[:, 1:, :2] != 0).all()
    for name in ("simple_spread_v3", "simple_adversary_v3", "simple_tag_v3",
                 "simple_world_comm_v3"):
        assert make(name, device="cpu").name == name
    assert make("simple_world_comm_v3", device="cpu").agent_act_dims == (
        9, 5, 5, 5, 5, 5)
    with pytest.raises(ValueError, match="continuous"):
        make("simple_world_comm_v3", device="cpu", continuous_actions=False)


@pytest.mark.parametrize("n_envs", [3, 16])
def test_step_auto_reset_resets_multi_agent_rows(n_envs):
    """(B, A, O) observations: each env's own done flag picks its carried
    observation. With 3 envs of 3 agents, broadcasting the (B,) flag over
    the agent axis would run and be silently wrong; with 16 it would
    raise."""
    jenv, env = pair("spread")
    keys = jax.random.split(jax.random.PRNGKey(5), n_envs)
    js, _ = jax.vmap(jenv.reset)(keys)
    # env 0 truncates on this step, the others run on
    js = js.replace(t=jnp.where(jnp.arange(n_envs) == 0, 24, 3))
    a = np.random.RandomState(0).uniform(0, 1, (n_envs, 3, 5)
                                         ).astype(np.float32)
    out = jax.jit(jax.vmap(lambda s, x, k: jax_step_auto_reset(jenv, s, x, k))
                  )(js, jnp.asarray(a), keys)
    reset_keys = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
    jreset, _ = jax.vmap(jenv.reset)(reset_keys)
    got = step_auto_reset(env, to_torch(js, env), torch.from_numpy(a), None,
                          reset_draw(jreset))
    assert got.episode_done.tolist() == [True] + [False] * (n_envs - 1)
    np.testing.assert_allclose(got.carry_obs.numpy(),
                               np.asarray(out.carry_obs), atol=ATOL)
    np.testing.assert_allclose(got.next_obs.numpy(), np.asarray(out.next_obs),
                               atol=ATOL)
    np.testing.assert_allclose(got.state.pos.numpy(),
                               np.asarray(out.state.pos), atol=ATOL)
    assert not np.allclose(got.carry_obs[1:].numpy(), got.carry_obs[0].numpy())
