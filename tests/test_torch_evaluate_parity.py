"""The port's ``evaluate`` against the JAX package's on the CPU: both play
the same held-out episodes for a ``seed0``, with the same params carried
across by ``freerl_tpu_torch/convert.py``.

- ``jax_prng.fold_in`` and ``gumbel``, which the JAX evaluation's step
  keys and the tabular envs' steps (``jax.random.categorical``) reach,
  against ``jax.random``: keys bit-equal, the Gumbel noise within
  ``GUMBEL_ABS`` (XLA's float32 log is not correctly rounded) and the
  outcomes it picks equal;
- Pendulum-v1 with a PPO ``obs_norm`` expert (the GAIL script's expert
  config), ``seed0=1000``, 10 episodes: the start observations within
  ``golden.START_ULPS`` float32 ulps of the JAX package's, the returns
  within ``RET_TOL`` (float32 rounding of 200 Pendulum steps under one
  policy, as in the GAIL tests);
- LunarLander-v2 with a DQN net and LunarLanderContinuous-v2 with a DDPG
  net for ``LL_STEPS`` steps: the per-step draws bit-equal to the JAX
  step's and the returns within ``RET_TOL``;
- FrozenLake-v1: the categorical draws of every step equal the JAX
  step's, and so the returns are equal;
- every env of the registry has its step draws, and an env without them
  raises rather than drawing from a generator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.algos.ddpg import DDPG as JaxDDPG
from freerl_tpu.algos.ddpg import DDPGConfig as JaxDDPGConfig
from freerl_tpu.algos.dqn import DQN as JaxDQN
from freerl_tpu.algos.dqn import DQNConfig as JaxDQNConfig
from freerl_tpu.envs import make as jax_make
from freerl_tpu.envs.lunar_lander import SCALE
from freerl_tpu.train.evaluate import evaluate as jax_eval
from freerl_tpu_torch.algos import DDPG, DQN, DDPGConfig, DQNConfig
from freerl_tpu_torch.convert import dqn_params_from_flax, net_params_from_flax
from freerl_tpu_torch.core import jax_prng
from freerl_tpu_torch.envs import _REGISTRY, make
from freerl_tpu_torch.envs.base import Env
from freerl_tpu_torch.train import evaluate, golden
from freerl_tpu_torch.train.evaluate import jax_draws, rollout_draws
from tests.test_torch_gail_e2e import _expert_pair

torch.set_num_threads(1)

RET_TOL = dict(rtol=1e-3, atol=1e-3)
GUMBEL_ABS = 1e-6
LL_STEPS = 40
N_KEYS = 300


def _keys(n=N_KEYS) -> np.ndarray:
    return np.asarray(jax.vmap(jax.random.PRNGKey)(jnp.arange(n)))


@pytest.mark.parametrize("data", [0, 1, 7, 1000, 1007, 2 ** 31 + 5,
                                  2 ** 32 - 1])
def test_fold_in_bit_equal(data):
    keys = _keys()
    want = np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, data))(keys))
    assert np.array_equal(jax_prng.fold_in(keys, data), want)
    assert np.array_equal(jax_prng.fold_in(keys[5], data), want[5])
    # over an array of data values: one key for each, as a map would
    base = jax.random.PRNGKey(data % 5000)
    ts = np.arange(N_KEYS)
    want = np.asarray(jax.vmap(lambda t: jax.random.fold_in(base, t))(ts))
    assert np.array_equal(jax_prng.fold_in(np.asarray(base), ts), want)


def test_gumbel_and_categorical_as_jax():
    keys = _keys(3000)
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (3,)))(keys))
    noise = jax_prng.gumbel(keys, (3,))
    assert noise.dtype == np.float32 and noise.shape == want.shape
    assert np.abs(noise.astype(np.float64) - want).max() <= GUMBEL_ABS
    for probs in ([1 / 3] * 3, [0.1, 0.6, 0.3]):
        logits = np.log(np.float32(probs) + np.float32(1e-12))
        want = np.asarray(jax.vmap(
            lambda k: jax.random.categorical(k, jnp.asarray(logits)))(keys))
        assert np.array_equal(np.argmax(noise + logits, axis=-1), want)


def _starts(jenv, seed0, n):
    _, obs = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(seed0),
                                                   n))
    return np.asarray(obs)


def test_pendulum_expert_plays_the_jax_episodes():
    """The GAIL script's expert evaluation: the same ten starts, so the
    same returns. (Before the evaluator took the JAX package's draws its
    starts sat at |theta| 1.14, 0.71, ... against JAX's 3.11, 2.79, ...)"""
    jenv, jact, env, act = _expert_pair()
    reset_draw, step_draws = jax_draws(env, 10, env.max_steps, 1000)
    _, obs = env.reset(reset_draw)
    assert golden.start_ulps(obs.numpy(), _starts(jenv, 1000, 10)) \
        <= golden.START_ULPS
    assert step_draws == [None] * env.max_steps
    want = jax_eval(jenv, jact, n_episodes=10, seed0=1000)
    got = evaluate(env, act, n_episodes=10, seed0=1000)
    assert len(set(np.round(want, 3).tolist())) > 1
    np.testing.assert_allclose(got, want, **RET_TOL)


def _lander_pair(name):
    """A JAX and a port policy with the same params on the lander: a DQN
    net on the discrete env, a DDPG actor on the continuous one."""
    jenv, env = jax_make(name), make(name, device="cpu")
    if env.dim_info.is_continue:
        jalgo = JaxDDPG(jenv.dim_info, JaxDDPGConfig(hidden=(32, 32)))
        jstate = jalgo.init(jax.random.PRNGKey(1))
        algo = DDPG(env.dim_info, DDPGConfig(hidden=(32, 32)), device="cpu")
        state = algo.init(torch.Generator().manual_seed(0))
        state.actor.load_state_dict(net_params_from_flax(
            jax.tree.map(np.asarray, jstate.actor_params)))
    else:
        jalgo = JaxDQN(jenv.dim_info, JaxDQNConfig(hidden=(32,)))
        jstate = jalgo.init(jax.random.PRNGKey(1))
        algo = DQN(env.dim_info, DQNConfig(hidden=(32,)), device="cpu")
        state = algo.init(torch.Generator().manual_seed(0))
        state.net.load_state_dict(dqn_params_from_flax(
            jax.tree.map(np.asarray, jstate.params)))
    return (jenv, lambda o: jalgo.evaluate_action(jstate, o),
            env, lambda o: algo.evaluate_action(state, o))


def _jax_dispersion(keys):
    """The dispersion the JAX lander's step draws from each key."""
    def one(key):
        k1, _ = jax.random.split(jax.random.fold_in(key, 7))
        return jax.random.uniform(k1, (2,), jnp.float32, -1.0, 1.0) / SCALE
    return np.asarray(jax.vmap(one)(jnp.asarray(keys)))


@pytest.mark.parametrize("name", ["LunarLander-v2",
                                  "LunarLanderContinuous-v2"])
def test_lander_plays_the_jax_episodes(name):
    jenv, jact, env, act = _lander_pair(name)
    seed0, n = 3, 6
    _, step_draws = jax_draws(env, n, LL_STEPS, seed0)
    for t in (0, 1, LL_STEPS - 1):
        ks = jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey(seed0 + 7), t), n)
        assert np.array_equal(step_draws[t].numpy(), _jax_dispersion(ks))
    want = jax_eval(jenv, jact, n_episodes=n, seed0=seed0,
                    max_steps=LL_STEPS)
    got = evaluate(env, act, n_episodes=n, seed0=seed0, max_steps=LL_STEPS)
    assert len(set(np.round(want, 2).tolist())) > 1
    np.testing.assert_allclose(got, want, **RET_TOL)


def test_frozenlake_draws_the_jax_outcomes():
    """Every (state, action) of the slippery lake: the outcome the port's
    step takes from ``key_step_draw`` is ``jax.random.categorical``'s on
    the same key; then a fixed policy's returns are the JAX package's."""
    jenv, env = jax_make("FrozenLake-v1"), make("FrozenLake-v1",
                                                device="cpu")
    keys = _keys()
    gumbel = env.key_step_draw(keys)
    assert gumbel.shape == (N_KEYS, 3)
    for s in range(env.n_states):
        for a in range(4):
            want = np.asarray(jax.vmap(lambda k: jax.random.categorical(
                k, jnp.log(jenv.prob[s, a] + 1e-12)))(keys))
            got = torch.argmax(gumbel + env.log_prob[s, a], dim=-1)
            assert np.array_equal(got.numpy(), want), (s, a)

    # the slippery lake's optimal policy, a state's action from a table
    table = np.array([0, 3, 3, 3, 0, 0, 0, 0, 3, 1, 0, 0, 0, 2, 1, 0])

    def policy(xp):
        if xp is jnp:
            return lambda obs: jnp.asarray(table)[obs[:, 0].astype(
                jnp.int32)]
        return lambda obs: torch.from_numpy(table)[obs[:, 0].long()]

    want = jax_eval(jenv, policy(jnp), n_episodes=64, seed0=11)
    got = evaluate(env, policy(torch), n_episodes=64, seed0=11)
    assert want.sum() > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(_REGISTRY))
def test_every_env_has_its_step_draws(name):
    """Every env the port makes gives the JAX step's draws: the lander's
    dispersion and the tabular Gumbel noise, one row a key; None where the
    JAX step reads no key (its draw_step is None too)."""
    env = make(name, device="cpu")
    draw = env.key_step_draw(_keys(4))
    if draw is None:
        assert env.draw_step(4, torch.Generator().manual_seed(0)) is None
    else:
        assert draw.shape == env.draw_step(
            4, torch.Generator().manual_seed(0)).shape


def test_an_env_without_key_draws_raises():
    class Bare(Env):
        max_steps = 5

    with pytest.raises(NotImplementedError):
        evaluate(Bare(device="cpu"), lambda o: o, n_episodes=2)


def test_generator_draws_still_play_when_given():
    """``draws=`` from a generator plays those episodes, not JAX's."""
    jenv, jact, env, act = _expert_pair()
    draws = rollout_draws(env, 10, env.max_steps,
                          torch.Generator().manual_seed(1000))
    mine = evaluate(env, act, n_episodes=10, draws=draws)
    np.testing.assert_array_equal(mine, evaluate(env, act, n_episodes=10,
                                                 draws=draws))
    assert not np.allclose(mine, evaluate(env, act, n_episodes=10,
                                          seed0=1000), **RET_TOL)
