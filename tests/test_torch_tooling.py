"""The port's tooling against the JAX package's: ``evaluate`` and
``rollout_trace`` (params carried over with ``convert.py``, the JAX run's
reset draws fed in), the plotting helpers, the plots and the GIF, and the
profiling helpers.

Tolerances: the evaluation returns within 1e-5 (the envs' float32
rounding, as in the env tests); the episode lengths, the trace's return and
length and the smoothing helpers exact. The rollout trace's states are held
within 1e-5 over the first ``TRACE_STEPS`` steps: a free-running CartPole
under a policy that keeps the pole up amplifies the two frameworks' float32
rounding about tenfold every 20 steps (1e-7 at step 50, 1e-5 near step
100), so later states of a long episode differ by more while its return
and length stay equal.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.algos.dqn import DQN as JaxDQN
from freerl_tpu.algos.dqn import DQNConfig as JaxDQNConfig
from freerl_tpu.algos.maddpg import MADDPG as JaxMADDPG
from freerl_tpu.algos.maddpg import MADDPGConfig as JaxMADDPGConfig
from freerl_tpu.envs import make as jax_make
from freerl_tpu.train.evaluate import evaluate as jax_eval
from freerl_tpu.train import plotting as jax_plotting
from freerl_tpu.train import render as jax_render
from freerl_tpu_torch.algos import DQN, MADDPG, DQNConfig, MADDPGConfig
from freerl_tpu_torch.convert import dqn_params_from_flax
from freerl_tpu_torch.envs import make
from freerl_tpu_torch.train import (aggregate_seeds, evaluate, exp_smooth,
                                    plot_compare, plot_evaluate,
                                    plot_learning_curve)
from freerl_tpu_torch.train.render import render_episode_gif, rollout_trace
from freerl_tpu_torch.utils import StepTimer, trace
from tests.test_torch_maddpg import port_state_of
from tests.test_torch_mpe import reset_draw as mpe_reset_draw
from tests.test_torch_rmappo import make_pair as rmappo_pair
from tests.test_torch_rmappo import port_state as rmappo_port_state

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
N_EP = 12
TRACE_STEPS = 60


def cartpole_dqn():
    """The JAX DQN and the port's with the same params, on CartPole."""
    jenv, env = jax_make("CartPole-v1"), make("CartPole-v1", device="cpu")
    jalgo = JaxDQN(jenv.dim_info, JaxDQNConfig(hidden=(32,)))
    jstate = jalgo.init(jax.random.PRNGKey(3))
    algo = DQN(env.dim_info, DQNConfig(hidden=(32,)), device="cpu")
    state = algo.init(torch.Generator().manual_seed(0))
    state.net.load_state_dict(dqn_params_from_flax(
        jax.tree.map(np.asarray, jstate.params)))
    return (jenv, lambda o: jalgo.evaluate_action(jstate, o),
            env, lambda o: algo.evaluate_action(state, o))


def cartpole_reset(key):
    """The draw the JAX CartPole's reset makes from ``key``."""
    return jax.random.uniform(key, (4,), jnp.float32, -0.05, 0.05)


def test_evaluate_equals_jax_cartpole():
    jenv, jact, env, act = cartpole_dqn()
    want = jax_eval(jenv, jact, n_episodes=N_EP, seed0=4)
    keys = jax.random.split(jax.random.PRNGKey(4), N_EP)
    draws = (torch.from_numpy(np.array(jax.vmap(cartpole_reset)(keys))),
             [None] * env.max_steps)
    got = evaluate(env, act, n_episodes=N_EP, draws=draws)
    assert got.shape == (N_EP,) and len(set(got.tolist())) > 1
    np.testing.assert_array_equal(got, want)       # CartPole: the lengths
    # seed0 alone plays the JAX package's episodes
    np.testing.assert_array_equal(evaluate(env, act, N_EP, seed0=4), want)
    # a generator's draws, on the env's device, given as draws
    again = evaluate(env, act, n_episodes=N_EP, draws=rollout_draws_of(
        env, 4, N_EP))
    np.testing.assert_array_equal(again, evaluate(
        env, act, n_episodes=N_EP, draws=rollout_draws_of(env, 4, N_EP)))
    assert ((again >= 1) & (again <= 500)).all()


def test_evaluate_equals_jax_multi_agent():
    jenv, env = jax_make("simple_spread_v3"), make("simple_spread_v3",
                                                   device="cpu")
    kw = dict(batch_size=8, buffer_size=64, hidden=(32, 32))
    jalgo = JaxMADDPG(jenv, JaxMADDPGConfig(**kw))
    jstate = jalgo.init(jax.random.PRNGKey(0))
    algo = MADDPG(env, MADDPGConfig(**kw), device="cpu")
    state = port_state_of(algo, jstate)
    want = jax_eval(jenv, lambda o: jalgo.evaluate_action(jstate, o),
                    n_episodes=N_EP, seed0=2, multi_agent=True)
    js, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(2),
                                                  N_EP))
    got = evaluate(env, lambda o: algo.evaluate_action(state, o),
                   n_episodes=N_EP, multi_agent=True,
                   draws=(mpe_reset_draw(js), [None] * env.max_steps))
    assert got.shape == want.shape == (N_EP, 3)
    np.testing.assert_allclose(got, want, **TOL)
    # without multi_agent the agents' rewards sum into one team return
    team = evaluate(env, lambda o: algo.evaluate_action(state, o),
                    n_episodes=N_EP,
                    draws=(mpe_reset_draw(js), [None] * env.max_steps))
    np.testing.assert_allclose(team, want.sum(-1), **TOL)


def test_evaluate_equals_jax_recurrent():
    jenv, env, jalgo, algo = rmappo_pair("rippo_cont")
    jstate = jalgo.init(jax.random.PRNGKey(0))
    state = rmappo_port_state(algo, jstate)

    def jact(obs, pc):
        return jalgo.evaluate_action(jstate, obs, pc,
                                     jnp.zeros((N_EP,), jnp.bool_))

    def act(obs, pc):
        return algo.evaluate_action(state, obs, pc,
                                    torch.zeros(N_EP, dtype=torch.bool))

    want = jax_eval(jenv, jact, n_episodes=N_EP, seed0=6, multi_agent=True,
                    carry_init=jalgo.init_policy_carry(N_EP))
    js, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(6),
                                                  N_EP))
    got = evaluate(env, act, n_episodes=N_EP, multi_agent=True,
                   carry_init=algo.init_policy_carry(N_EP),
                   draws=(mpe_reset_draw(js), [None] * env.max_steps))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("seed", [0, 7])
def test_rollout_trace_equals_jax(seed):
    jenv, jact, env, act = cartpole_dqn()
    jstates, jret, jlen = jax_render.rollout_trace(
        jenv, lambda o: jact(o[None])[0], seed=seed)
    draw = np.array(cartpole_reset(jax.random.PRNGKey(seed)))[None]
    states, ret, length = rollout_trace(
        env, act, draws=(torch.from_numpy(draw), [None] * env.max_steps))
    assert length == jlen and TRACE_STEPS < length < env.max_steps
    np.testing.assert_array_equal(ret, jret)
    np.testing.assert_array_equal(states.t, np.asarray(jstates.t))
    for name in ("x", "x_dot", "theta", "theta_dot"):
        got, want = getattr(states, name), np.asarray(getattr(jstates, name))
        assert got.shape == want.shape == (env.max_steps,)
        np.testing.assert_allclose(got[:TRACE_STEPS], want[:TRACE_STEPS],
                                   **TOL, err_msg=name)


def test_rollout_trace_multi_agent_return():
    env = make("simple_spread_v3", device="cpu")
    algo = MADDPG(env, MADDPGConfig(batch_size=8, buffer_size=64,
                                    hidden=(16,)), device="cpu")
    state = algo.init(torch.Generator().manual_seed(0))
    states, ret, length = rollout_trace(
        env, lambda o: algo.evaluate_action(state, o), seed=3)
    assert ret.shape == (3,) and length == env.max_steps == 25
    assert states.pos.shape == (25, 6, 2)
    # the per-agent return of a batch of one is evaluate's first row
    want = evaluate(env, lambda o: algo.evaluate_action(state, o), 1,
                    multi_agent=True, draws=rollout_draws_of(env, 3))
    np.testing.assert_array_equal(ret, want[0])


def rollout_draws_of(env, seed, n=1):
    from freerl_tpu_torch.train.evaluate import rollout_draws

    return rollout_draws(env, n, env.max_steps,
                         torch.Generator().manual_seed(seed))


def test_smoothing_equals_jax():
    rng = np.random.RandomState(0)
    curves = [rng.randn(n).cumsum().astype(np.float32) for n in (90, 80, 85)]
    for alpha in (0.9, 0.5):
        np.testing.assert_array_equal(
            exp_smooth(curves[0], alpha),
            jax_plotting.exp_smooth(curves[0], alpha))
        for got, want in zip(aggregate_seeds(curves, alpha),
                             jax_plotting.aggregate_seeds(curves, alpha)):
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    assert aggregate_seeds(curves)[0].shape == (3, 80)


def test_plots_written(tmp_path):
    curves = [np.random.RandomState(s).randn(60).cumsum() for s in range(3)]
    p1 = plot_learning_curve(curves, "DQN", str(tmp_path), "CartPole-v1",
                             goal=475)
    p2 = plot_compare({"DQN": curves, "Rainbow": curves[:2]}, str(tmp_path),
                      "CartPole-v1")
    p3 = plot_evaluate(curves[0], goal=475.0,
                       out_path=str(tmp_path / "eval" / "evaluate.png"))
    for p in (p1, p2, p3):
        assert os.path.getsize(p) > 1000
    assert os.path.basename(p2) == "compare_2.png"
    np.testing.assert_array_equal(
        np.load(tmp_path / "DQN_3_seed.npy"), aggregate_seeds(curves)[0])


@pytest.mark.parametrize("env_name", ["CartPole-v1", "simple_spread_v3",
                                      "Taxi-v3"])
def test_episode_gif_written(env_name, tmp_path):
    """A view per family (cart-pole, MPE) and the phase-space fallback
    (Taxi draws its observation trace)."""
    import imageio

    env = make(env_name, device="cpu")
    n = env.dim_info.action_dim
    if env_name.startswith("simple"):
        def act(obs):
            return torch.zeros(obs.shape[:2] + (n,))
    else:
        def act(obs):
            return torch.zeros(obs.shape[0], dtype=torch.int64)
    path = render_episode_gif(env, act, str(tmp_path / "ep.gif"), seed=1,
                              max_steps=30)
    _, _, length = rollout_trace(env, act, seed=1, max_steps=30)
    frames = imageio.mimread(path)
    assert len(frames) == length and frames[0].shape[:2] == (256, 256)


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with trace(str(tmp_path / "prof"), device="cpu") as prof:
        for _ in range(3):
            x = torch.tanh(x @ x)
    path = tmp_path / "prof" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_step_timer():
    timer = StepTimer(warmup=2, items_per_step=10)
    assert timer.items_per_second == 0.0
    for _ in range(5):
        timer.step()
    assert timer.measured_steps == 3 and timer.items_per_second > 0
