"""The port's first slice as a whole: DQN + PER (sum-tree) on LunarLander.

The lockstep test runs 8 envs x 12 vector steps of explore (epsilon 0)
-> auto-resetting step -> add -> PER learner step in both packages, with
every random draw taken from the JAX run (reset forces, engine
dispersions, PER stratification uniforms) and the JAX init params carried
over. After every step it compares observations, rewards, the PER tree,
the sampled indices (equal), the IS weights and the params. Tolerances:
rtol 1e-5 / atol 1e-6 for observations, atol 1e-4 for rewards (a
difference of O(100) shaping potentials), atol 1e-5 for params. A
priority sqrt(|td| + 0.01) turns td's absolute rounding (that of the
reward) into up to 5x as much in the leaf, so the tree is held to rtol 1e-5
/ atol 1e-4 and the IS weights, which are ratios of leaves, to rtol 1e-4.
(With identical priorities the weights agree to rtol 1e-5:
tests/test_torch_sumtree.py.)

The smoke tests run ``train_offpolicy`` itself on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.algos.base import ExploreCtx as JaxExploreCtx
from freerl_tpu.algos.dqn import DQN as JaxDQN
from freerl_tpu.algos.dqn import DQNConfig as JaxDQNConfig
from freerl_tpu.core.types import Transition as JaxTransition
from freerl_tpu.envs import vec_reset as jax_vec_reset
from freerl_tpu.envs import vec_step_auto_reset as jax_vec_step
from freerl_tpu.envs.lunar_lander import LunarLander as JaxLunarLander
from freerl_tpu_torch.algos import DQN, DQNConfig, ExploreCtx
from freerl_tpu_torch.convert import dqn_params_from_flax
from freerl_tpu_torch.core.types import Transition
from freerl_tpu_torch.envs import make, step_auto_reset
from freerl_tpu_torch.train import OffPolicyConfig, train_offpolicy
from freerl_tpu_torch.train.loop import LoopCarry, record_episodes
from tests.test_torch_lunar_lander import (REWARD_TOL, TOL, jax_auto_reset_draws,
                                           jax_reset_draw)

torch.set_num_threads(1)

N_ENVS, N_STEPS, BATCH = 8, 12, 16
CFG = dict(hidden=(32,), buffer_size=256, batch_size=BATCH, per=True,
           per_sampler="tree", epsilon=0.0)


def _jax_example(obs_dim):
    return JaxTransition(
        obs=jnp.zeros((obs_dim,), jnp.float32), action=jnp.zeros((), jnp.int32),
        reward=jnp.zeros((), jnp.float32),
        next_obs=jnp.zeros((obs_dim,), jnp.float32),
        done=jnp.zeros((), jnp.bool_), episode_done=jnp.zeros((), jnp.bool_),
    )


def test_lockstep_with_jax():
    jenv = JaxLunarLander()
    jalgo = JaxDQN(jenv.dim_info, JaxDQNConfig(**CFG))
    k_algo, k_env, key = jax.random.split(jax.random.PRNGKey(0), 3)
    jstate = jalgo.init(k_algo)
    jbuf = jalgo.make_buffer(_jax_example(8), num_envs=N_ENVS)
    jenv_state, jobs = jax_vec_reset(jenv, k_env, N_ENVS)
    ctx = JaxExploreCtx(total_env_steps=jnp.int32(0), episodes=jnp.int32(0),
                        done_prev=jnp.zeros((N_ENVS,), jnp.bool_))

    @jax.jit
    def jax_step(jstate, jbuf, jenv_state, jobs, k_act, k_step, k_learn):
        jstate, action = jalgo.explore(jstate, jobs, k_act, ctx)
        out = jax_vec_step(jenv, jenv_state, action, k_step, N_ENVS)
        jbuf = jbuf.add(JaxTransition(
            obs=jobs, action=action, reward=out.reward, next_obs=out.next_obs,
            done=out.terminated, episode_done=out.episode_done))
        k_s, _ = jax.random.split(k_learn)
        r = jax.random.uniform(k_s, (BATCH,))
        _, idx, w = jbuf.sample_idx(k_s, BATCH)
        jstate, jbuf, _ = jalgo.learn_step(jstate, jbuf, k_learn, N_ENVS)
        return jstate, jbuf, out, action, r, idx, w

    env = make("LunarLander-v2", device="cpu")
    algo = DQN(env.dim_info, DQNConfig(**CFG), device="cpu")
    g = torch.Generator().manual_seed(0)
    state = algo.init(g)
    sd = dqn_params_from_flax(jax.tree.map(np.asarray, jstate.params))
    state.net.load_state_dict(sd)
    state.target_net.load_state_dict(sd)
    ex = Transition(
        obs=torch.zeros(8), action=torch.zeros((), dtype=torch.int32),
        reward=torch.zeros(()), next_obs=torch.zeros(8),
        done=torch.zeros((), dtype=torch.bool),
        episode_done=torch.zeros((), dtype=torch.bool))
    buf = algo.make_buffer(ex, num_envs=N_ENVS)
    f0 = jax.vmap(jax_reset_draw)(jax.random.split(k_env, N_ENVS))
    env_state, obs = env.reset(torch.from_numpy(np.array(f0)))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), **TOL)
    tctx = ExploreCtx(total_env_steps=0, episodes=torch.tensor(0),
                      done_prev=torch.zeros(N_ENVS, dtype=torch.bool))

    for t in range(N_STEPS):
        key, k_act, k_step, k_learn = jax.random.split(key, 4)
        jstate, jbuf, jout, jaction, r, jidx, jw = jax_step(
            jstate, jbuf, jenv_state, jobs, k_act, k_step, k_learn)
        jenv_state, jobs = jout.state, jout.carry_obs

        _, action = algo.explore(state, obs, g, tctx)
        np.testing.assert_array_equal(action.numpy(), np.asarray(jaction),
                                      err_msg=f"step {t}: action")
        disp, f = jax_auto_reset_draws(k_step, N_ENVS)
        out = step_auto_reset(env, env_state, action, disp, f)
        buf.add(Transition(obs=obs, action=action, reward=out.reward,
                           next_obs=out.next_obs, done=out.terminated,
                           episode_done=out.episode_done))
        state, buf, m = algo.learn_per(state, buf,
                                       torch.from_numpy(np.array(r)))
        env_state, obs = out.state, out.carry_obs

        msg = f"step {t}"
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs),
                                   err_msg=msg, **TOL)
        np.testing.assert_allclose(out.reward.numpy(),
                                   np.asarray(jout.reward), err_msg=msg,
                                   **REWARD_TOL)
        np.testing.assert_array_equal(out.episode_done.numpy(),
                                      np.asarray(jout.episode_done))
        np.testing.assert_array_equal(m["idx"].numpy(), np.asarray(jidx),
                                      err_msg=msg)
        np.testing.assert_allclose(m["is_weights"].numpy(), np.asarray(jw),
                                   rtol=1e-4, err_msg=msg)
        np.testing.assert_allclose(buf.tree.numpy(), np.asarray(jbuf.tree),
                                   rtol=1e-5, atol=1e-4, err_msg=msg)
        assert buf.size == int(jbuf.size) and buf.pos == int(jbuf.pos)
        want = dqn_params_from_flax(jax.tree.map(np.asarray, jstate.params))
        for k, v in state.net.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                       err_msg=f"{msg}: {k}")
        want_t = dqn_params_from_flax(
            jax.tree.map(np.asarray, jstate.target_params))
        for k, v in state.target_net.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want_t[k].numpy(),
                                       atol=1e-5, err_msg=f"{msg}: target {k}")
    assert float(buf.beta) == pytest.approx(float(jbuf.beta))


def _expected_updates(cfg: OffPolicyConfig, vector_steps: int) -> int:
    every = max(cfg.learn_interval_steps // cfg.num_envs, 1)
    return cfg.updates_per_burst * sum(
        1 for t in range(1, vector_steps + 1)
        if t * cfg.num_envs > cfg.start_steps and t % every == 0)


@pytest.mark.parametrize("per", [True, False], ids=["per_tree", "uniform"])
def test_train_offpolicy_smoke(per):
    env = make("LunarLander-v2", device="cpu")
    algo = DQN(env.dim_info, DQNConfig(per=per, per_sampler="tree",
                                       buffer_size=4096, batch_size=32,
                                       hidden=(32,)), device="cpu")
    cfg = OffPolicyConfig(num_envs=8, start_steps=100, chunk_size=32,
                          learn_interval_steps=16, updates_per_burst=2,
                          max_env_steps=2048, max_episodes=10**6,
                          log_every_chunks=2)
    chunks = []
    _, returns, info = train_offpolicy(
        env, algo, cfg, on_chunk=lambda i, eps, steps, carry: chunks.append(i))
    assert info["env_steps"] == 2048
    assert info["updates"] == _expected_updates(cfg, 256) > 0
    assert info["episodes"] == len(returns) > 0
    assert np.isfinite(returns).all()
    assert chunks == [2, 4, 6, 8]


def test_train_offpolicy_stops_on_episodes():
    env = make("LunarLander-v2", device="cpu")
    algo = DQN(env.dim_info, DQNConfig(buffer_size=1024, batch_size=16,
                                       hidden=(16,)), device="cpu")
    cfg = OffPolicyConfig(num_envs=16, start_steps=10**9, chunk_size=16,
                          max_episodes=20, host_sync_every=1)
    _, returns, info = train_offpolicy(env, algo, cfg)
    assert info["episodes"] >= 20 and len(returns) == 20
    assert info["updates"] == 0


def test_train_offpolicy_checkpointing_not_ported(tmp_path):
    """Checkpointing came with slice 7: ``checkpoint_dir`` writes the algo
    state every ``checkpoint_every_chunks`` chunks, and it loads into a
    fresh ``init`` bit for bit."""
    from freerl_tpu_torch.train.runio import load_checkpoint

    env = make("LunarLander-v2", device="cpu")
    algo = DQN(env.dim_info, DQNConfig(buffer_size=64, batch_size=8,
                                       hidden=(8,)), device="cpu")
    cfg = OffPolicyConfig(num_envs=4, chunk_size=8, max_env_steps=64,
                          max_episodes=10**6, start_steps=16,
                          checkpoint_dir=str(tmp_path),
                          checkpoint_every_chunks=1)
    state, _, info = train_offpolicy(env, algo, cfg)
    restored = load_checkpoint(tmp_path / "ckpt",
                               algo.init(torch.Generator().manual_seed(9)))
    assert restored.step == state.step == info["updates"] > 0
    for x, y in zip(restored.net.parameters(), state.net.parameters()):
        assert torch.equal(x, y)


def test_record_episodes_is_chronological_and_drops_past_cap():
    """Finished returns land at ep_counter + their rank among this step's
    finishers; slots past the record fall into the drop slot. Vector
    rewards are scalarized with the env's record weights."""

    class TwoObjective:
        record_weights = (0.5, 0.5)

    c = LoopCarry(algo_state=None, buffer=None, env_state=None, obs=None,
                  ep_return=torch.tensor([1.0, 0.0, 2.0, 0.0]),
                  done_prev=torch.zeros(4, dtype=torch.bool),
                  ep_counter=torch.tensor(2),
                  episode_returns=torch.zeros(5))
    reward = torch.tensor([[2.0, 4.0], [1.0, 1.0], [0.0, 2.0], [6.0, 6.0]])
    dones = torch.tensor([True, False, True, True])
    record_episodes(TwoObjective(), c, reward, dones, record_cap=4)
    assert c.episode_returns[:4].tolist() == [0.0, 0.0, 4.0, 3.0]
    assert int(c.ep_counter) == 5
    assert c.ep_return.tolist() == [0.0, 1.0, 0.0, 0.0]
