"""The port's MAT against the JAX package, from the same params, rollout
and draws.

The decode's draws are agent i's ``fold_in(key, i)`` Gumbel noise or
normals, (A, B, D); the update's permutations one split per epoch. Sizes:
T 8, N 4, K_epochs 2, n_embd 16, 3 agents. Tolerances: actions and
log-probs within 1e-5 (the teacher-forced log-probs of sampled actions
too); after an update every param within 1e-5 bar one element in 10,000,
none past the lr; ``adv_mean`` within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.algos import mat as jax_mat
from freerl_tpu_torch.algos import MAT, MATConfig
from freerl_tpu_torch.convert import mat_state_from_flax
from tests.test_torch_mappo import (ATOL, N, T, assert_close_lists, env_pair,
                                    flax_numpy, jax_action_draws, np_rollout,
                                    rollouts, t)

torch.set_num_threads(1)


def mat_pair(discrete, **kw):
    jenv, env = env_pair("simple_spread_v3")
    if discrete:
        from freerl_tpu.envs import make as jax_make
        from freerl_tpu_torch.envs import make

        jenv = jax_make("simple_spread_v3", continuous_actions=False)
        env = make("simple_spread_v3", continuous_actions=False,
                   device="cpu")
    kw = dict(dict(K_epochs=2, n_embd=16), **kw)
    jalgo = jax_mat.MAT(jenv, jax_mat.MATConfig(**kw))
    algo = MAT(env, MATConfig(**kw), device="cpu")
    jstate = jalgo.init(jax.random.PRNGKey(0))
    state = algo.init(torch.Generator().manual_seed(1))
    mat_state_from_flax(state, flax_numpy(jstate))
    return jenv, env, jalgo, algo, jstate, state


def mat_params(state):
    return [p for net in (state.encoder, state.decoder)
            for _, p in sorted(net.state_dict().items())]


def check_mat_sample(jalgo, algo, jstate, state, env, seed):
    rng = np.random.RandomState(seed)
    obs = rng.randn(6, 3, env.dim_info.obs_dim).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = jalgo.sample_action(jstate, jnp.asarray(obs), key)
    draws = jax_action_draws(key, (env.dim_info.action_dim,) * 3,
                             env.dim_info.is_continue, 6, lead=1)
    got = algo.sample_action(state, t(obs), draws)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(
        algo.evaluate_action(state, t(obs)).numpy(),
        np.asarray(jalgo.evaluate_action(jstate, jnp.asarray(obs))),
        rtol=1e-5, atol=1e-5)
    return got


@pytest.mark.parametrize("discrete", [True, False], ids=["disc", "cont"])
def test_mat_matches_jax(discrete):
    """The autoregressive decode, the teacher-forced update (per-dim
    ratios for continuous actions, the agent-averaged values, the clip at
    10) and a decode with the updated params; the teacher-forced log-probs
    of sampled actions equal the decode's."""
    kw = dict(value_clip=True, huber_loss=True, adv_norm=True,
              lr_decay=True) if discrete else {}
    jenv, env, jalgo, algo, jstate, state = mat_pair(discrete, **kw)
    _, actions, logp = check_mat_sample(jalgo, algo, jstate, state, env, 31)
    rng = np.random.RandomState(31)
    obs = t(rng.randn(6, 3, env.dim_info.obs_dim).astype(np.float32))
    with torch.no_grad():
        logp_tf = algo._parallel_logp_ent_v(state, obs, actions)[0]
    np.testing.assert_allclose(logp_tf.reshape(logp.shape).numpy(),
                               logp.numpy(), rtol=1e-5, atol=1e-5)

    jroll, roll = rollouts(np_rollout(env, 6, per_dim_logp=not discrete))
    key = jax.random.PRNGKey(13)
    jstate2, jm = jax.jit(lambda s, k: jalgo.update(
        s, jroll, k, episodes=jnp.int32(40)))(jstate, key)
    perms, k = [], key
    for _ in range(2):
        k, k_perm = jax.random.split(k)
        perms.append(np.asarray(jax.random.permutation(k_perm, T * N)))
    state, m = algo.update(state, roll, t(np.stack(perms)).long(),
                           episodes=torch.tensor(40))
    want = algo.init(torch.Generator().manual_seed(2))
    mat_state_from_flax(want, flax_numpy(jstate2))
    assert_close_lists(mat_params(state), mat_params(want), "MAT", 5e-4)
    np.testing.assert_allclose(float(m["adv_mean"]), float(jm["adv_mean"]),
                               rtol=1e-5, atol=ATOL)
    check_mat_sample(jalgo, algo, jstate2, state, env, 32)


def test_mat_rejects_unequal_action_dims_and_keeps_defaults():
    from freerl_tpu_torch.envs import make

    with pytest.raises(ValueError, match="equal per-agent action dims"):
        MAT(make("simple_world_comm_v3", device="cpu"), MATConfig(),
            device="cpu")
    cfg = MATConfig()
    assert (cfg.clip_param, cfg.n_block, cfg.n_embd, cfg.n_head) == (
        0.05, 1, 64, 1)
    _, env, _, algo, _, state = mat_pair(False)
    assert torch.equal(state.decoder.log_std.detach(), torch.ones(5))
    assert state.opt.defaults["eps"] == 1e-5
