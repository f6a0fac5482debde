"""Exploration and observation normalization of the port's DDPG, TD3 and
SAC against the JAX package, with the JAX explore's draws fed in.

The draws are recomputed from each explore key: the Gaussian or OU
normals, the warm-up actions and the Gumbel noise behind
``jax.random.categorical``. Each case runs three chained steps (the OU
state carries over; ``done_prev`` resets some rows), at a noise scale part
way through its decay. Tolerance: atol 1e-5 for continuous actions and the
OU state; discrete actions are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.algos.base import ExploreCtx as JaxExploreCtx
from freerl_tpu_torch.algos import ExploreCtx, ExploreDraws
from tests.test_torch_continuous import VARIANTS, make_pair

torch.set_num_threads(1)

ATOL = 1e-5
B = 8

# case: (variant, extra config, random_steps, total env steps)
CASES = {
    "ddpg_gauss_decay": ("ddpg", dict(noise_init_scale=1.0,
                                      noise_final_scale=0.1), 0, 10**6),
    "ddpg_ou": ("ddpg_full", dict(noise_init_scale=0.8), 0, 10**6),
    "ddpg_warmup": ("ddpg_full", dict(), 100, 0),
    "ddpg_after_warmup": ("ddpg", dict(), 100, 100),
    "ddpg_disc": ("ddpg_disc", dict(), 0, 10**6),
    "ddpg_disc_warmup": ("ddpg_disc", dict(), 100, 0),
    "ddpg_disc_gumbel": ("ddpg_disc_gumbel", dict(), 0, 10**6),
    "td3": ("td3", dict(), 0, 10**6),
    "td3_warmup": ("td3", dict(), 100, 50),
    "sac": ("sac", dict(), 0, 10**6),
    "sac_ou": ("sac", dict(ou_noise=True, num_envs=B), 0, 10**6),
    "sac_disc": ("sac_disc", dict(), 0, 10**6),
    "sac_disc_warmup": ("sac_disc", dict(), 100, 0),
}


def t(x):
    return torch.from_numpy(np.array(x))


def jax_explore_draws(name, cfg, di, key, warm):
    """The draws ``explore(state, obs, key, ctx)`` of the JAX algo makes."""
    adim, max_a = di.action_dim, di.max_action
    if name.startswith("ddpg"):
        k_n, k_r, k_c = jax.random.split(key, 3)
        k_policy = k_c
    elif name.startswith("td3"):
        k_n, k_r = jax.random.split(key)
        k_policy = None
    else:
        k_a, k_r, k_n = jax.random.split(key, 3)
        k_policy = k_a
    draws = ExploreDraws()
    if not di.is_continue:
        draws.gumbel = t(jax.random.gumbel(k_policy, (B, adim)))
        if warm:
            draws.random = t(jax.random.randint(k_r, (B,), 0, adim))
        return draws
    if name.startswith("sac"):
        draws.normal = t(jax.random.normal(k_policy, (B, adim)))
        if cfg.ou_noise:
            draws.ou = t(jax.random.normal(k_n, (cfg.num_envs, adim)))
    elif getattr(cfg, "ou_noise", False):
        draws.ou = t(jax.random.normal(k_n, (cfg.num_envs, adim)))
    else:
        draws.normal = t(jax.random.normal(k_n, (B, adim)))
    if warm:
        draws.random = t(jax.random.uniform(k_r, (B, adim), jnp.float32,
                                            -max_a, max_a))
    return draws


@pytest.mark.parametrize("case", list(CASES))
def test_explore_matches_jax(case):
    name, extra, random_steps, total = CASES[case]
    if "ou_noise" in VARIANTS[name][5] or extra.get("ou_noise"):
        extra = dict(extra, num_envs=B)
    jalgo, jstate, algo, state = make_pair(name, **extra)
    stored = hasattr(algo, "explore_stored")
    rng = np.random.RandomState(0)
    for step in range(3):
        obs = rng.randn(B, algo.dim_info.obs_dim).astype(np.float32)
        done_prev = rng.rand(B) < 0.3
        episodes = 150 * step
        key = jax.random.PRNGKey(10 + step)
        jctx = JaxExploreCtx(total_env_steps=jnp.int32(total),
                             episodes=jnp.int32(episodes),
                             done_prev=jnp.asarray(done_prev),
                             random_steps=random_steps)
        ctx = ExploreCtx(total_env_steps=total,
                         episodes=torch.tensor(episodes),
                         done_prev=torch.from_numpy(done_prev),
                         random_steps=random_steps)
        draws = jax_explore_draws(name, algo.cfg, algo.dim_info, key,
                                  ctx.warmup)
        if stored:
            jstate, ja, js = jalgo.explore_stored(jstate, jnp.asarray(obs),
                                                  key, jctx)
            state, a, s = algo.explore_stored_with(
                state, torch.from_numpy(obs), draws, ctx)
            np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=ATOL)
        else:
            jstate, ja = jalgo.explore(jstate, jnp.asarray(obs), key, jctx)
            state, a = algo.explore_with(state, torch.from_numpy(obs), draws,
                                         ctx)
        if algo.dim_info.is_continue:
            np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=ATOL,
                                       err_msg=f"step {step}")
            assert float(a.abs().max()) <= algo.dim_info.max_action
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        if hasattr(state, "ou_state"):
            np.testing.assert_allclose(state.ou_state.numpy(),
                                       np.asarray(jstate.ou_state), atol=ATOL)


def test_explore_draws_from_the_generator():
    """The port's own draws: in range, seeded, and the warm-up drawn only
    during the warm-up."""
    _, _, algo, state = make_pair("td3")
    obs = torch.zeros(256, 3)
    ctx = dict(episodes=torch.tensor(0), done_prev=torch.zeros(256, dtype=bool))
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(3)
        _, a = algo.explore(state, obs, g, ExploreCtx(0, random_steps=10, **ctx))
        outs.append(a)
    assert torch.equal(outs[0], outs[1])
    assert float(a.abs().max()) <= 2.0 and float(a.std()) > 0.5
    draws = algo.draw_explore(256, torch.Generator(), ExploreCtx(10, **ctx,
                                                                 random_steps=10))
    assert draws.random is None and draws.normal.shape == (256, 1)


def test_process_obs_and_evaluate_match_jax():
    """obs_norm: three steps of Welford updates on the env's next
    observations; both outputs normalized with the updated stats; the
    evaluation action normalizes raw observations."""
    jalgo, jstate, algo, state = make_pair("ddpg_full")
    rng = np.random.RandomState(1)
    for step in range(3):
        nxt = (rng.randn(B, 3) * 4 + 2).astype(np.float32)
        carry = (rng.randn(B, 3) * 4 + 2).astype(np.float32)
        jstate, jn, jc = jalgo.process_obs(jstate, jnp.asarray(nxt),
                                           jnp.asarray(carry))
        state, n, c = algo.process_obs(state, torch.from_numpy(nxt),
                                       torch.from_numpy(carry))
        np.testing.assert_allclose(n.numpy(), np.asarray(jn), atol=ATOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=ATOL)
        for k in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(state.obs_rms, k).numpy(),
                                       np.asarray(getattr(jstate.obs_rms, k)),
                                       rtol=1e-6, err_msg=f"step {step} {k}")
    raw = (rng.randn(B, 3) * 4 + 2).astype(np.float32)
    np.testing.assert_allclose(
        algo.evaluate_action(state, torch.from_numpy(raw)).numpy(),
        np.asarray(jalgo.evaluate_action(jstate, jnp.asarray(raw))),
        atol=ATOL)
    # without obs_norm the observations pass through
    _, _, plain, pstate = make_pair("ddpg")
    x = torch.from_numpy(raw)
    _, n, c = plain.process_obs(pstate, x, x)
    assert n is x and c is x


@pytest.mark.parametrize("name", ["sac", "sac_disc", "td3", "ddpg_disc"])
def test_evaluate_action_matches_jax(name):
    jalgo, jstate, algo, state = make_pair(name)
    obs = np.random.RandomState(2).randn(B, algo.dim_info.obs_dim).astype(
        np.float32)
    got = algo.evaluate_action(state, torch.from_numpy(obs)).numpy()
    want = np.asarray(jalgo.evaluate_action(jstate, jnp.asarray(obs)))
    if algo.dim_info.is_continue:
        np.testing.assert_allclose(got, want, atol=ATOL)
    else:
        np.testing.assert_array_equal(got, want)
