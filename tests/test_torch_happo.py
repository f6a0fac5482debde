"""The port's HAPPO against the JAX package, from the same params,
rollout and draws.

The update order and each position's permutations come from the JAX
update's key as it draws them: ``k_perm, key = split(key)`` for the
order, then ONE key carried from position to position, split once per
epoch; ``sample_action`` is MAPPO's. Sizes: T 8, N 4, K_epochs 3 on
spread (so the factor moves through three positions) and 2 on adversary
(heterogeneous observation widths, huber), hidden (32, 32). Tolerances:
actions and log-probs within 1e-5; after an update every param within
1e-5 bar one element in 10,000, none past the lr; ``adv_mean`` and
``factor_mean`` within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.algos import happo as jax_happo
from freerl_tpu_torch.algos import HAPPO, HAPPOConfig, HAPPODraws
from tests.test_torch_mappo import (ATOL, HIDDEN, N, T, assert_close_lists,
                                    check_sample, env_pair, np_rollout,
                                    port_state, rollouts, state_params, t)

torch.set_num_threads(1)


def jax_happo_draws(key, n_agents, k_epochs, b):
    """The order and the per-position permutations HAPPO's JAX update
    draws from ``key``."""
    k_perm, key = jax.random.split(key)
    order = np.asarray(jax.random.permutation(k_perm, n_agents))
    perms = np.zeros((n_agents, k_epochs, b), np.int64)
    for pos in range(n_agents):
        for e in range(k_epochs):
            key, k_p = jax.random.split(key)
            perms[pos, e] = np.asarray(jax.random.permutation(k_p, b))
    return HAPPODraws(order=t(order), perms=t(perms))


@pytest.mark.parametrize("env_name,k_epochs", [
    ("simple_spread_v3", 3), ("simple_adversary_v3", 2)],
    ids=["spread", "adversary"])
def test_happo_matches_jax(env_name, k_epochs):
    """One update: the order, the position-carried key, both Adams, the
    0.5 clips and the factor chain."""
    jenv, env = env_pair(env_name)
    kw = dict(K_epochs=k_epochs, hidden=HIDDEN, actor_lr=1e-3,
              huber_loss=env_name == "simple_adversary_v3")
    jalgo = jax_happo.HAPPO(jenv, jax_happo.HAPPOConfig(**kw))
    algo = HAPPO(env, HAPPOConfig(**kw), device="cpu")
    jstate = jalgo.init(jax.random.PRNGKey(0))
    state = port_state(algo, jstate)
    check_sample(jalgo, algo, jstate, state, env, 21)
    jroll, roll = rollouts(np_rollout(env, 4))
    key = jax.random.PRNGKey(9)
    jstate2, jm = jax.jit(lambda s, k: jalgo.update(s, jroll, k))(jstate,
                                                                  key)
    draws = jax_happo_draws(key, env.n_agents, k_epochs, T * N)
    assert sorted(draws.order.tolist()) == list(range(env.n_agents))
    state, m = algo.update(state, roll, draws)
    assert_close_lists(state_params(state),
                       state_params(port_state(algo, jstate2)), "HAPPO",
                       1e-3)
    for k in ("adv_mean", "factor_mean"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=ATOL)
    assert abs(float(m["factor_mean"]) - 1.0) > 1e-5
    # every actor and critic took K * B // mb steps of its own Adam
    assert {int(o.state[p]["step"]) for o in state.actor_opts
            + state.critic_opts for p in o.state} == {k_epochs}


def test_happo_order_is_the_result():
    """The same rollout and permutations in another order give another
    result: the factor and the permutations follow the positions."""
    jenv, env = env_pair("simple_spread_v3")
    algo = HAPPO(env, HAPPOConfig(K_epochs=2, hidden=HIDDEN, actor_lr=1e-3),
                 device="cpu")
    jalgo = jax_happo.HAPPO(jenv, jax_happo.HAPPOConfig(K_epochs=2,
                                                        hidden=HIDDEN))
    jstate = jalgo.init(jax.random.PRNGKey(0))
    _, roll = rollouts(np_rollout(env, 5))
    draws = jax_happo_draws(jax.random.PRNGKey(3), 3, 2, T * N)
    out = []
    for order in ([0, 1, 2], [2, 1, 0]):
        state = port_state(algo, jstate)
        _, m = algo.update(state, roll, HAPPODraws(t(np.array(order)),
                                                   draws.perms))
        out.append((torch.cat([p.flatten() for p in state_params(state)]),
                    float(m["factor_mean"])))
    assert not torch.allclose(out[0][0], out[1][0])
    assert out[0][1] != out[1][1]
