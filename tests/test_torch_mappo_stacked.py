"""The port's stacked MAPPO update against the JAX package's stacked AND
loop updates under a binding grad clip.

The JAX stacked update (``_update_stacked``) clips inside ``vmap`` over the
agents, so each agent has its own clip norm, as on the loop path: with
``max_grad_norm=0.01`` the clip binds on every minibatch, and the port's
stacked update, JAX's stacked update and JAX's loop update agree, while
one norm over every agent's gradients would not. T 8, N 4, K_epochs 2,
minibatch 16 (two minibatches an epoch), hidden (32, 32); the tolerance
of ``tests/test_torch_mappo.py``: every param within 1e-5 bar one element
in 10,000, none past the lr.
"""
import jax
import pytest
import torch

from freerl_tpu.algos import mappo as jax_mappo
from freerl_tpu_torch.algos import MAPPO, MAPPOConfig
from freerl_tpu_torch.algos.common import clip_grads_by_norm
from tests.test_torch_mappo import (HIDDEN, N, T, assert_close_lists,
                                    env_pair, jax_agent_perms, np_rollout,
                                    port_state, rollouts, state_params)

torch.set_num_threads(1)


@pytest.mark.parametrize("independent", [False, True], ids=["mappo", "ippo"])
def test_stacked_update_clips_per_agent(independent):
    """The port's stacked update under a binding clip equals JAX's stacked
    update and JAX's loop update; a clip over all agents at once would
    not."""
    jenv, env = env_pair("simple_spread_v3")
    kw = dict(num_envs=4, horizon=32, K_epochs=2, minibatch_size=16,
              independent=independent, value_clip=True, huber_loss=True,
              max_grad_norm=0.01, hidden=HIDDEN)
    jalgo = jax_mappo.MAPPO(jenv, jax_mappo.MAPPOConfig(**kw))
    algo = MAPPO(env, MAPPOConfig(**kw), device="cpu")
    assert algo._stackable and jalgo._stackable
    jstate = jalgo.init(jax.random.PRNGKey(0))
    jroll, roll = rollouts(np_rollout(env, 7))
    key = jax.random.PRNGKey(2)
    draws = jax_agent_perms(key, 3, 2, T * N)
    state, _ = algo.update(port_state(algo, jstate), roll, draws)
    got = state_params(state)
    for stackable in (True, False):
        jalgo._stackable = stackable
        jstate2, _ = jalgo.update(jstate, jroll, key)
        assert_close_lists(got, state_params(port_state(algo, jstate2)),
                           f"clip, JAX stackable={stackable}", 5e-4)
    # the clip binds: without it, or with one norm over every agent, the
    # update moves the params elsewhere
    free = MAPPO(env, MAPPOConfig(**dict(kw, max_grad_norm=None)),
                 device="cpu")
    state_free, _ = free.update(port_state(free, jstate), roll, draws)
    moved = max(float((a - b).abs().max())
                for a, b in zip(got, state_params(state_free)))
    assert moved > 1e-3
    one_norm = MAPPO(env, MAPPOConfig(**kw), device="cpu")
    # every agent's actor (critic) gradients as ONE group
    one_norm._clip = lambda grads, n_actor, clip: (
        clip_grads_by_norm(grads[:n_actor], 0.01)
        + clip_grads_by_norm(grads[n_actor:], 0.01))
    state_one, _ = one_norm.update(port_state(one_norm, jstate), roll, draws)
    moved = max(float((a - b).abs().max())
                for a, b in zip(got, state_params(state_one)))
    assert moved > 1e-5
