"""The port's MAPPO against the JAX package on the variants of the masked
mode (the masked spread), the state-augmented critic (``state_dim``, with
``obs_norm``) and world comm (heterogeneous action widths, zero-padded):
``sample_action``, ``evaluate_action`` and one update. Sizes, draws and
tolerances as in ``tests/test_torch_mappo.py``.
"""
import jax
import pytest
import torch

from freerl_tpu.algos import mappo as jax_mappo
from freerl_tpu_torch.algos import MAPPO, MAPPOConfig
from tests.test_torch_mappo import (HIDDEN, check_sample, check_update,
                                    env_pair, port_state)

torch.set_num_threads(1)

# name: (env, config fields)
VARIANTS = {
    "masked": ("masked", dict(masked=True, mask_dim=5)),
    "state_dim": ("simple_spread_v3", dict(state_dim=4, obs_norm=True)),
    "world_comm": ("simple_world_comm_v3", dict(adv_norm=True)),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_matches_jax(name):
    env_name, kw = VARIANTS[name]
    jenv, env = env_pair(env_name)
    kw = dict(kw, K_epochs=2, hidden=HIDDEN)
    jalgo = jax_mappo.MAPPO(jenv, jax_mappo.MAPPOConfig(**kw))
    algo = MAPPO(env, MAPPOConfig(**kw), device="cpu")
    assert algo._stackable == jalgo._stackable == (name != "world_comm")
    jstate = jalgo.init(jax.random.PRNGKey(0))
    state = port_state(algo, jstate)
    check_sample(jalgo, algo, jstate, state, env, 41)
    if name == "world_comm":        # the five-wide agents' tails are zero
        draws = algo.draw_action(4, torch.Generator().manual_seed(0))
        obs = torch.randn(4, env.n_agents, env.dim_info.obs_dim)
        env_a, stored, _ = algo.sample_action(state, obs, draws)
        assert env_a.shape == stored.shape == (4, 6, 9)
        assert not env_a[:, 1:, 5:].any() and not stored[:, 1:, 5:].any()
    state, jstate2 = check_update(jalgo, algo, jenv, env, jstate, state)
    check_sample(jalgo, algo, jstate2, state, env, 42)
