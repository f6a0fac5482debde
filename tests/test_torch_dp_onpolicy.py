"""The on-policy algos' sharded updates against the JAX package's: PPO with
adv_norm, obs_norm and reward_scaling (the normalizer hooks, then the
update), REINFORCE with different filled-slot counts on the two ranks,
MAPPO on the loop and on the stacked path, HAPPO and MAT.

As in ``test_torch_dp_updates.py``: JAX runs each update inside a
``shard_map`` over 2 CPU devices with ``axis_name="dp"``, the port on 2
gloo ranks (one launch for the file); each rank's nets must match its
device's within 1e-5, bar one element in 10,000 and none past the lr, and
the normalizer stats at rtol 1e-5 / atol 1e-6. The update's draws are the
same on both ranks, as the sharded loop makes them (the JAX package's
loop does not fold the device into the update key); the rollouts
differ.

REINFORCE steps every slot filled on either rank and takes the Adam step
only where its own slot is filled (the JAX package's local select after
the pmean), so its ranks' params drift apart, as the JAX devices' do.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tests._torch_dp_cases import (Case, assert_nets_close,
                                   assert_stats_close, modules_of, run_cases)

torch.set_num_threads(1)


def _axis(jalgo, *args):
    return type(jalgo)(*args, dataclasses.replace(jalgo.cfg, axis_name="dp"))


def ppo_case():
    import jax
    import jax.numpy as jnp

    from freerl_tpu.algos.ppo import Rollout as JaxRollout
    from freerl_tpu.core.types import DimInfo as JaxDimInfo
    from freerl_tpu_torch.algos import Rollout
    from tests.test_torch_ppo import (DI_C, N, T, jax_perms, load_nets,
                                      make_pair, np_rollout)

    jalgo, jstate, algo, state = make_pair(
        "gauss", adv_norm=True, obs_norm=True, reward_scaling=True,
        num_envs=N)
    jalgo = _axis(jalgo, JaxDimInfo(**DI_C))
    key = jax.random.PRNGKey(7)
    perms = jax_perms(key, algo.cfg.K_epochs, T * N)

    def to_port(js):
        s = algo.init(torch.Generator().manual_seed(0))
        load_nets(s, js, False)
        return s

    jin, calls = [], []
    for d in range(2):
        roll = np_rollout("gauss", 100 + d)
        jin.append((JaxRollout(**{k: jnp.asarray(v) for k, v in roll.items()}),
                    key))
        r = Rollout(**{k: torch.from_numpy(v) for k, v in roll.items()})
        calls.append([("process_obs", (r.next_obs[0], r.next_obs[0]), {}),
                      ("process_reward", (r.reward[0], r.adv_done[0]), {}),
                      ("update", (r, perms), {})])

    def jfn(s, x):
        roll, k = x
        s = jalgo.process_obs(s, roll.next_obs[0], roll.next_obs[0])[0]
        s = jalgo.process_reward(s, roll.reward[0], roll.adv_done[0])[0]
        return jalgo.update(s, roll, k)[0]

    return Case(algo, state, jstate, jin, calls, jfn, to_port)


def reinforce_case():
    import jax
    import jax.numpy as jnp

    from freerl_tpu.algos.ppo import Rollout as JaxRollout
    from freerl_tpu.algos.reinforce import REINFORCE as JaxREINFORCE
    from freerl_tpu.algos.reinforce import REINFORCEConfig as JaxConfig
    from freerl_tpu.core.types import DimInfo as JaxDimInfo
    from freerl_tpu_torch.algos import REINFORCE, REINFORCEConfig, Rollout
    from freerl_tpu_torch.convert import net_params_from_flax
    from freerl_tpu_torch.core.types import DimInfo
    from tests.test_torch_dqn import _flax_params
    from tests.test_torch_onpolicy import DI, WINDOWS, window

    kw = dict(hidden=(16,), max_eps_per_update=8)
    jalgo = JaxREINFORCE(JaxDimInfo(**DI), JaxConfig(axis_name="dp", **kw))
    jstate = jalgo.init(jax.random.PRNGKey(0))
    algo = REINFORCE(DimInfo(**DI), REINFORCEConfig(**kw), device="cpu")

    def to_port(js):
        s = algo.init(torch.Generator().manual_seed(0))
        s.policy.load_state_dict(net_params_from_flax(
            _flax_params(js.params)))
        return s

    jin, calls = [], []
    # rank 0 fills slots 0, 2 and 4, rank 1 slots 0-6
    for d, name in enumerate(("empty_slots", "over_cap")):
        w = window(3 + d, WINDOWS[name][0])
        jin.append((JaxRollout(**{k: jnp.asarray(v) for k, v in w.items()}),
                    jax.random.PRNGKey(1)))
        calls.append([("update", (Rollout(**{k: torch.from_numpy(v)
                                             for k, v in w.items()}),), {})])
    return Case(algo, to_port(jstate), jstate, jin, calls,
                lambda s, x: jalgo.update(s, x[0], x[1])[0], to_port)


def mappo_case(loop: bool):
    import jax
    import jax.numpy as jnp

    from freerl_tpu.algos import mappo as jax_mappo
    from freerl_tpu_torch.algos import MAPPO, MAPPOConfig
    from tests.test_torch_mappo import (HIDDEN, K, N, T, env_pair,
                                        jax_agent_perms, np_rollout,
                                        port_state, rollouts)

    jenv, env = env_pair("simple_spread_v3")
    kw = dict(K_epochs=K, hidden=HIDDEN, adv_norm=True)
    jalgo = jax_mappo.MAPPO(jenv, jax_mappo.MAPPOConfig(axis_name="dp",
                                                        **kw))
    algo = MAPPO(env, MAPPOConfig(**kw), device="cpu")
    assert algo._stackable and jalgo._stackable
    if loop:
        jalgo._stackable = algo._stackable = False
    jstate = jalgo.init(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(7)
    draws = jax_agent_perms(key, env.n_agents, K, T * N)
    jin, calls = [], []
    for d in range(2):
        jroll, roll = rollouts(np_rollout(env, 110 + d))
        jin.append((jroll, key))
        calls.append([("update", (roll, draws),
                       {"episodes": torch.tensor(5)})])
    return Case(algo, port_state(algo, jstate), jstate, jin, calls,
                lambda s, x: jalgo.update(s, x[0], x[1],
                                          episodes=jnp.int32(5))[0],
                lambda js: port_state(algo, js))


def happo_case():
    import jax

    from freerl_tpu.algos import happo as jax_happo
    from freerl_tpu_torch.algos import HAPPO, HAPPOConfig
    from tests.test_torch_happo import jax_happo_draws
    from tests.test_torch_mappo import (HIDDEN, N, T, env_pair, np_rollout,
                                        port_state, rollouts)

    jenv, env = env_pair("simple_spread_v3")
    kw = dict(K_epochs=2, hidden=HIDDEN, actor_lr=1e-3)
    jalgo = jax_happo.HAPPO(jenv, jax_happo.HAPPOConfig(axis_name="dp",
                                                        **kw))
    algo = HAPPO(env, HAPPOConfig(**kw), device="cpu")
    jstate = jalgo.init(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(9)
    draws = jax_happo_draws(key, env.n_agents, 2, T * N)
    jin, calls = [], []
    for d in range(2):
        jroll, roll = rollouts(np_rollout(env, 120 + d))
        jin.append((jroll, key))
        calls.append([("update", (roll, draws), {})])
    return Case(algo, port_state(algo, jstate), jstate, jin, calls,
                lambda s, x: jalgo.update(s, x[0], x[1])[0],
                lambda js: port_state(algo, js))


def mat_case():
    import jax
    import jax.numpy as jnp

    from freerl_tpu_torch.convert import mat_state_from_flax
    from tests.test_torch_mappo import N, T, flax_numpy, np_rollout, rollouts
    from tests.test_torch_mat import mat_pair

    jenv, env, jalgo, algo, jstate, state = mat_pair(
        True, value_clip=True, huber_loss=True, adv_norm=True, lr_decay=True)
    jalgo = _axis(jalgo, jenv)
    key = jax.random.PRNGKey(13)
    perms, k = [], key
    for _ in range(2):
        k, k_perm = jax.random.split(k)
        perms.append(np.asarray(jax.random.permutation(k_perm, T * N)))
    perms = torch.from_numpy(np.stack(perms)).long()

    def to_port(js):
        s = algo.init(torch.Generator().manual_seed(2))
        mat_state_from_flax(s, flax_numpy(js))
        return s

    jin, calls = [], []
    for d in range(2):
        jroll, roll = rollouts(np_rollout(env, 130 + d))
        jin.append((jroll, key))
        calls.append([("update", (roll, perms),
                       {"episodes": torch.tensor(40)})])
    return Case(algo, state, jstate, jin, calls,
                lambda s, x: jalgo.update(s, x[0], x[1],
                                          episodes=jnp.int32(40))[0],
                to_port)


CASES = {
    "ppo_norms": ppo_case,
    "reinforce_uneven": reinforce_case,
    "mappo_loop": lambda: mappo_case(loop=True),
    "mappo_stacked": lambda: mappo_case(loop=False),
    "happo": happo_case,
    "mat": mat_case,
}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases({name: make() for name, make in CASES.items()},
                     tmp_path_factory.mktemp("dp_onpolicy"))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_update_matches_jax(results, name):
    for rank, (got, want, jstate) in enumerate(results[name]):
        assert_nets_close(got, want, f"{name} rank {rank}", 1e-3)
        if name == "ppo_norms":
            assert_stats_close(got.obs_rms, jstate.obs_rms, name)
            assert_stats_close(got.rew_scale.stats, jstate.rew_scale.stats,
                               name)
    (a, _, _), (b, _, _) = results[name]
    same = all(torch.equal(v, y.state_dict()[k])
               for (_, x), (_, y) in zip(modules_of(a), modules_of(b))
               for k, v in x.state_dict().items())
    # REINFORCE's ranks step where their own slots are filled: they drift
    assert same == (name != "reinforce_uneven"), name
