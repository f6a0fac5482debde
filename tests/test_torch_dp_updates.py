"""The off-policy algos' sharded updates against the JAX package's: DQN
with PER weights, DDPG with obs_norm, TD3 (two updates, the second with
the delayed actor), SAC, ENVELOPE DQN, MADDPG, MASAC and MAAC.

Each case starts from the same params on both sides (``convert.py``). JAX
runs the update inside a ``shard_map`` over 2 CPU devices with
``axis_name="dp"``; the port runs it on 2 gloo ranks (one launch for the
file, ``tests/_torch_dp_worker.py updates``), each rank with its device's
batch and the draws JAX made from its device's key. Every rank's nets must
match its device's within 1e-5, bar one element in 10,000 and none past
the lr (``_torch_dp_cases.assert_nets_close``); the normalizer stats at
rtol 1e-5 / atol 1e-6. SAC's and MASAC's temperatures are not averaged
over the mesh in the JAX package, so they are held per device.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tests._torch_dp_cases import (Case, assert_nets_close,
                                   assert_stats_close, modules_of, run_cases)

torch.set_num_threads(1)


def _axis(jalgo, *args):
    """The same JAX algo with ``axis_name="dp"``."""
    return type(jalgo)(*args, dataclasses.replace(jalgo.cfg, axis_name="dp"))


def dqn_case():
    import jax
    import jax.numpy as jnp

    from freerl_tpu.algos.dqn import DQN as JaxDQN
    from freerl_tpu.algos.dqn import DQNConfig as JaxDQNConfig
    from freerl_tpu.core.types import DimInfo as JaxDimInfo
    from freerl_tpu_torch.algos import DQN, DQNConfig
    from freerl_tpu_torch.convert import dqn_params_from_flax
    from freerl_tpu_torch.core.types import DimInfo
    from tests.test_torch_dqn import _flax_params, _jax_t, _np_batch, _torch_t

    jalgo = JaxDQN(JaxDimInfo(obs_dim=8, action_dim=4),
                   JaxDQNConfig(hidden=(32,), axis_name="dp"))
    jstate = jalgo.init(jax.random.PRNGKey(0))
    algo = DQN(DimInfo(obs_dim=8, action_dim=4), DQNConfig(hidden=(32,)),
               device="cpu")

    def to_port(js):
        s = algo.init(torch.Generator().manual_seed(0))
        s.net.load_state_dict(dqn_params_from_flax(_flax_params(js.params)))
        s.target_net.load_state_dict(dqn_params_from_flax(
            _flax_params(js.target_params)))
        return s

    jin, calls = [], []
    for d in range(2):
        b = _np_batch(32, seed=10 + d)
        w = np.random.RandomState(20 + d).rand(32).astype(np.float32)
        jin.append((_jax_t(b), jnp.asarray(w)))
        calls.append([("update", (_torch_t(b), None, torch.from_numpy(w)),
                       {})])
    return Case(algo, to_port(jstate), jstate, jin, calls,
                lambda s, x: jalgo.update(s, x[0], None, x[1])[0], to_port)


def continuous_case(name, **extra):
    import jax

    from tests.test_torch_continuous import (NETS, VARIANTS, _jax_t,
                                             _torch_t, jax_net,
                                             jax_update_draws, make_pair,
                                             np_batch)
    from freerl_tpu.core.types import DimInfo as JaxDimInfo
    from freerl_tpu_torch.convert import net_params_from_flax
    from tests.test_torch_dqn import _flax_params

    jalgo, jstate, algo, state = make_pair(name, **extra)
    di = VARIANTS[name][4]
    jalgo = _axis(jalgo, JaxDimInfo(**di))
    adim = di["action_dim"]
    steps = 2 if name == "td3" else 1
    obs_norm = extra.get("obs_norm", False)

    def to_port(js):
        s = algo.init(torch.Generator().manual_seed(0))
        for net in NETS:
            getattr(s, net).load_state_dict(
                net_params_from_flax(_flax_params(jax_net(js, net))))
        return s

    jin, calls = [], []
    for d in range(2):
        batches = [np_batch(name, 32, seed=30 + 10 * d + i)
                   for i in range(steps)]
        keys = [jax.random.PRNGKey(40 + 10 * d + i) for i in range(steps)]
        obs = np.random.RandomState(50 + d).randn(16, di["obs_dim"]).astype(
            np.float32)
        jin.append(([_jax_t(b) for b in batches], keys, obs))
        c = [("process_obs", (torch.from_numpy(obs),) * 2, {})] \
            if obs_norm else []
        c += [("update", (_torch_t(b), jax_update_draws(name, k, 32, adim)),
               {}) for b, k in zip(batches, keys)]
        calls.append(c)

    def jfn(s, x):
        batches, keys, obs = x
        if obs_norm:
            s = jalgo.process_obs(s, obs, obs)[0]
        for b, k in zip(batches, keys):
            s = jalgo.update(s, b, key=k)[0]
        return s

    return Case(algo, state, jstate, jin, calls, jfn, to_port)


def envelope_case():
    import jax

    from freerl_tpu.core.types import DimInfo as JaxDimInfo
    from freerl_tpu_torch.algos import Envelope
    from freerl_tpu_torch.convert import envelope_state_from_flax
    from tests.test_torch_dqn import _jax_t, _torch_t
    from tests.test_torch_envelope import DI, R, _t, make_pair, mo_batch

    jalgo, jstate, algo, state = make_pair()
    jalgo = _axis(jalgo, JaxDimInfo(**DI), R)

    def to_port(js):
        s = algo.init(torch.Generator().manual_seed(0))
        envelope_state_from_flax(s, jax.tree.map(np.asarray, js))
        return s

    jin, calls = [], []
    for d in range(2):
        b = mo_batch(16, 60 + d)
        key = jax.random.PRNGKey(70 + d)
        jin.append((_jax_t(b), key))
        calls.append([("update", (_torch_t(b),
                                  _t(jax.random.normal(key, (3, R)))), {})])
    assert isinstance(algo, Envelope)
    return Case(algo, state, jstate, jin, calls,
                lambda s, x: jalgo.update(s, x[0], x[1])[0], to_port)


def marl_case(name):
    import jax

    from tests.test_torch_maddpg import (ROWS, buffers, jax_maddpg_draws,
                                         make_maddpg, port_state_of)
    from tests.test_torch_masac_maac import make

    if name == "maddpg":
        jenv, env, jalgo, algo, _ = make_maddpg("maddpg")
        draws = jax_maddpg_draws
    else:
        jenv, env, jalgo, algo, draws = make(name)
    jalgo = _axis(jalgo, jenv)
    jstate = jalgo.init(jax.random.PRNGKey(0))
    jin, calls = [], []
    for d in range(2):
        jbuf, buf = buffers(jalgo, jenv, algo, env, seed=80 + d)
        key = jax.random.PRNGKey(90 + d)
        jin.append((jbuf, key))
        calls.append([("update", (buf, draws(algo, key, ROWS)), {})])
    return Case(algo, port_state_of(algo, jstate), jstate, jin, calls,
                lambda s, x: jalgo.learn_step(s, x[0], x[1], ROWS)[0],
                lambda js: port_state_of(algo, js))


CASES = {
    "dqn_per": dqn_case,
    "ddpg_obs_norm": lambda: continuous_case("ddpg", obs_norm=True),
    "td3": lambda: continuous_case("td3"),
    "sac": lambda: continuous_case("sac"),
    "envelope_dqn": envelope_case,
    "maddpg": lambda: marl_case("maddpg"),
    "masac": lambda: marl_case("masac"),
    "maac": lambda: marl_case("maac"),
}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases({name: make() for name, make in CASES.items()},
                     tmp_path_factory.mktemp("dp_updates"))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_update_matches_jax(results, name):
    for rank, (got, want, jstate) in enumerate(results[name]):
        assert_nets_close(got, want, f"{name} rank {rank}", 1e-3)
        if name == "ddpg_obs_norm":
            assert_stats_close(got.obs_rms, jstate.obs_rms, name)
        if name == "sac":
            np.testing.assert_allclose(float(got.log_alpha.detach()),
                                       float(jstate.log_alpha), atol=1e-5)
        if name == "masac":
            np.testing.assert_allclose(
                [float(x.detach()) for x in got.log_alphas],
                np.asarray(jstate.log_alphas), atol=1e-5)
    # the averaged gradients keep the nets replicated across the ranks
    (a, _, _), (b, _, _) = results[name]
    for (_, x), (_, y) in zip(modules_of(a), modules_of(b)):
        for k, v in x.state_dict().items():
            assert torch.equal(v, y.state_dict()[k]), f"{name} {k}"
