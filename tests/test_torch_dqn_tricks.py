"""The port's DQN trick matrix against the JAX package: the C51
projection, the Q-network's eight head combinations, the standalone nets,
and five learner updates per trick combination.

Parameters move from flax to torch with ``convert.dqn_params_from_flax``.
The JAX noisy layer draws its factorized noise inside the module; the tests
read those draws by wrapping ``freerl_tpu.nets.noisy._f`` for one eager
forward under the same key, and hand them to the port as arguments.
Tolerances: atol 1e-6 for ``c51_project`` (its dense form adds the same
terms in another order), atol 1e-5 for forwards and, after five updates,
for params, target params and priorities (float32 matmul and Adam rounding
in two frameworks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import freerl_tpu.nets.noisy as jax_noisy
from freerl_tpu.algos.common import c51_project as jax_c51_project
from freerl_tpu.algos.dqn import DQN as JaxDQN
from freerl_tpu.algos.dqn import DQNConfig as JaxDQNConfig
from freerl_tpu.core.types import DimInfo as JaxDimInfo
from freerl_tpu.nets import mlp as jax_mlp
from freerl_tpu_torch.algos import DQN, DQNConfig, QNetwork
from freerl_tpu_torch.algos.common import c51_project, td_target
from freerl_tpu_torch.convert import dqn_params_from_flax
from freerl_tpu_torch.core.types import DimInfo
from freerl_tpu_torch.nets import (CategoricalQNet, Dense, DuelingQNet,
                                   NoisyCategoricalQNet, NoisyDense,
                                   NoisyDuelingQNet, NoisyMLP)
from tests.test_torch_dqn import _flax_params, _jax_t, _np_batch, _torch_t

torch.set_num_threads(1)

ATOL = 1e-5
OBS, ACT, HIDDEN = 8, 4, (32,)
HEADS = [dict(noisy=n, dueling=d, categorical=c)
         for n in (False, True) for d in (False, True) for c in (False, True)]


def _ids(d):
    return "+".join(k for k, v in d.items() if v is True) or "plain"


def jax_noise(jalgo, params, key):
    """The (eps_in, eps_out) of every noisy head that the JAX net draws
    under ``key``, in creation order (A head, then V head)."""
    seen = []
    f = jax_noisy._f

    def recording_f(x):
        y = f(x)
        seen.append(torch.from_numpy(np.array(y)))
        return y

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_noisy, "_f", recording_f)
        jalgo._apply(params, jnp.zeros((1, OBS)), key, deterministic=False)
    return list(zip(seen[::2], seen[1::2]))


def _pair(cfg, seed=0):
    """A JAX DQN and the port's, the port's nets carrying the JAX init."""
    jalgo = JaxDQN(JaxDimInfo(obs_dim=OBS, action_dim=ACT), JaxDQNConfig(**cfg))
    jstate = jalgo.init(jax.random.PRNGKey(seed))
    algo = DQN(DimInfo(obs_dim=OBS, action_dim=ACT), DQNConfig(**cfg),
               device="cpu")
    state = algo.init(torch.Generator().manual_seed(0))
    sd = dqn_params_from_flax(_flax_params(jstate.params),
                              dueling=cfg.get("dueling", False))
    state.net.load_state_dict(sd)
    state.target_net.load_state_dict(sd)
    return jalgo, jstate, algo, state


# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["inside", "clipped", "exact_atoms", "done"])
def test_c51_project_matches_jax(case):
    rng = np.random.RandomState(0)
    b, n = 256, 51
    atoms = np.linspace(-100, 100, n).astype(np.float32)
    logits = rng.randn(b, n).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    reward = rng.randn(b).astype(np.float32) * 5
    gamma = np.full(b, 0.99, np.float32)
    done = np.zeros(b, np.float32)
    if case == "clipped":
        reward = rng.choice([-150.0, 150.0], b).astype(np.float32) \
            + rng.randn(b).astype(np.float32) * 30
    elif case == "exact_atoms":
        # integer atom positions: low == high, the whole mass to one atom
        reward = (4.0 * rng.randint(-5, 6, b)).astype(np.float32)
        gamma[:] = 1.0
    elif case == "done":
        done = (rng.rand(b) < 0.5).astype(np.float32)
    tz = reward[:, None] + (gamma * (1 - done))[:, None] * atoms
    want = np.asarray(jax_c51_project(jnp.asarray(probs), jnp.asarray(tz),
                                      jnp.asarray(atoms)))
    got = c51_project(torch.from_numpy(probs), torch.from_numpy(tz),
                      torch.from_numpy(atoms)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)


def test_td_target_per_sample_gamma():
    r, v = torch.tensor([1.0, 2.0]), torch.tensor([10.0, 10.0])
    g = torch.tensor([0.5, 0.25])
    out = td_target(r, g, v, torch.tensor([False, True]))
    assert out.tolist() == [6.0, 2.0]


@pytest.mark.parametrize("head", HEADS, ids=_ids)
def test_head_forward_matches_flax(head):
    """Every head combination from carried-over params; noisy heads with
    the JAX draw injected, and noiseless."""
    jalgo, jstate, algo, state = _pair(dict(hidden=HIDDEN, **head))
    obs = np.random.RandomState(2).randn(16, OBS).astype(np.float32)
    runs = [(None, None)]
    if head["noisy"]:
        key = jax.random.PRNGKey(5)
        runs.append((key, jax_noise(jalgo, jstate.params, key)))
    for key, noise in runs:
        want = np.asarray(jalgo._apply(jstate.params, jnp.asarray(obs), key,
                                       deterministic=key is None))
        got = state.net(torch.from_numpy(obs), noise).detach().numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL)
    q = algo.q_values(state.net, torch.from_numpy(obs)).detach().numpy()
    np.testing.assert_allclose(
        q, np.asarray(jalgo._q_values(jstate.params, jnp.asarray(obs))),
        atol=ATOL)


@pytest.mark.parametrize("head", [h for h in HEADS if h["noisy"]], ids=_ids)
def test_per_row_noise_matches_flax(head):
    """Exploration's per-row noise (one draw per env row, the factorized
    identity) against JAX's per-row forward, row by row."""
    jalgo, jstate, algo, state = _pair(dict(hidden=HIDDEN, **head))
    rows = 8
    obs = np.random.RandomState(3).randn(rows, OBS).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), rows)
    draws = [jax_noise(jalgo, jstate.params, k) for k in keys]
    noise = [tuple(torch.stack([d[layer][i] for d in draws]) for i in (0, 1))
             for layer in range(len(draws[0]))]
    got = state.net(torch.from_numpy(obs), noise).detach().numpy()
    for i, k in enumerate(keys):
        want = jalgo._apply(jstate.params, jnp.asarray(obs[i:i + 1]), k,
                            deterministic=False)
        np.testing.assert_allclose(got[i], np.asarray(want)[0], atol=ATOL)
    # select_action makes one such per-row draw from its generator
    x = torch.from_numpy(obs)
    greedy = algo.select_action(state, x, torch.Generator().manual_seed(1))
    noise = state.net.draw_noise(torch.Generator().manual_seed(1), rows=rows)
    assert noise[0][0].shape == (rows, HIDDEN[-1])
    assert torch.equal(greedy, algo.q_values(state.net, x, noise).argmax(-1))


def _standalone_state_dict(params, net):
    """flax params of a standalone net -> state_dict, pairing the layers
    in creation order (every plain Dense before every NoisyDense)."""
    layers = [name for name, m in net.named_modules()
              if isinstance(m, (Dense, NoisyDense))]
    dense = sorted((k for k in params if k.startswith("Dense_")),
                   key=lambda k: int(k.split("_")[1]))
    noisy = sorted((k for k in params if k.startswith("NoisyDense_")),
                   key=lambda k: int(k.split("_")[1]))
    sd = {}
    for flax_name, name in zip(dense + noisy, layers):
        p = params[flax_name]
        if flax_name.startswith("Dense_"):
            sd[f"{name}.weight"] = torch.from_numpy(np.array(p["Dense_0"]["kernel"]).T.copy())
            sd[f"{name}.bias"] = torch.from_numpy(np.array(p["Dense_0"]["bias"]))
        else:
            for k in ("w_mu", "w_sigma"):
                sd[f"{name}.{k}"] = torch.from_numpy(np.array(p[k]).T.copy())
            for k in ("b_mu", "b_sigma"):
                sd[f"{name}.{k}"] = torch.from_numpy(np.array(p[k]))
    return sd


@pytest.mark.parametrize("kind", ["dueling", "categorical", "noisy_mlp",
                                  "noisy_dueling", "noisy_categorical"])
def test_standalone_nets_match_flax(kind):
    """nets/mlp.py and nets/noisy.py's Q nets, noiseless and (noisy) with
    one draw injected."""
    flax_net, net = {
        "dueling": (jax_mlp.DuelingQNet(ACT, hidden=HIDDEN),
                    DuelingQNet(OBS, ACT, HIDDEN, device="cpu")),
        "categorical": (jax_mlp.CategoricalQNet(ACT, 11, hidden=HIDDEN),
                        CategoricalQNet(OBS, ACT, 11, HIDDEN, device="cpu")),
        "noisy_mlp": (jax_noisy.NoisyMLP(ACT, hidden=HIDDEN),
                      NoisyMLP(OBS, ACT, HIDDEN, device="cpu")),
        "noisy_dueling": (jax_noisy.NoisyDuelingQNet(ACT, hidden=HIDDEN),
                          NoisyDuelingQNet(OBS, ACT, HIDDEN, device="cpu")),
        "noisy_categorical": (
            jax_noisy.NoisyCategoricalQNet(ACT, 11, hidden=HIDDEN),
            NoisyCategoricalQNet(OBS, ACT, 11, HIDDEN, device="cpu")),
    }[kind]
    obs = np.random.RandomState(4).randn(16, OBS).astype(np.float32)
    noisy = kind.startswith("noisy")
    key = jax.random.PRNGKey(9)
    rngs = {"params": key, "noise": key} if noisy else key
    params = jax.tree.map(np.asarray, flax_net.init(rngs, jnp.asarray(obs))["params"])
    net.load_state_dict(_standalone_state_dict(params, net))
    runs = [(True, None)]
    if noisy:
        seen = []
        f = jax_noisy._f

        def recording_f(x):
            y = f(x)
            seen.append(torch.from_numpy(np.array(y)))
            return y

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_noisy, "_f", recording_f)
            flax_net.apply({"params": params}, jnp.asarray(obs), False,
                           rngs={"noise": key})
        runs.append((False, list(zip(seen[::2], seen[1::2]))))
    for deterministic, noise in runs:
        args = (deterministic,) if noisy else ()
        want = flax_net.apply({"params": params}, jnp.asarray(obs), *args,
                              rngs=None if deterministic else {"noise": key})
        got = net(torch.from_numpy(obs), noise) if noisy else net(
            torch.from_numpy(obs))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL)


def test_noisy_dense_init():
    layer = NoisyDense(128, 6, 0.05, torch.Generator().manual_seed(0), "cpu")
    assert layer.w_mu.shape == layer.w_sigma.shape == (6, 128)
    bound = 1 / np.sqrt(128)
    assert float(layer.w_mu.detach().abs().max()) <= bound
    assert float(layer.b_mu.detach().abs().max()) <= bound
    np.testing.assert_allclose(layer.w_sigma.detach().numpy(), 0.05 / np.sqrt(128))
    np.testing.assert_allclose(layer.b_sigma.detach().numpy(), 0.05 / np.sqrt(6))
    eps_in, eps_out = layer.draw_noise(torch.Generator().manual_seed(1), rows=3)
    assert eps_in.shape == (3, 128) and eps_out.shape == (3, 6)
    x = torch.randn(3, 128)
    for i in range(3):          # per-row identity == the perturbed weight
        want = layer(x[i:i + 1], (eps_in[i], eps_out[i]))
        got = layer(x, (eps_in, eps_out))[i:i + 1]
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
UPDATES = {
    "double": dict(double=True),
    "dueling": dict(dueling=True),
    "c51": dict(categorical=True),
    "c51_weighted_nstep": dict(categorical=True),
    "rainbow_head": dict(double=True, dueling=True, noisy=True,
                         categorical=True),
}


@pytest.mark.parametrize("name", list(UPDATES))
def test_updates_match_jax(name):
    """Five updates on identical batches from carried-over params: params,
    target params and priorities. The weighted cases carry IS weights and
    a per-sample eff_gamma; the Rainbow head gets JAX's three draws."""
    cfg = dict(hidden=HIDDEN, **UPDATES[name])
    weighted = name in ("c51_weighted_nstep", "rainbow_head")
    jalgo, jstate, algo, state = _pair(cfg)
    jupdate = jax.jit(jalgo.update)
    for i in range(5):
        b = _np_batch(64, seed=i, obs_dim=OBS, n_actions=ACT)
        rng = np.random.RandomState(100 + i)
        w = g = None
        if weighted:
            w = rng.rand(64).astype(np.float32)
            g = (0.99 ** rng.randint(1, 4, 64)).astype(np.float32)
        key, noise = None, None
        if cfg.get("noisy"):
            key = jax.random.PRNGKey(50 + i)
            noise = tuple(jax_noise(jalgo, jstate.params, k)
                          for k in jax.random.split(key, 3))
        jstate, jm, jprio = jupdate(
            jstate, _jax_t(b), None if g is None else jnp.asarray(g),
            None if w is None else jnp.asarray(w), key)
        state, m, prio = algo.update(
            state, _torch_t(b), None if g is None else torch.from_numpy(g),
            None if w is None else torch.from_numpy(w), noise)
        np.testing.assert_allclose(prio.numpy(), np.asarray(jprio), atol=ATOL)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        for net, jparams in ((state.net, jstate.params),
                             (state.target_net, jstate.target_params)):
            want = dqn_params_from_flax(_flax_params(jparams),
                                        dueling=cfg.get("dueling", False))
            got = net.state_dict()
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                           atol=ATOL, err_msg=f"{i}: {k}")
    assert state.step == int(jstate.step) == 5


def test_convert_rejects_wrong_tree():
    jalgo = JaxDQN(JaxDimInfo(OBS, ACT), JaxDQNConfig(hidden=HIDDEN, noisy=True,
                                                      dueling=True))
    params = _flax_params(jalgo.init(jax.random.PRNGKey(0)).params)
    with pytest.raises(ValueError, match="dueling=False"):
        dqn_params_from_flax(params)
    net = QNetwork(OBS, ACT, HIDDEN, device="cpu", noisy=True, dueling=True)
    net.load_state_dict(dqn_params_from_flax(params, dueling=True))
