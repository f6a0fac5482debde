"""The parts of the port's PPO against the JAX package: ``gae``, one
minibatch step of each actor, ``sample_action`` with JAX's draws fed in,
``evaluate_action`` under ObsNorm, the orthogonal init and the param
bridge for every PPO net.

Tolerances: ``gae`` rtol 1e-5 / atol 1e-6 (float32 rounding of the
recursion); one minibatch step 1e-6; the samples, log-probs and forward
passes 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.algos import ppo as jax_ppo
from freerl_tpu.algos.common import gae as jax_gae
from freerl_tpu.algos.ppo import PPO as JaxPPO
from freerl_tpu.algos.ppo import PPOConfig as JaxPPOConfig
from freerl_tpu.core.types import DimInfo as JaxDimInfo
from freerl_tpu.nets import mlp as jax_mlp
from freerl_tpu_torch.algos import (PPO, BetaPolicy, CategoricalPolicy,
                                    GaussianPolicy, PPOConfig, VCritic)
from freerl_tpu_torch.algos.common import gae
from freerl_tpu_torch.convert import net_params_from_flax
from freerl_tpu_torch.core.types import DimInfo
from freerl_tpu_torch.nets import MLP, Dense
from tests.test_torch_dqn import _flax_params
from tests.test_torch_ppo import (BRANCHES, DI_C, DI_D, HIDDEN, load_nets,
                                  run_update, state_err)

torch.set_num_threads(1)


def test_gae_matches_jax():
    """The JAX test's inputs (tests/test_onpolicy.py): T 16, N 2, dead and
    truncated ends apart."""
    t, n = 16, 2
    rng = np.random.RandomState(0)
    rewards = rng.randn(t, n).astype(np.float32)
    vs = rng.randn(t, n).astype(np.float32)
    vs_next = rng.randn(t, n).astype(np.float32)
    done = (rng.rand(t, n) < 0.1).astype(np.float32)
    adv_done = np.maximum(done, (rng.rand(t, n) < 0.1)).astype(np.float32)
    want = jax_gae(*[jnp.asarray(x) for x in (rewards, vs, vs_next, done,
                                               adv_done)], 0.99, 0.95)
    got = gae(*[torch.from_numpy(x) for x in (rewards, vs, vs_next)],
              torch.from_numpy(done > 0), torch.from_numpy(adv_done > 0),
              0.99, 0.95)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    assert adv_done.sum() > done.sum() > 0


@pytest.mark.parametrize("name", ["gauss", "discrete", "beta", "all_tricks"])
def test_one_minibatch_step_matches_jax(name):
    """One epoch of one minibatch (the whole rollout): one Adam step."""
    jstate, _, state, _ = run_update(name, K_epochs=1, minibatch_size=64)
    err = state_err(state, jstate, BRANCHES[name][1].get("beta_dist", False))
    print(f"{name}: params max abs err after one step {err:.3e}")
    assert err <= 1e-6, err


def _pair(name, **extra):
    di, kw, _ = BRANCHES[name]
    kw = dict(kw, hidden=HIDDEN, **extra)
    jalgo = JaxPPO(JaxDimInfo(**di), JaxPPOConfig(**kw))
    jstate = jalgo.init(jax.random.PRNGKey(3))
    algo = PPO(DimInfo(**di), PPOConfig(**kw), device="cpu")
    state = algo.init(torch.Generator().manual_seed(0))
    load_nets(state, jstate, kw.get("beta_dist", False))
    return jalgo, jstate, algo, state


@pytest.mark.parametrize("name", ["gauss", "discrete", "std_decay"])
def test_sample_action_matches_jax(name):
    """Gumbel noise (categorical) and a standard normal (Gaussian) drawn
    from the JAX call's key: the same env action, stored action and
    log-prob; std_decay samples with the external std."""
    jalgo, jstate, algo, state = _pair(name)
    obs = np.random.RandomState(5).randn(64, BRANCHES[name][0]["obs_dim"])
    obs = obs.astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = jalgo.sample_action(jstate, jnp.asarray(obs), key)
    shape = (64, BRANCHES[name][0]["action_dim"])
    draw = (jax.random.gumbel(key, shape) if name == "discrete"
            else jax.random.normal(key, shape))
    got = algo.sample_action(state, torch.from_numpy(obs),
                             torch.from_numpy(np.array(draw)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    if name == "gauss":        # std 1: some samples leave the box, clipped
        assert float(got[0].abs().max()) <= 2.0 < float(got[1].abs().max())


def test_beta_sample_range_and_draw():
    """The Beta actor samples from the caller's generator: stored actions
    in [0, 1], env actions in the +-2 box, log-probs finite and
    reproducible from the seed."""
    _, _, algo, state = _pair("beta")
    obs = torch.randn(4096, 3, generator=torch.Generator().manual_seed(1))
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(4)
        assert algo.draw_action(4096, g) is g
        outs.append(algo.sample_action(state, obs, g))
    env_a, x, logp = outs[0]
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    assert float(env_a.min()) >= -2.0 and float(env_a.max()) <= 2.0
    assert bool(torch.isfinite(logp).all())
    assert torch.equal(x, outs[1][1])
    # near-uniform Beta(~1.7, ~1.7) from the zero-ish init heads: mean 1/2
    np.testing.assert_allclose(float(x.mean()), 0.5, atol=0.02)


@pytest.mark.parametrize("name", ["gauss", "discrete", "beta"])
def test_evaluate_action_applies_obs_norm(name):
    """Raw observations through the saved running stats, as the JAX
    package's evaluate path does."""
    jalgo, jstate, algo, state = _pair(name, obs_norm=True)
    od = BRANCHES[name][0]["obs_dim"]
    rng = np.random.RandomState(2)
    big = (rng.randn(128, od) * 5 + 100).astype(np.float32)
    jstate = jstate.replace(obs_rms=jstate.obs_rms.update(jnp.asarray(big)))
    state.obs_rms = state.obs_rms.update(torch.from_numpy(big))
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(state.obs_rms, f).numpy(),
                                   np.asarray(getattr(jstate.obs_rms, f)),
                                   rtol=1e-5)
    raw = (rng.randn(16, od) * 5 + 100).astype(np.float32)
    want = jalgo.evaluate_action(jstate, jnp.asarray(raw))
    got = algo.evaluate_action(state, torch.from_numpy(raw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    plain = PPO(algo.dim_info, PPOConfig(hidden=HIDDEN,
                                         beta_dist=name == "beta"),
                device="cpu")
    np.testing.assert_allclose(
        plain.evaluate_action(state, state.obs_rms.normalize(
            torch.from_numpy(raw))).numpy(), got.numpy(), atol=1e-6)


def _is_orthogonal(w, gain):
    w = w.double()
    gram = w.T @ w if w.shape[0] >= w.shape[1] else w @ w.T
    return float((gram - gain ** 2 * torch.eye(gram.shape[0],
                                               dtype=torch.float64)
                  ).abs().max())


@pytest.mark.parametrize("shape,gain", [((24, 128), np.sqrt(2)),
                                        ((128, 128), np.sqrt(2)),
                                        ((128, 4), 0.01), ((128, 1), 1.0)])
def test_orthogonal_init(shape, gain):
    """W^T W = gain^2 I (W W^T for a wide weight) on the weight torch
    holds, for the port's draw and the transposed flax kernel alike; the
    bias is zero."""
    layer = Dense(*shape, torch.Generator().manual_seed(0), device="cpu",
                  scheme="orthogonal", gain=gain)
    jp = jax_mlp.Dense(shape[1], scheme="orthogonal", gain=gain).init(
        jax.random.PRNGKey(0), jnp.zeros((1, shape[0])))["params"]["Dense_0"]
    kernel = torch.from_numpy(np.asarray(jp["kernel"]).T.copy())
    assert layer.weight.shape == kernel.shape == (shape[1], shape[0])
    for w in (layer.weight.detach(), kernel):
        assert _is_orthogonal(w, gain) < 1e-5 * max(gain ** 2, 1e-2)
    assert not bool(layer.bias.any()) and not np.asarray(jp["bias"]).any()
    again = Dense(*shape, torch.Generator().manual_seed(0), device="cpu",
                  scheme="orthogonal", gain=gain)
    assert torch.equal(layer.weight, again.weight)


def test_ppo_nets_init_with_their_gains():
    """orthogonal_init: sqrt(2) hidden layers, 0.01 policy heads (both Beta
    heads), 1.0 value head; MLP's out_gain."""
    algo = PPO(DimInfo(**DI_C), PPOConfig(orthogonal_init=True,
                                          beta_dist=True), device="cpu")
    state = algo.init(torch.Generator().manual_seed(0))
    nets = state.actor, state.critic
    for net in nets:
        for layer in net.hidden:
            assert _is_orthogonal(layer.weight.detach(), np.sqrt(2)) < 1e-5
    for head in (state.actor.alpha_head, state.actor.beta_head):
        assert _is_orthogonal(head.weight.detach(), 0.01) < 1e-8
    assert _is_orthogonal(state.critic.head.weight.detach(), 1.0) < 1e-5
    net = MLP(8, 4, (32,), device="cpu", scheme="orthogonal", out_gain=0.5)
    assert _is_orthogonal(net.head.weight.detach(), 0.5) < 1e-5


def _jax_nets():
    return {
        "GaussianPolicy": (jax_ppo.GaussianPolicy(2, HIDDEN, max_action=2.0),
                           lambda: GaussianPolicy(5, 2, HIDDEN,
                                                  max_action=2.0,
                                                  device="cpu")),
        "BetaPolicy": (jax_ppo.BetaPolicy(2, HIDDEN, activation="tanh"),
                       lambda: BetaPolicy(5, 2, HIDDEN, "tanh",
                                          device="cpu")),
        "CategoricalPolicy": (jax_ppo.CategoricalPolicy(3, HIDDEN),
                              lambda: CategoricalPolicy(5, 3, HIDDEN,
                                                        device="cpu")),
        "VCritic": (jax_ppo.VCritic(HIDDEN, orthogonal=True),
                    lambda: VCritic(5, HIDDEN, orthogonal=True,
                                    device="cpu")),
        "REINFORCE": (jax_ppo.CategoricalPolicy(2, (128,)),
                      lambda: CategoricalPolicy(5, 2, (128,), device="cpu")),
    }


@pytest.mark.parametrize("name", ["GaussianPolicy", "BetaPolicy",
                                  "CategoricalPolicy", "VCritic",
                                  "REINFORCE"])
def test_ppo_net_params_from_flax(name):
    """Every PPO net (and REINFORCE's 128-wide policy) carried over from
    flax computes what flax computes."""
    jnet, make = _jax_nets()[name]
    x = np.random.RandomState(1).randn(16, 5).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    if name == "GaussianPolicy":
        params = dict(params, log_std=jnp.asarray([0.3, -1.5]))
    net = make()
    net.load_state_dict(net_params_from_flax(_flax_params(params),
                                             beta=name == "BetaPolicy"))
    want = jnet.apply({"params": params}, jnp.asarray(x))
    got = net(torch.from_numpy(x))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-5)
    with pytest.raises(ValueError, match="actor or critic"):
        net_params_from_flax({"Dense_0": {}, "log_std": 0}, beta=True)

