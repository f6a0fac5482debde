"""The port's DDPG, TD3 and SAC against the JAX package: five learner
updates of each of the nine variants of ``tests/test_continuous.py``, from
the same params and batches and with the JAX update's draws fed in; the
param bridge, ``clip_by_global_norm`` and the init schemes.

Parameters move from flax to torch with ``convert.net_params_from_flax``.
The draws are recomputed from the JAX update's key: DDPG's Gumbel noise
(``gumbel_softmax``), TD3's smoothing normal (drawn from the key itself),
SAC's two normals (``k_next``, ``k_new``). Tolerance: atol 1e-5 after five
updates for params, target params, losses, ``log_alpha`` and the PopArt
stats (float32 matmul and Adam rounding in two frameworks), as for DQN.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from freerl_tpu.algos.ddpg import DDPG as JaxDDPG
from freerl_tpu.algos.ddpg import DDPGConfig as JaxDDPGConfig
from freerl_tpu.algos.sac import SAC as JaxSAC
from freerl_tpu.algos.sac import SACConfig as JaxSACConfig
from freerl_tpu.algos.td3 import TD3 as JaxTD3
from freerl_tpu.algos.td3 import TD3Config as JaxTD3Config
from freerl_tpu.core.types import DimInfo as JaxDimInfo
from freerl_tpu.nets import mlp as jax_mlp
from freerl_tpu_torch.algos import (DDPG, SAC, TD3, DDPGConfig, GaussianActor,
                                    QCritic, SACConfig, SoftmaxActor,
                                    SoftmaxPolicy, TanhActor, TD3Config,
                                    TwinQCritic, TwinQTable)
from freerl_tpu_torch.algos.common import clip_by_global_norm
from freerl_tpu_torch.convert import net_params_from_flax
from freerl_tpu_torch.core.types import DimInfo
from freerl_tpu_torch.nets import MLP, Dense
from freerl_tpu_torch.train.loop import example_transition
from tests.test_torch_dqn import _flax_params, _jax_t, _torch_t

torch.set_num_threads(1)

ATOL = 1e-5
HIDDEN = (16, 16)
DI = dict(obs_dim=3, action_dim=1, is_continue=True, max_action=2.0)
DI_DISC = dict(obs_dim=4, action_dim=3, is_continue=False)

# (JAX class, JAX config, port class, port config, dim info, batch action
# form): the nine variants of tests/test_continuous.py
VARIANTS = {
    "ddpg": (JaxDDPG, JaxDDPGConfig, DDPG, DDPGConfig, DI, dict(), "box"),
    "ddpg_full": (JaxDDPG, JaxDDPGConfig, DDPG, DDPGConfig, DI,
                  dict(weight_decay=True, ou_noise=True, obs_norm=True,
                       net_init=True, num_envs=8), "box"),
    "ddpg_popart": (JaxDDPG, JaxDDPGConfig, DDPG, DDPGConfig, DI,
                    dict(popart=True), "box"),
    "ddpg_disc": (JaxDDPG, JaxDDPGConfig, DDPG, DDPGConfig, DI_DISC, dict(),
                  "probs"),
    "ddpg_disc_gumbel": (JaxDDPG, JaxDDPGConfig, DDPG, DDPGConfig, DI_DISC,
                         dict(discrete_gumbel=True), "index"),
    "td3": (JaxTD3, JaxTD3Config, TD3, TD3Config, DI, dict(), "box"),
    "td3_min": (JaxTD3, JaxTD3Config, TD3, TD3Config, DI,
                dict(clip_double=False, policy_noise=False, twin_delay=False),
                "box"),
    "sac": (JaxSAC, JaxSACConfig, SAC, SACConfig, DI, dict(), "box"),
    "sac_disc": (JaxSAC, JaxSACConfig, SAC, SACConfig, DI_DISC, dict(),
                 "index"),
}

NETS = ("actor", "actor_target", "critic", "critic_target")


def make_pair(name, batch_size=32, **extra):
    """The JAX algo and state, and the port's, the port's four nets
    carrying the JAX init."""
    jcls, jcfg, cls, cfg, di, kw, _ = VARIANTS[name]
    kw = dict(kw, hidden=HIDDEN, batch_size=batch_size, **extra)
    jalgo = jcls(JaxDimInfo(**di), jcfg(**kw))
    jstate = jalgo.init(jax.random.PRNGKey(0))
    algo = cls(DimInfo(**di), cfg(**kw), device="cpu")
    state = algo.init(torch.Generator().manual_seed(0))
    for net in NETS:
        getattr(state, net).load_state_dict(
            net_params_from_flax(_flax_params(jax_net(jstate, net))))
    return jalgo, jstate, algo, state


def jax_net(jstate, net):
    """The flax params of one of the four nets of a JAX learner state."""
    return getattr(jstate, net if "target" in net else net + "_params")


def np_batch(name, n, seed):
    di, form = VARIANTS[name][4], VARIANTS[name][6]
    rng = np.random.RandomState(seed)
    adim = di["action_dim"]
    if form == "box":
        action = rng.uniform(-2, 2, (n, adim)).astype(np.float32)
    elif form == "probs":
        logits = rng.randn(n, adim)
        action = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
                  ).astype(np.float32)
    else:
        action = rng.randint(0, adim, n).astype(np.int32)
    return dict(
        obs=rng.randn(n, di["obs_dim"]).astype(np.float32),
        action=action,
        reward=(rng.randn(n) * 3).astype(np.float32),
        next_obs=rng.randn(n, di["obs_dim"]).astype(np.float32),
        done=rng.rand(n) < 0.2,
        episode_done=rng.rand(n) < 0.3,
    )


def jax_update_draws(name, key, n, adim):
    """The draws the JAX update makes from ``key``, in the port's form."""
    def t(x):
        return torch.from_numpy(np.array(x))

    if name == "ddpg_disc_gumbel":
        return t(jax.random.gumbel(key, (n, adim)))
    if name == "td3":
        return t(jax.random.normal(key, (n, adim)))
    if name == "sac":
        k_next, k_new = jax.random.split(key)
        return (t(jax.random.normal(k_next, (n, adim))),
                t(jax.random.normal(k_new, (n, adim))))
    return None


def assert_net_close(net, flax_params, what):
    want = net_params_from_flax(_flax_params(flax_params))
    got = {k: v.detach().numpy() for k, v in net.state_dict().items()}
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k].numpy(), atol=ATOL,
                                   err_msg=f"{what}: {k}")


# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(VARIANTS))
def test_updates_match_jax(name):
    """Five updates from carried-over params, with the JAX update's draws
    fed in: the four nets, the losses, PopArt's stats and the temperature.
    TD3 at policy_freq 2 runs both branches of the delayed update."""
    jalgo, jstate, algo, state = make_pair(name)
    jupdate = jax.jit(lambda s, b, k: jalgo.update(s, b, key=k)[:2])
    adim = VARIANTS[name][4]["action_dim"]
    for i in range(5):
        b = np_batch(name, 32, seed=i)
        key = jax.random.PRNGKey(100 + i)
        jstate, jm = jupdate(jstate, _jax_t(b), key)
        state, m, _ = algo.update(state, _torch_t(b),
                                  jax_update_draws(name, key, 32, adim))
        assert sorted(m) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=ATOL,
                                       rtol=1e-5, err_msg=f"update {i} {k}")
        for net in NETS:
            assert_net_close(getattr(state, net), jax_net(jstate, net),
                             f"update {i} {net}")
        if name == "ddpg_popart":
            for k in ("mean", "var", "count"):
                np.testing.assert_allclose(
                    getattr(state.popart, k).numpy(),
                    np.asarray(getattr(jstate.popart, k)), rtol=1e-5,
                    atol=ATOL, err_msg=f"update {i} popart {k}")
        if name.startswith("sac"):
            np.testing.assert_allclose(float(state.log_alpha.detach()),
                                       float(jstate.log_alpha), atol=ATOL)
    assert state.step == int(jstate.step) == 5


def test_td3_delays_actor_and_both_targets():
    """policy_freq 2: step 0 moves only the critic; step 1 moves the
    actor and BOTH target nets."""
    _, _, algo, state = make_pair("td3")
    b = _torch_t(np_batch("td3", 32, seed=0))
    g = torch.Generator().manual_seed(0)

    def snap():
        return {net: torch.cat([p.detach().flatten().clone()
                                for p in getattr(state, net).parameters()])
                for net in NETS}

    s0 = snap()
    state, m, _ = algo.update(state, b, algo.draw_update(b, g))
    s1 = snap()
    assert float(m["actor_loss"]) == 0.0
    assert not torch.equal(s0["critic"], s1["critic"])
    for net in ("actor", "actor_target", "critic_target"):
        assert torch.equal(s0[net], s1[net]), net
    state, m, _ = algo.update(state, b, algo.draw_update(b, g))
    s2 = snap()
    for net in NETS:
        assert not torch.equal(s1[net], s2[net]), net


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clipped", "kept"])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.RandomState(4)
    g = [rng.randn(3, 3).astype(np.float32), rng.randn(7).astype(np.float32)]
    tx = optax.clip_by_global_norm(max_norm)
    want, _ = tx.update([jnp.asarray(x) for x in g], tx.init(None))
    got = clip_by_global_norm([torch.from_numpy(x) for x in g], max_norm)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    if max_norm > 10:
        for a, x in zip(got, g):
            np.testing.assert_array_equal(a.numpy(), x)


@pytest.mark.parametrize("scheme", ["torch", "fanin", "final"])
def test_dense_init_schemes(scheme):
    """Weight and bias uniform in +-1/sqrt(fan_in) ('torch', 'fanin') or
    +-3e-3 ('final'), as the JAX package's initializers draw them."""
    layer = Dense(64, 4096, torch.Generator().manual_seed(0), device="cpu",
                  scheme=scheme)
    bound = 3e-3 if scheme == "final" else 1.0 / np.sqrt(64)
    jdense = jax_mlp.Dense(4096, scheme=scheme)
    jp = jdense.init(jax.random.PRNGKey(0), jnp.zeros((1, 64)))["params"]
    for p, jx in ((layer.weight, jp["Dense_0"]["kernel"]),
                  (layer.bias, jp["Dense_0"]["bias"])):
        x = p.detach().numpy()
        assert np.abs(x).max() <= bound
        np.testing.assert_allclose(x.std(), bound / np.sqrt(3), rtol=0.05)
        np.testing.assert_allclose(np.abs(np.asarray(jx)).max(), bound,
                                   rtol=0.01)
    with pytest.raises(ValueError, match="unknown init scheme"):
        Dense(4, 4, device="cpu", scheme="xavier")


def test_mlp_out_scheme_and_ddpg_nets():
    """MLP's out_scheme; DDPG's net_init gives fan-in hidden layers and
    final-uniform heads on both nets."""
    def bound(p):
        return float(p.detach().abs().max())

    net = MLP(8, 4, (32, 32), device="cpu", scheme="fanin", out_scheme="final")
    assert bound(net.head.weight) <= 3e-3 < bound(net.hidden[0].weight)
    algo = DDPG(DimInfo(**DI), DDPGConfig(net_init=True), device="cpu")
    state = algo.init(torch.Generator().manual_seed(0))
    for net in (state.actor, state.critic):
        assert bound(net.head.weight) <= 3e-3 and bound(net.head.bias) <= 3e-3
        assert bound(net.hidden[0].weight) > 3e-3


def _jax_nets():
    from freerl_tpu.algos import ddpg, sac, td3
    return {
        "TanhActor": (ddpg.TanhActor(2, HIDDEN, 2.0), (5,),
                      lambda: TanhActor(5, 2, HIDDEN, 2.0, device="cpu")),
        "SoftmaxActor": (ddpg.SoftmaxActor(3, HIDDEN), (5,),
                         lambda: SoftmaxActor(5, 3, HIDDEN, device="cpu")),
        "QCritic": (ddpg.QCritic(HIDDEN), (5, 2),
                    lambda: QCritic(5, 2, HIDDEN, device="cpu")),
        "TwinQCritic": (td3.TwinQCritic(HIDDEN), (5, 2),
                        lambda: TwinQCritic(7, HIDDEN, device="cpu")),
        "GaussianActor": (sac.GaussianActor(2, HIDDEN), (5,),
                          lambda: GaussianActor(5, 2, HIDDEN, device="cpu")),
        "SoftmaxPolicy": (sac.SoftmaxPolicy(3, HIDDEN), (5,),
                          lambda: SoftmaxPolicy(5, 3, HIDDEN, device="cpu")),
        "TwinQTable": (sac.TwinQTable(3, HIDDEN), (5,),
                       lambda: TwinQTable(5, 3, HIDDEN, device="cpu")),
    }


@pytest.mark.parametrize("name", ["TanhActor", "SoftmaxActor", "QCritic",
                                  "TwinQCritic", "GaussianActor",
                                  "SoftmaxPolicy", "TwinQTable"])
def test_net_forward_matches_flax(name):
    jnet, in_dims, make = _jax_nets()[name]
    rng = np.random.RandomState(1)
    inputs = [rng.randn(16, d).astype(np.float32) for d in in_dims]
    params = jnet.init(jax.random.PRNGKey(2),
                       *[jnp.asarray(x) for x in inputs])["params"]
    if name == "GaussianActor":            # a non-zero log_std, partly clipped
        params = dict(params, log_std=jnp.asarray([0.3, -25.0]))
    net = make()
    net.load_state_dict(net_params_from_flax(_flax_params(params)))
    want = jnet.apply({"params": params}, *[jnp.asarray(x) for x in inputs])
    got = net(*[torch.from_numpy(x) for x in inputs])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=ATOL)


def test_net_params_from_flax_rejects_other_trees():
    with pytest.raises(ValueError, match="twin critic"):
        net_params_from_flax({"q1_0": {}, "Dense_0": {}})
    with pytest.raises(ValueError, match="actor or critic"):
        net_params_from_flax({"Dense_0": {}, "NoisyDense_0": {}})


@pytest.mark.parametrize("case", ["continuous", "stored", "index"])
def test_example_transition_actions(case):
    """The ring's action slot: a float (A,) vector for continuous envs,
    the stored vector of discrete DDPG, the int32 index otherwise."""
    from freerl_tpu_torch.envs import make

    env = make("CartPole-v1" if case != "continuous"
               else "LunarLanderContinuous-v2", device="cpu")
    algo = {"continuous": None,
            "stored": DDPG(env.dim_info, DDPGConfig(), device="cpu"),
            "index": SAC(env.dim_info, SACConfig(), device="cpu")}[case]
    ex = example_transition(env, algo)
    want = {"continuous": ((2,), torch.float32), "stored": ((2,), torch.float32),
            "index": ((), torch.int32)}[case]
    assert (tuple(ex.action.shape), ex.action.dtype) == want


def test_axis_name_raises():
    """An axis_name that no ``make_mesh`` registered raises, naming the axis
    and make_mesh, rather than skipping the gradient all-reduce."""
    for cls, cfg in ((DDPG, DDPGConfig), (TD3, TD3Config), (SAC, SACConfig)):
        with pytest.raises(LookupError, match="'data'.*make_mesh"):
            cls(DimInfo(**DI), cfg(axis_name="data"), device="cpu")
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.train import OffPolicyConfig, train_offpolicy

    env = make("Pendulum-v1", device="cpu")
    with pytest.raises(TypeError, match="make_mesh"):
        train_offpolicy(env, TD3(env.dim_info, TD3Config(), device="cpu"),
                        OffPolicyConfig(), mesh=object())
    with pytest.raises(ValueError, match="continuous"):
        TD3(DimInfo(**DI_DISC), TD3Config(), device="cpu")
