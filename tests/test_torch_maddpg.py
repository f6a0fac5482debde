"""The port's MADDPG family against the JAX package: one learner step of
MADDPG, ATT-MADDPG, MADDPG with the Gaussian actor
(``actor_learn_way="1"``) and MADDPG (with ``regular``) on a
heterogeneous world comm, and two steps of MATD3 (one of them delayed),
from the same params, replay and draws; exploration; the ``flax`` init
scheme; ``gelu``.

Parameters move from flax to torch with ``convert.marl_state_from_flax``.
The draws are recomputed from the JAX learner step's key: each agent's
``(k_s, k_pn)`` split gives its replay indices (``randint``) and, folded
per next-action agent, MATD3's smoothing normals and the Gaussian actor's
samples. Tolerance: atol 1e-5 for params, targets and losses after each
step (float32 matmul and Adam rounding in two frameworks), as for the
single-agent family, bar at most one weight in 10,000 whose gradient is
float noise (``assert_states_close``). Nets are narrow (hidden 32; the ATT
critic's width is fixed at 128), spread has 2 agents and world comm 3 (the
9-wide leader, one adversary, one good agent).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.algos import maddpg as jax_maddpg
from freerl_tpu.algos.base import ExploreCtx as JaxExploreCtx
from freerl_tpu.core.types import Transition as JaxTransition
from freerl_tpu.envs import mpe as jax_mpe
from freerl_tpu.nets import mlp as jax_mlp
from freerl_tpu.train.marl import _example_transition as jax_example
from freerl_tpu_torch.algos import (MADDPG, MATD3, ExploreCtx, LearnDraws,
                                    MADDPGConfig)
from freerl_tpu_torch.convert import marl_state_from_flax, net_params_from_flax
from freerl_tpu_torch.core.types import Transition
from freerl_tpu_torch.envs import mpe
from freerl_tpu_torch.nets import MLP, Dense
from freerl_tpu_torch.train.marl import example_transition

torch.set_num_threads(1)

ATOL = 1e-5
HIDDEN = (32, 32)
BATCH, ROWS = 32, 64

ENVS = {
    "spread": ("SimpleSpread", dict(N=2)),
    "world_comm": ("SimpleWorldComm", dict(num_good=1, num_adversaries=2)),
    "spread_disc": ("SimpleSpread", dict(N=2, continuous_actions=False)),
}

# name: (env, config fields, JAX learner steps)
VARIANTS = {
    "maddpg": ("spread", dict(), 1),
    "matd3": ("spread", dict(twin=True), 2),
    "att": ("spread", dict(att_critic=True, att_heads=4), 1),
    "learn_way_1": ("spread", dict(actor_learn_way="1"), 1),
    "world_comm": ("world_comm", dict(regular=True), 1),
}


def env_pair(name):
    cls, kw = ENVS[name]
    return getattr(jax_mpe, cls)(**kw), getattr(mpe, cls)(device="cpu", **kw)


def np_rows(env, n, seed):
    """Random replay rows of env's layout; padded tails are random too."""
    rng = np.random.RandomState(seed)
    a, di = env.n_agents, env.dim_info
    if di.is_continue:
        action = rng.uniform(-1, 1, (n, a, di.action_dim)).astype(np.float32)
    else:
        action = rng.randint(0, di.action_dim, (n, a)).astype(np.int32)
    return dict(
        obs=rng.randn(n, a, di.obs_dim).astype(np.float32),
        action=action,
        reward=(rng.randn(n, a) * 3).astype(np.float32),
        next_obs=rng.randn(n, a, di.obs_dim).astype(np.float32),
        done=rng.rand(n) < 0.2,
        episode_done=rng.rand(n) < 0.3,
    )


def buffers(jalgo, jenv, algo, env, seed=0):
    """The JAX and the port's replay, holding the same ROWS rows."""
    rows = np_rows(env, ROWS, seed)
    jbuf = jalgo.make_buffer(jax_example(jenv), num_envs=ROWS).add(
        JaxTransition(**{k: jnp.asarray(v) for k, v in rows.items()}))
    buf = algo.make_buffer(example_transition(env), num_envs=ROWS).add(
        Transition(**{k: torch.from_numpy(v) for k, v in rows.items()}))
    return jbuf, buf


def flax_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def port_state_of(algo, jstate):
    """A port learner state carrying a JAX learner state's nets."""
    state = algo.init(torch.Generator().manual_seed(1))
    marl_state_from_flax(state, flax_numpy(jstate))
    return state


NET_FIELDS = ("actors", "actor_targets", "critics", "critic_targets",
              "critic", "critic_target")


def assert_states_close(state, want, what, lr=5e-4):
    """Every net (and temperature) of two port learner states, within ATOL.
    Adam's first step moves a weight by ``lr * g / (|g| + 1e-8)``: where a
    gradient is float noise (|g| ~ 1e-9, a cancellation) that step differs
    between frameworks by up to ``lr``, so at most one element in 10,000 may
    be past ATOL, and none past ``lr``."""
    diffs = []
    for field in NET_FIELDS:
        if not hasattr(state, field):
            continue
        nets, wants = getattr(state, field), getattr(want, field)
        if not isinstance(nets, list):
            nets, wants = [nets], [wants]
        for k, (net, ref) in enumerate(zip(nets, wants)):
            got, exp = net.state_dict(), ref.state_dict()
            assert sorted(got) == sorted(exp)
            for name in exp:
                d = (got[name] - exp[name]).abs().flatten()
                diffs.append(d)
                assert float(d.max()) <= lr, f"{what}: {field}[{k}] {name}"
    d = torch.cat(diffs)
    assert int((d > ATOL).sum()) <= d.numel() // 10_000, (
        f"{what}: {int((d > ATOL).sum())} of {d.numel()} past {ATOL}")
    if hasattr(state, "log_alphas"):
        np.testing.assert_allclose(
            [float(x.detach()) for x in state.log_alphas],
            [float(x.detach()) for x in want.log_alphas], atol=ATOL,
            err_msg=what)


def assert_metrics_close(m, jm, what, skip=()):
    assert sorted(m) == sorted(jm), what
    for k in jm:
        if k not in skip:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=ATOL,
                                       rtol=1e-5, err_msg=f"{what} {k}")


def t(x):
    return torch.from_numpy(np.array(x))


def jax_maddpg_draws(algo, key, size):
    """The draws of one JAX MADDPG learner step from ``key``."""
    cfg, n, p = algo.cfg, algo.n_agents, algo.act_pad
    b, ad = cfg.batch_size, algo.act_dims
    idx = np.zeros((n, b), np.int64)
    smooth = np.zeros((n, b, n, p), np.float32)
    nxt = np.zeros((n, b, n, p), np.float32)
    new = np.zeros((b, n, p), np.float32)
    for i in range(n):
        k_s, k_pn, key = jax.random.split(key, 3)
        idx[i] = jax.random.randint(k_s, (b,), 0, size)
        for j in range(n):
            smooth[i, :, j, :ad[j]] = jax.random.normal(
                jax.random.fold_in(k_pn, j), (b, ad[j]))
            nxt[i, :, j, :ad[j]] = jax.random.normal(
                jax.random.fold_in(k_pn, 100 + j), (b, ad[j]))
        new[:, i, :ad[i]] = jax.random.normal(
            jax.random.fold_in(k_pn, 200 + i), (b, ad[i]))
    gaussian = cfg.actor_learn_way == "1"
    return LearnDraws(idx=t(idx), smooth=t(smooth) if cfg.twin else None,
                      next=t(nxt) if gaussian else None,
                      new=t(new) if gaussian else None)


def make_maddpg(name):
    env_name, kw, steps = VARIANTS[name]
    jenv, env = env_pair(env_name)
    kw = dict(kw, hidden=HIDDEN, batch_size=BATCH, buffer_size=256)
    jalgo = jax_maddpg.MADDPG(jenv, jax_maddpg.MADDPGConfig(**kw))
    algo = MADDPG(env, MADDPGConfig(**kw), device="cpu")
    return jenv, env, jalgo, algo, steps


# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(VARIANTS))
def test_learn_step_matches_jax(name):
    """Learner steps from carried-over params and the same replay, with the
    JAX step's draws fed in: every net and target, and the losses. MATD3's
    first step is its delayed one: the actors, their Adam states and their
    targets keep still, the critic targets move."""
    jenv, env, jalgo, algo, steps = make_maddpg(name)
    jstate = jalgo.init(jax.random.PRNGKey(0))
    state = port_state_of(algo, jstate)
    jbuf, buf = buffers(jalgo, jenv, algo, env)
    jlearn = jax.jit(lambda s, b, k: jalgo.learn_step(s, b, k, ROWS))
    for step in range(steps):
        key = jax.random.PRNGKey(10 + step)
        before = [p.detach().clone() for a in state.actors
                  for p in a.parameters()]
        jstate, jbuf, jm = jlearn(jstate, jbuf, key)
        state, m = algo.update(state, buf,
                               jax_maddpg_draws(algo, key, ROWS))
        delayed = algo.cfg.twin and step == 0
        assert_metrics_close(m, jm, f"{name} step {step}",
                             skip=[k for k in jm if "actor" in k]
                             if delayed else ())
        assert_states_close(state, port_state_of(algo, jstate),
                            f"{name} step {step}")
        moved = [not torch.equal(p0, p.detach()) for p0, p in zip(
            before, (p for a in state.actors for p in a.parameters()))]
        assert not any(moved) if delayed else all(moved)
        if delayed:
            assert all(not o.state for o in state.actor_opts)
            assert all(float(m[f"actor_loss_{i}"]) == 0.0 for i in range(2))
    assert state.step == int(jstate.step) == steps


def test_matd3_factory_and_att_refuses_twin():
    _, env = env_pair("spread")
    assert MATD3(env, device="cpu").cfg.twin
    assert MATD3(env, MADDPGConfig(gauss_sigma=0.3), device="cpu").cfg == (
        MADDPGConfig(gauss_sigma=0.3, twin=True))
    with pytest.raises(ValueError, match="single-Q"):
        MADDPG(env, MADDPGConfig(att_critic=True, twin=True), device="cpu")
    _, disc = env_pair("spread_disc")
    with pytest.raises(ValueError, match="continuous"):
        MADDPG(disc, device="cpu")


@pytest.mark.parametrize("learn_way", ["0", "1"])
def test_explore_matches_jax(learn_way):
    """Exploration on world comm from the JAX explore's draws: the policy's
    action plus decayed noise on every column (the padded tail too),
    clipped to [-1, 1]; and the warm-up's uniform actions."""
    jenv, env = env_pair("world_comm")
    kw = dict(hidden=HIDDEN, actor_learn_way=learn_way)
    jalgo = jax_maddpg.MADDPG(jenv, jax_maddpg.MADDPGConfig(**kw))
    algo = MADDPG(env, MADDPGConfig(**kw), device="cpu")
    jstate = jalgo.init(jax.random.PRNGKey(0))
    state = port_state_of(algo, jstate)
    n, a, p = 16, algo.n_agents, algo.act_pad
    obs = np.random.RandomState(0).randn(n, a, env.dim_info.obs_dim
                                         ).astype(np.float32)
    key = jax.random.PRNGKey(7)
    for episodes, total, random_steps in ((300, 0, 0), (0, 8, 64)):
        jctx = JaxExploreCtx(total_env_steps=jnp.int32(total),
                             episodes=jnp.int32(episodes),
                             done_prev=jnp.zeros(n, bool),
                             random_steps=random_steps)
        _, want = jax.jit(jalgo.explore)(jstate, jnp.asarray(obs), key, jctx)
        k_n, k_r, k_s = jax.random.split(key, 3)
        policy = np.zeros((n, a, p), np.float32)
        for i, d in enumerate(algo.act_dims):
            policy[:, i, :d] = jax.random.normal(jax.random.fold_in(k_s, i),
                                                 (n, d))
        ctx = ExploreCtx(total_env_steps=total,
                         episodes=torch.tensor(episodes),
                         done_prev=torch.zeros(n, dtype=torch.bool),
                         random_steps=random_steps)
        draws = algo.draw_explore(n, torch.Generator().manual_seed(0), ctx)
        assert draws.normal.shape == (n, a, p)
        assert (draws.policy is not None) == (learn_way == "1")
        assert (draws.random is not None) == (random_steps > 0)
        draws.normal = t(jax.random.normal(k_n, (n, a, p)))
        draws.policy = t(policy) if learn_way == "1" else None
        if random_steps:
            draws.random = t(jax.random.uniform(k_r, (n, a, p), jnp.float32,
                                                -1.0, 1.0))
        _, got = algo.explore_with(state, torch.from_numpy(obs), draws, ctx)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        assert got.shape == (n, a, p) and got.abs().max() <= 1.0
        if episodes == 300:          # half the noise on the padded tail
            assert (got[:, 1:, 5:] != 0).all()


# --------------------------------------------------------------------------
def test_flax_init_scheme_matches_flax_lecun_normal():
    """``Dense(scheme="flax")``: the weight's std within 1% of flax's
    ``lecun_normal`` (1/sqrt(fan_in)), truncated at 2 / 0.8796 / sqrt(fan_in)
    as flax's is; a zero bias; ``bias=False`` has no bias parameter."""
    fan_in, out = 256, 512
    layer = Dense(fan_in, out, torch.Generator().manual_seed(0), "cpu", "flax")
    w = layer.weight.detach().numpy()
    kernel = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (fan_in, out)))
    bound = 2.0 / 0.87962566103423978 / np.sqrt(fan_in)
    for x in (w, kernel):
        assert abs(x.std() / (1 / np.sqrt(fan_in)) - 1) < 0.01
        assert np.abs(x).max() <= bound * (1 + 1e-6)
        assert np.abs(x).max() > 0.95 * bound
    assert abs(w.std() / kernel.std() - 1) < 0.01
    assert (layer.bias == 0).all()
    no_bias = Dense(fan_in, out, None, "cpu", "flax", bias=False)
    assert no_bias.bias is None and len(list(no_bias.parameters())) == 1
    x = torch.randn(3, fan_in)
    assert torch.equal(no_bias(x), x @ no_bias.weight.T)
    with pytest.raises(ValueError, match="bias"):
        Dense(4, 4, None, "cpu", "torch", bias=False)


def test_gelu_mlp_matches_jax():
    """``MLP(activation="gelu")`` is flax's ``nn.gelu``, the tanh form
    (ROADMAP queue C, fault C1), within 1e-5 of the JAX MLP."""
    jnet = jax_mlp.MLP(out_dim=3, hidden=(16, 16), activation="gelu")
    x = np.random.RandomState(0).uniform(-6, 6, (64, 5)).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    net = MLP(5, 3, (16, 16), "gelu", device="cpu")
    net.load_state_dict(net_params_from_flax(flax_numpy(params)))
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    z = torch.linspace(-6, 6, 1001)
    np.testing.assert_allclose(net.act(z).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(z.numpy()))),
                               atol=1e-6)


def test_convert_refuses_unknown_trees():
    from freerl_tpu_torch.convert import (att_critic_params_from_flax,
                                          maac_critics_params_from_flax)

    layer = {"kernel": np.zeros((2, 2)), "bias": np.zeros(2)}
    with pytest.raises(ValueError, match="ATTCritic"):
        att_critic_params_from_flax({"fc_obs_0": layer, "fc_enc": layer})
    with pytest.raises(ValueError, match="MAACCritics"):
        maac_critics_params_from_flax({"enc_s_0": {"Dense_0": layer}})
    with pytest.raises(ValueError, match="multi-agent"):
        marl_state_from_flax(dataclasses.make_dataclass("S", ["step"])(0),
                             None)
