"""The port's MAPPO / IPPO against the JAX package: flax's LayerNorm, the
new loss helpers, the actor and critic nets, ``sample_action`` and one
``update`` of each branch of ``tests/test_marl_onpolicy.py`` plus the
attention critic, from the same params, rollout and draws.

Params move from flax to torch with ``convert.mappo_state_from_flax``.
Rollouts are made with numpy from a seed (some steps end an episode, some
of those by truncation). The draws are JAX's: agent i's Gumbel noise or
normals from ``fold_in(key, i)``, and its permutations from
``fold_in(key, i)`` then one split per epoch. Sizes: T 8, N 4, K_epochs 2,
hidden (32, 32): one minibatch of 32 per epoch, so two Adam steps per
agent. Tolerances: the LayerNorm and the nets' outputs within 1e-6 (atol,
rtol 1e-6), sampled actions and log-probs within 1e-5; after an update
every param within 1e-5 bar at most one element in 10,000 (an Adam step
on a gradient that is float noise moves a weight by up to the lr between
two frameworks) and none past the lr, the metrics within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.algos import common as jax_common
from freerl_tpu.algos import mappo as jax_mappo
from freerl_tpu.algos.ppo import Rollout as JaxRollout
from freerl_tpu.envs import make as jax_make
from freerl_tpu.envs.masked import MaskedSpread as JaxMaskedSpread
from freerl_tpu_torch.algos import IPPO, MAPPO, MAPPOConfig, Rollout, common
from freerl_tpu_torch.algos.mappo import (AgentActor, AgentVCritic,
                                          SharedAttnVCritics)
from freerl_tpu_torch.convert import _agent_net, _attn_critics
from freerl_tpu_torch.convert import mappo_state_from_flax
from freerl_tpu_torch.envs import MaskedSpread
from freerl_tpu_torch.envs import make
from freerl_tpu_torch.nets.norm import LayerNorm

torch.set_num_threads(1)

ATOL = 1e-5
T, N, K = 8, 4, 2
HIDDEN = (32, 32)


def env_pair(name):
    if name == "masked":
        return JaxMaskedSpread(), MaskedSpread(device="cpu")
    return jax_make(name), make(name, device="cpu")


def t(x):
    return torch.from_numpy(np.array(x))


def flax_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def np_rollout(env, seed, per_dim_logp=False, t_len=T, n=N):
    """A (T, N) multi-agent rollout in ``env``'s layout; episodes end on
    about one step in ten, a third of those by truncation."""
    rng = np.random.RandomState(seed)
    a, di = env.n_agents, env.dim_info
    if di.is_continue:
        action = rng.uniform(-1, 1, (t_len, n, a, di.action_dim))
    else:
        action = rng.randint(0, di.action_dim, (t_len, n, a))
    lp_shape = (t_len, n, a) + ((di.action_dim,) if per_dim_logp else ())
    ends = rng.rand(t_len, n) < 0.1
    return dict(
        obs=rng.randn(t_len, n, a, di.obs_dim).astype(np.float32),
        action=action.astype(np.float32 if di.is_continue else np.int32),
        log_pi=(rng.randn(*lp_shape) * 0.1 - 1.6).astype(np.float32),
        reward=rng.randn(t_len, n, a).astype(np.float32),
        next_obs=rng.randn(t_len, n, a, di.obs_dim).astype(np.float32),
        done=ends & (rng.rand(t_len, n) < 0.67),
        adv_done=ends)


def rollouts(roll):
    """The numpy rollout as the JAX package's and the port's Rollout."""
    return (JaxRollout(**{k: jnp.asarray(v) for k, v in roll.items()}),
            Rollout(**{k: t(v).long() if k == "action" and v.dtype == np.int32
                       else t(v) for k, v in roll.items()}))


def jax_agent_perms(key, n_agents, k_epochs, b):
    """Agent i's epoch permutations: fold_in(key, i), then per epoch
    ``k, k_perm = split(k)``; (A, K, B) int64."""
    out = np.zeros((n_agents, k_epochs, b), np.int64)
    for i in range(n_agents):
        k = jax.random.fold_in(key, i)
        for e in range(k_epochs):
            k, k_perm = jax.random.split(k)
            out[i, e] = np.asarray(jax.random.permutation(k_perm, b))
    return t(out)


def jax_action_draws(key, act_dims, is_continue, b, lead=0):
    """Agent i's noise from fold_in(key, i), laid out (b, A, P) (or
    (A, b, P) with ``lead``, MAT's layout)."""
    a, p = len(act_dims), max(act_dims)
    out = np.zeros((b, a, p), np.float32)
    for i, d in enumerate(act_dims):
        k = jax.random.fold_in(key, i)
        out[:, i, :d] = (jax.random.normal(k, (b, d)) if is_continue
                         else jax.random.gumbel(k, (b, d)))
    return t(out.transpose(1, 0, 2) if lead else out)


def assert_close_lists(got, want, what, lr):
    """Two lists of tensors (every param of two states): within ATOL bar
    one element in 10,000, none past ``lr``."""
    diffs = []
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape, what
        d = (g.detach() - w.detach()).abs().flatten()
        diffs.append(d)
    d = torch.cat(diffs)
    assert float(d.max()) <= lr, f"{what}: max {float(d.max())}"
    past = int((d > ATOL).sum())
    assert past <= d.numel() // 10_000, (
        f"{what}: {past} of {d.numel()} past {ATOL} (max {float(d.max())})")


def state_params(state) -> list:
    """Every net parameter of a MAPPO / HAPPO state, in a fixed order."""
    out = []
    for nets in (state.actors, state.critics):
        for net in nets if isinstance(nets, list) else [nets]:
            out += [p for _, p in sorted(net.state_dict().items())]
    return out


def port_state(algo, jstate):
    state = algo.init(torch.Generator().manual_seed(1))
    mappo_state_from_flax(algo, state, flax_numpy(jstate))
    return state


# --------------------------------------------------------------------------
def test_layer_norm_matches_flax():
    """flax's epsilon (1e-6, torch's is 1e-5) and fast variance, within
    1e-6; the stacked form applies one norm per leading row."""
    from flax import linen as fnn

    rng = np.random.RandomState(0)
    x = (rng.randn(64, 24) * 3 + 1).astype(np.float32)
    x[0] = 5.0                          # a constant row: variance 0
    scale = rng.randn(24).astype(np.float32)
    bias = rng.randn(24).astype(np.float32)
    want = np.asarray(fnn.LayerNorm().apply(
        {"params": {"scale": scale, "bias": bias}}, x))
    ln = LayerNorm(24, "cpu")
    ln.load_state_dict({"scale": t(scale), "bias": t(bias)})
    got = ln(t(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # flax differs from torch's layer_norm past 1e-6 on small variances
    small = (x[:8] * 1e-3).astype(np.float32)
    ref = torch.nn.functional.layer_norm(t(small), (24,)).numpy()
    flax_small = np.asarray(fnn.LayerNorm().apply(
        {"params": {"scale": np.ones(24, np.float32),
                    "bias": np.zeros(24, np.float32)}}, small))
    assert np.abs(ref - flax_small).max() > 1e-3
    stacked = LayerNorm(24, "cpu", n=2)
    with torch.no_grad():
        stacked.scale.copy_(t(np.stack([scale, scale * 2])))
        stacked.bias.copy_(t(np.stack([bias, -bias])))
    got = stacked(t(x)).detach().numpy()            # (B, D) broadcast
    want2 = np.asarray(fnn.LayerNorm().apply(
        {"params": {"scale": scale * 2, "bias": -bias}}, x))
    np.testing.assert_allclose(got[0], want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1], want2, rtol=1e-6, atol=1e-6)


def test_loss_helpers_match_jax():
    rng = np.random.RandomState(1)
    x = (rng.randn(256) * 20).astype(np.float32)
    v, old, ret = (rng.randn(256).astype(np.float32) for _ in range(3))
    ratio = np.exp(rng.randn(256) * 0.3).astype(np.float32)
    np.testing.assert_allclose(common.huber(t(x)).numpy(),
                               np.asarray(jax_common.huber(x)), rtol=1e-6)
    np.testing.assert_allclose(
        common.clipped_surrogate(t(ratio), t(v), 0.2).numpy(),
        np.asarray(jax_common.clipped_surrogate(ratio, v, 0.2)), rtol=1e-6)
    for use_huber in (False, True):
        np.testing.assert_allclose(
            common.value_clip_loss(t(v), t(old), t(ret) * 30, 0.2,
                                   use_huber).numpy(),
            np.asarray(jax_common.value_clip_loss(v, old, ret * 30, 0.2,
                                                  use_huber)),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tricks", [
    dict(), dict(orthogonal=True, layer_norm=True, feature_norm=True)],
    ids=["plain", "norms"])
def test_nets_match_jax(tricks):
    """AgentActor (both action kinds), AgentVCritic and the attention
    critics on the same params and inputs, within 1e-6; the stacked nets
    give each agent's own output."""
    rng = np.random.RandomState(2)
    x = rng.randn(16, 18).astype(np.float32)
    kw = dict(hidden=HIDDEN, **tricks)
    for cont in (True, False):
        jnet = jax_mappo.AgentActor(5, cont, **kw)
        params = jnet.init(jax.random.PRNGKey(0), x)["params"]
        net = AgentActor(18, 5, cont, device="cpu", **kw)
        cfg = MAPPOConfig(feature_norm=tricks.get("feature_norm", False))
        net.load_state_dict(_agent_net(flax_numpy(params), cfg))
        want = jnet.apply({"params": params}, x)
        got = net(t(x))
        for g, w in zip(got if cont else [got], want if cont else [want]):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-6)
    jc = jax_mappo.AgentVCritic(**kw)
    trees = [jc.init(jax.random.PRNGKey(s), x)["params"] for s in (3, 4)]
    stacked = AgentVCritic(18, device="cpu", n=2, **kw)
    sds = [_agent_net(flax_numpy(p), cfg) for p in trees]
    stacked.load_state_dict({k: torch.stack([s[k] for s in sds])
                             for k in sds[0]})
    got = stacked(t(x)).detach().numpy()
    for j, p in enumerate(trees):
        np.testing.assert_allclose(got[j], np.asarray(jc.apply(
            {"params": p}, x)), rtol=1e-6, atol=1e-6)
    obs = [rng.randn(16, d).astype(np.float32) for d in (8, 10, 10)]
    ja = jax_mappo.SharedAttnVCritics((8, 10, 10))
    params = ja.init(jax.random.PRNGKey(5), obs)["params"]
    att = SharedAttnVCritics((8, 10, 10), device="cpu")
    att.load_state_dict(_attn_critics(flax_numpy(params)))
    np.testing.assert_allclose(
        att([t(o) for o in obs]).detach().numpy(),
        np.asarray(ja.apply({"params": params}, obs)), rtol=1e-6, atol=1e-6)


# name: (env, config fields, IPPO?, the loop path on homogeneous agents?)
VARIANTS = {
    "mappo": ("simple_spread_v3", dict(), False, False),
    "mappo_12tricks": ("simple_spread_v3", dict(
        adv_norm=True, obs_norm=True, reward_scaling=True,
        orthogonal_init=True, adam_eps=True, lr_decay=True, value_clip=True,
        huber_loss=True, layer_norm=True, feature_norm=True, num_envs=4),
        False, False),
    "ippo_hetero": ("simple_adversary_v3", dict(), True, False),
    "attention": ("simple_spread_v3", dict(attention=True), False, False),
    "mappo_loop": ("simple_spread_v3", dict(value_clip=True), False, True),
}


def make_pair(name):
    env_name, kw, ippo, loop = VARIANTS[name]
    jenv, env = env_pair(env_name)
    kw = dict(kw, K_epochs=K, hidden=HIDDEN)
    if ippo:
        jalgo = jax_mappo.IPPO(jenv, jax_mappo.MAPPOConfig(**kw))
        algo = IPPO(env, MAPPOConfig(**kw), device="cpu")
    else:
        jalgo = jax_mappo.MAPPO(jenv, jax_mappo.MAPPOConfig(**kw))
        algo = MAPPO(env, MAPPOConfig(**kw), device="cpu")
    if loop:
        jalgo._stackable = algo._stackable = False
    return jenv, env, jalgo, algo


def check_sample(jalgo, algo, jstate, state, env, seed):
    """sample_action and evaluate_action on the same obs and draws."""
    rng = np.random.RandomState(seed)
    obs = rng.randn(6, env.n_agents, env.dim_info.obs_dim).astype(np.float32)
    if getattr(algo.cfg, "masked", False):         # a valid mask tail
        m = algo.cfg.mask_dim
        obs[..., -m:] = rng.rand(6, env.n_agents, m) < 0.6
        obs[..., -m] = 1.0
    key = jax.random.PRNGKey(seed)
    want = jalgo.sample_action(jstate, jnp.asarray(obs), key)
    got = algo.sample_action(state, t(obs), jax_action_draws(
        key, algo.act_dims, algo.is_continue, 6))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(
        algo.evaluate_action(state, t(obs)).numpy(),
        np.asarray(jalgo.evaluate_action(jstate, jnp.asarray(obs))),
        rtol=1e-5, atol=1e-5)


def check_update(jalgo, algo, jenv, env, jstate, state, episodes=5):
    """One update from the same params, rollout and draws; returns the
    updated port state and the JAX one."""
    jroll, roll = rollouts(np_rollout(env, 3))
    key = jax.random.PRNGKey(7)
    jstate2, jm = jax.jit(lambda s, k: jalgo.update(
        s, jroll, k, episodes=jnp.int32(episodes)))(jstate, key)
    draws = jax_agent_perms(key, env.n_agents, K, T * N)
    state, m = algo.update(state, roll, draws, episodes=torch.tensor(episodes))
    want = port_state(algo, jstate2)
    lr = max(algo.cfg.actor_lr, algo.cfg.critic_lr)
    assert_close_lists(state_params(state), state_params(want), "update", lr)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=ATOL)
    return state, jstate2


@pytest.mark.parametrize("name", list(VARIANTS))
def test_sample_and_update_match_jax(name):
    jenv, env, jalgo, algo = make_pair(name)
    assert algo.cfg.max_grad_norm == jalgo.cfg.max_grad_norm
    assert algo._stackable == jalgo._stackable
    jstate = jalgo.init(jax.random.PRNGKey(0))
    state = port_state(algo, jstate)
    check_sample(jalgo, algo, jstate, state, env, 11)
    state, jstate2 = check_update(jalgo, algo, jenv, env, jstate, state)
    check_sample(jalgo, algo, jstate2, state, env, 12)
    assert state.step == int(jstate2.step) == 1


def test_config_defaults_and_validators():
    """The clip defaults per variant, MAPPO's unread critic_lr kept, the
    JAX validators."""
    spread = make("simple_spread_v3", device="cpu")
    disc = make("simple_spread_v3", continuous_actions=False, device="cpu")
    assert MAPPO(spread, device="cpu").cfg.max_grad_norm is None
    assert MAPPO(disc, device="cpu").cfg.max_grad_norm == 10.0
    assert MAPPO(spread, MAPPOConfig(attention=True),
                 device="cpu").cfg.max_grad_norm == 0.5
    assert IPPO(spread, device="cpu").cfg.max_grad_norm == 0.5
    assert MAPPOConfig().critic_lr == 5e-4
    for bad, match in ((dict(reward_norm=True, reward_scaling=True), "both"),
                       (dict(masked=True), "mask_dim"),
                       (dict(attention=True, independent=True), "central"),
                       (dict(state_dim=2, independent=True), "state")):
        with pytest.raises(ValueError, match=match):
            MAPPOConfig(**bad)
    with pytest.raises(LookupError, match="'d'.*make_mesh"):
        MAPPO(spread, MAPPOConfig(axis_name="d"), device="cpu")
