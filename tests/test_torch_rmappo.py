"""The port's GRU nets and rMAPPO / rIPPO against the JAX package.

The GRU cell, the recurrent trunks, actors and critics run on the same
params (``convert.rmappo_state_from_flax``) and inputs, resets included.
An update runs on a short rollout whose hidden states (the extras) come
from stepping the JAX ``sample_action`` through it, resets and all, with
the same per-agent permutations of the sequences (``fold_in(key, i)``,
one split per epoch). Sizes: T 8, N 4, K_epochs 2, hidden (32,),
rnn_hidden 16; chunk lengths 4 (two chunks per env) and 3 (T 8 has no
such divisor: the chunks fall back to 2 steps). Tolerances: the cell,
trunks and nets within 1e-6, sampling within 1e-5; after an update every
param within 1e-5 bar one element in 10,000, none past the lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.algos import rmappo as jax_rmappo
from freerl_tpu.nets import rnn as jax_rnn
from freerl_tpu_torch.algos import RIPPO, RMAPPO, HiddenCarry, RMAPPOConfig
from freerl_tpu_torch.convert import _agent_net, rmappo_state_from_flax
from freerl_tpu_torch.nets.rnn import (GRUCell, RecurrentActor,
                                       RecurrentVCritic)
from tests.test_torch_mappo import (ATOL, N, T, assert_close_lists, env_pair,
                                    flax_numpy, jax_action_draws, np_rollout,
                                    rollouts, t)

torch.set_num_threads(1)

H = 16


def test_gru_cell_matches_flax():
    """flax's GRUCell parameters and gates; ``in``'s and ``hn``'s biases
    only on the input side and ``hn``."""
    from flax import linen as fnn

    rng = np.random.RandomState(0)
    x = rng.randn(12, 8).astype(np.float32)
    h = rng.randn(12, H).astype(np.float32)
    cell = fnn.GRUCell(features=H)
    params = cell.init(jax.random.PRNGKey(0), jnp.asarray(h),
                       jnp.asarray(x))["params"]
    params = jax.tree.map(lambda p: p + 0.1, params)    # nonzero biases
    want, _ = cell.apply({"params": params}, jnp.asarray(h), jnp.asarray(x))
    port = GRUCell(8, H, device="cpu")
    sd = {f"dense.{k}.{'weight' if n == 'kernel' else n}":
          t(v.T if n == "kernel" else v)
          for k, layer in flax_numpy(params).items() for n, v in layer.items()}
    port.load_state_dict(sd)
    assert {k for k in sd if k.endswith("bias")} == {
        "dense.ir.bias", "dense.iz.bias", "dense.in.bias", "dense.hn.bias"}
    np.testing.assert_allclose(port(t(h), t(x)).detach().numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layer_norm", [False, True], ids=["plain", "ln"])
def test_recurrent_nets_match_jax(layer_norm):
    """Actor (both action kinds) and critic, one step each from a hidden
    state that half the rows reset."""
    rng = np.random.RandomState(1)
    x = rng.randn(10, 18).astype(np.float32)
    h = rng.randn(10, H).astype(np.float32)
    reset = np.arange(10) % 2 == 0
    kw = dict(hidden=(32,), rnn_hidden=H, layer_norm=layer_norm)
    cfg = RMAPPOConfig(layer_norm=layer_norm)
    for cont in (True, False):
        jnet = jax_rnn.RecurrentActor(5, cont, **kw)
        params = jnet.init(jax.random.PRNGKey(2), x, h, reset)["params"]
        net = RecurrentActor(18, 5, cont, device="cpu", **kw)
        net.load_state_dict(_agent_net(flax_numpy(params), cfg, True))
        (wout, wh), (gout, gh) = (jnet.apply({"params": params}, x, h, reset),
                                  net(t(x), t(h), t(reset)))
        for g, w in zip((*gout, gh) if cont else (gout, gh),
                        (*wout, wh) if cont else (wout, wh)):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-6)
    jc = jax_rnn.RecurrentVCritic(**kw)
    params = jc.init(jax.random.PRNGKey(3), x, h, reset)["params"]
    critic = RecurrentVCritic(18, device="cpu", **kw)
    critic.load_state_dict(_agent_net(flax_numpy(params), cfg, True))
    for g, w in zip(critic(t(x), t(h), t(reset)),
                    jc.apply({"params": params}, x, h, reset)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-6)


# name: (env, config fields, rIPPO?)
VARIANTS = {
    "rmappo_disc": ("simple_spread_v3 discrete", dict(
        value_clip=True, huber_loss=True, adv_norm=True, layer_norm=True,
        data_chunk_length=4), False),
    "rippo_cont": ("simple_spread_v3", dict(data_chunk_length=3, lr_decay=True,
                                            orthogonal_init=True), True),
}


def make_pair(name):
    env_name, kw, independent = VARIANTS[name]
    if env_name.endswith("discrete"):
        from freerl_tpu.envs import make as jax_make
        from freerl_tpu_torch.envs import make

        jenv = jax_make("simple_spread_v3", continuous_actions=False)
        env = make("simple_spread_v3", continuous_actions=False,
                   device="cpu")
    else:
        jenv, env = env_pair(env_name)
    kw = dict(kw, K_epochs=2, hidden=(32,), rnn_hidden=H, minibatch_size=8)
    if independent:
        return (jenv, env, jax_rmappo.RIPPO(jenv, jax_rmappo.RMAPPOConfig(
            **kw)), RIPPO(env, RMAPPOConfig(**kw), device="cpu"))
    return (jenv, env, jax_rmappo.RMAPPO(jenv, jax_rmappo.RMAPPOConfig(**kw)),
            RMAPPO(env, RMAPPOConfig(**kw), device="cpu"))


def port_state(algo, jstate):
    state = algo.init(torch.Generator().manual_seed(1))
    rmappo_state_from_flax(algo, state, flax_numpy(jstate))
    return state


def params_of(state):
    return [p for nets in (state.actors, state.critics) for net in nets
            for _, p in sorted(net.state_dict().items())]


def jax_rollout_extras(jalgo, jstate, env, roll, seed):
    """Step the JAX sample_action through the rollout's obs from a
    nonzero carry, with the rollout's episode ends as the resets; returns
    the stacked extras (numpy) and each step's outputs."""
    n, a = roll["obs"].shape[1:3]
    rng = np.random.RandomState(seed)
    carry = jax_rmappo.HiddenCarry(
        h_actor=jnp.asarray(rng.randn(n, a, H).astype(np.float32) * 0.3),
        h_critic=jnp.asarray(rng.randn(n, a, H).astype(np.float32) * 0.3))
    done_prev = jnp.zeros((n,), jnp.bool_)
    extras, outs = [], []
    sample = jax.jit(jalgo.sample_action)
    for step in range(roll["obs"].shape[0]):
        key = jax.random.PRNGKey(100 + step)
        out = sample(jstate, jnp.asarray(roll["obs"][step]), key, carry,
                     done_prev)
        carry, ex = out[3], out[4]
        extras.append(flax_numpy(ex))
        outs.append((key, out, done_prev))
        done_prev = jnp.asarray(roll["adv_done"][step])
    stacked = {k: np.stack([e[k] for e in extras]) for k in extras[0]}
    return stacked, outs


@pytest.mark.parametrize("name", list(VARIANTS))
def test_rmappo_matches_jax(name):
    """sample_action step by step (actions, log-probs, the carry, the
    extras), then one update on the rollout with those extras."""
    jenv, env, jalgo, algo = make_pair(name)
    jstate = jalgo.init(jax.random.PRNGKey(0))
    state = port_state(algo, jstate)
    roll = np_rollout(env, 8)
    extras, outs = jax_rollout_extras(jalgo, jstate, env, roll, 9)
    for step, (key, want, done_prev) in enumerate(outs):
        carry = HiddenCarry(h_actor=t(extras["h_actor"][step]),
                            h_critic=t(extras["h_critic"][step]))
        got = algo.sample_action(
            state, t(roll["obs"][step]),
            jax_action_draws(key, algo.act_dims, algo.is_continue, N),
            carry, t(np.asarray(done_prev)))
        for g, w in zip(got[:3], want[:3], strict=True):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)
        for g, w in ((got[3].h_actor, want[3].h_actor),
                     (got[3].h_critic, want[3].h_critic)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)
        assert got[4]["h_actor"] is carry.h_actor
    jroll, proll = rollouts(roll)
    key = jax.random.PRNGKey(17)
    jstate2, jm = jax.jit(lambda s, k, ex: jalgo.update(
        s, jroll, k, episodes=jnp.int32(30), extras=ex))(
        jstate, key, {k: jnp.asarray(v) for k, v in extras.items()})
    L, S, _, _ = algo._chunks(T, N)
    assert (L, S) == ((4, 8) if name == "rmappo_disc" else (2, 16))
    perms = np.zeros((env.n_agents, 2, S), np.int64)
    for i in range(env.n_agents):
        k = jax.random.fold_in(key, i)
        for e in range(2):
            k, k_perm = jax.random.split(k)
            perms[i, e] = np.asarray(jax.random.permutation(k_perm, S))
    state, m = algo.update(state, proll, t(perms),
                           episodes=torch.tensor(30),
                           extras={k: t(v) for k, v in extras.items()})
    assert_close_lists(params_of(state), params_of(port_state(algo, jstate2)),
                       name, 5e-4)
    np.testing.assert_allclose(float(m["adv_mean"]), float(jm["adv_mean"]),
                               rtol=1e-5, atol=ATOL)
    with pytest.raises(ValueError, match="extras"):
        algo.update(state, proll, t(perms))


def test_hidden_reset_on_done_matches_zero_hidden():
    """A done_prev row samples as a fresh zero hidden state would, whatever
    the carry holds (the JAX package's test, on the port)."""
    _, env, _, algo = make_pair("rmappo_disc")
    state = algo.init(torch.Generator().manual_seed(0))
    obs = torch.randn(4, env.n_agents, env.dim_info.obs_dim,
                      generator=torch.Generator().manual_seed(1))
    draws = algo.draw_action(4, torch.Generator().manual_seed(2))
    zero = algo.init_policy_carry(4)
    garbage = HiddenCarry(zero.h_actor + 7.0, zero.h_critic + 7.0)
    _, _, logp_a, ca, _ = algo.sample_action(state, obs, draws, garbage,
                                             torch.ones(4, dtype=torch.bool))
    _, _, logp_b, cb, _ = algo.sample_action(state, obs, draws, zero,
                                             torch.zeros(4, dtype=torch.bool))
    np.testing.assert_allclose(logp_a.numpy(), logp_b.numpy(), rtol=1e-6)
    np.testing.assert_allclose(ca.h_actor.numpy(), cb.h_actor.numpy(),
                               rtol=1e-6)
    assert ca.h_actor.shape == (4, env.n_agents, H)
