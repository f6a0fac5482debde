"""The port's pixel stack against the JAX package: ``ConvTrunk`` (both
archs, through ``convert.py``), ``PixelCartPole`` (teacher-forced
auto-resetting steps from the JAX env's state and draws), the
``EpisodeBuffer`` (exact, an add larger than the ring included), and one
DQN and one PPO update through a conv trunk.

Tolerances: the trunk's forward within 1e-5 (float32 convolutions summed
in another order); PixelCartPole's frames, observations, rewards and flags
exact (the renderer's float operations are the JAX package's, in its
order), its inner state within rtol 1e-5 / atol 1e-6 as CartPole's
(tests/test_torch_classic.py); the buffer exact; updates within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.algos.dqn import DQN as JaxDQN
from freerl_tpu.algos.dqn import DQNConfig as JaxDQNConfig
from freerl_tpu.algos.ppo import PPO as JaxPPO
from freerl_tpu.algos.ppo import PPOConfig as JaxPPOConfig
from freerl_tpu.algos.ppo import Rollout as JaxRollout
from freerl_tpu.buffers.episode import EpisodeBuffer as JaxEpisodeBuffer
from freerl_tpu.core.types import DimInfo as JaxDimInfo
from freerl_tpu.envs import step_auto_reset as jax_step_auto_reset
from freerl_tpu.envs.pixel import PixelCartPole as JaxPixelCartPole
from freerl_tpu.nets.cnn import ConvTrunk as JaxConvTrunk
from freerl_tpu_torch.algos import DQN, PPO, DQNConfig, PPOConfig, Rollout
from freerl_tpu_torch.buffers import EpisodeBuffer
from freerl_tpu_torch.convert import (conv_params_from_flax,
                                      dqn_params_from_flax,
                                      net_params_from_flax)
from freerl_tpu_torch.core.types import DimInfo, Transition
from freerl_tpu_torch.envs import make, step_auto_reset
from freerl_tpu_torch.envs.classic import CartPoleState
from freerl_tpu_torch.envs.pixel import PixelCartPole, PixelCartPoleState
from freerl_tpu_torch.nets import ConvTrunk
from tests.test_torch_dqn import _flax_params, _jax_t, _torch_t
from tests.test_torch_ppo import jax_perms

torch.set_num_threads(1)

ATOL = 1e-5
ARCHS = {"small": (12, 12, 2), "nature": (36, 36, 4)}


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_conv_trunk_matches_flax(arch):
    """The flax trunk's params through ``convert.py``: the same features
    for (B, H*W*C) and (2, B, H*W*C) inputs; the port's own init is flax's
    he_uniform with zero biases."""
    shape = ARCHS[arch]
    flat = int(np.prod(shape))
    jtrunk = JaxConvTrunk(obs_shape=shape, features=24, arch=arch)
    x = np.random.RandomState(0).rand(2, 5, flat).astype(np.float32)
    params = jtrunk.init(jax.random.PRNGKey(0), jnp.asarray(x[0]))["params"]
    trunk = ConvTrunk(shape, 24, arch, device="cpu")
    trunk.load_state_dict(conv_params_from_flax(_flax_params(params)))
    for xs in (x[0], x):
        want = np.asarray(jtrunk.apply({"params": params}, jnp.asarray(xs)))
        got = trunk(torch.from_numpy(xs)).detach().numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL)
    fresh = ConvTrunk(shape, 24, arch, torch.Generator().manual_seed(0),
                      device="cpu")
    for w, b in zip(fresh.convs, fresh.biases):
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        assert float(w.detach().abs().max()) <= np.sqrt(6.0 / fan_in)
        assert not b.any()


def _jax_reset_draw(k):
    return jax.random.uniform(k, (4,), jnp.float32, -0.05, 0.05)


def _port_state(js) -> PixelCartPoleState:
    inner = CartPoleState(**{f.name: _t(getattr(js.inner, f.name))
                             for f in dataclasses.fields(CartPoleState)})
    return PixelCartPoleState(inner=inner, frames=_t(js.frames))


def test_pixel_cartpole_matches_jax():
    """200 auto-resetting steps of 16 envs, each from the JAX env's state
    with its reset draws; some rows start near the truncation horizon."""
    n, steps = 16, 200
    jenv, env = JaxPixelCartPole(), make("PixelCartPole-v1", device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    jstate, jobs = jax.vmap(jenv.reset)(keys)
    _, obs = env.reset(_t(jax.vmap(_jax_reset_draw)(keys)))
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    jstate = jstate.replace(inner=jstate.inner.replace(
        t=jnp.asarray(np.arange(n) * 31 % 500, jnp.int32)))
    jstep = jax.jit(jax.vmap(lambda s, a, k: jax_step_auto_reset(
        jenv, s, a, k)))
    rows = np.arange(n)
    for t in range(steps):
        key = jax.random.fold_in(jax.random.PRNGKey(1), t)
        ks = jax.random.split(key, n)
        reset = jax.vmap(lambda k: _jax_reset_draw(jax.random.split(k)[1]))(
            ks)
        action = ((rows + t // 3) % 2).astype(np.int32)
        want = jstep(jstate, jnp.asarray(action), ks)
        got = step_auto_reset(env, _port_state(jstate), _t(action), None,
                              _t(reset))
        for field in ("next_obs", "carry_obs", "reward", "terminated",
                      "truncated"):
            np.testing.assert_array_equal(
                getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                err_msg=f"step {t}: {field}")
        np.testing.assert_array_equal(got.state.frames.numpy(),
                                      np.asarray(want.state.frames))
        for f in dataclasses.fields(CartPoleState):
            np.testing.assert_allclose(
                getattr(got.state.inner, f.name).numpy(),
                np.asarray(getattr(want.state.inner, f.name)), rtol=1e-5,
                atol=1e-6, err_msg=f"step {t}: {f.name}")
        jstate = want.state
    img = got.next_obs.numpy().reshape((n,) + env.obs_shape)
    assert set(np.unique(img)) <= set(np.float32([0.0, 0.3, 0.7, 1.0]))


def _traj(n, T, seed):
    rng = np.random.RandomState(seed)
    done = rng.rand(n, T) < 0.25
    return dict(obs=rng.randn(n, T, 3).astype(np.float32),
                action=rng.randint(0, 4, (n, T)).astype(np.int32),
                reward=rng.randn(n, T).astype(np.float32),
                next_obs=rng.randn(n, T, 3).astype(np.float32),
                done=done, episode_done=done | (rng.rand(n, T) < 0.1))


def test_episode_buffer_matches_jax():
    """One-episode and batched adds (one of 7 into a ring of 3), the flat
    view, the mask, the counters, whole-episode gathers and ``clear``."""
    cap, T = 3, 5
    ex = {k: v[0, 0] for k, v in _traj(1, T, 0).items()}
    jbuf = JaxEpisodeBuffer.create(cap, T, _jax_t(ex))
    buf = EpisodeBuffer.create(cap, T, _torch_t(ex))
    for i, n in enumerate((1, 2, 7, 1)):
        tr = _traj(n, T, i + 1)
        if n == 1:
            one = {k: v[0] for k, v in tr.items()}
            jbuf = jbuf.add_episode(_jax_t(one))
            buf.add_episode(_torch_t(one))
        else:
            jbuf = jbuf.add_episodes(_jax_t(tr))
            buf.add_episodes(_torch_t(tr))
        assert (buf.ep_pos, len(buf)) == (int(jbuf.ep_pos), len(jbuf))
        (flat, mask), (jflat, jmask) = buf.all(), jbuf.all()
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        for f in dataclasses.fields(Transition):
            np.testing.assert_array_equal(getattr(flat, f.name).numpy(),
                                          np.asarray(getattr(jflat, f.name)))
    key = jax.random.PRNGKey(3)
    jeps, jm = jbuf.sample_episodes(key, 4)
    idx = jax.random.randint(key, (4,), 0, jnp.maximum(jbuf.ep_count, 1))
    eps, m = buf.gather(_t(idx).long())
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(eps.obs.numpy(), np.asarray(jeps.obs))
    buf.clear()
    assert len(buf) == buf.ep_pos == 0 and not buf.valid.any()


def _pixel_batch(n, shape, seed):
    rng = np.random.RandomState(seed)
    flat = int(np.prod(shape))
    done = rng.rand(n) < 0.2
    return dict(obs=rng.rand(n, flat).astype(np.float32),
                action=rng.randint(0, 2, n).astype(np.int32),
                reward=rng.randn(n).astype(np.float32),
                next_obs=rng.rand(n, flat).astype(np.float32),
                done=done, episode_done=done)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_dqn_update_through_conv_trunk(arch):
    """Three DQN updates with a conv trunk (the trunk before the hidden
    layers) from the JAX params: params and target within 1e-5."""
    shape = ARCHS[arch]
    kw = dict(obs_shape=shape, conv_arch=arch, cnn_features=16,
              hidden=(16,), batch_size=8, double=True)
    di = dict(obs_dim=int(np.prod(shape)), action_dim=2)
    jalgo = JaxDQN(JaxDimInfo(**di), JaxDQNConfig(**kw))
    jstate = jalgo.init(jax.random.PRNGKey(0))
    algo = DQN(DimInfo(**di), DQNConfig(**kw), device="cpu")
    state = algo.init(torch.Generator().manual_seed(0))
    sd = dqn_params_from_flax(_flax_params(jstate.params))
    state.net.load_state_dict(sd)
    state.target_net.load_state_dict(sd)
    jupdate = jax.jit(jalgo.update)
    for i in range(3):
        b = _pixel_batch(8, shape, i)
        jstate, jm, _ = jupdate(jstate, _jax_t(b))
        state, m, _ = algo.update(state, _torch_t(b))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5, atol=1e-6)
    for net, jp in ((state.net, jstate.params),
                    (state.target_net, jstate.target_params)):
        want = dqn_params_from_flax(_flax_params(jp))
        got = net.state_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       atol=ATOL, err_msg=k)


def test_ppo_update_through_conv_trunks():
    """One PPO update (2 epochs) with the actor's and the critic's own
    small trunks, from the JAX params and permutations."""
    shape = ARCHS["small"]
    kw = dict(obs_shape=shape, cnn_features=16, hidden=(16,), K_epochs=2,
              minibatch_size=16, horizon=32)
    di = dict(obs_dim=int(np.prod(shape)), action_dim=2)
    jalgo = JaxPPO(JaxDimInfo(**di), JaxPPOConfig(**kw))
    jstate = jalgo.init(jax.random.PRNGKey(0))
    algo = PPO(DimInfo(**di), PPOConfig(**kw), device="cpu")
    state = algo.init(torch.Generator().manual_seed(0))
    assert state.actor.conv is not state.critic.conv
    for net, jp in ((state.actor, jstate.actor_params),
                    (state.critic, jstate.critic_params)):
        net.load_state_dict(net_params_from_flax(_flax_params(jp)))
    rng = np.random.RandomState(1)
    t, n = 8, 4
    done = rng.rand(t, n) < 0.1
    roll = dict(obs=rng.rand(t, n, di["obs_dim"]).astype(np.float32),
                action=rng.randint(0, 2, (t, n)).astype(np.int32),
                log_pi=(rng.randn(t, n) * 0.1 - 0.7).astype(np.float32),
                reward=rng.randn(t, n).astype(np.float32),
                next_obs=rng.rand(t, n, di["obs_dim"]).astype(np.float32),
                done=done, adv_done=done)
    key = jax.random.PRNGKey(7)
    jstate, jm = jax.jit(lambda s, k: jalgo.update(
        s, JaxRollout(**{a: jnp.asarray(v) for a, v in roll.items()}), k))(
        jstate, key)
    state, m = algo.update(
        state, Rollout(**{a: torch.from_numpy(v) for a, v in roll.items()}),
        jax_perms(key, 2, t * n))
    for net, jp in ((state.actor, jstate.actor_params),
                    (state.critic, jstate.critic_params)):
        want = net_params_from_flax(_flax_params(jp))
        got = net.state_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       atol=ATOL, err_msg=k)


def test_pixel_dqn_drives_train_offpolicy():
    """A short pixel-DQN run through the port's ``train_offpolicy``."""
    from freerl_tpu_torch.train import OffPolicyConfig, train_offpolicy

    env = make("PixelCartPole-v1", device="cpu")
    assert isinstance(env, PixelCartPole)
    algo = DQN(env.dim_info, DQNConfig(
        buffer_size=2_000, batch_size=16, hidden=(16,),
        obs_shape=env.obs_shape, conv_arch="small", cnn_features=16),
        device="cpu")
    cfg = OffPolicyConfig(num_envs=4, max_episodes=4, max_env_steps=400,
                          start_steps=64, chunk_size=25)
    _, returns, info = train_offpolicy(env, algo, cfg)
    assert info["updates"] > 0 and len(returns) >= 1
    assert np.isfinite(returns).all() and returns.min() >= 1


@pytest.mark.parametrize("arch", list(ARCHS))
def test_conv_trunk_bit_equal_to_plain_conv2d(arch, monkeypatch):
    """The trunk's deterministic convolution computes what ``F.conv2d``
    computes on the CPU, bit for bit: the features, and the gradients of
    every parameter and of the input."""
    import torch.nn.functional as F

    from freerl_tpu_torch.nets import cnn

    shape = ARCHS[arch]
    trunk = ConvTrunk(shape, 24, arch, torch.Generator().manual_seed(3),
                      device="cpu")
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.rand(6, int(np.prod(shape))).astype(np.float32))
    g = torch.from_numpy(rng.randn(6, 24).astype(np.float32))
    outs = []
    for conv in (cnn.conv2d, F.conv2d):
        monkeypatch.setattr(cnn, "conv2d", conv)
        trunk.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_(True)
        y = trunk(xi)
        y.backward(g)
        outs.append([y.detach(), xi.grad]
                    + [p.grad for p in trunk.parameters()])
    assert len(outs[0]) == 2 + len(list(trunk.parameters()))
    for got, want in zip(*outs):
        assert torch.equal(got, want)


@pytest.mark.parametrize("flags", [(True, False, False, True),
                                   (True, True, False, False)])
def test_conv_trunk_leaves_cudnn_flags_as_found(flags):
    """Inside the trunk's convolutions, forward and backward, cuDNN runs
    deterministic algorithms without autotuning, with ``enabled`` and
    ``allow_tf32`` as the caller set them; after them every flag reads
    what it read before."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cudnn = torch.backends.cudnn
    names = ("enabled", "benchmark", "deterministic", "allow_tf32")
    seen = {}

    class Flags(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name.startswith("convolution"):
                seen.setdefault(name, []).append(
                    tuple(getattr(cudnn, n) for n in names))
            return func(*args, **(kwargs or {}))

    before = tuple(getattr(cudnn, n) for n in names)
    try:
        for n, v in zip(names, flags):
            setattr(cudnn, n, v)
        trunk = ConvTrunk(ARCHS["small"], 8, "small", device="cpu")
        x = torch.rand(3, int(np.prod(ARCHS["small"])), requires_grad=True)
        with Flags():
            trunk(x).sum().backward()
        after = tuple(getattr(cudnn, n) for n in names)
    finally:
        for n, v in zip(names, before):
            setattr(cudnn, n, v)
    assert after == flags
    inside = (flags[0], False, True, flags[3])
    assert sorted(seen) == ["convolution", "convolution_backward"]
    assert all(len(v) == 2 and set(v) == {inside} for v in seen.values())
