"""The port's DQN, nets, common helpers and replay buffer against the JAX
package, on identical inputs made with numpy.

Parameters move from flax to torch with ``convert.dqn_params_from_flax``.
Tolerance for learner state: atol 1e-5 after five updates (float32 matmul
and Adam rounding in two frameworks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.algos.common import clip_grads_by_norm as jax_clip
from freerl_tpu.algos.common import polyak as jax_polyak
from freerl_tpu.algos.dqn import DQN as JaxDQN
from freerl_tpu.algos.dqn import DQNConfig as JaxDQNConfig
from freerl_tpu.buffers.uniform import ReplayBuffer as JaxReplayBuffer
from freerl_tpu.core.types import DimInfo as JaxDimInfo
from freerl_tpu.core.types import Transition as JaxTransition
from freerl_tpu_torch.algos import DQN, DQNConfig, ExploreCtx, QNetwork
from freerl_tpu_torch.algos.common import clip_grads_by_norm, polyak
from freerl_tpu_torch.buffers import PERBuffer, ReplayBuffer
from freerl_tpu_torch.convert import dqn_params_from_flax
from freerl_tpu_torch.core.types import DimInfo, Transition
from freerl_tpu_torch.nets import Dense

torch.set_num_threads(1)

ATOL = 1e-5


def _np_batch(n, seed, obs_dim=8, n_actions=4):
    rng = np.random.RandomState(seed)
    return dict(
        obs=rng.randn(n, obs_dim).astype(np.float32),
        action=rng.randint(0, n_actions, n).astype(np.int32),
        reward=rng.randn(n).astype(np.float32),
        next_obs=rng.randn(n, obs_dim).astype(np.float32),
        done=rng.rand(n) < 0.2,
        episode_done=rng.rand(n) < 0.3,
    )


def _jax_t(d):
    return JaxTransition(**{k: jnp.asarray(v) for k, v in d.items()})


def _torch_t(d):
    return Transition(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()})


def _flax_params(params):
    return jax.tree.map(np.asarray, params)


def _torch_flat(net):
    return {k: v.detach().numpy() for k, v in net.state_dict().items()}


def _assert_params_close(net, flax_params, what):
    want = dqn_params_from_flax(_flax_params(flax_params))
    got = _torch_flat(net)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k].numpy(), atol=ATOL,
                                   err_msg=f"{what}: {k}")


# --------------------------------------------------------------------------
@pytest.mark.parametrize("weighted", [True, False], ids=["per", "uniform"])
def test_updates_match_jax(weighted):
    """Five updates on identical batches (and IS weights) from carried-over
    params: params, target params and priorities match."""
    jalgo = JaxDQN(JaxDimInfo(obs_dim=8, action_dim=4), JaxDQNConfig())
    jstate = jalgo.init(jax.random.PRNGKey(0))
    algo = DQN(DimInfo(obs_dim=8, action_dim=4), DQNConfig(), device="cpu")
    state = algo.init(torch.Generator().manual_seed(0))
    sd = dqn_params_from_flax(_flax_params(jstate.params))
    state.net.load_state_dict(sd)
    state.target_net.load_state_dict(sd)
    jupdate = jax.jit(jalgo.update)
    for i in range(5):
        b = _np_batch(64, seed=i)
        w = np.random.RandomState(100 + i).rand(64).astype(np.float32)
        w = w if weighted else None
        jstate, jm, jprio = jupdate(jstate, _jax_t(b), None,
                                    None if w is None else jnp.asarray(w))
        state, m, prio = algo.update(
            state, _torch_t(b), None, None if w is None else torch.from_numpy(w))
        np.testing.assert_allclose(prio.numpy(), np.asarray(jprio), atol=ATOL)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        _assert_params_close(state.net, jstate.params, f"update {i} params")
        _assert_params_close(state.target_net, jstate.target_params,
                             f"update {i} target")
    assert state.step == int(jstate.step) == 5


@pytest.mark.parametrize("hidden", [(128,), (64, 32)])
def test_convert_forward_matches_flax(hidden):
    jalgo = JaxDQN(JaxDimInfo(obs_dim=8, action_dim=4),
                   JaxDQNConfig(hidden=hidden))
    params = jalgo.init(jax.random.PRNGKey(1)).params
    net = QNetwork(8, 4, hidden, device="cpu")
    net.load_state_dict(dqn_params_from_flax(_flax_params(params)))
    obs = np.random.RandomState(2).randn(32, 8).astype(np.float32)
    want = np.asarray(jalgo.net.apply({"params": params}, jnp.asarray(obs)))
    got = net(torch.from_numpy(obs)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_polyak_matches_jax():
    rng = np.random.RandomState(3)
    t = [rng.randn(4, 5).astype(np.float32), rng.randn(5).astype(np.float32)]
    o = [rng.randn(4, 5).astype(np.float32), rng.randn(5).astype(np.float32)]
    want = jax_polyak([jnp.asarray(x) for x in t], [jnp.asarray(x) for x in o],
                      0.01)
    tt = [torch.from_numpy(x.copy()) for x in t]
    polyak(tt, [torch.from_numpy(x) for x in o], 0.01)
    for a, b in zip(tt, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clipped", "kept"])
def test_clip_grads_by_norm_matches_jax(max_norm):
    rng = np.random.RandomState(4)
    g = [rng.randn(3, 3).astype(np.float32), rng.randn(7).astype(np.float32)]
    want = jax_clip([jnp.asarray(x) for x in g], max_norm)
    got = clip_grads_by_norm([torch.from_numpy(x) for x in g], max_norm)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_dense_init_is_torch_default():
    layer = Dense(128, 4096, torch.Generator().manual_seed(0), device="cpu")
    bound = 1.0 / np.sqrt(128)
    for p in (layer.weight, layer.bias):
        x = p.detach().numpy()
        assert np.abs(x).max() <= bound
        np.testing.assert_allclose(x.std(), bound / np.sqrt(3), rtol=0.05)
    assert layer.weight.shape == (4096, 128)      # torch layout (out, in)


@pytest.mark.parametrize("trick", [
    dict(obs_shape=(8, 8, 1), axis_name="data"), dict(axis_name="data"),
], ids=lambda d: next(iter(d)))
def test_unported_tricks_raise(trick):
    """An axis_name that no ``make_mesh`` registered raises, naming the axis
    and make_mesh, rather than skipping the gradient all-reduce."""
    with pytest.raises(LookupError, match="'data'.*make_mesh"):
        DQN(DimInfo(obs_dim=8, action_dim=4), DQNConfig(**trick), device="cpu")


def test_make_buffer_mirrors_jax():
    """PER rounds to a power of two; the uniform ring rounds up to the env
    batch and, like the JAX DQN, ignores bf16_replay."""
    ex = {k: v[0] for k, v in _np_batch(1, 0).items()}
    jex, tex = _jax_t(ex), _torch_t(ex)
    for cfg in (dict(per=True), dict(bf16_replay=True)):
        jbuf = JaxDQN(JaxDimInfo(8, 4), JaxDQNConfig(buffer_size=1000, **cfg)
                      ).make_buffer(jex, num_envs=48)
        tbuf = DQN(DimInfo(8, 4), DQNConfig(buffer_size=1000, **cfg),
                   device="cpu").make_buffer(tex, num_envs=48)
        assert tbuf.capacity == jbuf.capacity
        assert isinstance(tbuf, PERBuffer if cfg.get("per") else ReplayBuffer)
        if not cfg.get("per"):
            assert tbuf.capacity == 1008
            assert not tbuf.bf16_storage and not jbuf.bf16_storage
            assert tbuf.data.obs.dtype == torch.float32


@pytest.mark.parametrize("add_batch", [0, 16], ids=["scatter", "contiguous"])
def test_replay_ring_matches_jax(add_batch):
    ex = {k: v[0] for k, v in _np_batch(1, 0).items()}
    jbuf = JaxReplayBuffer.create(40, _jax_t(ex), add_batch=add_batch)
    tbuf = ReplayBuffer.create(40, _torch_t(ex), add_batch=add_batch)
    assert tbuf.capacity == jbuf.capacity
    for i in range(4):                            # wraps the ring
        b = _np_batch(16, seed=10 + i)
        jbuf = jbuf.add(_jax_t(b))
        tbuf.add(_torch_t(b))
    assert (tbuf.pos, tbuf.size) == (int(jbuf.pos), int(jbuf.size))
    for name in ("obs", "action", "reward", "next_obs", "done"):
        np.testing.assert_array_equal(getattr(tbuf.data, name).numpy(),
                                      np.asarray(getattr(jbuf.data, name)))
    idx = tbuf.sample_idx(torch.Generator().manual_seed(0), 500)
    assert int(idx.min()) >= 0 and int(idx.max()) < tbuf.size
    if add_batch:
        with pytest.raises(ValueError, match="add_batch=16"):
            tbuf.add(_torch_t(_np_batch(8, seed=0)))


def test_replay_bf16_storage_matches_jax():
    ex = {k: v[0] for k, v in _np_batch(1, 0).items()}
    jbuf = JaxReplayBuffer.create(32, _jax_t(ex), bf16_storage=True,
                                  add_batch=16)
    tbuf = ReplayBuffer.create(32, _torch_t(ex), bf16_storage=True,
                               add_batch=16)
    b = _np_batch(16, seed=5)
    jbuf = jbuf.add(_jax_t(b))
    tbuf.add(_torch_t(b))
    assert tbuf.data.obs.dtype == torch.bfloat16
    idx = np.arange(16)
    got = tbuf.gather(torch.from_numpy(idx))
    want = jbuf.gather(jnp.asarray(idx))
    assert got.obs.dtype == torch.float32
    for name in ("obs", "reward", "action"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


def test_explore_greedy_random_and_warmup():
    algo = DQN(DimInfo(8, 4), DQNConfig(epsilon=0.0), device="cpu")
    g = torch.Generator().manual_seed(0)
    state = algo.init(g)
    obs = torch.randn(256, 8, generator=g)
    ctx = ExploreCtx(total_env_steps=10_000, episodes=torch.tensor(0),
                     done_prev=torch.zeros(256, dtype=torch.bool))
    _, a = algo.explore(state, obs, g, ctx)
    assert torch.equal(a, state.net(obs).argmax(-1))
    warm = ExploreCtx(total_env_steps=0, episodes=torch.tensor(0),
                      done_prev=torch.zeros(256, dtype=torch.bool),
                      random_steps=100)
    _, a = algo.explore(state, obs, g, warm)
    assert not torch.equal(a, state.net(obs).argmax(-1))
    assert set(a.tolist()) == {0, 1, 2, 3}
