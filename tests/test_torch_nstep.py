"""The port's n-step fold and its PER x n-step learner step against the
JAX package.

The fold and the sample range are compared on a filled ring (4 envs,
n 3, episode ends inside the window, wrapped and not), with the start
offsets fed in from JAX's own draw: indices exactly, the folded return and
``eff_gamma`` to atol 1e-6 (``pow`` and a three-term sum in two
frameworks). The learner step runs Rainbow (PER tree, n 3, noisy, dueling,
C51, double) in both packages from the same ring, uniforms and noise:
the sampled indices exactly, the tree to rtol 1e-6 and params to atol
1e-5, with beta advanced once per step.
"""
import jax
import numpy as np
import pytest
import torch

from freerl_tpu.algos.dqn import DQN as JaxDQN
from freerl_tpu.algos.dqn import DQNConfig as JaxDQNConfig
from freerl_tpu.buffers.nstep import nstep_fold as jax_nstep_fold
from freerl_tpu.buffers.nstep import nstep_sample_range as jax_sample_range
from freerl_tpu.buffers.uniform import ReplayBuffer as JaxReplayBuffer
from freerl_tpu.core.types import DimInfo as JaxDimInfo
from freerl_tpu_torch.algos import DQN, DQNConfig
from freerl_tpu_torch.buffers import NStepAccumulator, ReplayBuffer
from freerl_tpu_torch.buffers.nstep import nstep_count, nstep_sample_range
from freerl_tpu_torch.convert import dqn_params_from_flax
from freerl_tpu_torch.core.types import DimInfo
from tests.test_torch_dqn import _flax_params, _jax_t, _np_batch, _torch_t
from tests.test_torch_dqn_tricks import jax_noise

torch.set_num_threads(1)

N_ENVS, N, GAMMA = 4, 3, 0.99


def _fill(jbuf, tbuf, adds, seed=0):
    for i in range(adds):
        b = _np_batch(N_ENVS, seed=seed + i)
        jbuf = jbuf.add(_jax_t(b))
        tbuf.add(_torch_t(b))
    return jbuf, tbuf


@pytest.mark.parametrize("adds", [6, 15], ids=["filling", "wrapped"])
def test_fold_and_sample_range_match_jax(adds):
    ex = {k: v[0] for k, v in _np_batch(1, 0).items()}
    jbuf = JaxReplayBuffer.create(40, _jax_t(ex), add_batch=N_ENVS)
    tbuf = ReplayBuffer.create(40, _torch_t(ex), add_batch=N_ENVS)
    jbuf, tbuf = _fill(jbuf, tbuf, adds)
    assert (tbuf.size, tbuf.pos) == (int(jbuf.size), int(jbuf.pos))
    key = jax.random.PRNGKey(3)
    jidx = jax_sample_range(jbuf.size, jbuf.capacity, jbuf.pos, N_ENVS, N,
                            key, 256)
    count = nstep_count(tbuf.size, tbuf.capacity, N_ENVS, N)
    assert count == (32 if adds == 15 else 16)
    d = torch.from_numpy(np.array(jax.random.randint(key, (256,), 0, count)))
    idx = nstep_sample_range(tbuf.size, tbuf.capacity, tbuf.pos, d)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))

    jbatch, jg = jax_nstep_fold(jbuf.data, jidx, N_ENVS, N, GAMMA)
    batch, g = NStepAccumulator.fold(tbuf.data, idx, N_ENVS, N, GAMMA)
    for name in ("obs", "action", "next_obs", "done", "episode_done"):
        np.testing.assert_array_equal(getattr(batch, name).numpy(),
                                      np.asarray(getattr(jbatch, name)),
                                      err_msg=name)
    np.testing.assert_allclose(batch.reward.numpy(), np.asarray(jbatch.reward),
                               atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-6)
    # the window is cut at episode ends for some samples, whole for others
    m = np.round(np.log(g.numpy()) / np.log(GAMMA)).astype(int)
    assert set(m) == {1, 2, 3}


def test_sample_range_bounds():
    """Before the ring fills, starts stay below size - (n-1)*stride; once
    full they are offsets from the oldest slot, wrapping."""
    assert nstep_count(10, 40, 4, 3) == 2
    assert nstep_count(4, 40, 4, 3) == 1            # never empty
    assert nstep_count(40, 40, 4, 3) == 32
    d = torch.tensor([0, 5, 31])
    assert nstep_sample_range(20, 40, 20, d).tolist() == [0, 5, 31]
    assert nstep_sample_range(40, 40, 12, d).tolist() == [12, 17, 3]


RAINBOW = dict(double=True, dueling=True, per=True, per_sampler="tree",
               noisy=True, n_step=N, categorical=True, hidden=(32,),
               buffer_size=128, batch_size=64)


def test_per_nstep_learn_step_matches_jax():
    """sample_idx -> nstep_fold -> update -> update_priorities: the port's
    learn_per from JAX's uniforms and noise, three steps on a wrapped ring."""
    jalgo = JaxDQN(JaxDimInfo(8, 4), JaxDQNConfig(**RAINBOW))
    jstate = jalgo.init(jax.random.PRNGKey(0))
    algo = DQN(DimInfo(8, 4), DQNConfig(**RAINBOW), device="cpu")
    state = algo.init(torch.Generator().manual_seed(0))
    sd = dqn_params_from_flax(_flax_params(jstate.params), dueling=True)
    state.net.load_state_dict(sd)
    state.target_net.load_state_dict(sd)
    ex = {k: v[0] for k, v in _np_batch(1, 0).items()}
    jbuf = jalgo.make_buffer(_jax_t(ex), num_envs=N_ENVS)
    tbuf = algo.make_buffer(_torch_t(ex), num_envs=N_ENVS)
    jbuf, tbuf = _fill(jbuf, tbuf, 40, seed=40)     # 160 adds into 128 slots
    learn = jax.jit(lambda s, b, k: jalgo.learn_step(s, b, k, N_ENVS))
    for t in range(3):
        key = jax.random.PRNGKey(10 + t)
        k_s, k_u = jax.random.split(key)
        r = torch.from_numpy(np.array(jax.random.uniform(k_s, (64,))))
        _, jidx, _ = jbuf.sample_idx(k_s, 64)
        noise = tuple(jax_noise(jalgo, jstate.params, k)
                      for k in jax.random.split(k_u, 3))
        beta = float(tbuf.beta)
        jstate, jbuf, jm = learn(jstate, jbuf, key)
        state, tbuf, m = algo.learn_per(state, tbuf, r, N_ENVS, noise)
        msg = f"step {t}"
        np.testing.assert_array_equal(m["idx"].numpy(), np.asarray(jidx),
                                      err_msg=msg)
        assert float(tbuf.beta) == pytest.approx(beta + 1e-3)
        assert float(tbuf.beta) == pytest.approx(float(jbuf.beta))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=msg)
        np.testing.assert_allclose(tbuf.tree.numpy(), np.asarray(jbuf.tree),
                                   rtol=1e-6, err_msg=msg)
        want = dqn_params_from_flax(_flax_params(jstate.params), dueling=True)
        for k, v in state.net.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                       err_msg=f"{msg}: {k}")
