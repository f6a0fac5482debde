"""The port's multi-agent driver, ``train_marl``, and the shared episode
recorder (ROADMAP queue C, fault C2).

``record_episodes`` is held to the JAX drivers' rules on the same inputs:
a multi-agent ``(N, A)`` reward keeps its agent axis
(``freerl_tpu/train/marl.py:151-159``); a single-agent reward, and a
multi-objective one scalarized by its ``record_weights``, as the
off-policy loop records them. ``train_marl`` runs MADDPG (continuous,
remapped to the MPE box [0, 1] at the env) and MAAC (discrete, on the
masked spread) on the CPU: the record equals each agent's sum of the raw
rewards, the learner bursts as the host rule says, and the episode count
follows the 25-step truncation. The driver's own draws come from torch's
generator, so its runs are not compared with JAX's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.envs.base import record_scalarize as jax_record_scalarize
from freerl_tpu_torch.algos import MAAC, MADDPG, MAACConfig, MADDPGConfig
from freerl_tpu_torch.envs import MaskedSpread, mpe
from freerl_tpu_torch.train import MARLConfig, train_marl
from freerl_tpu_torch.train.loop import LoopCarry, record_episodes

torch.set_num_threads(1)


def jax_record(record, reward, dones, ep_return, ep_counter):
    """The JAX drivers' record step (``train/marl.py:151-159``; the
    single-agent loop's is the same on a scalarized reward)."""
    ret = ep_return + reward
    offs = jnp.cumsum(dones.astype(jnp.int32)) - 1
    slot = jnp.where(dones, ep_counter + offs, record.shape[0])
    record = record.at[slot].set(ret, mode="drop")
    return (record, ep_counter + jnp.sum(dones.astype(jnp.int32)),
            jnp.where(dones.reshape(dones.shape + (1,) * (ret.ndim - 1)),
                      0.0, ret))


class TwoObjective:
    record_weights = (0.5, 0.5)


class TwoAgents:
    n_agents = 2


@pytest.mark.parametrize("kind", ["multi_agent", "single_agent",
                                  "multi_objective"])
def test_record_episodes_matches_the_jax_rule(kind):
    """Four steps of 5 envs: the record, the counter and the running
    returns equal the JAX rule's; slots past the record drop."""
    rng = np.random.RandomState(0)
    n, cap = 5, 6
    shape = {"multi_agent": (n, 3), "single_agent": (n,),
             "multi_objective": (n, 2)}[kind]
    env = {"multi_agent": TwoAgents(), "single_agent": object(),
           "multi_objective": TwoObjective()}[kind]
    tail = shape[1:] if kind == "multi_agent" else ()
    c = LoopCarry(algo_state=None, buffer=None, env_state=None, obs=None,
                  ep_return=torch.zeros((n,) + tail),
                  done_prev=torch.zeros(n, dtype=torch.bool),
                  ep_counter=torch.tensor(0),
                  episode_returns=torch.zeros((cap + 1,) + tail))
    ep_return, counter = jnp.zeros((n,) + tail), jnp.int32(0)
    record = jnp.zeros((cap,) + tail)
    for step in range(4):
        reward = rng.randn(*shape).astype(np.float32)
        dones = rng.rand(n) < 0.6
        record_episodes(env, c, torch.from_numpy(reward),
                        torch.from_numpy(dones), cap)
        r = jnp.asarray(reward)
        if kind == "multi_objective":
            r = jax_record_scalarize(env, r)
        record, counter, ep_return = jax_record(record, r, jnp.asarray(dones),
                                                ep_return, counter)
        np.testing.assert_allclose(c.episode_returns[:cap].numpy(),
                                   np.asarray(record), atol=1e-6)
        np.testing.assert_allclose(c.ep_return.numpy(), np.asarray(ep_return),
                                   atol=1e-6)
        assert int(c.ep_counter) == int(counter)
    assert int(c.ep_counter) > cap          # some finished past the record


class RecordingSpread(mpe.SimpleSpread):
    """simple_spread that keeps each step's actions, rewards and flags."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.log = []

    def step(self, state, actions, step_draw=None):
        out = super().step(state, actions, step_draw)
        self.log.append((actions.clone(), out[2].clone(),
                         (out[3] | out[4]).clone()))
        return out


def expected_record(log) -> np.ndarray:
    """Each env's per-agent float32 running sums, recorded where its
    episode ends, in the order episodes end (env order within a step)."""
    run, out = None, []
    for _, reward, done in log:
        run = reward.clone() if run is None else run + reward
        out.append(run[done])
        run = torch.where(done[:, None], 0.0, run)
    return torch.cat(out).numpy()


def test_train_marl_maddpg_record_bursts_and_remap():
    env = RecordingSpread(N=2, device="cpu")
    algo = MADDPG(env, MADDPGConfig(hidden=(16, 16), batch_size=16,
                                    buffer_size=1024), device="cpu")
    cfg = MARLConfig(num_envs=4, chunk_size=20, max_env_steps=4 * 60,
                     max_episodes=10**6, start_steps=40, random_steps=24,
                     updates_per_burst=2)
    state, returns, info = train_marl(env, algo, cfg)
    # 60 vector steps: learn once t * 4 > 40, two learner steps each
    assert info["updates"] == 2 * sum(1 for t in range(1, 61) if 4 * t > 40)
    assert state.step == info["updates"]
    assert info["episodes"] == 4 * (60 // 25) and returns.shape == (8, 2)
    np.testing.assert_array_equal(returns, expected_record(env.log))
    acts = torch.stack([a for a, _, _ in env.log])
    assert acts.min() >= 0.0 and acts.max() <= 1.0
    assert acts.shape == (60, 4, 2, 5)


def test_train_marl_maac_on_masked_spread():
    env = MaskedSpread(N=3, device="cpu")
    algo = MAAC(env, MAACConfig(hidden=(16, 16), batch_size=16,
                                buffer_size=1024, attention_dim=16),
                device="cpu")
    cfg = MARLConfig(num_envs=2, chunk_size=25, max_env_steps=2 * 50,
                     max_episodes=10**6, start_steps=20)
    state, returns, info = train_marl(env, algo, cfg)
    assert info["updates"] == sum(1 for t in range(1, 51) if 2 * t > 20)
    assert returns.shape == (4, 3) and np.isfinite(returns).all()
    assert state.step == info["updates"]


def test_train_marl_refuses_what_it_does_not_take_yet(tmp_path):
    """``mesh`` must be a ``make_mesh`` mesh; ``checkpoint_dir`` writes the
    algo state every ``checkpoint_every`` chunks."""
    from freerl_tpu_torch.train.runio import load_checkpoint

    env = mpe.SimpleSpread(N=2, device="cpu")
    algo = MADDPG(env, MADDPGConfig(buffer_size=256, batch_size=8,
                                    hidden=(8,)), device="cpu")
    with pytest.raises(TypeError, match="make_mesh"):
        train_marl(env, algo, MARLConfig(), mesh=object())
    cfg = MARLConfig(num_envs=2, chunk_size=5, max_env_steps=20,
                     max_episodes=10**6, start_steps=4,
                     checkpoint_dir=str(tmp_path), checkpoint_every=2)
    state, _, info = train_marl(env, algo, cfg)
    restored = load_checkpoint(tmp_path / "ckpt",
                               algo.init(torch.Generator().manual_seed(9)))
    assert restored.step == state.step == info["updates"] > 0
    for a, b in zip(restored.actors, state.actors):
        for x, y in zip(a.parameters(), b.parameters()):
            assert torch.equal(x, y)
