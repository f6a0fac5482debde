"""The port's REINFORCE and on-policy driver against the JAX package.

REINFORCE's update is compared on identical params and windows made with
numpy: windows with several episodes per env, with unfinished tails and
with empty episode slots, where the JAX scan's ``where(has, ...)`` keeps
the params and the Adam state and the port steps only the filled slots.
Tolerance: params within 1e-5 after an update of up to 8 Adam steps, the
loss relatively within 1e-5. ``train_onpolicy`` is checked for its
episode record on RAW rewards under ``reward_scaling``, its iteration
cadence and the options it does not take yet.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.algos.ppo import Rollout as JaxRollout
from freerl_tpu.algos.reinforce import REINFORCE as JaxREINFORCE
from freerl_tpu.algos.reinforce import REINFORCEConfig as JaxREINFORCEConfig
from freerl_tpu.core.types import DimInfo as JaxDimInfo
from freerl_tpu_torch.algos import (PPO, REINFORCE, PPOConfig,
                                    REINFORCEConfig, Rollout)
from freerl_tpu_torch.convert import net_params_from_flax
from freerl_tpu_torch.core.types import DimInfo
from freerl_tpu_torch.envs import make
from freerl_tpu_torch.train import OnPolicyConfig, train_onpolicy
from tests.test_torch_dqn import _flax_params

torch.set_num_threads(1)

DI = dict(obs_dim=4, action_dim=3, is_continue=False)
T, N = 24, 4


def window(seed, ends):
    """A (T, N) window; ``ends[env]`` lists the steps where that env's
    episodes end (dead on even steps, truncated on odd ones)."""
    rng = np.random.RandomState(seed)
    adv_done = np.zeros((T, N), bool)
    for env, steps in enumerate(ends):
        adv_done[list(steps), env] = True
    return dict(
        obs=rng.randn(T, N, 4).astype(np.float32),
        action=rng.randint(0, 3, (T, N)).astype(np.int32),
        log_pi=np.zeros((T, N), np.float32),
        reward=rng.randn(T, N).astype(np.float32),
        next_obs=rng.randn(T, N, 4).astype(np.float32),
        done=adv_done & (np.arange(T)[:, None] % 2 == 0),
        adv_done=adv_done,
    )


# (episode ends per env, max_eps_per_update): env 1 and env 3 finish
# nothing in the first window, so slots 1, 3, 5, 7 are empty; the second
# fills more slots than the cap; the third has no complete episode
WINDOWS = {
    "empty_slots": ([(5, 11), (), (17,), ()], 8),
    "over_cap": ([(3, 7, 15), (9, 20), (2, 5, 8, 23), (12,)], 6),
    "none_complete": ([(), (), (), ()], 8),
}


def adam_steps(state) -> list[int]:
    return [int(state.opt.state[p]["step"]) if p in state.opt.state else 0
            for p in state.policy.parameters()]


@pytest.mark.parametrize("name", list(WINDOWS))
@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
def test_reinforce_update_matches_jax(name, normalize):
    ends, cap = WINDOWS[name]
    kw = dict(hidden=(16,), max_eps_per_update=cap,
              normalize_returns=normalize)
    jalgo = JaxREINFORCE(JaxDimInfo(**DI), JaxREINFORCEConfig(**kw))
    jstate = jalgo.init(jax.random.PRNGKey(0))
    algo = REINFORCE(DimInfo(**DI), REINFORCEConfig(**kw), device="cpu")
    state = algo.init(torch.Generator().manual_seed(0))
    state.policy.load_state_dict(net_params_from_flax(
        _flax_params(jstate.params)))
    before = [p.detach().clone() for p in state.policy.parameters()]
    w = window(3, ends)
    jstate, jm = jax.jit(lambda s: jalgo.update(
        s, JaxRollout(**{k: jnp.asarray(v) for k, v in w.items()}),
        jax.random.PRNGKey(1)))(jstate)
    state, m = algo.update(
        state, Rollout(**{k: torch.from_numpy(v) for k, v in w.items()}))

    want = net_params_from_flax(_flax_params(jstate.params))
    got = state.policy.state_dict()
    err = max(float((got[k] - want[k]).abs().max()) for k in want)
    print(f"{name}: params max abs err {err:.3e}")
    assert err <= 1e-5
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5, atol=1e-6)
    # one Adam step per filled slot: JAX's count moved only where has
    filled = sum(1 for k in range(cap) if len(ends[k % N]) > k // N)
    jcount = int(jax.tree.leaves(jstate.opt_state[0].count)[0])
    assert set(adam_steps(state)) == {filled} and jcount == filled
    if filled == 0:
        for p, q in zip(state.policy.parameters(), before):
            assert torch.equal(p, q)
        assert float(m["loss"]) == 0.0
    assert state.step == int(jstate.step) == 1


def test_reinforce_discrete_only():
    with pytest.raises(ValueError, match="discrete"):
        REINFORCE(DimInfo(3, 1, True), device="cpu")
    with pytest.raises(LookupError, match="'d'.*make_mesh"):
        REINFORCE(DimInfo(**DI), REINFORCEConfig(axis_name="d"), device="cpu")
    assert not hasattr(REINFORCEConfig(), "num_envs")


class _Keep:
    """Wraps an algo's update to keep each rollout's rewards and flags."""

    def __init__(self, algo):
        self.algo, self.rollouts = algo, []

    def __getattr__(self, name):
        return getattr(self.algo, name)

    def update(self, state, rollout, draws, episodes=None):
        self.rollouts.append(Rollout(**{k: v.clone() for k, v in
                                        vars(rollout).items()}))
        return self.algo.update(state, rollout, draws, episodes)


def test_record_is_on_raw_rewards_under_reward_scaling():
    """CartPole pays 1 a step: the record holds each finished episode's
    length, in the order the episodes ended, while the stored rewards are
    scaled."""
    env = make("CartPole-v1", device="cpu")
    algo = _Keep(PPO(env.dim_info, PPOConfig(
        reward_scaling=True, num_envs=8, hidden=(16, 16), K_epochs=1,
        minibatch_size=64), device="cpu"))
    cfg = OnPolicyConfig(num_envs=8, horizon=256, max_episodes=10**6,
                         max_env_steps=256 * 3)
    _, returns, info = train_onpolicy(env, algo, cfg)
    assert info["iterations"] == 3 and info["env_steps"] == 768
    stored = torch.cat([r.reward.flatten() for r in algo.rollouts])
    assert not torch.allclose(stored, torch.ones_like(stored))
    ends = torch.cat([r.adv_done for r in algo.rollouts])       # (3T, N)
    start, lengths = [0] * 8, []
    for t in range(ends.shape[0]):
        for e in range(8):
            if ends[t, e]:
                lengths.append(t - start[e] + 1)
                start[e] = t + 1
    assert len(lengths) == info["episodes"] > 8
    np.testing.assert_array_equal(returns, np.float32(lengths))


def test_iteration_cadence_and_reinforce_drive():
    """iters_per_dispatch iterations between host checks, on_iter once per
    log_every_iters window; REINFORCE through the driver takes one Adam
    step per filled slot."""
    env = make("CartPole-v1", device="cpu")
    algo = _Keep(REINFORCE(env.dim_info, REINFORCEConfig(hidden=(16,)),
                           device="cpu"))
    calls = []
    cfg = OnPolicyConfig(num_envs=4, horizon=4 * 64, max_episodes=10**6,
                         max_env_steps=4 * 64 * 6, iters_per_dispatch=2,
                         log_every_iters=4)
    state, returns, info = train_onpolicy(
        env, algo, cfg, on_iter=lambda it, *a: calls.append(it))
    assert info["iterations"] == 6 and calls == [4]
    filled = 0
    for r in algo.rollouts:
        n_done = r.adv_done.sum(0).tolist()
        filled += sum(1 for k in range(64) if n_done[k % 4] > k // 4)
    assert filled > 0 and set(adam_steps(state)) == {filled}
    assert state.step == 6 and len(returns) == info["episodes"]


def test_driver_refuses_what_it_does_not_take_yet(tmp_path):
    """``mesh`` must be a ``make_mesh`` mesh; ``checkpoint_dir`` writes the
    algo state every ``checkpoint_every`` iterations."""
    from freerl_tpu_torch.train.runio import load_checkpoint

    env = make("CartPole-v1", device="cpu")
    algo = PPO(env.dim_info, PPOConfig(hidden=(8,), horizon=32, num_envs=4,
                                       K_epochs=1, minibatch_size=16),
               device="cpu")
    with pytest.raises(TypeError, match="make_mesh"):
        train_onpolicy(env, algo, OnPolicyConfig(), mesh=object())
    cfg = OnPolicyConfig(num_envs=4, horizon=32, max_env_steps=96,
                         max_episodes=10**6, checkpoint_dir=str(tmp_path),
                         checkpoint_every=2)
    state, _, info = train_onpolicy(env, algo, cfg)
    restored = load_checkpoint(tmp_path / "ckpt",
                               algo.init(torch.Generator().manual_seed(9)))
    assert info["iterations"] == 3 and restored.step == 2 == state.step - 1
