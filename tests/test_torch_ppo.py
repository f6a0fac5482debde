"""The port's PPO update against the JAX package's, one case per branch:
the Gaussian, discrete and Beta actors, all tricks on, PPO_d
(``recompute_logp``), ``std_decay`` and ``lr_decay`` at a set episode
count.

Parameters move from flax to torch with ``convert.net_params_from_flax``,
and the update is fed the permutations the JAX update draws from its key
(for each epoch ``k, k_perm = split(k); permutation(k_perm, B)``). The
rollout is made with numpy. Tolerance: a whole update of 10 epochs x 4
minibatches within 1e-5 (Adam scales a near-zero gradient to about lr, so
the frameworks' float32 rounding can grow with the steps); one minibatch
step is held within 1e-6 in ``tests/test_torch_ppo_parts.py``. The largest
error is printed either way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.algos.ppo import PPO as JaxPPO
from freerl_tpu.algos.ppo import PPOConfig as JaxPPOConfig
from freerl_tpu.algos.ppo import Rollout as JaxRollout
from freerl_tpu.core.types import DimInfo as JaxDimInfo
from freerl_tpu_torch.algos import PPO, PPOConfig, Rollout
from freerl_tpu_torch.convert import net_params_from_flax
from freerl_tpu_torch.core.types import DimInfo
from tests.test_torch_dqn import _flax_params

torch.set_num_threads(1)

DI_C = dict(obs_dim=3, action_dim=2, is_continue=True, max_action=2.0)
DI_D = dict(obs_dim=4, action_dim=3, is_continue=False)
HIDDEN = (16, 16)
T, N = 16, 4

# name: (dim info, config fields, episodes passed to update)
BRANCHES = {
    "gauss": (DI_C, dict(), None),
    "discrete": (DI_D, dict(), None),
    "beta": (DI_C, dict(beta_dist=True), None),
    "all_tricks": (DI_C, dict(adv_norm=True, obs_norm=True,
                              reward_scaling=True, lr_decay=True,
                              orthogonal_init=True, adam_eps=True, tanh=True,
                              num_envs=N), 10),
    "recompute_logp": (DI_C, dict(recompute_logp=True), None),
    "std_decay": (DI_C, dict(std_decay=True), 50),
    "lr_decay": (DI_D, dict(lr_decay=True, adv_norm=True), 150),
}


def make_pair(name, **extra):
    di, kw, _ = BRANCHES[name]
    kw = dict(kw, hidden=HIDDEN, **extra)
    jalgo = JaxPPO(JaxDimInfo(**di), JaxPPOConfig(**kw))
    jstate = jalgo.init(jax.random.PRNGKey(0))
    algo = PPO(DimInfo(**di), PPOConfig(**kw), device="cpu")
    state = algo.init(torch.Generator().manual_seed(0))
    load_nets(state, jstate, kw.get("beta_dist", False))
    return jalgo, jstate, algo, state


def load_nets(state, jstate, beta):
    state.actor.load_state_dict(net_params_from_flax(
        _flax_params(jstate.actor_params), beta=beta))
    state.critic.load_state_dict(net_params_from_flax(
        _flax_params(jstate.critic_params)))


def np_rollout(name, seed, t=T, n=N):
    di, kw, _ = BRANCHES[name]
    rng = np.random.RandomState(seed)
    a = di["action_dim"]
    if not di["is_continue"]:
        action = rng.randint(0, a, (t, n)).astype(np.int32)
    elif kw.get("beta_dist"):
        action = rng.uniform(0.02, 0.98, (t, n, a)).astype(np.float32)
    else:
        action = rng.uniform(-2, 2, (t, n, a)).astype(np.float32)
    done = rng.rand(t, n) < 0.1
    return dict(
        obs=rng.randn(t, n, di["obs_dim"]).astype(np.float32),
        action=action,
        log_pi=(rng.randn(t, n) * 0.1 - 1.0).astype(np.float32),
        reward=rng.randn(t, n).astype(np.float32),
        next_obs=rng.randn(t, n, di["obs_dim"]).astype(np.float32),
        done=done,
        adv_done=done | (rng.rand(t, n) < 0.1),
    )


def jax_perms(key, k_epochs, b):
    """The permutations the JAX update draws from ``key``, (K, B) int64."""
    perms = []
    for _ in range(k_epochs):
        key, k_perm = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(k_perm, b)))
    return torch.from_numpy(np.stack(perms).astype(np.int64))


def state_err(state, jstate, beta):
    """The largest abs difference over the actor's and critic's params."""
    err = 0.0
    for net, jp, b in ((state.actor, jstate.actor_params, beta),
                       (state.critic, jstate.critic_params, False)):
        want = net_params_from_flax(_flax_params(jp), beta=b)
        got = net.state_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            err = max(err, float((got[k] - want[k]).abs().max()))
    return err


def run_update(name, seed=1, **extra):
    jalgo, jstate, algo, state = make_pair(name, **extra)
    ep = BRANCHES[name][2]
    roll = np_rollout(name, seed)
    key = jax.random.PRNGKey(7)
    jstate2, jm = jax.jit(lambda s, k: jalgo.update(
        s, JaxRollout(**{k_: jnp.asarray(v) for k_, v in roll.items()}), k,
        episodes=None if ep is None else jnp.int32(ep)))(jstate, key)
    perms = jax_perms(key, algo.cfg.K_epochs, T * N)
    state, m = algo.update(
        state, Rollout(**{k_: torch.from_numpy(v) for k_, v in roll.items()}),
        perms, episodes=None if ep is None else torch.tensor(ep))
    return jstate2, jm, state, m


@pytest.mark.parametrize("name", list(BRANCHES))
def test_update_matches_jax(name):
    """A whole update, 10 epochs of 4 minibatches: params, metrics, the lr
    multiplier and the external std."""
    jstate, jm, state, m = run_update(name)
    err = state_err(state, jstate, BRANCHES[name][1].get("beta_dist", False))
    print(f"{name}: params max abs err {err:.3e}")
    assert err <= 1e-5, err
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert {"actor_loss", "critic_loss"} <= set(m)
    np.testing.assert_allclose(state.lr_frac, float(jstate.lr_frac), rtol=1e-7)
    np.testing.assert_allclose(float(state.ext_std), float(jstate.ext_std),
                               rtol=1e-7)
    assert state.step == int(jstate.step) == 1


def test_minibatch_remainder_goes_unused():
    """B // minibatch_size minibatches: with minibatch 24 of B 64, two a
    epoch, and the permutation's last 16 entries never reach a step. The
    same update with those entries changed gives the same params."""
    _, _, algo, state = make_pair("gauss", minibatch_size=24)
    _, _, _, state2 = make_pair("gauss", minibatch_size=24)
    roll = Rollout(**{k: torch.from_numpy(v)
                      for k, v in np_rollout("gauss", 3).items()})
    perms = torch.stack([torch.randperm(64, generator=torch.Generator()
                                        .manual_seed(e)) for e in range(10)])
    perms2 = perms.clone()
    perms2[:, 48:] = perms[:, 48:].flip(1)
    algo.update(state, roll, perms)
    algo.update(state2, roll, perms2)
    for a, b in zip(state.actor.parameters(), state2.actor.parameters()):
        assert torch.equal(a, b)


def test_config_rules():
    with pytest.raises(ValueError, match="cannot both"):
        PPOConfig(reward_norm=True, reward_scaling=True)
    with pytest.raises(ValueError, match="Gaussian"):
        PPOConfig(beta_dist=True, std_decay=True)
    with pytest.raises(LookupError, match="'data'.*make_mesh"):
        PPO(DimInfo(**DI_C), PPOConfig(axis_name="data"), device="cpu")
    state = PPO(DimInfo(obs_dim=64, action_dim=2, is_continue=True),
                PPOConfig(obs_shape=(8, 8, 1), cnn_features=8),
                device="cpu").init(torch.Generator().manual_seed(0))
    assert state.actor.conv is not None
    assert state.critic.conv is not None
    assert state.critic.conv is not state.actor.conv
    assert not hasattr(PPOConfig(), "critic_lr")
