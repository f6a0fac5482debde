"""The on-policy driver's multi-agent and recurrent paths.

``train_onpolicy`` runs every multi-agent on-policy algo on the CPU
(MAPPO stacked and with the attention critic, IPPO, HAPPO, MAT continuous
and discrete, rMAPPO, rIPPO): the record is (E, A) and equals each
agent's sums of the RAW rewards, continuous actions reach the MPE env in
its box [0, 1], and one update runs per iteration.

Two runs are then held against the JAX package. The driver's own draws
come from torch's generator, so the runs start from params carried over
from a JAX init and their updates are fed the permutations JAX draws from
a fixed key; what the driver collected is replayed through the JAX
functions. MAPPO: the stored log-probs are the JAX actors' log-probs of
the stored actions (within 1e-5), and the JAX update on the driver's
rollout gives the port's updated params. rMAPPO: the extras hold the
hidden states the JAX ``sample_action`` reaches from a zero carry over
the driver's observations and resets (within 1e-5), ``done_prev`` is the
previous step's episode end, the carry runs on across iterations, and the
JAX update on the rollout and extras gives the port's params. Update
tolerance: 1e-5 bar one element in 10,000, none past the lr.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.algos import mappo as jax_mappo
from freerl_tpu.algos import rmappo as jax_rmappo
from freerl_tpu.algos.ppo import Rollout as JaxRollout
from freerl_tpu.envs import make as jax_make
from freerl_tpu_torch import algos
from freerl_tpu_torch.convert import (mappo_state_from_flax,
                                      rmappo_state_from_flax)
from freerl_tpu_torch.envs import make
from freerl_tpu_torch.train import OnPolicyConfig, train_onpolicy
from tests.test_torch_mappo import (assert_close_lists, flax_numpy,
                                    jax_agent_perms, state_params, t)

torch.set_num_threads(1)

T, N = 25, 4          # one 25-step episode per env per iteration


class Probe:
    """Wraps an algo and an env: keeps each vector step's RAW reward and
    episode ends, each env action's range, and each update's rollout,
    extras, episode count and resulting params; ``perms`` (a function of
    the update's index) replaces the update's draws, and ``load`` the
    initial params."""

    def __init__(self, algo, env, perms=None, load=None):
        self.algo, self.perms, self.load = algo, perms, load
        self.raw, self.actions, self.updates = [], [], []
        step = env.step

        def logged(state, action, draw):
            self.actions.append((float(action.min()), float(action.max())))
            return step(state, action, draw)

        env.step = logged

    def __getattr__(self, name):
        return getattr(self.algo, name)

    def init(self, generator):
        state = self.algo.init(generator)
        if self.load is not None:
            self.load(state)
        return state

    def process_reward(self, state, reward, episode_done):
        self.raw.append((reward.clone(), episode_done.clone()))
        return self.algo.process_reward(state, reward, episode_done)

    def update(self, state, rollout, draws, episodes=None, **kw):
        if self.perms is not None:
            draws = self.perms(len(self.updates))
        keep = dict(rollout=dataclasses.replace(rollout, **{
            k: v.clone() for k, v in vars(rollout).items()}),
            extras={k: v.clone() for k, v in kw.get("extras", {}).items()},
            episodes=int(episodes))
        state, m = self.algo.update(state, rollout, draws, episodes, **kw)
        keep["params"] = [p.detach().clone() for p in params_of(state)]
        self.updates.append(keep)
        return state, m


def params_of(state):
    if hasattr(state, "encoder"):
        return [p for net in (state.encoder, state.decoder)
                for _, p in sorted(net.state_dict().items())]
    return state_params(state)


def expected_record(raw):
    """Each agent's running sum of the RAW rewards, recorded where its
    env's episode ends, in the order the episodes end."""
    run, out = None, []
    for reward, done in raw:
        run = reward.clone() if run is None else run + reward
        out.append(run[done])
        run = torch.where(done[:, None], 0.0, run)
    return torch.cat(out).numpy()


# name: (env, algo, config fields)
PATHS = {
    "mappo": ("simple_spread_v3", "MAPPO", dict(reward_scaling=True)),
    "mappo_attention": ("simple_spread_v3", "MAPPO", dict(attention=True)),
    "ippo": ("simple_adversary_v3", "IPPO", dict()),
    "happo": ("simple_spread_v3", "HAPPO", dict()),
    "mat_cont": ("simple_spread_v3", "MAT", dict()),
    "mat_disc": ("simple_spread_v3 discrete", "MAT", dict()),
    "rmappo": ("simple_spread_v3", "RMAPPO", dict()),
    "rippo": ("simple_adversary_v3", "RIPPO", dict()),
}


def make_algo(name, env, **extra):
    _, algo_name, kw = PATHS[name]
    cfg_name = {"IPPO": "MAPPOConfig", "RIPPO": "RMAPPOConfig"}.get(
        algo_name, algo_name + "Config")
    kw = dict(kw, K_epochs=2, num_envs=N, horizon=T * N, **extra)
    if algo_name == "MAT":
        kw["n_embd"] = 16
    elif algo_name in ("RMAPPO", "RIPPO"):
        kw.update(hidden=(32,), rnn_hidden=16, minibatch_size=40)
    else:
        kw["hidden"] = (32, 32)
    return getattr(algos, algo_name)(env, getattr(algos, cfg_name)(**kw),
                                     device="cpu")


def env_of(name, device_make=make):
    env_name = PATHS[name][0]
    if env_name.endswith("discrete"):
        return device_make("simple_spread_v3", continuous_actions=False,
                           **({"device": "cpu"} if device_make is make
                              else {}))
    return device_make(env_name, **({"device": "cpu"} if device_make is make
                                    else {}))


@pytest.mark.parametrize("name", list(PATHS))
def test_driver_runs_every_algo(name):
    """Two iterations: the (E, A) record of the RAW rewards, actions in
    the env's box, one update per iteration."""
    env = env_of(name)
    algo = Probe(make_algo(name, env), env)
    cfg = OnPolicyConfig(num_envs=N, horizon=T * N, max_episodes=10**6,
                         max_env_steps=2 * T * N)
    state, returns, info = train_onpolicy(env, algo, cfg)
    assert info["iterations"] == 2 == len(algo.updates)
    assert returns.shape == (2 * N, env.n_agents) == (info["episodes"],
                                                      env.n_agents)
    np.testing.assert_array_equal(returns, expected_record(algo.raw))
    lo = min(a for a, _ in algo.actions)
    hi = max(b for _, b in algo.actions)
    if env.dim_info.is_continue:
        assert 0.0 <= lo and hi <= 1.0 and lo < 0.3 and hi > 0.7
    else:
        assert lo >= 0 and hi <= env.dim_info.action_dim - 1
    assert state.step == 2


def test_mappo_driver_matches_jax():
    """The driver's MAPPO rollout and update replayed through the JAX
    package (reward_scaling on: the stored rewards are scaled, the record
    is raw)."""
    jenv, env = jax_make("simple_spread_v3"), make("simple_spread_v3",
                                                   device="cpu")
    kw = dict(K_epochs=2, num_envs=N, horizon=T * N, hidden=(32, 32),
              reward_scaling=True)
    jalgo = jax_mappo.MAPPO(jenv, jax_mappo.MAPPOConfig(**kw))
    jstate = jalgo.init(jax.random.PRNGKey(0))
    port = algos.MAPPO(env, algos.MAPPOConfig(**kw), device="cpu")
    algo = Probe(port, env, load=lambda s: mappo_state_from_flax(
        port, s, flax_numpy(jstate)),
        perms=lambda u: jax_agent_perms(jax.random.PRNGKey(u), 3, 2, T * N))
    train_onpolicy(env, algo, OnPolicyConfig(
        num_envs=N, horizon=T * N, max_episodes=10**6, max_env_steps=T * N))
    (up,) = algo.updates
    roll = up["rollout"]
    assert not torch.equal(roll.reward,
                           torch.stack([r for r, _ in algo.raw]))
    for i in range(3):
        logp, _ = jalgo._logp_ent(jstate.actor_params[i],
                                  jnp.asarray(roll.obs[..., i, :].numpy()),
                                  jnp.asarray(roll.action[..., i, :].numpy()),
                                  i)
        np.testing.assert_allclose(roll.log_pi[..., i].numpy(),
                                   np.asarray(logp), rtol=1e-5, atol=1e-5)
    jroll = JaxRollout(**{k: jnp.asarray(v.numpy())
                          for k, v in vars(roll).items()})
    jstate2, _ = jax.jit(lambda s: jalgo.update(
        s, jroll, jax.random.PRNGKey(0), episodes=jnp.int32(
            up["episodes"])))(jstate)
    want = port.init(torch.Generator().manual_seed(5))
    mappo_state_from_flax(port, want, flax_numpy(jstate2))
    assert_close_lists(up["params"], state_params(want), "driver MAPPO", 5e-4)


def test_rmappo_driver_matches_jax():
    """The recurrent path: the carry and done_prev through the rollout,
    the stacked extras, the carry across iterations, and the update."""
    jenv = jax_make("simple_spread_v3", continuous_actions=False)
    env = make("simple_spread_v3", continuous_actions=False, device="cpu")
    kw = dict(K_epochs=2, num_envs=N, horizon=T * N, hidden=(32,),
              rnn_hidden=16, minibatch_size=40, data_chunk_length=10)
    jalgo = jax_rmappo.RMAPPO(jenv, jax_rmappo.RMAPPOConfig(**kw))
    jstate = jalgo.init(jax.random.PRNGKey(0))
    port = algos.RMAPPO(env, algos.RMAPPOConfig(**kw), device="cpu")
    L, S, _, _ = port._chunks(T, N)
    assert (L, S) == (5, 20)            # 10 does not divide 25

    def perms(u):
        key, out = jax.random.PRNGKey(u), np.zeros((3, 2, S), np.int64)
        for i in range(3):
            k = jax.random.fold_in(key, i)
            for e in range(2):
                k, k_perm = jax.random.split(k)
                out[i, e] = np.asarray(jax.random.permutation(k_perm, S))
        return t(out)

    algo = Probe(port, env, perms=perms, load=lambda s: rmappo_state_from_flax(
        port, s, flax_numpy(jstate)))
    train_onpolicy(env, algo, OnPolicyConfig(
        num_envs=N, horizon=T * N, max_episodes=10**6,
        max_env_steps=2 * T * N))
    first, second = algo.updates
    roll, ex = first["rollout"], first["extras"]
    assert ex["h_actor"].shape == (T, N, 3, 16)
    assert not ex["done_prev"][0].any()
    assert torch.equal(ex["done_prev"][1:], roll.adv_done[:-1])
    assert torch.equal(second["extras"]["done_prev"][0], roll.adv_done[-1])
    # the JAX cells over the driver's obs and resets reach the same carry
    carry = jax_rmappo.HiddenCarry(h_actor=jnp.zeros((N, 3, 16)),
                                   h_critic=jnp.zeros((N, 3, 16)))
    sample = jax.jit(jalgo.sample_action)
    for step in range(T):
        for k in ("h_actor", "h_critic"):
            np.testing.assert_allclose(ex[k][step].numpy(),
                                       np.asarray(getattr(carry, k)),
                                       rtol=1e-5, atol=1e-5)
        carry = sample(jstate, jnp.asarray(roll.obs[step].numpy()),
                       jax.random.PRNGKey(step), carry,
                       jnp.asarray(ex["done_prev"][step].numpy()))[3]
    assert float((second["extras"]["h_actor"][0]).abs().max()) > 0
    jroll = JaxRollout(**{k: jnp.asarray(v.numpy())
                          for k, v in vars(roll).items()})
    jstate2, _ = jax.jit(lambda s, e: jalgo.update(
        s, jroll, jax.random.PRNGKey(0), episodes=jnp.int32(
            first["episodes"]), extras=e))(
        jstate, {k: jnp.asarray(v.numpy()) for k, v in ex.items()})
    want = port.init(torch.Generator().manual_seed(5))
    rmappo_state_from_flax(port, want, flax_numpy(jstate2))
    assert_close_lists(first["params"], state_params(want), "driver rMAPPO",
                       5e-4)
