"""On-policy (PPO-family) training driver (counterpart:
``freerl_tpu/train/onpolicy.py``).

Each iteration collects ``T = horizon // num_envs`` vector steps into
preallocated ``(T, N, ...)`` tensors, then runs one ``algo.update`` on
them. Everything runs on the algo's and env's device; the host only
counts. Iterations are fixed-length, so the step count is a host int, and
the episode counter is read back every ``host_sync_every`` iterations.

Conventions kept from the JAX package: episode returns are recorded on RAW
env rewards while the stored rewards pass through ``process_reward``
(reward_norm / reward_scaling), and ``process_obs`` (obs normalization)
updates during collection.

Multi-agent envs (MAPPO, IPPO, HAPPO, MAT, rMAPPO) keep the agent axis:
rewards are (N, A) and so are the running returns, and the record is
(E, A). Where the env's box is [0, 1] (``action_space_01``, the MPE
scenarios) continuous actions are mapped there from the policy's
[-1, 1]. A recurrent algo (one with ``init_policy_carry``, rMAPPO) gets
its hidden-state carry and the previous step's episode ends at every
``sample_action``, and its per-step ``extras``, stacked into (T, ...)
tensors allocated once, at ``update(..., extras=)``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from freerl_tpu_torch.algos.ppo import Rollout
from freerl_tpu_torch.envs.base import Env, vec_reset, vec_step_auto_reset
from freerl_tpu_torch.train.loop import record_episodes
from freerl_tpu_torch.train.runio import save_checkpoint


@dataclasses.dataclass(frozen=True)
class OnPolicyConfig:
    seed: int = 0
    num_envs: int = 8
    max_episodes: int = 200
    max_env_steps: int = 50_000_000
    horizon: int = 2048             # total transitions per update
    log_every_iters: int = 10
    # rollout+update iterations between host checks
    iters_per_dispatch: int = 1
    # save the algo state to f"{checkpoint_dir}/ckpt" every N iterations
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    # read the episode counter back from the device every N iterations;
    # the termination on max_episodes can overshoot by up to N-1 of them
    host_sync_every: int = 4


@dataclasses.dataclass
class OnPolicyCarry:
    algo_state: object
    env_state: object
    obs: torch.Tensor
    ep_return: torch.Tensor        # (num_envs,), or (num_envs, A)
    ep_counter: torch.Tensor       # scalar int64, completed episodes
    episode_returns: torch.Tensor  # (record_cap + 1[, A]); the last slot drops
    rollout: Optional[Rollout] = None   # (T, N, ...), allocated once
    total_steps: int = 0           # vector steps so far (host)
    # recurrent algos: the hidden-state carry, the previous step's episode
    # ends, and the iteration's stacked extras (T, ...)
    policy_carry: object = None
    done_prev: Optional[torch.Tensor] = None
    extras: Optional[dict] = None
    # the data-parallel driver's completion vector-step of each record slot
    episode_steps: Optional[torch.Tensor] = None


def _write(store, t: int, T: int, step: dict, make=Rollout):
    """Write one vector step into row ``t`` of ``store`` (a Rollout, or
    with ``make=dict`` a dict), allocating its ``(T, ...)`` tensors on the
    first write."""
    if store is None:
        store = make(**{k: torch.empty((T,) + tuple(v.shape),
                                       dtype=v.dtype, device=v.device)
                        for k, v in step.items()})
    rows = store if isinstance(store, dict) else vars(store)
    for k, v in step.items():
        rows[k][t] = v
    return store


def _recurrent(algo) -> bool:
    return hasattr(algo, "init_policy_carry")


def vector_step(env: Env, algo, c: OnPolicyCarry,
                generator: torch.Generator, record_cap: int, t: int,
                T: int) -> None:
    """Vector step ``t`` of an iteration's rollout, updating the carry in
    place: sample, auto-resetting env step, reward and obs processing,
    the episode record on RAW rewards, row ``t`` of ``c.rollout``."""
    num_envs = c.obs.shape[0]
    draws = algo.draw_action(num_envs, generator)
    if _recurrent(algo):
        env_a, stored_a, logp, c.policy_carry, extras = algo.sample_action(
            c.algo_state, c.obs, draws, c.policy_carry, c.done_prev)
        c.extras = _write(c.extras, t, T, extras, dict)
    else:
        env_a, stored_a, logp = algo.sample_action(c.algo_state, c.obs, draws)
    if getattr(env, "action_space_01", False) and env.dim_info.is_continue:
        env_a = (env_a + 1.0) / 2.0       # the MPE box is [0, 1]
    out = vec_step_auto_reset(env, c.env_state, env_a, generator, num_envs)
    c.algo_state, reward = algo.process_reward(c.algo_state, out.reward,
                                               out.episode_done)
    c.algo_state, next_obs, carry_obs = algo.process_obs(
        c.algo_state, out.next_obs, out.carry_obs)
    record_episodes(env, c, out.reward, out.episode_done, record_cap)
    c.rollout = _write(c.rollout, t, T, dict(
        obs=c.obs, action=stored_a, log_pi=logp, reward=reward,
        next_obs=next_obs, done=out.terminated, adv_done=out.episode_done))
    c.env_state, c.obs = out.state, carry_obs
    if _recurrent(algo):
        c.done_prev = out.episode_done
    c.total_steps += 1


def learn(algo, c: OnPolicyCarry, generator: torch.Generator,
          episodes: Optional[torch.Tensor] = None) -> dict:
    """The iteration's update on ``c.rollout`` (and a recurrent algo's
    ``c.extras``), with its draws from ``generator``; returns the update's
    metrics. ``episodes`` (default: the carry's count) is what the
    update's schedules read."""
    kw = {"extras": c.extras} if _recurrent(algo) else {}
    c.algo_state, metrics = algo.update(
        c.algo_state, c.rollout, algo.draw_update(c.rollout, generator),
        episodes=c.ep_counter if episodes is None else episodes, **kw)
    return metrics


def start(env: Env, algo, num_envs: int, generator: torch.Generator,
          record_cap: int, algo_state=None) -> OnPolicyCarry:
    """The algo's initial state (``algo_state``, or built from
    ``generator``) and the reset batch, in a fresh carry; a multi-agent
    env's returns and record keep the agent axis."""
    device = env.device
    n_agents = getattr(env, "n_agents", 1)
    agents = (n_agents,) if n_agents > 1 else ()
    if algo_state is None:
        algo_state = algo.init(generator)
    env_state, obs = vec_reset(env, generator, num_envs)
    algo_state, _, obs = algo.process_obs(algo_state, obs, obs)
    c = OnPolicyCarry(
        algo_state=algo_state, env_state=env_state, obs=obs,
        ep_return=torch.zeros((num_envs,) + agents, device=device),
        ep_counter=torch.zeros((), dtype=torch.int64, device=device),
        episode_returns=torch.zeros((record_cap + 1,) + agents,
                                    device=device),
    )
    if _recurrent(algo):
        c.policy_carry = algo.init_policy_carry(num_envs)
        c.done_prev = torch.zeros(num_envs, dtype=torch.bool, device=device)
    return c


def train_onpolicy(env: Env, algo, cfg: OnPolicyConfig,
                   on_iter: Optional[Callable] = None, mesh=None):
    """``algo`` must expose ``init(generator)``, ``draw_action(b,
    generator)``, ``sample_action(state, obs, draws)``, ``process_obs``,
    ``process_reward``, ``draw_update(rollout, generator)`` and
    ``update(state, rollout, draws, episodes)`` (see ``algos/ppo.py``); a
    recurrent one also ``init_policy_carry(num_envs)``, and its
    ``sample_action`` and ``update`` take the carry and the extras (see
    ``algos/rmappo.py``). ``env`` and ``algo`` must share a device.
    ``on_iter(it, episodes, env_steps, carry, metrics)`` fires once per
    ``log_every_iters`` iterations. Returns ``(algo_state,
    episode_returns ndarray, info)``; the returns are (E,), or (E, A) for
    a multi-agent env.

    With ``mesh`` (``distributed.make_mesh``), every rank calls this and
    the iteration runs data-parallel through ``distributed/dp.py`` (the
    algo's config must carry ``axis_name`` equal to the mesh's axis).
    """
    if mesh is not None:
        from freerl_tpu_torch.distributed.dp import train_onpolicy_sharded

        return train_onpolicy_sharded(env, algo, cfg, mesh, on_iter=on_iter)
    num_envs = cfg.num_envs
    T = max(cfg.horizon // num_envs, 1)
    K = max(cfg.iters_per_dispatch, 1)
    # an episode costs >=1 env step, so the record never needs more slots
    # than the step budget plus the last block's overshoot
    record_cap = min(cfg.max_episodes,
                     cfg.max_env_steps + K * T * num_envs) + num_envs + 1

    generator = torch.Generator(device=env.device)
    generator.manual_seed(cfg.seed)
    c = start(env, algo, num_envs, generator, record_cap)

    def one_iteration():
        for t in range(T):
            vector_step(env, algo, c, generator, record_cap, t, T)
        return learn(algo, c, generator)

    t0 = time.time()
    it = 0
    n_eps = 0
    # with K-iteration blocks, "every N iterations" must fire once per
    # window for any K: it % N < K is true exactly once per N window
    def hit(every):
        return every > 0 and it % every < K

    while True:
        for _ in range(K):
            metrics = one_iteration()
        it += K
        n_steps = it * T * num_envs
        if hit(cfg.host_sync_every) or n_steps >= cfg.max_env_steps:
            n_eps = int(c.ep_counter)
        if on_iter is not None and hit(cfg.log_every_iters):
            on_iter(it, n_eps, n_steps, c, metrics)
        if cfg.checkpoint_dir and hit(cfg.checkpoint_every):
            save_checkpoint(f"{cfg.checkpoint_dir}/ckpt", c.algo_state)
        if n_eps >= cfg.max_episodes or n_steps >= cfg.max_env_steps:
            break

    n_eps = int(c.ep_counter)
    elapsed = time.time() - t0
    returns = c.episode_returns[: min(n_eps, cfg.max_episodes)]
    info = {
        "elapsed_s": elapsed,
        "env_steps": n_steps,
        "iterations": it,
        "env_steps_per_s": n_steps / max(elapsed, 1e-9),
        "episodes": n_eps,
    }
    return c.algo_state, np.asarray(returns.cpu()), info
