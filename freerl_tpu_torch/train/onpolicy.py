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
    # periodic checkpointing waits for the port of train/runio.py
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
    ep_return: torch.Tensor        # (num_envs,)
    ep_counter: torch.Tensor       # scalar int64, completed episodes
    episode_returns: torch.Tensor  # (record_cap + 1,); the last slot drops
    rollout: Optional[Rollout] = None   # (T, N, ...), allocated once
    total_steps: int = 0           # vector steps so far (host)


def _check_supported(env: Env, algo, cfg: OnPolicyConfig, mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel training (mesh) comes with the distributed slice "
            "(ROADMAP.md queue A, slice 8)")
    if cfg.checkpoint_dir and cfg.checkpoint_every:
        raise NotImplementedError(
            "checkpointing waits for the port of train/runio.py "
            "(ROADMAP.md queue A, slice 7)")
    if getattr(env, "n_agents", 1) > 1 or getattr(env, "action_space_01",
                                                   False):
        raise NotImplementedError(
            "multi-agent envs come with the multi-agent slice (ROADMAP.md "
            "queue A, slice 5, item 12)")
    if hasattr(algo, "init_policy_carry"):
        raise NotImplementedError(
            "recurrent policies come with the multi-agent slice (ROADMAP.md "
            "queue A, slice 5, item 15)")


def _write(rollout: Optional[Rollout], t: int, T: int, step: dict) -> Rollout:
    """Write one vector step into row ``t`` of the rollout, allocating its
    ``(T, N, ...)`` tensors on the first write."""
    if rollout is None:
        rollout = Rollout(**{k: torch.empty((T,) + tuple(v.shape),
                                            dtype=v.dtype, device=v.device)
                             for k, v in step.items()})
    for k, v in step.items():
        getattr(rollout, k)[t] = v
    return rollout


def vector_step(env: Env, algo, c: OnPolicyCarry,
                generator: torch.Generator, record_cap: int, t: int,
                T: int) -> None:
    """Vector step ``t`` of an iteration's rollout, updating the carry in
    place: sample, auto-resetting env step, reward and obs processing,
    the episode record on RAW rewards, row ``t`` of ``c.rollout``."""
    num_envs = c.obs.shape[0]
    env_a, stored_a, logp = algo.sample_action(
        c.algo_state, c.obs, algo.draw_action(num_envs, generator))
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
    c.total_steps += 1


def learn(algo, c: OnPolicyCarry, generator: torch.Generator) -> dict:
    """The iteration's update on ``c.rollout``, with its draws from
    ``generator``; returns the update's metrics."""
    c.algo_state, metrics = algo.update(
        c.algo_state, c.rollout, algo.draw_update(c.rollout, generator),
        episodes=c.ep_counter)
    return metrics


def start(env: Env, algo, num_envs: int, generator: torch.Generator,
          record_cap: int) -> OnPolicyCarry:
    """The algo's initial state and the reset batch, in a fresh carry."""
    device = env.device
    algo_state = algo.init(generator)
    env_state, obs = vec_reset(env, generator, num_envs)
    algo_state, _, obs = algo.process_obs(algo_state, obs, obs)
    return OnPolicyCarry(
        algo_state=algo_state, env_state=env_state, obs=obs,
        ep_return=torch.zeros(num_envs, device=device),
        ep_counter=torch.zeros((), dtype=torch.int64, device=device),
        episode_returns=torch.zeros(record_cap + 1, device=device),
    )


def train_onpolicy(env: Env, algo, cfg: OnPolicyConfig,
                   on_iter: Optional[Callable] = None, mesh=None):
    """``algo`` must expose ``init(generator)``, ``draw_action(b,
    generator)``, ``sample_action(state, obs, draws)``, ``process_obs``,
    ``process_reward``, ``draw_update(rollout, generator)`` and
    ``update(state, rollout, draws, episodes)`` (see ``algos/ppo.py``);
    ``env`` and ``algo`` must share a device. ``on_iter(it, episodes,
    env_steps, carry, metrics)`` fires once per ``log_every_iters``
    iterations. Returns ``(algo_state, episode_returns ndarray, info)``.
    """
    _check_supported(env, algo, cfg, mesh)
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
