"""Hindsight Experience Replay training loop (counterpart:
``freerl_tpu/train/her.py``).

Episodes are fixed-horizon (GoalPendulum's 200 steps), so one episode is a
rollout of the whole env batch to the horizon, stacked to (T, N, ...).
Each transition is then relabeled with ``k_future`` goals achieved later in
its own trajectory ("future" strategy, window ``[t, t + sample_range)``),
its sparse reward recomputed with the env's ``goal_reward``, and the real
and the relabeled transitions go into the replay ring in two adds, both
through the ring's scatter path (the buffer is made with ``add_batch=0``).
The learner then runs ``updates_per_episode`` steps.

Deviations kept from the JAX package: future goals are drawn with
replacement, and the recorded return is the sparse HER return.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from freerl_tpu_torch.algos.base import ExploreCtx
from freerl_tpu_torch.core.types import Transition
from freerl_tpu_torch.envs.base import vec_reset


@dataclasses.dataclass(frozen=True)
class HERConfig:
    seed: int = 0
    num_envs: int = 16
    max_episodes: int = 500
    start_steps: int = 500           # total env steps before learning
    random_steps: int = 0
    k_future: int = 4                # relabeled goals per transition
    sample_range: int = 200          # future window length
    updates_per_episode: Optional[int] = None   # default: episode length


def relabel_future(env, obs: torch.Tensor, action: torch.Tensor,
                   next_obs: torch.Tensor, u: torch.Tensor,
                   sample_range: int) -> Transition:
    """'Future' relabeling of trajectories.

    obs/next_obs: (..., T, obs_dim); action: (..., T, act_dim); u: (..., T,
    k) uniforms on [0, 1), which pick for step t the future step
    ``t + floor(u * min(sample_range, T - t))``. Leading dims are
    independent trajectories. Returns the prod(...) * T * k relabeled
    copies, trajectory-major, then t, then k, with done = False.
    """
    T, k = u.shape[-2], u.shape[-1]
    lead = tuple(obs.shape[:-2])
    t_idx = torch.arange(T, device=obs.device)
    win = torch.clamp(T - t_idx, max=sample_range)                   # (T,)
    j = t_idx[:, None] + torch.floor(u * win[:, None]).to(torch.int64)
    # gather next_obs at j along the time axis: (..., T, k, obs_dim)
    src = next_obs.reshape((-1, T, next_obs.shape[-1]))
    jj = j.reshape((-1, T * k))
    picked = torch.gather(
        src, 1, jj[..., None].expand(-1, -1, src.shape[-1]))
    new_goal = env.achieved(picked).reshape(lead + (T, k, -1))
    obs_k = obs[..., None, :].expand(lead + (T, k, obs.shape[-1]))
    next_k = next_obs[..., None, :].expand(lead + (T, k, obs.shape[-1]))
    act_k = action[..., None, :].expand(lead + (T, k, action.shape[-1]))
    reward = env.goal_reward(new_goal, obs_k)
    n = int(np.prod(lead, dtype=np.int64)) * T * k

    def flat(x):
        return x.reshape((n,) + tuple(x.shape[len(lead) + 2:]))

    zeros = torch.zeros(n, dtype=torch.bool, device=obs.device)
    return Transition(
        obs=flat(env.with_goal(obs_k, new_goal)), action=flat(act_k),
        reward=flat(reward), next_obs=flat(env.with_goal(next_k, new_goal)),
        done=zeros, episode_done=zeros,
    )


def run_episode(env, algo, cfg: HERConfig, algo_state, buffer, ep: int,
                generator: torch.Generator):
    """One episode of the whole env batch: rollout, the two adds, and the
    learner burst. Returns (algo_state, buffer, returns (num_envs,))."""
    n, T, dev = cfg.num_envs, env.max_steps, env.device
    env_state, obs = vec_reset(env, generator, n)
    episodes = torch.tensor(ep, device=dev)
    no_done = torch.zeros(n, dtype=torch.bool, device=dev)
    steps = {k: [] for k in ("obs", "action", "reward", "next_obs", "term")}
    for t in range(T):
        ctx = ExploreCtx(total_env_steps=(ep * T + t) * n, episodes=episodes,
                         done_prev=no_done, random_steps=cfg.random_steps)
        algo_state, action = algo.explore(algo_state, obs, generator, ctx)
        env_state, next_obs, reward, term, _ = env.step(
            env_state, action, env.draw_step(n, generator))
        for key, x in zip(steps, (obs, action, reward, next_obs, term)):
            steps[key].append(x)
        obs = next_obs
    roll = {key: torch.stack(x) for key, x in steps.items()}    # (T, n, ...)

    # real transitions: done = terminated, the episode ends at the horizon
    ep_done = torch.zeros((T, n), dtype=torch.bool, device=dev)
    ep_done[-1] = True

    def time_major(x):
        return x.reshape((T * n,) + tuple(x.shape[2:]))

    buffer.add(Transition(
        obs=time_major(roll["obs"]), action=time_major(roll["action"]),
        reward=time_major(roll["reward"]),
        next_obs=time_major(roll["next_obs"]), done=time_major(roll["term"]),
        episode_done=time_major(ep_done)))
    # relabeled copies, trajectory by trajectory
    u = torch.rand((n, T, cfg.k_future), generator=generator, device=dev)
    buffer.add(relabel_future(
        env, roll["obs"].transpose(0, 1), roll["action"].transpose(0, 1),
        roll["next_obs"].transpose(0, 1), u, cfg.sample_range))

    if (ep + 1) * T * n > cfg.start_steps:
        for _ in range(cfg.updates_per_episode or T):
            algo_state, buffer, _ = algo.learn_step(algo_state, buffer,
                                                    generator, n)
    return algo_state, buffer, roll["reward"].sum(dim=0)


def train_her(env, algo, cfg: HERConfig):
    """HER training: an off-policy algo on a goal env (one exposing
    ``achieved``/``with_goal``/``goal_reward`` and a fixed horizon), on the
    env's device. Returns ``(algo_state, episode_returns ndarray, info)``.
    """
    generator = torch.Generator(device=env.device)
    generator.manual_seed(cfg.seed)
    algo_state = algo.init(generator)
    di, dev = env.dim_info, env.device
    example = Transition(
        obs=torch.zeros(di.obs_dim, device=dev),
        action=torch.zeros(di.action_dim, device=dev),
        reward=torch.zeros((), device=dev),
        next_obs=torch.zeros(di.obs_dim, device=dev),
        done=torch.zeros((), dtype=torch.bool, device=dev),
        episode_done=torch.zeros((), dtype=torch.bool, device=dev),
    )
    buffer = algo.make_buffer(example)

    t0 = time.time()
    returns, ep = [], 0
    while ep * cfg.num_envs < cfg.max_episodes:
        algo_state, buffer, rets = run_episode(env, algo, cfg, algo_state,
                                               buffer, ep, generator)
        returns.append(rets)
        ep += 1
    returns = torch.cat(returns)[: cfg.max_episodes].cpu().numpy()
    info = {
        "elapsed_s": time.time() - t0,
        "env_steps": ep * env.max_steps * cfg.num_envs,
        "episodes": int(len(returns)),
    }
    return algo_state, returns, info
