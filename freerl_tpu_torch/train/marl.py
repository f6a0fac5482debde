"""Multi-agent off-policy training driver for MADDPG, MATD3, MASAC and
MAAC (counterpart: ``freerl_tpu/train/marl.py``).

The single-agent loop with an agent axis: observations ``(N, A, O_pad)``,
rewards ``(N, A)``; every agent of an env ends its episode at once (MPE
truncates at 25 steps). Stored actions live in [-1, 1] (the tanh actors'
range) and are remapped to the MPE box [0, 1] at the env; discrete actions
are ``(N, A)`` indices. The episode record is ``(E, A)``: each agent's
return.

The host only counts: the learner bursts ``updates_per_burst`` steps on
every vector step once ``total_steps * num_envs > start_steps``, decided
on host ints, and the episode counter is read back every
``host_sync_every`` chunks.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from freerl_tpu_torch.algos.base import ExploreCtx
from freerl_tpu_torch.core.types import Transition
from freerl_tpu_torch.envs.base import Env, vec_reset, vec_step_auto_reset
from freerl_tpu_torch.train.loop import LoopCarry, record_episodes
from freerl_tpu_torch.train.runio import save_checkpoint


@dataclasses.dataclass(frozen=True)
class MARLConfig:
    seed: int = 0
    num_envs: int = 16
    max_episodes: int = 600
    max_env_steps: int = 10_000_000
    start_steps: int = 500
    random_steps: int = 0
    updates_per_burst: int = 1
    chunk_size: int = 128
    log_every_chunks: int = 8
    # save the algo state to f"{checkpoint_dir}/ckpt" every N chunks
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    # read the episode counter back from the device every N chunks; the
    # termination on max_episodes can overshoot by up to N-1 chunks
    host_sync_every: int = 4


def example_transition(env: Env) -> Transition:
    """One transition with no batch dim, to allocate the replay ring:
    (A, O_pad) observations, (A, act_pad) float or (A,) int32 actions, an
    (A,) reward and scalar flags."""
    a, di, dev = env.n_agents, env.dim_info, env.device
    action = (torch.zeros((a, di.action_dim), device=dev) if di.is_continue
              else torch.zeros(a, dtype=torch.int32, device=dev))
    return Transition(
        obs=torch.zeros((a, di.obs_dim), device=dev),
        action=action,
        reward=torch.zeros(a, device=dev),
        next_obs=torch.zeros((a, di.obs_dim), device=dev),
        done=torch.zeros((), dtype=torch.bool, device=dev),
        episode_done=torch.zeros((), dtype=torch.bool, device=dev),
    )


def vector_step(env: Env, algo, cfg: MARLConfig, c: LoopCarry,
                generator: torch.Generator, record_cap: int,
                local_envs: Optional[int] = None) -> None:
    """One vector step of the loop, updating the carry in place;
    ``local_envs`` as in ``train/loop.py:vector_step``."""
    num_envs = cfg.num_envs
    n_here = local_envs or num_envs
    ctx = ExploreCtx(
        total_env_steps=c.total_steps * num_envs,
        episodes=c.ep_counter,
        done_prev=c.done_prev,
        random_steps=cfg.random_steps,
    )
    c.algo_state, action = algo.explore(c.algo_state, c.obs, generator, ctx)
    env_action = (action + 1.0) / 2.0 if env.dim_info.is_continue else action
    out = vec_step_auto_reset(env, c.env_state, env_action, generator,
                              n_here)
    dones = out.episode_done
    c.buffer = c.buffer.add(Transition(
        obs=c.obs, action=action, reward=out.reward, next_obs=out.next_obs,
        done=out.terminated, episode_done=dones,
    ))
    record_episodes(env, c, out.reward, dones, record_cap)
    c.done_prev = dones
    c.env_state, c.obs = out.state, out.carry_obs

    c.total_steps += 1
    if c.total_steps * num_envs > cfg.start_steps:
        for _ in range(cfg.updates_per_burst):
            c.algo_state, c.buffer, _ = algo.learn_step(
                c.algo_state, c.buffer, generator, n_here)
        c.update_count += cfg.updates_per_burst


def start(env: Env, algo, num_envs: int, generator: torch.Generator,
          record_cap: int, algo_state=None) -> LoopCarry:
    """The algo's initial state (``algo_state``, or built from
    ``generator``), its replay and the reset batch, in a fresh carry with
    an (record_cap + 1, n_agents) record."""
    device, n_agents = env.device, env.n_agents
    if algo_state is None:
        algo_state = algo.init(generator)
    env_state, obs = vec_reset(env, generator, num_envs)
    return LoopCarry(
        algo_state=algo_state,
        buffer=algo.make_buffer(example_transition(env), num_envs=num_envs),
        env_state=env_state,
        obs=obs,
        ep_return=torch.zeros((num_envs, n_agents), device=device),
        done_prev=torch.zeros(num_envs, dtype=torch.bool, device=device),
        ep_counter=torch.zeros((), dtype=torch.int64, device=device),
        episode_returns=torch.zeros((record_cap + 1, n_agents),
                                    device=device),
    )


def train_marl(env: Env, algo, cfg: MARLConfig,
               on_chunk: Optional[Callable] = None, mesh=None):
    """``algo`` exposes ``init(generator)``, ``make_buffer(example,
    num_envs)``, ``explore(state, obs, generator, ctx)`` and
    ``learn_step(state, buffer, generator, num_envs)`` (``MADDPG``,
    ``MATD3``, ``MASAC``, ``MAAC``); ``env`` and ``algo`` share a device.
    ``on_chunk(chunk, episodes, env_steps, carry)`` fires once per
    ``log_every_chunks`` chunks.

    With ``mesh`` (``distributed.make_mesh``), every rank calls this and
    the loop runs data-parallel through ``distributed/dp.py`` (the algo's
    config must carry ``axis_name`` equal to the mesh's axis).

    Returns ``(algo_state, episode_returns ndarray (E, n_agents), info)``.
    """
    if mesh is not None:
        from freerl_tpu_torch.distributed.dp import train_marl_sharded

        return train_marl_sharded(env, algo, cfg, mesh, on_chunk=on_chunk)
    num_envs = cfg.num_envs
    # an episode costs >=1 env step, so the record never needs more slots
    # than the step budget plus the final chunk's overshoot
    record_cap = min(
        cfg.max_episodes,
        cfg.max_env_steps + cfg.chunk_size * num_envs,
    ) + num_envs + 1

    generator = torch.Generator(device=env.device)
    generator.manual_seed(cfg.seed)
    c = start(env, algo, num_envs, generator, record_cap)

    t0 = time.time()
    chunk_i = 0
    n_eps = 0
    while True:
        for _ in range(cfg.chunk_size):
            vector_step(env, algo, cfg, c, generator, record_cap)
        chunk_i += 1
        n_steps = c.total_steps * num_envs
        if (chunk_i % cfg.host_sync_every == 0
                or n_steps >= cfg.max_env_steps):
            n_eps = int(c.ep_counter)
        if on_chunk is not None and chunk_i % cfg.log_every_chunks == 0:
            on_chunk(chunk_i, n_eps, n_steps, c)
        if (cfg.checkpoint_dir and cfg.checkpoint_every
                and chunk_i % cfg.checkpoint_every == 0):
            save_checkpoint(f"{cfg.checkpoint_dir}/ckpt", c.algo_state)
        if n_eps >= cfg.max_episodes or n_steps >= cfg.max_env_steps:
            break

    n_eps = int(c.ep_counter)
    elapsed = time.time() - t0
    returns = c.episode_returns[: min(n_eps, cfg.max_episodes)]
    info = {
        "elapsed_s": elapsed,
        "env_steps": n_steps,
        "updates": c.update_count,
        "env_steps_per_s": n_steps / max(elapsed, 1e-9),
        "episodes": n_eps,
    }
    return c.algo_state, np.asarray(returns.cpu()), info
