"""Vectorized off-policy actor-learner loop (counterpart:
``freerl_tpu/train/loop.py``).

One vector step is, in order: explore, auto-resetting env step, replay add
(through the algo's ``add_transition`` where it has one), chronological
episode record, then the learner burst. Everything runs on
the algo's and env's device. The host only counts: ``start_steps`` and
the learn cadence are counted in TOTAL env steps (num_envs per vector step)
as Python ints, so deciding whether to learn costs no device sync, and the
episode counter is read back only every ``host_sync_every`` chunks.

Conventions kept from the JAX package: ``done`` = terminated only goes
into the buffer; episode accounting uses terminated|truncated; finished
returns are written to a chronological record.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from freerl_tpu_torch.algos.base import ExploreCtx
from freerl_tpu_torch.core.types import Transition
from freerl_tpu_torch.envs.base import (Env, record_scalarize, row_mask,
                                        vec_reset, vec_step_auto_reset)
from freerl_tpu_torch.train.runio import save_checkpoint


@dataclasses.dataclass(frozen=True)
class OffPolicyConfig:
    seed: int = 0
    num_envs: int = 16
    max_episodes: int = 500
    max_env_steps: int = 10_000_000      # hard budget
    start_steps: int = 500               # env steps before learning
    random_steps: int = 0                # uniform-random action warmup
    learn_interval_steps: int = 1        # env steps between update bursts
    updates_per_burst: int = 1           # gradient updates per burst
    chunk_size: int = 256                # vector steps between host checks
    log_every_chunks: int = 8
    # save the algo state to f"{checkpoint_dir}/ckpt" every N chunks
    checkpoint_dir: Optional[str] = None
    checkpoint_every_chunks: int = 0
    # read the episode counter back from the device every N chunks; the
    # termination on max_episodes can overshoot by up to N-1 chunks
    host_sync_every: int = 4


@dataclasses.dataclass
class LoopCarry:
    algo_state: object
    buffer: object
    env_state: object
    obs: torch.Tensor
    ep_return: torch.Tensor        # (num_envs,)
    done_prev: torch.Tensor        # (num_envs,) episode ended last step
    ep_counter: torch.Tensor       # scalar int64, completed episodes
    episode_returns: torch.Tensor  # (record_cap + 1,); the last slot drops
    total_steps: int = 0           # vector steps so far (host)
    update_count: int = 0          # (host)
    # the data-parallel drivers' completion vector-step of each record
    # slot, by which they merge the ranks' records
    episode_steps: Optional[torch.Tensor] = None


def example_transition(env: Env, algo=None) -> Transition:
    """One transition with no batch dim, to allocate the replay ring: a
    float (action_dim,) action for continuous envs, the algo's
    ``stored_action_example()`` where it stores something richer than the
    env's index (discrete DDPG), else an int32 index; a multi-objective
    env's (reward_dim,) reward, else a scalar one."""
    di = env.dim_info
    dev = env.device
    if di.is_continue:
        action = torch.zeros(di.action_dim, dtype=torch.float32, device=dev)
    elif hasattr(algo, "stored_action_example"):
        action = algo.stored_action_example().to(dev)
    else:
        action = torch.zeros((), dtype=torch.int32, device=dev)
    rdim = getattr(env, "reward_dim", 1)
    return Transition(
        obs=torch.zeros(di.obs_dim, dtype=torch.float32, device=dev),
        action=action,
        reward=torch.zeros((rdim,) if rdim > 1 else (), dtype=torch.float32,
                           device=dev),
        next_obs=torch.zeros(di.obs_dim, dtype=torch.float32, device=dev),
        done=torch.zeros((), dtype=torch.bool, device=dev),
        episode_done=torch.zeros((), dtype=torch.bool, device=dev),
    )


def record_episodes(env: Env, c, reward: torch.Tensor,
                    dones: torch.Tensor, record_cap: int) -> None:
    """Episode accounting on a carry ``c`` with ``ep_return``,
    ``ep_counter`` and ``episode_returns`` (this loop's, the on-policy
    driver's and the multi-agent driver's): write finished returns
    chronologically. Slots past the record, and rows still running, land in
    the drop slot ``record_cap`` (the masked form of JAX's ``mode="drop"``
    scatter). A multi-agent reward (N, A) keeps its agent axis, into an
    (record_cap + 1, A) record (``record_scalarize``). Where the carry has
    ``episode_steps``, each slot also gets the vector step it completed
    at."""
    ret = c.ep_return + record_scalarize(env, reward)
    offs = torch.cumsum(dones.to(torch.int64), 0) - 1
    slot = torch.where(dones, c.ep_counter + offs, record_cap)
    slot.clamp_(max=record_cap)
    c.episode_returns[slot] = ret
    if c.episode_steps is not None:
        c.episode_steps[slot] = c.total_steps
    c.ep_counter = c.ep_counter + dones.sum()
    c.ep_return = torch.where(row_mask(dones, ret), 0.0, ret)


def vector_step(env: Env, algo, cfg: OffPolicyConfig, c: LoopCarry,
                generator: torch.Generator, record_cap: int,
                local_envs: Optional[int] = None) -> None:
    """One vector step of the loop, updating the carry in place.
    ``local_envs`` is the number of envs stepped here where it is not
    ``cfg.num_envs`` (one rank's slice under a mesh); warm-ups and the
    learn cadence count all ``cfg.num_envs``."""
    num_envs = cfg.num_envs
    n_here = local_envs or num_envs
    ctx = ExploreCtx(
        total_env_steps=c.total_steps * num_envs,
        episodes=c.ep_counter,
        done_prev=c.done_prev,
        random_steps=cfg.random_steps,
    )
    if hasattr(algo, "explore_stored"):
        # the env acts on ``action``, the buffer keeps ``stored`` (discrete
        # DDPG: a sampled index, and the behaviour probs or one-hot)
        c.algo_state, action, stored = algo.explore_stored(
            c.algo_state, c.obs, generator, ctx)
    else:
        c.algo_state, action = algo.explore(c.algo_state, c.obs, generator,
                                            ctx)
        stored = action
    out = vec_step_auto_reset(env, c.env_state, action, generator, n_here)
    c.algo_state, next_obs, carry_obs = algo.process_obs(
        c.algo_state, out.next_obs, out.carry_obs
    )
    dones = out.episode_done
    trans = Transition(obs=c.obs, action=stored, reward=out.reward,
                       next_obs=next_obs, done=out.terminated,
                       episode_done=dones)
    if hasattr(algo, "add_transition"):
        # an algo-mediated add (ENVELOPE's add-time priorities and its
        # homotopy schedule)
        c.algo_state, c.buffer = algo.add_transition(
            c.algo_state, c.buffer, trans, generator)
    else:
        c.buffer = c.buffer.add(trans)

    record_episodes(env, c, out.reward, dones, record_cap)
    c.done_prev = dones
    c.env_state, c.obs = out.state, carry_obs

    # learner burst, decided on host counters
    c.total_steps += 1
    do_learn = (
        c.total_steps * num_envs > cfg.start_steps
        and c.total_steps % max(cfg.learn_interval_steps // num_envs, 1) == 0
    )
    if do_learn:
        for _ in range(cfg.updates_per_burst):
            c.algo_state, c.buffer, _ = algo.learn_step(
                c.algo_state, c.buffer, generator, n_here
            )
        c.update_count += cfg.updates_per_burst


def train_offpolicy(env: Env, algo, cfg: OffPolicyConfig,
                    on_chunk: Optional[Callable] = None, mesh=None):
    """Generic off-policy training loop for the DQN, DDPG, TD3 and SAC
    families.
    ``algo`` must expose ``init(generator)``, ``make_buffer(example,
    num_envs)``, ``explore(state, obs, generator, ctx)`` (or
    ``explore_stored``), ``process_obs`` and ``learn_step(state, buffer,
    generator, num_envs)``; ``env`` and ``algo`` must share a device.

    With ``mesh`` (``distributed.make_mesh``), every rank calls this and
    the loop runs data-parallel through ``distributed/dp.py``: each rank
    steps its slice of the envs into its own replay, and the learner's
    gradients are all-reduced (the algo's config must carry ``axis_name``
    equal to the mesh's axis).

    Returns ``(algo_state, episode_returns ndarray, info dict)``.
    """
    if mesh is not None:
        from freerl_tpu_torch.distributed.dp import train_offpolicy_sharded

        return train_offpolicy_sharded(env, algo, cfg, mesh,
                                       on_chunk=on_chunk)
    num_envs = cfg.num_envs
    device = env.device
    # an episode costs >=1 env step, so the record never needs more slots
    # than the step budget plus the final chunk's overshoot
    record_cap = min(
        cfg.max_episodes,
        cfg.max_env_steps + cfg.chunk_size * num_envs,
    ) + num_envs + 1

    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.seed)
    algo_state = algo.init(generator)
    buffer = algo.make_buffer(example_transition(env, algo),
                              num_envs=num_envs)
    env_state, obs = vec_reset(env, generator, num_envs)
    carry = LoopCarry(
        algo_state=algo_state,
        buffer=buffer,
        env_state=env_state,
        obs=obs,
        ep_return=torch.zeros(num_envs, device=device),
        done_prev=torch.zeros(num_envs, dtype=torch.bool, device=device),
        ep_counter=torch.zeros((), dtype=torch.int64, device=device),
        episode_returns=torch.zeros(record_cap + 1, device=device),
    )

    t0 = time.time()
    chunk_i = 0
    n_eps = 0
    while True:
        for _ in range(cfg.chunk_size):
            vector_step(env, algo, cfg, carry, generator, record_cap)
        chunk_i += 1
        n_steps = carry.total_steps * num_envs
        if (chunk_i % cfg.host_sync_every == 0
                or n_steps >= cfg.max_env_steps):
            n_eps = int(carry.ep_counter)
        if on_chunk is not None and chunk_i % cfg.log_every_chunks == 0:
            on_chunk(chunk_i, n_eps, n_steps, carry)
        if (cfg.checkpoint_dir and cfg.checkpoint_every_chunks
                and chunk_i % cfg.checkpoint_every_chunks == 0):
            save_checkpoint(f"{cfg.checkpoint_dir}/ckpt", carry.algo_state)
        if n_eps >= cfg.max_episodes or n_steps >= cfg.max_env_steps:
            break

    n_eps = int(carry.ep_counter)
    elapsed = time.time() - t0
    returns = carry.episode_returns[: min(n_eps, cfg.max_episodes)]
    info = {
        "elapsed_s": elapsed,
        "env_steps": carry.total_steps * num_envs,
        "updates": carry.update_count,
        "env_steps_per_s": carry.total_steps * num_envs / max(elapsed, 1e-9),
        "episodes": n_eps,
    }
    return carry.algo_state, np.asarray(returns.cpu()), info
