"""Shared off-policy algorithm protocol consumed by the train loop
(counterpart: ``freerl_tpu/algos/base.py``).

The loop (``freerl_tpu_torch/train/loop.py``) drives any algo exposing:
  init(generator) -> state
  make_buffer(example, num_envs) -> buffer
  explore(state, obs, generator, ctx) -> (state, action)       # batched
  process_obs(state, next_obs, carry_obs) -> (state, next_obs, carry_obs)
  learn_step(state, buffer, generator, num_envs) -> (state, buffer, metrics)
and, where the buffer keeps another action than the env takes,
  explore_stored(state, obs, generator, ctx) -> (state, action, stored).

Every random draw comes from the caller's generator through a split: the
default ``explore`` makes an :class:`ExploreDraws` with ``draw_explore`` and
hands it to ``explore_with``, and the default ``learn_step`` samples a batch,
makes the update's draws with ``draw_update`` and hands them to ``update``.
Tests call ``explore_with`` and ``update`` with the JAX package's draws.

State and buffers are updated in place (PyTorch has no need for JAX's
functional copies) and returned, so the call shapes stay those of the JAX
package.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch

from freerl_tpu_torch.core.types import Transition


@dataclasses.dataclass
class ExploreCtx:
    """Loop counters for exploration schedules. The step count is a host
    int, so deciding on it costs no device sync."""

    total_env_steps: int               # env steps before this step
    episodes: torch.Tensor             # scalar int64, completed episodes
    done_prev: torch.Tensor            # (num_envs,) episode ended last step
    random_steps: int = 0

    @property
    def warmup(self) -> bool:
        """Uniform-random actions replace the policy's: the ``random_steps``
        warm-up, decided on the host."""
        return 0 < self.random_steps and self.total_env_steps < self.random_steps


@dataclasses.dataclass
class ExploreDraws:
    """The draws of one exploration step; a field an algo does not use is
    None.

    normal:  (B, A) standard normals: Gaussian exploration noise, or the
             reparameterization noise of a sampled policy;
    ou:      (num_envs, A) standard normals of the Ornstein-Uhlenbeck step;
    gumbel:  (B, A) Gumbel noise of a categorical sample;
    random:  the warm-up actions, (B, A) uniform in +-max_action or (B,)
             indices; drawn only during the warm-up.
    """

    normal: Optional[torch.Tensor] = None
    ou: Optional[torch.Tensor] = None
    gumbel: Optional[torch.Tensor] = None
    random: Optional[torch.Tensor] = None


def draw_random_actions(dim_info, b: int, generator: torch.Generator,
                        device) -> torch.Tensor:
    """Uniform warm-up actions: (b, A) in +-max_action, or (b,) indices."""
    if dim_info.is_continue:
        max_a = dim_info.max_action
        u = torch.rand((b, dim_info.action_dim), generator=generator,
                       device=device)
        return u * (2 * max_a) - max_a
    return torch.randint(0, dim_info.action_dim, (b,), generator=generator,
                         device=device)


def noise_scale(cfg, episodes: torch.Tensor):
    """The exploration-noise scale, decayed linearly over
    ``noise_decay_episodes`` completed episodes from ``noise_init_scale`` to
    ``noise_final_scale`` (1 when ``noise_init_scale`` is None); a device
    scalar, computed from the device episode counter."""
    if cfg.noise_init_scale is None:
        return 1.0
    remaining = torch.clamp(
        (cfg.noise_decay_episodes - episodes.to(torch.float32))
        / cfg.noise_decay_episodes, min=0.0)
    return cfg.noise_final_scale + (
        cfg.noise_init_scale - cfg.noise_final_scale) * remaining


def ou_step(cfg, ou_state: torch.Tensor, done_prev: torch.Tensor,
            eps: torch.Tensor) -> torch.Tensor:
    """One Ornstein-Uhlenbeck step from zero where an episode just ended:
    ``ou + theta * (0 - ou) + sqrt(dt) * sigma * eps``."""
    ou = torch.where(done_prev[:, None], 0.0, ou_state)
    dx = cfg.ou_theta * (0.0 - ou) + cfg.ou_dt ** 0.5 * (cfg.ou_sigma * eps)
    return ou + dx


def frozen_copy(net: torch.nn.Module) -> torch.nn.Module:
    """A target net: a copy of ``net`` that takes no gradients."""
    return copy.deepcopy(net).requires_grad_(False)


def check_axis_name(cfg) -> None:
    if cfg.axis_name is not None:
        raise NotImplementedError(
            "axis_name (data-parallel gradients) comes with the distributed "
            "slice (ROADMAP.md queue A, slice 8)")


class OffPolicyAlgo:
    """Default hooks; algorithms override what they need."""

    def make_buffer(self, example: Transition, num_envs: int = 0):
        from freerl_tpu_torch.buffers.uniform import ReplayBuffer

        return ReplayBuffer.create(
            self.cfg.buffer_size, example,
            bf16_storage=getattr(self.cfg, "bf16_replay", False),
            add_batch=num_envs,
        )

    def process_obs(self, state, next_obs, carry_obs):
        return state, next_obs, carry_obs

    def explore(self, state, obs: torch.Tensor, generator: torch.Generator,
                ctx: ExploreCtx):
        draws = self.draw_explore(obs.shape[0], generator, ctx)
        return self.explore_with(state, obs, draws, ctx)

    def draw_update(self, batch: Transition, generator: torch.Generator):
        """The draws of one ``update`` on ``batch``; None when it has none."""
        return None

    def learn_step(self, state, buffer, generator: torch.Generator,
                   num_envs: int):
        batch = buffer.sample(generator, self.cfg.batch_size)
        state, metrics, _ = self.update(state, batch,
                                        self.draw_update(batch, generator))
        return state, buffer, metrics
