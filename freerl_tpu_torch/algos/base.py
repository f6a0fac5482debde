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
from freerl_tpu_torch.distributed.dp import mesh_of


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
             indices; drawn only during the warm-up;
    policy:  standard normals of a sampled policy where ``normal`` is the
             exploration noise (MADDPG's Gaussian actor);
    preference: (B, R) standard normals of the preference each row acts
             under (ENVELOPE, ``algos/envelope.py:random_preference``);
    uniform: (B,) uniforms of an epsilon-greedy choice (ENVELOPE).

    Multi-agent algos put an agent axis after B: (B, n_agents, act_pad).
    """

    normal: Optional[torch.Tensor] = None
    ou: Optional[torch.Tensor] = None
    gumbel: Optional[torch.Tensor] = None
    random: Optional[torch.Tensor] = None
    policy: Optional[torch.Tensor] = None
    preference: Optional[torch.Tensor] = None
    uniform: Optional[torch.Tensor] = None


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
    """A config's ``axis_name`` must name a mesh that
    ``distributed.make_mesh`` registered: the updates all-reduce over it,
    and an unknown axis raises here rather than skipping the reduction."""
    if cfg.axis_name is not None:
        mesh_of(cfg.axis_name)


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


# ---------------------------------------------------------------------------
# The multi-agent off-policy family (MADDPG, MASAC, MAAC)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class LearnDraws:
    """The draws of one multi-agent learner step; a field an algo does not
    use is None. Draws are laid out as actions are, ``(..., A, P)``, with
    ``P`` the widest agent's action width: agent j's are the first
    ``act_dims[j]`` columns of ``[..., j, :]``.

    idx:    (A, B) replay indices, a fresh batch for each updating agent
            (MADDPG, MASAC), or (B,), one batch for all (MAAC);
    smooth: (A, B, A, P) standard normals of MATD3's target-policy noise:
            ``[i, :, j]`` on agent j's next action in agent i's target;
    next:   (A, B, A, P) standard normals of the sampled next actions:
            ``[i, :, j]``, agent j's in agent i's target (MASAC; MADDPG's
            Gaussian actor);
    new:    standard normals of the actor loss's sampled actions: (A, B, A,
            P), ``[i, :, j]`` agent j's in agent i's loss (MASAC), or
            (B, A, P), agent i's own at ``[:, i]`` (MADDPG's Gaussian
            actor);
    gumbel: (B, A, P) Gumbel noise of each agent's sampled next action
            (MAAC).
    """

    idx: torch.Tensor
    smooth: Optional[torch.Tensor] = None
    next: Optional[torch.Tensor] = None
    new: Optional[torch.Tensor] = None
    gumbel: Optional[torch.Tensor] = None


class MultiAgentAlgo(OffPolicyAlgo):
    """What MADDPG, MASAC and MAAC share: the per-agent widths of a
    multi-agent env (observations ``(..., A, O_pad)``, actions
    ``(..., A, P)`` or ``(..., A)`` indices), slicing and padding, and a
    ``learn_step`` whose draws include the replay indices:
    ``draw_update(buffer, generator)`` then ``update(state, buffer,
    draws)``."""

    def __init__(self, env, cfg, device="cuda"):
        check_axis_name(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.n_agents = env.n_agents
        self.obs_dims = tuple(env.agent_obs_dims)
        self.act_dims = tuple(env.agent_act_dims)
        self.act_pad = max(self.act_dims)

    def _obs(self, obs: torch.Tensor, i: int) -> torch.Tensor:
        """Agent i's true-width slice of (..., A, O_pad) observations."""
        return obs[..., i, :self.obs_dims[i]]

    def _act(self, act: torch.Tensor, i: int) -> torch.Tensor:
        """Agent i's true-width slice of (..., A, P) actions or draws."""
        return act[..., i, :self.act_dims[i]]

    def _stack(self, acts: list) -> torch.Tensor:
        """Per-agent true-width actions, zero-padded to (..., A, P)."""
        return torch.stack([torch.nn.functional.pad(a, (0, self.act_pad
                                                        - a.shape[-1]))
                            for a in acts], dim=-2)

    def _joint(self, obs: torch.Tensor, acts: list):
        """A centralized critic's input: every agent's true-width
        observation, and the actions ``acts`` (one per agent), each
        concatenated."""
        return (torch.cat([self._obs(obs, j) for j in range(self.n_agents)],
                          dim=-1), torch.cat(acts, dim=-1))

    def _normals(self, shape, generator: torch.Generator) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=self.device)

    def _idx(self, buffer, generator: torch.Generator,
             per_agent: bool = True) -> torch.Tensor:
        """Replay indices: (A, B), one batch per agent, or (B,)."""
        b = self.cfg.batch_size
        if not per_agent:
            return buffer.sample_idx(generator, b)
        return buffer.sample_idx(generator, self.n_agents * b).reshape(
            self.n_agents, b)

    def learn_step(self, state, buffer, generator: torch.Generator,
                   num_envs: int):
        state, metrics = self.update(state, buffer,
                                     self.draw_update(buffer, generator))
        return state, buffer, metrics
