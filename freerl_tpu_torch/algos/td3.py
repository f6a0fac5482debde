"""TD3 with the reference's three switches (counterpart:
``freerl_tpu/algos/td3.py``).

A twin critic with a Q1-only path for the actor loss; clipped double-Q
(the min of the two target heads); target-policy smoothing noise (sigma
0.1, clipped to +-0.5); the actor and BOTH target nets updated only every
``policy_freq``-th learner step. The step counter is a host int, so the
delayed update is a Python branch and costs no device sync. Shared
skeleton: 2x128 nets, Adam 1e-3, clip 0.5, tau 0.01, Gaussian exploration
noise with an episode-linear scale decay.

``update`` takes the smoothing noise as an argument (standard normals of
the next action's shape); ``draw_update`` makes it from the caller's
generator.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn

from freerl_tpu_torch.algos.base import (ExploreCtx, ExploreDraws,
                                         OffPolicyAlgo, check_axis_name,
                                         draw_random_actions, frozen_copy,
                                         noise_scale)
from freerl_tpu_torch.algos.common import optimizer_step, polyak, td_target
from freerl_tpu_torch.algos.ddpg import TanhActor
from freerl_tpu_torch.core.types import DimInfo, Transition
from freerl_tpu_torch.nets.mlp import MLP


class TwinQCritic(nn.Module):
    """Two Q(obs, act) MLPs; ``q1`` is the Q1-only path of the actor loss.
    With ``action_dim`` heads and no action input it is the discrete twin
    critic (``TwinQTable`` in ``algos/sac.py``)."""

    def __init__(self, in_dim: int, hidden: Sequence[int] = (128, 128),
                 out_dim: int = 1,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        self.q1_net = MLP(in_dim, out_dim, hidden, "relu", generator, device)
        self.q2_net = MLP(in_dim, out_dim, hidden, "relu", generator, device)
        self.squeeze = out_dim == 1

    def _out(self, y: torch.Tensor) -> torch.Tensor:
        return y[..., 0] if self.squeeze else y

    def forward(self, obs: torch.Tensor, act: torch.Tensor | None = None):
        x = obs if act is None else torch.cat([obs, act], dim=-1)
        return self._out(self.q1_net(x)), self._out(self.q2_net(x))

    def q1(self, obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        return self._out(self.q1_net(torch.cat([obs, act], dim=-1)))


@dataclasses.dataclass(frozen=True)
class TD3Config:
    """Static hyperparameters, with the JAX package's fields and defaults."""

    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    gamma: float = 0.99
    tau: float = 0.01
    batch_size: int = 64
    buffer_size: int = 1_000_000
    hidden: Sequence[int] = (128, 128)
    num_envs: int = 1
    # exploration
    gauss_sigma: float = 0.1
    noise_init_scale: Optional[float] = 1.0
    noise_final_scale: float = 0.0
    noise_decay_episodes: int = 500
    # the three switches
    clip_double: bool = True
    policy_noise: bool = True
    twin_delay: bool = True
    policy_noise_sigma: float = 0.1
    noise_clip: float = 0.5
    policy_freq: int = 2
    axis_name: Optional[str] = None


@dataclasses.dataclass
class TD3State:
    actor: TanhActor
    actor_target: TanhActor
    critic: TwinQCritic
    critic_target: TwinQCritic
    actor_opt: torch.optim.Optimizer
    critic_opt: torch.optim.Optimizer
    step: int = 0


class TD3(OffPolicyAlgo):
    GRAD_CLIP = 0.5          # both nets, every update

    def __init__(self, dim_info: DimInfo, cfg: TD3Config = TD3Config(),
                 device="cuda"):
        if not dim_info.is_continue:
            raise ValueError("TD3 is continuous-control")
        check_axis_name(cfg)
        self.dim_info = dim_info
        self.cfg = cfg
        self.device = torch.device(device)

    def init(self, generator: torch.Generator) -> TD3State:
        cfg, di = self.cfg, self.dim_info
        actor = TanhActor(di.obs_dim, di.action_dim, tuple(cfg.hidden),
                          di.max_action, "torch", generator, self.device)
        critic = TwinQCritic(di.obs_dim + di.action_dim, tuple(cfg.hidden), 1,
                             generator, self.device)
        return TD3State(
            actor=actor, actor_target=frozen_copy(actor),
            critic=critic, critic_target=frozen_copy(critic),
            actor_opt=torch.optim.Adam(actor.parameters(), lr=cfg.actor_lr,
                                       eps=1e-8),
            critic_opt=torch.optim.Adam(critic.parameters(), lr=cfg.critic_lr,
                                        eps=1e-8),
        )

    # ------------------------------------------------------------------
    @torch.no_grad()
    def select_action(self, state: TD3State, obs: torch.Tensor):
        return state.actor(obs)

    evaluate_action = select_action

    def draw_explore(self, b: int, generator: torch.Generator,
                     ctx: ExploreCtx) -> ExploreDraws:
        di = self.dim_info
        draws = ExploreDraws(normal=torch.randn(
            b, di.action_dim, generator=generator, device=self.device))
        if ctx.warmup:
            draws.random = draw_random_actions(di, b, generator, self.device)
        return draws

    def explore_with(self, state: TD3State, obs: torch.Tensor,
                     draws: ExploreDraws, ctx: ExploreCtx):
        max_a = self.dim_info.max_action
        a = self.select_action(state, obs)
        noise = self.cfg.gauss_sigma * noise_scale(self.cfg, ctx.episodes) \
            * draws.normal
        action = torch.clamp(a + noise, -max_a, max_a)
        if ctx.warmup:
            action = draws.random
        return state, action

    # ------------------------------------------------------------------
    def draw_update(self, batch: Transition, generator: torch.Generator):
        """The standard normals of the target-policy smoothing noise."""
        if not self.cfg.policy_noise:
            return None
        return torch.randn(batch.obs.shape[0], self.dim_info.action_dim,
                           generator=generator, device=self.device)

    def update(self, state: TD3State, batch: Transition,
               draws: Optional[torch.Tensor] = None):
        """One learner step, in place. ``draws`` is the (B, A) standard
        normal of the smoothing noise (needed under ``policy_noise``).
        Returns (state, metrics, None); ``actor_loss`` is 0 on the steps
        that skip the actor."""
        cfg, max_a = self.cfg, self.dim_info.max_action
        reward = batch.reward.reshape(-1)
        done = batch.done.reshape(-1)
        action = batch.action.reshape(-1, self.dim_info.action_dim)

        with torch.no_grad():
            next_action = state.actor_target(batch.next_obs)
            if cfg.policy_noise:
                if draws is None:
                    raise ValueError("policy_noise needs the smoothing draws")
                noise = torch.clamp(cfg.policy_noise_sigma * draws,
                                    -cfg.noise_clip, cfg.noise_clip)
                next_action = torch.clamp(next_action + noise, -max_a, max_a)
            q1_t, q2_t = state.critic_target(batch.next_obs, next_action)
            next_q = torch.minimum(q1_t, q2_t) if cfg.clip_double else q1_t
            target = td_target(reward, cfg.gamma, next_q, done)

        critic_params = list(state.critic.parameters())
        q1, q2 = state.critic(batch.obs, action)
        critic_loss = (torch.mean(torch.square(q1 - target))
                       + torch.mean(torch.square(q2 - target)))
        optimizer_step(state.critic_opt, critic_params, critic_loss,
                       self.GRAD_CLIP, cfg.axis_name)

        # delayed actor update; both polyak updates only on its steps
        freq = cfg.policy_freq if cfg.twin_delay else 1
        if state.step % freq == freq - 1:
            actor_params = list(state.actor.parameters())
            actor_loss = -torch.mean(
                state.critic.q1(batch.obs, state.actor(batch.obs)))
            optimizer_step(state.actor_opt, actor_params, actor_loss,
                           self.GRAD_CLIP, cfg.axis_name)
            polyak(state.actor_target.parameters(), actor_params, cfg.tau)
            polyak(state.critic_target.parameters(), critic_params, cfg.tau)
            actor_loss = actor_loss.detach()
        else:
            actor_loss = torch.zeros((), device=self.device)
        state.step += 1
        return state, {"critic_loss": critic_loss.detach(),
                       "actor_loss": actor_loss}, None
