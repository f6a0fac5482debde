"""SAC, continuous and discrete, with the reference's choices kept
(counterpart: ``freerl_tpu/algos/sac.py``).

- a squashed-Gaussian actor with a STATE-INDEPENDENT ``log_std`` clipped
  to [-20, 2], and the softplus tanh log-prob correction;
- a twin critic; the min of the target heads for the backup but the MEAN
  of Q1 and Q2 in the actor loss;
- next actions from the actor TARGET net;
- an adaptive temperature: ``log_alpha`` is a device scalar (alpha 0.01 at
  start) with its own unclipped Adam (lr 1e-4); target entropy ``-|A|``,
  or ``0.6 * log|A|`` for discrete actions;
- discrete: a softmax policy and a per-action twin Q table, with
  expectation-form backups;
- exploration samples the policy, with an optional Ornstein-Uhlenbeck
  add-on for continuous actions, and ``random_steps`` of uniform warm-up.

``update`` takes its two standard normals ``(eps_next, eps_new)`` (the
target's next actions and the actor loss's actions) as an argument;
``draw_update`` makes them from the caller's generator. Exploration's
draws go through ``draw_explore`` / ``explore_with``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from freerl_tpu_torch.algos.base import (ExploreCtx, ExploreDraws,
                                         OffPolicyAlgo, check_axis_name,
                                         draw_random_actions, frozen_copy,
                                         noise_scale, ou_step)
from freerl_tpu_torch.algos.common import optimizer_step, polyak
from freerl_tpu_torch.algos.td3 import TwinQCritic
from freerl_tpu_torch.core.types import DimInfo, Transition
from freerl_tpu_torch.nets.distributions import (categorical_sample,
                                                 draw_gumbel,
                                                 squashed_sample_logp)
from freerl_tpu_torch.nets.mlp import MLP


class GaussianActor(MLP):
    """A mean head and a global ``log_std`` parameter, clipped to
    [-20, 2] and broadcast to the mean's shape."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (128, 128),
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__(obs_dim, action_dim, hidden, "relu", generator, device)
        self.log_std = nn.Parameter(torch.zeros(action_dim, device=device))

    def forward(self, x: torch.Tensor):
        mean = super().forward(x)
        log_std = torch.clamp(self.log_std, -20.0, 2.0)
        return mean, log_std.expand_as(mean)


class SoftmaxPolicy(MLP):
    """obs -> action logits."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (128, 128),
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__(obs_dim, action_dim, hidden, "relu", generator, device)


class TwinQTable(TwinQCritic):
    """The discrete twin critic: obs -> per-action Q values (B, A), twice."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (128, 128),
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__(obs_dim, hidden, action_dim, generator, device)


@dataclasses.dataclass(frozen=True)
class SACConfig:
    """Static hyperparameters, with the JAX package's fields and defaults."""

    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    alpha_lr: float = 1e-4
    alpha_init: float = 0.01
    adaptive_alpha: bool = True
    gamma: float = 0.99
    tau: float = 0.01
    batch_size: int = 64
    buffer_size: int = 1_000_000
    hidden: Sequence[int] = (128, 128)
    num_envs: int = 1
    # the Ornstein-Uhlenbeck exploration add-on
    ou_noise: bool = False
    ou_theta: float = 0.15
    ou_sigma: float = 1.0
    ou_dt: float = 1.0
    noise_init_scale: Optional[float] = 1.0
    noise_final_scale: float = 0.0
    noise_decay_episodes: int = 500
    axis_name: Optional[str] = None


@dataclasses.dataclass
class SACState:
    actor: nn.Module
    actor_target: nn.Module
    critic: TwinQCritic
    critic_target: TwinQCritic
    log_alpha: torch.Tensor            # scalar, requires grad
    actor_opt: torch.optim.Optimizer
    critic_opt: torch.optim.Optimizer
    alpha_opt: torch.optim.Optimizer
    ou_state: torch.Tensor
    step: int = 0


class SAC(OffPolicyAlgo):
    GRAD_CLIP = 0.5          # actor and critic; the temperature is unclipped

    def __init__(self, dim_info: DimInfo, cfg: SACConfig = SACConfig(),
                 device="cuda"):
        check_axis_name(cfg)
        self.dim_info = dim_info
        self.cfg = cfg
        self.device = torch.device(device)
        if dim_info.is_continue:
            self.target_entropy = -float(dim_info.action_dim)
        else:
            self.target_entropy = 0.6 * math.log(dim_info.action_dim)

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> SACState:
        cfg, di, dev = self.cfg, self.dim_info, self.device
        hidden = tuple(cfg.hidden)
        if di.is_continue:
            actor = GaussianActor(di.obs_dim, di.action_dim, hidden, generator,
                                  dev)
            critic = TwinQCritic(di.obs_dim + di.action_dim, hidden, 1,
                                 generator, dev)
        else:
            actor = SoftmaxPolicy(di.obs_dim, di.action_dim, hidden, generator,
                                  dev)
            critic = TwinQTable(di.obs_dim, di.action_dim, hidden, generator,
                                dev)
        log_alpha = torch.log(torch.tensor(cfg.alpha_init, device=dev)
                              ).requires_grad_(True)
        return SACState(
            actor=actor, actor_target=frozen_copy(actor),
            critic=critic, critic_target=frozen_copy(critic),
            log_alpha=log_alpha,
            actor_opt=torch.optim.Adam(actor.parameters(), lr=cfg.actor_lr,
                                       eps=1e-8),
            critic_opt=torch.optim.Adam(critic.parameters(), lr=cfg.critic_lr,
                                        eps=1e-8),
            alpha_opt=torch.optim.Adam([log_alpha], lr=cfg.alpha_lr, eps=1e-8),
            ou_state=torch.zeros(
                cfg.num_envs, di.action_dim if di.is_continue else 1,
                device=dev),
        )

    # ------------------------------------------------------------------
    def _sample(self, actor, obs: torch.Tensor, eps: torch.Tensor):
        mean, log_std = actor(obs)
        return squashed_sample_logp(mean, log_std, eps,
                                    self.dim_info.max_action)

    @torch.no_grad()
    def select_action(self, state: SACState, obs: torch.Tensor,
                      noise: torch.Tensor):
        """A policy sample: ``noise`` is a standard normal (continuous) or
        Gumbel noise (discrete), of shape (B, A)."""
        if self.dim_info.is_continue:
            return self._sample(state.actor, obs, noise)[0]
        return categorical_sample(state.actor(obs), noise)

    @torch.no_grad()
    def evaluate_action(self, state: SACState, obs: torch.Tensor):
        if self.dim_info.is_continue:
            mean, _ = state.actor(obs)
            return torch.tanh(mean) * self.dim_info.max_action
        return torch.argmax(state.actor(obs), dim=-1)

    def draw_explore(self, b: int, generator: torch.Generator,
                     ctx: ExploreCtx) -> ExploreDraws:
        di, dev = self.dim_info, self.device
        draws = ExploreDraws()
        if di.is_continue:
            draws.normal = torch.randn(b, di.action_dim, generator=generator,
                                       device=dev)
            if self.cfg.ou_noise:
                draws.ou = torch.randn(b, di.action_dim,
                                       generator=generator, device=dev)
        else:
            draws.gumbel = draw_gumbel((b, di.action_dim), generator, dev)
        if ctx.warmup:
            draws.random = draw_random_actions(di, b, generator, dev)
        return draws

    def explore_with(self, state: SACState, obs: torch.Tensor,
                     draws: ExploreDraws, ctx: ExploreCtx):
        cfg, di = self.cfg, self.dim_info
        if di.is_continue:
            action = self.select_action(state, obs, draws.normal)
            if cfg.ou_noise:
                state.ou_state = ou_step(cfg, state.ou_state, ctx.done_prev,
                                         draws.ou)
                action = torch.clamp(
                    action + state.ou_state * noise_scale(cfg, ctx.episodes),
                    -di.max_action, di.max_action)
        else:
            action = self.select_action(state, obs, draws.gumbel)
        if ctx.warmup:
            action = draws.random
        return state, action

    # ------------------------------------------------------------------
    def draw_update(self, batch: Transition, generator: torch.Generator):
        """(eps_next, eps_new), each (B, A); None for discrete actions."""
        if not self.dim_info.is_continue:
            return None
        shape = (batch.obs.shape[0], self.dim_info.action_dim)
        return tuple(torch.randn(shape, generator=generator,
                                 device=self.device) for _ in range(2))

    def update(self, state: SACState, batch: Transition, draws=None):
        """One learner step, in place. Continuous: ``draws`` is
        ``(eps_next, eps_new)``. Returns (state, metrics, None)."""
        if self.dim_info.is_continue:
            if draws is None:
                raise ValueError("continuous SAC's update needs its draws")
            return self._update_continuous(state, batch, *draws)
        return self._update_discrete(state, batch)

    def _update_continuous(self, state: SACState, batch: Transition,
                           eps_next: torch.Tensor, eps_new: torch.Tensor):
        cfg = self.cfg
        reward = batch.reward.reshape(-1)
        done = batch.done.reshape(-1).to(torch.float32)
        action = batch.action.reshape(-1, self.dim_info.action_dim)
        alpha = torch.exp(state.log_alpha.detach())

        # critic: min target + entropy bonus; next action from ACTOR TARGET
        with torch.no_grad():
            next_a, next_logp = self._sample(state.actor_target,
                                             batch.next_obs, eps_next)
            q1_t, q2_t = state.critic_target(batch.next_obs, next_a)
            next_q = torch.minimum(q1_t, q2_t)
            target = reward + cfg.gamma * (1.0 - done) * (
                next_q - alpha * next_logp)

        critic_params = list(state.critic.parameters())
        q1, q2 = state.critic(batch.obs, action)
        critic_loss = (torch.mean(torch.square(q1 - target))
                       + torch.mean(torch.square(q2 - target)))
        optimizer_step(state.critic_opt, critic_params, critic_loss,
                       self.GRAD_CLIP, cfg.axis_name)

        # actor: mean(Q1, Q2) through the updated critic
        actor_params = list(state.actor.parameters())
        a, logp = self._sample(state.actor, batch.obs, eps_new)
        q1, q2 = state.critic(batch.obs, a)
        actor_loss = torch.mean(alpha * logp - 0.5 * (q1 + q2))
        optimizer_step(state.actor_opt, actor_params, actor_loss,
                       self.GRAD_CLIP, cfg.axis_name)

        self._alpha_update(state, -logp.detach())
        return self._finish(state, critic_params, actor_params, critic_loss,
                            actor_loss)

    def _update_discrete(self, state: SACState, batch: Transition):
        cfg = self.cfg
        reward = batch.reward.reshape(-1)
        done = batch.done.reshape(-1).to(torch.float32)
        action = batch.action.reshape(-1).to(torch.int64)
        alpha = torch.exp(state.log_alpha.detach())
        bidx = torch.arange(action.shape[0], device=action.device)

        # expectation-form target over the next state's policy
        with torch.no_grad():
            next_logp = F.log_softmax(state.actor_target(batch.next_obs), -1)
            next_p = torch.exp(next_logp)
            q1_t, q2_t = state.critic_target(batch.next_obs)
            next_q = torch.minimum(q1_t, q2_t)
            next_v = torch.sum(next_p * (next_q - alpha * next_logp), dim=-1)
            target = reward + cfg.gamma * (1.0 - done) * next_v

        critic_params = list(state.critic.parameters())
        q1, q2 = state.critic(batch.obs)
        critic_loss = (torch.mean(torch.square(q1[bidx, action] - target))
                       + torch.mean(torch.square(q2[bidx, action] - target)))
        optimizer_step(state.critic_opt, critic_params, critic_loss,
                       self.GRAD_CLIP, cfg.axis_name)

        actor_params = list(state.actor.parameters())
        logp = F.log_softmax(state.actor(batch.obs), dim=-1)
        p = torch.exp(logp)
        q1, q2 = state.critic(batch.obs)
        q = 0.5 * (q1 + q2)
        actor_loss = torch.mean(torch.sum(p * (alpha * logp - q), dim=-1))
        entropy = -torch.sum(p * logp, dim=-1).detach()
        optimizer_step(state.actor_opt, actor_params, actor_loss,
                       self.GRAD_CLIP, cfg.axis_name)

        self._alpha_update(state, entropy)
        return self._finish(state, critic_params, actor_params, critic_loss,
                            actor_loss)

    def _alpha_update(self, state: SACState, entropy: torch.Tensor) -> None:
        """L = alpha * (mean entropy - target entropy), the error held
        constant; one unclipped Adam step on ``log_alpha``. The JAX package
        does not average this gradient over a mesh, so each rank's
        temperature follows its own batch; the port does the same."""
        if not self.cfg.adaptive_alpha:
            return
        err = torch.mean(entropy) - self.target_entropy
        optimizer_step(state.alpha_opt, [state.log_alpha],
                       torch.exp(state.log_alpha) * err)

    def _finish(self, state: SACState, critic_params, actor_params,
                critic_loss, actor_loss):
        polyak(state.actor_target.parameters(), actor_params, self.cfg.tau)
        polyak(state.critic_target.parameters(), critic_params, self.cfg.tau)
        state.step += 1
        metrics = {"critic_loss": critic_loss.detach(),
                   "actor_loss": actor_loss.detach(),
                   "alpha": torch.exp(state.log_alpha.detach())}
        return state, metrics, None
