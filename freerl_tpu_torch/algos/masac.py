"""MASAC: multi-agent SAC with centralized twin critics (counterpart:
``freerl_tpu/algos/masac.py``).

- a squashed-Gaussian actor per agent (the state-independent ``log_std``
  of ``algos/sac.py``) and a twin critic per agent over every agent's
  observation and action; no actor targets: next actions come from the
  LIVE actors;
- a learner step takes the agents in order, each with a FRESH batch. Agent
  i's target samples every agent's next action from its live actor, so an
  actor j < i updated earlier in this step is the updated one; its critic
  steps on ``min`` of the target heads minus ``alpha * logp``; then its
  actor steps on ``alpha * logp - min(Q1, Q2)`` of the just-updated
  critic, the other agents' actions sampled fresh from their live actors
  (no gradient); then its temperature;
- actor and critic clipped at global norm 0.5 (no epsilon), Adam eps 1e-8;
  each agent's ``log_alpha`` (``log(0.01)`` at start) has its own
  unclipped Adam at 1e-4 and the target entropy ``-act_dims[i]``.

``update(state, buffer, draws)`` takes a :class:`LearnDraws`: the (A, B)
replay indices and the (A, B, A, P) normals of the target's and of the
actor loss's samples; ``draw_update`` makes them from the caller's
generator.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from freerl_tpu_torch.algos.base import (ExploreCtx, ExploreDraws, LearnDraws,
                                         MultiAgentAlgo, frozen_copy)
from freerl_tpu_torch.algos.common import net_params, optimizer_step, polyak
from freerl_tpu_torch.algos.sac import GaussianActor
from freerl_tpu_torch.algos.td3 import TwinQCritic
from freerl_tpu_torch.nets.distributions import squashed_sample_logp


@dataclasses.dataclass(frozen=True)
class MASACConfig:
    """Static hyperparameters, with the JAX package's fields and defaults."""

    actor_lr: float = 1e-4
    critic_lr: float = 1e-4
    alpha_lr: float = 1e-4
    alpha_init: float = 0.01
    adaptive_alpha: bool = True
    gamma: float = 0.95
    tau: float = 0.01
    batch_size: int = 256
    buffer_size: int = 1_000_000
    hidden: Sequence[int] = (128, 128)
    num_envs: int = 1
    axis_name: Optional[str] = None


@dataclasses.dataclass
class MASACState:
    actors: list
    critics: list
    critic_targets: list
    log_alphas: list          # A scalars, each with its own Adam
    actor_opts: list
    critic_opts: list
    alpha_opts: list
    step: int = 0


class MASAC(MultiAgentAlgo):
    GRAD_CLIP = 0.5          # actor and critic of every agent

    def __init__(self, env, cfg: MASACConfig = MASACConfig(), device="cuda"):
        if not env.dim_info.is_continue:
            raise ValueError("MASAC is continuous-control")
        super().__init__(env, cfg, device)
        self.target_entropies = tuple(-float(d) for d in self.act_dims)

    def init(self, generator: torch.Generator) -> MASACState:
        cfg, dev = self.cfg, self.device
        hid = tuple(cfg.hidden)
        g_in = sum(self.obs_dims) + sum(self.act_dims)
        actors, critics = [], []
        for i in range(self.n_agents):
            actors.append(GaussianActor(self.obs_dims[i], self.act_dims[i],
                                        hid, generator, dev))
            critics.append(TwinQCritic(g_in, hid, 1, generator, dev))
        log_alphas = [torch.log(torch.tensor(cfg.alpha_init, device=dev)
                                ).requires_grad_(True)
                      for _ in range(self.n_agents)]
        return MASACState(
            actors=actors, critics=critics,
            critic_targets=[frozen_copy(c) for c in critics],
            log_alphas=log_alphas,
            actor_opts=[torch.optim.Adam(a.parameters(), lr=cfg.actor_lr,
                                         eps=1e-8) for a in actors],
            critic_opts=[torch.optim.Adam(c.parameters(), lr=cfg.critic_lr,
                                          eps=1e-8) for c in critics],
            alpha_opts=[torch.optim.Adam([la], lr=cfg.alpha_lr, eps=1e-8)
                        for la in log_alphas],
        )

    # ------------------------------------------------------------------
    def _sample(self, actor, obs_i: torch.Tensor, eps: torch.Tensor):
        mean, log_std = actor(obs_i)
        return squashed_sample_logp(mean, log_std, eps, 1.0)

    @torch.no_grad()
    def select_action(self, state: MASACState, obs: torch.Tensor,
                      eps: torch.Tensor) -> torch.Tensor:
        """A policy sample: (..., A, O_pad) -> (..., A, P) in [-1, 1], with
        ``eps`` (..., A, P) standard normals."""
        return self._stack([
            self._sample(state.actors[i], self._obs(obs, i),
                         self._act(eps, i))[0]
            for i in range(self.n_agents)])

    @torch.no_grad()
    def evaluate_action(self, state: MASACState, obs: torch.Tensor):
        return self._stack([torch.tanh(state.actors[i](self._obs(obs, i))[0])
                            for i in range(self.n_agents)])

    def draw_explore(self, b: int, generator: torch.Generator,
                     ctx: ExploreCtx) -> ExploreDraws:
        shape = (b, self.n_agents, self.act_pad)
        draws = ExploreDraws(normal=self._normals(shape, generator))
        if ctx.warmup:
            draws.random = torch.rand(shape, generator=generator,
                                      device=self.device) * 2.0 - 1.0
        return draws

    def explore_with(self, state: MASACState, obs: torch.Tensor,
                     draws: ExploreDraws, ctx: ExploreCtx):
        action = self.select_action(state, obs, draws.normal)
        if ctx.warmup:
            action = draws.random
        return state, action

    # ------------------------------------------------------------------
    def draw_update(self, buffer, generator: torch.Generator) -> LearnDraws:
        a, b, p = self.n_agents, self.cfg.batch_size, self.act_pad
        return LearnDraws(idx=self._idx(buffer, generator),
                          next=self._normals((a, b, a, p), generator),
                          new=self._normals((a, b, a, p), generator))

    def update(self, state: MASACState, buffer, draws: LearnDraws):
        """One learner step, in place. Returns (state, metrics)."""
        cfg = self.cfg
        n = self.n_agents
        batches = buffer.gather(draws.idx)                 # (A, B, ...)
        metrics = {}
        for i in range(n):
            batch = batches.map(lambda x: x[i])
            critic = state.critics[i]
            alpha = torch.exp(state.log_alphas[i].detach())
            with torch.no_grad():
                next_acts, next_logp = [], None
                for j in range(n):
                    a_j, logp_j = self._sample(
                        state.actors[j], self._obs(batch.next_obs, j),
                        self._act(draws.next[i], j))
                    next_acts.append(a_j)
                    if j == i:
                        next_logp = logp_j
                q1_t, q2_t = state.critic_targets[i](
                    *self._joint(batch.next_obs, next_acts))
                next_q = torch.minimum(q1_t, q2_t)
                target = batch.reward[:, i] + cfg.gamma * (
                    1.0 - batch.done.to(torch.float32)) * (
                    next_q - alpha * next_logp)

            acts = [self._act(batch.action, j) for j in range(n)]
            q1, q2 = critic(*self._joint(batch.obs, acts))
            critic_loss = (torch.mean(torch.square(q1 - target))
                           + torch.mean(torch.square(q2 - target)))
            optimizer_step(state.critic_opts[i], list(critic.parameters()),
                           critic_loss, self.GRAD_CLIP, cfg.axis_name)

            # the other agents' fresh actions from their live actors
            new_acts = []
            for j in range(n):
                if j == i:
                    a_i, logp = self._sample(state.actors[i],
                                             self._obs(batch.obs, i),
                                             self._act(draws.new[i], i))
                    new_acts.append(a_i)
                else:
                    with torch.no_grad():
                        new_acts.append(self._sample(
                            state.actors[j], self._obs(batch.obs, j),
                            self._act(draws.new[i], j))[0])
            q1, q2 = critic(*self._joint(batch.obs, new_acts))
            actor_loss = torch.mean(alpha * logp - torch.minimum(q1, q2))
            optimizer_step(state.actor_opts[i],
                           list(state.actors[i].parameters()), actor_loss,
                           self.GRAD_CLIP, cfg.axis_name)

            if cfg.adaptive_alpha:
                # L = alpha * (mean entropy - target), the error held fixed;
                # rank-local under a mesh, as in the JAX package
                err = torch.mean(-logp.detach()) - self.target_entropies[i]
                optimizer_step(state.alpha_opts[i], [state.log_alphas[i]],
                               torch.exp(state.log_alphas[i]) * err)
            metrics[f"critic_loss_{i}"] = critic_loss.detach()
            metrics[f"actor_loss_{i}"] = actor_loss.detach()

        polyak(net_params(state.critic_targets), net_params(state.critics),
               cfg.tau)
        state.step += 1
        return state, metrics
