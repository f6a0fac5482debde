"""MAAC: Actor-Attention-Critic, discrete actions (counterpart:
``freerl_tpu/algos/maac.py``).

- one shared multi-head attention block (:class:`SharedAttention`): the
  query from an agent's own state embedding, keys and LeakyReLU values
  from the OTHER agents' state-action embeddings, scaled dot products, an
  output layer; its layers are flax ``nn.Dense`` in the JAX package (the
  ``'flax'`` init; ``query`` and ``key`` have no bias);
- per agent, a state encoder, a state-action encoder and a Q head
  ``fc2(relu(fc1([own encoding, attention])))`` giving a Q table
  (:class:`MAACCritics` holds them all, with the shared block);
- one batch per learner step; soft targets from each agent's sampled next
  action (``q - alpha * logp``) through the target critics; ONE Adam over
  every agent's heads and the shared block, so one global clip at 0.5;
- each actor (a LeakyReLU softmax policy, :class:`SoftmaxActorNet`) steps
  on the advantage against the counterfactual baseline ``E_pi[Q_i]`` of
  the just-updated critics, with its own Adam and clip.

``update(state, buffer, draws)`` takes a :class:`LearnDraws`: the (B,)
replay indices and the (B, A, P) Gumbel noise of the next actions;
``draw_update`` makes them from the caller's generator.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from freerl_tpu_torch.algos.base import (ExploreCtx, ExploreDraws, LearnDraws,
                                         MultiAgentAlgo, frozen_copy)
from freerl_tpu_torch.algos.common import optimizer_step, polyak
from freerl_tpu_torch.nets.distributions import categorical_sample, draw_gumbel
from freerl_tpu_torch.nets.mlp import MLP, Dense

CRITIC_HIDDEN = 128      # the JAX package builds MAACCritics with hidden 128


class SharedAttention(nn.Module):
    """One query (an agent's own embedding) over the other agents'
    embeddings, ``num_heads`` heads of ``hidden_dim // num_heads``."""

    def __init__(self, hidden_dim: int = 128, num_heads: int = 4,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()

        def dense(bias=True):
            return Dense(hidden_dim, hidden_dim, generator, device, "flax",
                         bias=bias)

        self.hidden_dim, self.num_heads = hidden_dim, num_heads
        self.query = dense(bias=False)
        self.key = dense(bias=False)
        self.value = dense()
        self.fc_out = dense()

    def forward(self, e_q: torch.Tensor, e_k: torch.Tensor) -> torch.Tensor:
        """e_q (B, 1, D), e_k (B, n_others, D) -> (B, hidden_dim)."""
        h = self.num_heads
        hd = self.hidden_dim // h
        b, n = e_k.shape[0], e_k.shape[1]
        q = self.query(e_q).reshape(b, 1, h, hd).transpose(1, 2)
        k = self.key(e_k).reshape(b, n, h, hd).transpose(1, 2)
        v = F.leaky_relu(self.value(e_k)).reshape(b, n, h, hd).transpose(1, 2)
        scores = (q @ k.transpose(2, 3)) / math.sqrt(hd)         # (B, H, 1, n)
        w = torch.softmax(scores, dim=-1)
        out = (w @ v).transpose(1, 2).reshape(b, self.hidden_dim)
        return self.fc_out(out)


class MAACCritics(nn.Module):
    """Every agent's attention critic, with the shared block."""

    def __init__(self, obs_dims: Sequence[int], act_dims: Sequence[int],
                 attention_dim: int = 128, hidden: int = CRITIC_HIDDEN,
                 num_heads: int = 4,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()

        def dense(i, o):
            return Dense(i, o, generator, device)

        self.attn = SharedAttention(attention_dim, num_heads, generator,
                                    device)
        self.enc_s = nn.ModuleList(dense(d, attention_dim) for d in obs_dims)
        self.enc_sa = nn.ModuleList(dense(o + a, attention_dim)
                                    for o, a in zip(obs_dims, act_dims))
        self.fc1 = nn.ModuleList(dense(2 * attention_dim, hidden)
                                 for _ in obs_dims)
        self.fc2 = nn.ModuleList(dense(hidden, a) for a in act_dims)

    def forward(self, obs_list: list, act_onehot_list: list) -> list:
        """obs_list[i] (B, O_i), act_onehot_list[i] (B, act_i) -> every
        agent's Q table, [(B, act_i)]."""
        n = len(obs_list)
        e_sa = [F.leaky_relu(enc(torch.cat([o, a], dim=-1)))
                for enc, o, a in zip(self.enc_sa, obs_list, act_onehot_list)]
        e_s = [F.leaky_relu(enc(o)) for enc, o in zip(self.enc_s, obs_list)]
        qs = []
        for i in range(n):
            others = torch.stack([e_sa[j] for j in range(n) if j != i], dim=1)
            attn_out = self.attn(e_s[i][:, None, :], others)
            h = F.relu(self.fc1[i](torch.cat([e_s[i], attn_out], dim=-1)))
            qs.append(self.fc2[i](h))
        return qs


class SoftmaxActorNet(MLP):
    """obs -> action logits through LeakyReLU (slope 0.01) hidden layers."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (128, 128),
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__(obs_dim, action_dim, hidden, "leaky_relu", generator,
                         device)


@dataclasses.dataclass(frozen=True)
class MAACConfig:
    """Static hyperparameters, with the JAX package's fields and defaults."""

    actor_lr: float = 5e-4
    critic_lr: float = 5e-4
    gamma: float = 0.95
    tau: float = 0.01
    batch_size: int = 256
    buffer_size: int = 1_000_000
    hidden: Sequence[int] = (128, 128)
    attention_dim: int = 128
    num_heads: int = 4
    alpha: float = 0.01            # entropy temperature
    num_envs: int = 1
    axis_name: Optional[str] = None


@dataclasses.dataclass
class MAACState:
    actors: list
    critic: MAACCritics
    critic_target: MAACCritics
    actor_opts: list
    critic_opt: torch.optim.Optimizer
    step: int = 0


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[b, idx[b]] for a (B, n) table and (B,) indices."""
    return torch.gather(table, -1, idx[:, None])[:, 0]


class MAAC(MultiAgentAlgo):
    GRAD_CLIP = 0.5          # the critics as one group; each actor

    def __init__(self, env, cfg: MAACConfig = MAACConfig(), device="cuda"):
        if env.dim_info.is_continue:
            raise ValueError("MAAC is the discrete variant; MASAC is the "
                             "continuous one")
        super().__init__(env, cfg, device)

    def init(self, generator: torch.Generator) -> MAACState:
        cfg, dev = self.cfg, self.device
        actors = [SoftmaxActorNet(self.obs_dims[i], self.act_dims[i],
                                  tuple(cfg.hidden), generator, dev)
                  for i in range(self.n_agents)]
        critic = MAACCritics(self.obs_dims, self.act_dims, cfg.attention_dim,
                             CRITIC_HIDDEN, cfg.num_heads, generator, dev)
        return MAACState(
            actors=actors, critic=critic, critic_target=frozen_copy(critic),
            actor_opts=[torch.optim.Adam(a.parameters(), lr=cfg.actor_lr,
                                         eps=1e-8) for a in actors],
            critic_opt=torch.optim.Adam(critic.parameters(), lr=cfg.critic_lr,
                                        eps=1e-8),
        )

    # ------------------------------------------------------------------
    @torch.no_grad()
    def select_action(self, state: MAACState, obs: torch.Tensor,
                      gumbel: torch.Tensor) -> torch.Tensor:
        """(..., A, O_pad) -> (..., A) sampled indices, with ``gumbel``
        (..., A, P) noise."""
        return torch.stack([
            categorical_sample(state.actors[i](self._obs(obs, i)),
                               self._act(gumbel, i))
            for i in range(self.n_agents)], dim=-1)

    @torch.no_grad()
    def evaluate_action(self, state: MAACState, obs: torch.Tensor):
        return torch.stack([torch.argmax(state.actors[i](self._obs(obs, i)),
                                         dim=-1)
                            for i in range(self.n_agents)], dim=-1)

    def draw_explore(self, b: int, generator: torch.Generator,
                     ctx: ExploreCtx) -> ExploreDraws:
        dev = self.device
        draws = ExploreDraws(gumbel=draw_gumbel(
            (b, self.n_agents, self.act_pad), generator, dev))
        if ctx.warmup:
            draws.random = torch.randint(0, self.act_pad, (b, self.n_agents),
                                         generator=generator, device=dev)
        return draws

    def explore_with(self, state: MAACState, obs: torch.Tensor,
                     draws: ExploreDraws, ctx: ExploreCtx):
        action = self.select_action(state, obs, draws.gumbel)
        if ctx.warmup:
            action = draws.random
        return state, action

    # ------------------------------------------------------------------
    def draw_update(self, buffer, generator: torch.Generator) -> LearnDraws:
        return LearnDraws(
            idx=self._idx(buffer, generator, per_agent=False),
            gumbel=draw_gumbel((self.cfg.batch_size, self.n_agents,
                                self.act_pad), generator, self.device))

    def update(self, state: MAACState, buffer, draws: LearnDraws):
        """One learner step, in place. Returns (state, metrics)."""
        cfg = self.cfg
        n = self.n_agents
        batch = buffer.gather(draws.idx)
        done = batch.done.to(torch.float32)
        obs = [self._obs(batch.obs, i) for i in range(n)]
        next_obs = [self._obs(batch.next_obs, i) for i in range(n)]
        act = batch.action.to(torch.int64)                     # (B, A)
        onehot = [F.one_hot(act[:, i], self.act_dims[i]).to(torch.float32)
                  for i in range(n)]

        # soft targets from each agent's sampled next action
        with torch.no_grad():
            next_logits = [state.actors[i](next_obs[i]) for i in range(n)]
            next_a = [categorical_sample(next_logits[i],
                                         self._act(draws.gumbel, i))
                      for i in range(n)]
            next_qs = state.critic_target(next_obs, [
                F.one_hot(next_a[i], self.act_dims[i]).to(torch.float32)
                for i in range(n)])
            targets = [
                batch.reward[:, i] + cfg.gamma * (1.0 - done) * (
                    _take(next_qs[i], next_a[i]) - cfg.alpha * _take(
                        F.log_softmax(next_logits[i], dim=-1), next_a[i]))
                for i in range(n)]

        critic_params = list(state.critic.parameters())
        qs = state.critic(obs, onehot)
        critic_loss = sum(torch.mean(torch.square(_take(qs[i], act[:, i])
                                                  - targets[i]))
                          for i in range(n))
        optimizer_step(state.critic_opt, critic_params, critic_loss,
                       self.GRAD_CLIP, cfg.axis_name)

        # actors: the advantage against E_pi[Q_i] of the updated critics
        with torch.no_grad():
            q_tables = state.critic(obs, onehot)
        metrics = {"critic_loss": critic_loss.detach()}
        for i in range(n):
            logp = F.log_softmax(state.actors[i](obs[i]), dim=-1)
            baseline = torch.sum(torch.exp(logp) * q_tables[i], dim=-1)
            logp_a = _take(logp, act[:, i])
            adv = (_take(q_tables[i], act[:, i]) - baseline
                   - cfg.alpha * logp_a).detach()
            actor_loss = -torch.mean(logp_a * adv)
            optimizer_step(state.actor_opts[i],
                           list(state.actors[i].parameters()), actor_loss,
                           self.GRAD_CLIP, cfg.axis_name)
            metrics[f"actor_loss_{i}"] = actor_loss.detach()

        polyak(state.critic_target.parameters(), critic_params, cfg.tau)
        state.step += 1
        return state, metrics
