"""MADDPG and MATD3: centralized critics, decentralized actors
(counterpart: ``freerl_tpu/algos/maddpg.py``).

- a tanh actor per agent over its own observation, and a critic per agent
  over every agent's observation and action, concatenated at their true
  widths (the padded tails never reach a net);
- a learner step takes the agents in order, each with a FRESH batch: its
  critic's TD step on the target actors' next actions, then its actor's
  step through that just-updated critic, with its own action replaced by
  the actor's; the targets of every agent move after the last agent;
- both nets clipped at global norm 0.5 (no epsilon), Adam eps 1e-8;
  optional ``regular`` (+1e-3 * mean(a^2) in the actor loss);
- Gaussian exploration noise on every action column, its scale decayed
  on the device episode counter; ``random_steps`` of uniform warm-up;
- MATD3 (``twin``): a twin critic, target-policy noise drawn for each
  (updating agent, next-action agent) pair, and the actors, their Adam
  states and their targets moved only every ``policy_freq``-th step (a
  host int); the critic targets move every step;
- ATT-MADDPG (``att_critic``): :class:`ATTCritic`;
- ``actor_learn_way="1"``: a Gaussian actor trained by
  ``-(logp + lambda * entropy)`` of a sampled action.

``update(state, buffer, draws)`` takes a :class:`LearnDraws`: the (A, B)
replay indices and the normals of the target noise and of the Gaussian
actor's samples; ``draw_update`` makes them from the caller's generator.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from freerl_tpu_torch.algos.base import (ExploreCtx, ExploreDraws, LearnDraws,
                                         MultiAgentAlgo, frozen_copy,
                                         noise_scale)
from freerl_tpu_torch.algos.common import (net_params, optimizer_step, polyak,
                                           td_target)
from freerl_tpu_torch.algos.ddpg import QCritic, TanhActor
from freerl_tpu_torch.algos.sac import GaussianActor
from freerl_tpu_torch.algos.td3 import TwinQCritic
from freerl_tpu_torch.nets.distributions import normal_entropy, normal_log_prob
from freerl_tpu_torch.nets.mlp import Dense


class ATTCritic(nn.Module):
    """The ATT-MADDPG critic of agent ``agent_idx``. Encoder: the
    embeddings of every agent's observation and of its OWN action make a
    hidden state, projected through ``head_count`` heads (the keys).
    Decoder: the OTHER agents' action embeddings make the query; a softmax
    over the heads weighs the context that gives Q. Its layers are flax
    ``nn.Dense`` in the JAX package: the ``'flax'`` init."""

    def __init__(self, obs_dims: Sequence[int], act_dims: Sequence[int],
                 agent_idx: int, hidden_dim: int = 128, head_count: int = 8,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        n = len(obs_dims)

        def dense(i, o):
            return Dense(i, o, generator, device, "flax")

        self.agent_idx = agent_idx
        self.fc_obs = nn.ModuleList(dense(d, hidden_dim) for d in obs_dims)
        self.fc_act = nn.ModuleList(dense(d, hidden_dim) for d in act_dims)
        self.fc_enc = dense(hidden_dim * (n + 1), hidden_dim)
        self.head = nn.ModuleList(dense(hidden_dim, hidden_dim)
                                  for _ in range(head_count))
        self.fc_dec = dense(hidden_dim * (n - 1), hidden_dim)
        self.fc_q = dense(hidden_dim, 1)

    def forward(self, obs_list: list, act_list: list) -> torch.Tensor:
        i = self.agent_idx
        obs_embs = [F.relu(fc(o)) for fc, o in zip(self.fc_obs, obs_list)]
        act_embs = [F.relu(fc(a)) for fc, a in zip(self.fc_act, act_list)]
        h = F.relu(self.fc_enc(torch.cat(obs_embs + [act_embs[i]], dim=-1)))
        heads = torch.stack([F.relu(head(h)) for head in self.head])  # (H,B,D)
        query = F.relu(self.fc_dec(torch.cat(
            [e for j, e in enumerate(act_embs) if j != i], dim=-1)))
        scores = torch.sum(heads * query[None], dim=-1)               # (H, B)
        w = torch.softmax(scores.T, dim=-1)                           # (B, H)
        context = torch.einsum("hbd,bh->bd", heads, w)
        return self.fc_q(context)[..., 0]


@dataclasses.dataclass(frozen=True)
class MADDPGConfig:
    """Static hyperparameters, with the JAX package's fields and defaults."""

    actor_lr: float = 5e-4
    critic_lr: float = 5e-4
    gamma: float = 0.95
    tau: float = 0.01
    batch_size: int = 256
    buffer_size: int = 1_000_000
    hidden: Sequence[int] = (128, 128)
    num_envs: int = 1
    gauss_sigma: float = 1.0
    noise_init_scale: Optional[float] = 1.0
    noise_final_scale: float = 0.0
    noise_decay_episodes: int = 600
    regular: bool = False           # +1e-3 * mean(a^2) actor regularizer
    # MATD3
    twin: bool = False
    policy_noise_sigma: float = 0.2
    noise_clip: float = 0.5
    policy_freq: int = 2
    # ATT-MADDPG
    att_critic: bool = False
    att_heads: int = 8
    # '0': the deterministic actor through the joint critic; '1': a
    # Gaussian actor trained by -(logp + approx_lmbda * entropy)
    actor_learn_way: str = "0"
    approx_lmbda: float = 1e-3
    axis_name: Optional[str] = None


@dataclasses.dataclass
class MADDPGState:
    actors: list
    actor_targets: list
    critics: list
    critic_targets: list
    actor_opts: list
    critic_opts: list
    step: int = 0


class MADDPG(MultiAgentAlgo):
    GRAD_CLIP = 0.5          # both nets of every agent, every update

    def __init__(self, env, cfg: MADDPGConfig = MADDPGConfig(),
                 device="cuda"):
        if not env.dim_info.is_continue:
            raise ValueError("MADDPG is continuous-control")
        if cfg.att_critic and cfg.twin:
            raise ValueError("the ATT critic is the single-Q variant")
        super().__init__(env, cfg, device)
        self.gaussian = cfg.actor_learn_way == "1"

    def init(self, generator: torch.Generator) -> MADDPGState:
        cfg, dev = self.cfg, self.device
        hid = tuple(cfg.hidden)
        g_obs, g_act = sum(self.obs_dims), sum(self.act_dims)
        actors, critics = [], []
        for i in range(self.n_agents):
            od, ad = self.obs_dims[i], self.act_dims[i]
            actors.append(GaussianActor(od, ad, hid, generator, dev)
                          if self.gaussian else
                          TanhActor(od, ad, hid, 1.0, "torch", generator, dev))
            if cfg.att_critic:
                critics.append(ATTCritic(self.obs_dims, self.act_dims, i, 128,
                                         cfg.att_heads, generator, dev))
            elif cfg.twin:
                critics.append(TwinQCritic(g_obs + g_act, hid, 1, generator,
                                           dev))
            else:
                critics.append(QCritic(g_obs, g_act, hid, "torch", generator,
                                       dev))
        return MADDPGState(
            actors=actors, actor_targets=[frozen_copy(a) for a in actors],
            critics=critics, critic_targets=[frozen_copy(c) for c in critics],
            actor_opts=[torch.optim.Adam(a.parameters(), lr=cfg.actor_lr,
                                         eps=1e-8) for a in actors],
            critic_opts=[torch.optim.Adam(c.parameters(), lr=cfg.critic_lr,
                                          eps=1e-8) for c in critics],
        )

    # ------------------------------------------------------------------
    def _actor_act(self, actor, obs_i: torch.Tensor,
                   eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Agent i's action in [-1, 1]: the tanh actor's, or the Gaussian
        actor's tanh(mean), or with ``eps`` its tanh(mean + std * eps)."""
        if not self.gaussian:
            return actor(obs_i)
        mean, log_std = actor(obs_i)
        if eps is None:
            return torch.tanh(mean)
        return torch.tanh(mean + torch.exp(log_std) * eps)

    def _q(self, critic, obs: torch.Tensor, acts: list, q1_only=False):
        """Agent i's critic on every agent's observation and the actions
        ``acts`` (true widths); ``q1_only``: the twin critic's Q1."""
        if self.cfg.att_critic:
            return critic([self._obs(obs, j) for j in range(self.n_agents)],
                          acts)
        g_obs, g_act = self._joint(obs, acts)
        return critic.q1(g_obs, g_act) if q1_only else critic(g_obs, g_act)

    @torch.no_grad()
    def select_action(self, state: MADDPGState, obs: torch.Tensor,
                      eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(..., A, O_pad) observations -> (..., A, P) actions in [-1, 1];
        ``eps`` (..., A, P) samples the Gaussian actor."""
        return self._stack([
            self._actor_act(state.actors[i], self._obs(obs, i),
                            None if eps is None else self._act(eps, i))
            for i in range(self.n_agents)])

    def evaluate_action(self, state: MADDPGState, obs: torch.Tensor):
        return self.select_action(state, obs)

    def draw_explore(self, b: int, generator: torch.Generator,
                     ctx: ExploreCtx) -> ExploreDraws:
        shape = (b, self.n_agents, self.act_pad)
        draws = ExploreDraws(normal=self._normals(shape, generator))
        if self.gaussian:
            draws.policy = self._normals(shape, generator)
        if ctx.warmup:
            draws.random = torch.rand(shape, generator=generator,
                                      device=self.device) * 2.0 - 1.0
        return draws

    def explore_with(self, state: MADDPGState, obs: torch.Tensor,
                     draws: ExploreDraws, ctx: ExploreCtx):
        """Policy actions plus decayed Gaussian noise on every column (the
        padded tail too), clipped to [-1, 1]."""
        cfg = self.cfg
        a = self.select_action(state, obs, draws.policy)
        noise = cfg.gauss_sigma * noise_scale(cfg, ctx.episodes) * draws.normal
        action = torch.clamp(a + noise, -1.0, 1.0)
        if ctx.warmup:
            action = draws.random
        return state, action

    # ------------------------------------------------------------------
    def draw_update(self, buffer, generator: torch.Generator) -> LearnDraws:
        a, b, p = self.n_agents, self.cfg.batch_size, self.act_pad
        draws = LearnDraws(idx=self._idx(buffer, generator))
        if self.cfg.twin and self.cfg.policy_noise_sigma > 0:
            draws.smooth = self._normals((a, b, a, p), generator)
        if self.gaussian:
            draws.next = self._normals((a, b, a, p), generator)
            draws.new = self._normals((b, a, p), generator)
        return draws

    def update(self, state: MADDPGState, buffer, draws: LearnDraws):
        """One learner step, in place. Returns (state, metrics); an actor's
        loss is 0 on the steps MATD3 skips."""
        cfg = self.cfg
        n = self.n_agents
        batches = buffer.gather(draws.idx)                 # (A, B, ...)
        do_actor = (not cfg.twin
                    or state.step % cfg.policy_freq == cfg.policy_freq - 1)
        metrics = {}
        for i in range(n):
            batch = batches.map(lambda x: x[i])
            critic = state.critics[i]
            with torch.no_grad():
                next_acts = []
                for j in range(n):
                    na = self._actor_act(
                        state.actor_targets[j], self._obs(batch.next_obs, j),
                        None if draws.next is None
                        else self._act(draws.next[i], j))
                    if draws.smooth is not None:
                        pn = torch.clamp(
                            cfg.policy_noise_sigma * self._act(draws.smooth[i],
                                                               j),
                            -cfg.noise_clip, cfg.noise_clip)
                        na = torch.clamp(na + pn, -1.0, 1.0)
                    next_acts.append(na)
                next_q = self._q(state.critic_targets[i], batch.next_obs,
                                 next_acts)
                if cfg.twin:
                    next_q = torch.minimum(*next_q)
                target = td_target(batch.reward[:, i], cfg.gamma, next_q,
                                   batch.done)

            acts = [self._act(batch.action, j) for j in range(n)]
            q = self._q(critic, batch.obs, acts)
            if cfg.twin:
                critic_loss = (torch.mean(torch.square(q[0] - target))
                               + torch.mean(torch.square(q[1] - target)))
            else:
                critic_loss = torch.mean(torch.square(q - target))
            optimizer_step(state.critic_opts[i], list(critic.parameters()),
                           critic_loss, self.GRAD_CLIP, cfg.axis_name)
            metrics[f"critic_loss_{i}"] = critic_loss.detach()

            if do_actor:
                actor_loss = self._actor_loss(state, batch, acts, i, draws)
                optimizer_step(state.actor_opts[i],
                               list(state.actors[i].parameters()), actor_loss,
                               self.GRAD_CLIP, cfg.axis_name)
                actor_loss = actor_loss.detach()
            else:
                actor_loss = torch.zeros((), device=self.device)
            metrics[f"actor_loss_{i}"] = actor_loss

        if do_actor:
            polyak(net_params(state.actor_targets), net_params(state.actors),
                   cfg.tau)
        polyak(net_params(state.critic_targets), net_params(state.critics),
               cfg.tau)
        state.step += 1
        return state, metrics

    def _actor_loss(self, state: MADDPGState, batch, acts: list, i: int,
                    draws: LearnDraws) -> torch.Tensor:
        """Agent i's actor loss, through its just-updated critic."""
        cfg = self.cfg
        obs_i = self._obs(batch.obs, i)
        if self.gaussian:
            mean, log_std = state.actors[i](obs_i)
            std = torch.exp(log_std)
            u = (mean + std * self._act(draws.new, i)).detach()
            return -(torch.mean(normal_log_prob(mean, std, u))
                     + cfg.approx_lmbda * torch.mean(normal_entropy(std)))
        a_i = state.actors[i](obs_i)
        q = self._q(state.critics[i], batch.obs,
                    acts[:i] + [a_i] + acts[i + 1:], q1_only=cfg.twin)
        loss = -torch.mean(q)
        if cfg.regular:
            loss = loss + 1e-3 * torch.mean(torch.square(a_i))
        return loss


def MATD3(env, cfg: Optional[MADDPGConfig] = None, device="cuda") -> MADDPG:
    """MADDPG x TD3: a twin centralized critic, target-policy smoothing and
    delayed actors."""
    cfg = MADDPGConfig(twin=True) if cfg is None else dataclasses.replace(
        cfg, twin=True)
    return MADDPG(env, cfg, device)
