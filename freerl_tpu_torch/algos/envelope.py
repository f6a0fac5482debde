"""ENVELOPE multi-objective Q-learning, preference-conditioned, and its
continuous DDPG form (counterpart: ``freerl_tpu/algos/envelope.py``).

- ``MOQNet``: Q(s, w) -> (action_dim, reward_dim) vector values from a
  2x256 MLP over ``concat(obs, w)`` (``Dense``, the torch scheme);
- acting: a fresh preference per row, ``|N(0, 1)|`` L1-normalized,
  scalarizes Q; epsilon-greedy on top;
- the replay add goes through ``add_transition`` (the loop's hook): it
  stores an add-time priority ``|w.r + gamma * w.hQ - w.Q| + 1e-5`` under
  a sampled preference, and advances the homotopy beta once per
  terminated transition;
- ``sample``: priority-proportional sampling without replacement, by the
  Gumbel-top-k trick;
- ``update``: the batch repeated ``weight_num`` times with fresh
  preferences, the double-DQN action on the scalarized ONLINE Q, the
  TARGET vector Q gathered there, loss ``beta * mse(wQ, wTQ) + (1 - beta)
  * mse(Q, TQ)``, Adam (eps 1e-8; ``grad_clip=None``, the default, is no
  clip, as the reference's clip before ``backward`` is a no-op), polyak.

**The homotopy schedule.** The JAX package bumps beta with a masked
``fori_loop`` over the add's rows: ``beta' = min(beta + delta, uplim)``,
``delta' = (beta' - beta_init) * (expbase - 1)`` in float32, once per
terminated row. The sequence depends only on how many bumps have been
made, so the port computes it once, in float32 numpy with the same
operations, as a table of (beta, delta) that ends where the recurrence
reaches its fixed point (beta at ``beta_uplim``), and an add looks its
row up by a device bump counter: no host sync, no loop per row.

**Sampling order.** ``lax.top_k`` puts ties (the ``-inf`` of unwritten
slots) lowest index first; ``torch.topk`` gives no such order, a stable
descending ``torch.sort`` does. While fewer than ``batch_size``
transitions are stored, the tail of the top-k is such ties, folded back
onto the stored ones modulo ``size``.

Draws are arguments: the preference normals (``random_preference`` takes
standard normals), the epsilon uniforms and random actions
(``ExploreDraws``), the Gumbel noise of ``sample``.

``EnvelopeDDPG`` (the continuous variant): a preference-conditioned tanh
actor and a vector critic with the same beta-blended loss, on the plain
uniform replay; its beta advances once per learner step with its own
recurrence, ``delta' = (beta' - beta_init) * expbase + beta_init -
beta'``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from freerl_tpu_torch.algos.base import (ExploreCtx, ExploreDraws,
                                         OffPolicyAlgo, check_axis_name,
                                         draw_random_actions, frozen_copy)
from freerl_tpu_torch.algos.common import optimizer_step, polyak
from freerl_tpu_torch.buffers.uniform import ReplayBuffer
from freerl_tpu_torch.core.types import DimInfo, Transition
from freerl_tpu_torch.nets.distributions import draw_gumbel
from freerl_tpu_torch.nets.mlp import MLP


def random_preference(normal: torch.Tensor) -> torch.Tensor:
    """The reference's preference sampler from standard normals ``(...,
    R)``: ``|normal|`` divided by its L1 norm."""
    w = torch.abs(normal)
    return w / torch.sum(w, dim=-1, keepdim=True)


def draw_preference_normals(shape, reward_dim: int,
                            generator: torch.Generator, device):
    return torch.randn(tuple(shape) + (reward_dim,), generator=generator,
                       device=device)


class MOQNet(MLP):
    """(obs, w) -> (..., action_dim, reward_dim) vector Q-values."""

    def __init__(self, obs_dim: int, action_dim: int, reward_dim: int,
                 hidden: Sequence[int] = (256, 256),
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__(obs_dim + reward_dim, action_dim * reward_dim,
                         hidden, "relu", generator, device)
        self.action_dim, self.reward_dim = action_dim, reward_dim

    def forward(self, obs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        q = super().forward(torch.cat([obs, w], dim=-1))
        return q.reshape(q.shape[:-1] + (self.action_dim, self.reward_dim))


@dataclasses.dataclass(frozen=True)
class EnvelopeConfig:
    """Static hyperparameters, with the JAX package's fields and
    defaults."""

    lr: float = 1e-3
    gamma: float = 0.99
    tau: float = 0.01
    batch_size: int = 256
    buffer_size: int = 100_000
    hidden: Sequence[int] = (256, 256)
    epsilon: float = 0.1
    # the reference protocol: epsilon 0.4 decaying linearly to 0.05 over
    # max_episodes
    epsilon_decay: bool = False
    epsilon_final: float = 0.05
    weight_num: int = 4
    # the reference's --beta 0.95: the homotopy path runs 0.95 -> 1.0
    beta_init: float = 0.95
    beta_uplim: float = 1.0
    homotopy_tau: float = 1000.0
    max_episodes: int = 500
    # None (no clip) matches the reference, whose clip runs before
    # backward() and so clips nothing
    grad_clip: Optional[float] = None
    axis_name: Optional[str] = None


def beta_expbase(cfg: EnvelopeConfig) -> float:
    """The exponential homotopy schedule's base (a host double)."""
    return float((cfg.homotopy_tau * (cfg.beta_uplim - cfg.beta_init))
                 ** (1.0 / cfg.max_episodes))


def beta_table(cfg: EnvelopeConfig, limit: int = 1_000_000):
    """(beta, delta) after k bumps, k = 0, 1, ... up to the recurrence's
    fixed point, as two float32 arrays: the JAX ``fori_loop``'s float32
    operations, made one bump at a time."""
    f32 = np.float32
    uplim, b0 = f32(cfg.beta_uplim), f32(cfg.beta_init)
    em1 = f32(beta_expbase(cfg) - 1.0)
    beta, delta = b0, f32(beta_expbase(cfg) / cfg.homotopy_tau)
    betas, deltas = [beta], [delta]
    for _ in range(limit):
        nb = np.minimum(f32(beta + delta), uplim)
        nd = f32(f32(nb - b0) * em1)
        if nb == beta and nd == delta:
            return np.array(betas, f32), np.array(deltas, f32)
        beta, delta = nb, nd
        betas.append(beta)
        deltas.append(delta)
    raise ValueError(f"the homotopy recurrence of {cfg} reaches no fixed "
                     f"point in {limit} bumps")


@dataclasses.dataclass
class EnvelopeState:
    net: MOQNet
    target_net: MOQNet
    opt: torch.optim.Adam
    beta: torch.Tensor             # f32 scalar
    beta_delta: torch.Tensor       # f32 scalar
    bumps: torch.Tensor            # int64 scalar: homotopy bumps so far
    step: int = 0


@dataclasses.dataclass
class MOReplay(ReplayBuffer):
    """The transition ring with vector rewards and aligned add-time
    priorities."""

    priorities: Optional[torch.Tensor] = None     # (capacity,)

    def add_with(self, batch: Transition,
                 priority: torch.Tensor) -> "MOReplay":
        rows, skip = self.rows(batch.obs.shape[0])
        self.priorities[rows] = priority[skip:]
        return self.add(batch)


def _gather_action(q: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """(B, A, R) vector values at the (B,) actions -> (B, R)."""
    return q[torch.arange(q.shape[0], device=q.device), action]


class Envelope(OffPolicyAlgo):
    def __init__(self, dim_info: DimInfo, reward_dim: int,
                 cfg: EnvelopeConfig = EnvelopeConfig(), device="cuda"):
        if dim_info.is_continue:
            raise ValueError("Envelope is discrete-action; EnvelopeDDPG is "
                             "the continuous variant")
        check_axis_name(cfg)
        self.dim_info = dim_info
        self.reward_dim = reward_dim
        self.cfg = cfg
        self.device = torch.device(device)
        betas, deltas = beta_table(cfg)
        self._betas = torch.from_numpy(betas).to(self.device)
        self._deltas = torch.from_numpy(deltas).to(self.device)

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> EnvelopeState:
        cfg, di = self.cfg, self.dim_info
        net = MOQNet(di.obs_dim, di.action_dim, self.reward_dim,
                     tuple(cfg.hidden), generator, self.device)
        opt = torch.optim.Adam(net.parameters(), lr=cfg.lr, eps=1e-8)
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        return EnvelopeState(net=net, target_net=frozen_copy(net), opt=opt,
                             beta=self._betas[0].clone(),
                             beta_delta=self._deltas[0].clone(), bumps=zero)

    def make_buffer(self, example: Transition, num_envs: int = 0) -> MOReplay:
        base = ReplayBuffer.create(self.cfg.buffer_size, example,
                                   add_batch=num_envs)
        return MOReplay(data=base.data, capacity=base.capacity,
                        align=base.align,
                        priorities=torch.zeros(base.capacity,
                                               device=example.obs.device))

    # ------------------------------------------------------------------
    def _scalarized_q(self, net, obs, w):
        q = net(obs, w)                                        # (..., A, R)
        return torch.einsum("...ar,...r->...a", q, w), q

    @torch.no_grad()
    def select_action(self, state: EnvelopeState, obs: torch.Tensor,
                      preference_normals: torch.Tensor):
        """The greedy action of each row under its own preference, drawn
        from ``preference_normals`` (B, R)."""
        w = random_preference(preference_normals)
        return torch.argmax(self._scalarized_q(state.net, obs, w)[0], dim=-1)

    @torch.no_grad()
    def evaluate_action(self, state: EnvelopeState, obs: torch.Tensor,
                        preference: torch.Tensor):
        w = torch.as_tensor(preference, dtype=torch.float32,
                            device=obs.device).expand(
            obs.shape[:-1] + (self.reward_dim,))
        return torch.argmax(self._scalarized_q(state.net, obs, w)[0], dim=-1)

    def draw_explore(self, b: int, generator: torch.Generator,
                     ctx: ExploreCtx) -> ExploreDraws:
        dev = self.device
        return ExploreDraws(
            preference=draw_preference_normals((b,), self.reward_dim,
                                               generator, dev),
            uniform=torch.rand(b, generator=generator, device=dev),
            random=torch.randint(0, self.dim_info.action_dim, (b,),
                                 generator=generator, device=dev))

    def explore_with(self, state: EnvelopeState, obs: torch.Tensor,
                     draws: ExploreDraws, ctx: ExploreCtx):
        cfg = self.cfg
        greedy = self.select_action(state, obs, draws.preference)
        eps = cfg.epsilon
        if cfg.epsilon_decay:
            frac = ctx.episodes.to(torch.float32) / cfg.max_episodes
            eps = torch.clamp(
                cfg.epsilon - (cfg.epsilon - cfg.epsilon_final) * frac,
                min=cfg.epsilon_final)
        action = torch.where(draws.uniform < eps, draws.random, greedy)
        if ctx.warmup:
            action = draws.random
        return state, action

    # ------------------------------------------------------------------
    def draw_priority(self, b: int, generator: torch.Generator):
        """The preference normals (b, R) of an add's priorities."""
        return draw_preference_normals((b,), self.reward_dim, generator,
                                       self.device)

    @torch.no_grad()
    def add_with_priority(self, state: EnvelopeState, buffer: MOReplay,
                          batch: Transition, preference_normals):
        """Replay add with the reference's add-time priority, and one
        homotopy bump per terminated transition. Returns (state, buffer)."""
        cfg = self.cfg
        w = random_preference(preference_normals)
        action = batch.action.reshape(-1).to(torch.int64)
        q_a = _gather_action(state.net(batch.obs, w), action)      # (B, R)
        wq = torch.sum(w * q_a, dim=-1)
        wr = torch.sum(w * batch.reward, dim=-1)
        scal, next_q = self._scalarized_q(state.net, batch.next_obs, w)
        hq = _gather_action(next_q, torch.argmax(scal, dim=-1))
        whq = torch.sum(w * hq, dim=-1)
        done = batch.done.to(torch.float32)
        p = torch.abs(wr + (1.0 - done) * cfg.gamma * whq - wq) + 1e-5
        buffer.add_with(batch, p)
        state.bumps = state.bumps + batch.done.sum()
        k = torch.clamp(state.bumps, max=self._betas.shape[0] - 1)
        state.beta, state.beta_delta = self._betas[k], self._deltas[k]
        return state, buffer

    def add_transition(self, state: EnvelopeState, buffer: MOReplay,
                       batch: Transition, generator: torch.Generator):
        """The loop's add hook: ``add_with_priority`` with its draw."""
        return self.add_with_priority(
            state, buffer, batch,
            self.draw_priority(batch.obs.shape[0], generator))

    # ------------------------------------------------------------------
    def sample_idx(self, buffer: MOReplay, gumbel: torch.Tensor,
                   batch_size: int) -> torch.Tensor:
        """``batch_size`` indices, priority-proportional and without
        replacement, from the Gumbel noise ``gumbel`` (capacity,)."""
        slots = torch.arange(buffer.capacity, device=gumbel.device)
        logits = torch.where(slots < buffer.size,
                             torch.log(buffer.priorities + 1e-12),
                             -torch.inf)
        idx = torch.sort(logits + gumbel, descending=True,
                         stable=True).indices[:batch_size]
        return torch.where(idx < buffer.size, idx,
                           idx % max(buffer.size, 1))

    def sample(self, buffer: MOReplay, gumbel: torch.Tensor,
               batch_size: int) -> Transition:
        return buffer.gather(self.sample_idx(buffer, gumbel, batch_size))

    # ------------------------------------------------------------------
    def draw_update(self, batch: Transition, generator: torch.Generator):
        """The preference normals (weight_num, R) of one update."""
        return draw_preference_normals((self.cfg.weight_num,),
                                       self.reward_dim, generator,
                                       self.device)

    def update(self, state: EnvelopeState, batch: Transition,
               preference_normals: torch.Tensor):
        """One learner step, in place. Returns (state, metrics, None)."""
        cfg = self.cfg
        B, W = batch.reward.shape[0], cfg.weight_num

        def rep(x):
            return torch.cat([x] * W, dim=0)

        obs, next_obs = rep(batch.obs), rep(batch.next_obs)
        actions = rep(batch.action.reshape(-1)).to(torch.int64)
        rewards = rep(batch.reward)
        dones = rep(batch.done.to(torch.float32))
        w = torch.repeat_interleave(random_preference(preference_normals), B,
                                    dim=0)                     # (B*W, R)

        with torch.no_grad():
            # double DQN: online scalarized argmax, target vector gather
            scal, _ = self._scalarized_q(state.net, next_obs, w)
            hq = _gather_action(state.target_net(next_obs, w),
                                torch.argmax(scal, dim=-1))
            target_q = rewards + cfg.gamma * hq * (1.0 - dones[:, None])
            wtq = torch.sum(w * target_q, dim=-1)

        q_a = _gather_action(state.net(obs, w), actions)
        wq = torch.sum(w * q_a, dim=-1)
        aux = torch.mean(torch.square(wq - wtq))
        main = torch.mean(torch.square(q_a - target_q))
        loss = state.beta * aux + (1.0 - state.beta) * main
        params = list(state.net.parameters())
        optimizer_step(state.opt, params, loss, cfg.grad_clip, cfg.axis_name)
        polyak(state.target_net.parameters(), params, cfg.tau)
        state.step += 1
        return state, {"loss": loss.detach(), "beta": state.beta}, None

    def draw_sample(self, buffer: MOReplay, generator: torch.Generator):
        """The Gumbel noise (capacity,) of one ``sample``."""
        return draw_gumbel((buffer.capacity,), generator, self.device)

    def learn_step(self, state, buffer, generator: torch.Generator,
                   num_envs: int):
        batch = self.sample(buffer, self.draw_sample(buffer, generator),
                            self.cfg.batch_size)
        state, metrics, _ = self.update(state, batch,
                                        self.draw_update(batch, generator))
        return state, buffer, metrics


# ---------------------------------------------------------------------------
class MOActor(MLP):
    """The preference-conditioned tanh actor a = pi(obs, w) (in [-1, 1];
    the caller scales by ``max_action``)."""

    def __init__(self, obs_dim: int, action_dim: int, reward_dim: int,
                 hidden: Sequence[int] = (256, 256),
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__(obs_dim + reward_dim, action_dim, hidden, "relu",
                         generator, device)

    def forward(self, obs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.tanh(super().forward(torch.cat([obs, w], dim=-1)))


class MOCritic(MLP):
    """The vector critic Q(obs, a, w) -> (..., reward_dim)."""

    def __init__(self, obs_dim: int, action_dim: int, reward_dim: int,
                 hidden: Sequence[int] = (256, 256),
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__(obs_dim + action_dim + reward_dim, reward_dim,
                         hidden, "relu", generator, device)

    def forward(self, obs: torch.Tensor, act: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
        return super().forward(torch.cat([obs, act, w], dim=-1))


@dataclasses.dataclass
class EnvelopeDDPGState:
    actor: MOActor
    actor_target: MOActor
    critic: MOCritic
    critic_target: MOCritic
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    beta: torch.Tensor
    beta_delta: torch.Tensor
    step: int = 0


class EnvelopeDDPG(OffPolicyAlgo):
    """Continuous ENVELOPE: a preference-conditioned actor and a vector
    critic with the DQN variant's beta-blended loss."""

    def __init__(self, dim_info: DimInfo, reward_dim: int,
                 cfg: EnvelopeConfig = EnvelopeConfig(), device="cuda"):
        if not dim_info.is_continue:
            raise ValueError("EnvelopeDDPG is continuous-action")
        check_axis_name(cfg)
        self.dim_info = dim_info
        self.reward_dim = reward_dim
        self.cfg = cfg
        self.device = torch.device(device)
        self.beta_expbase = beta_expbase(cfg)

    def init(self, generator: torch.Generator) -> EnvelopeDDPGState:
        cfg, di, dev = self.cfg, self.dim_info, self.device
        hidden = tuple(cfg.hidden)
        actor = MOActor(di.obs_dim, di.action_dim, self.reward_dim, hidden,
                        generator, dev)
        critic = MOCritic(di.obs_dim, di.action_dim, self.reward_dim, hidden,
                          generator, dev)
        return EnvelopeDDPGState(
            actor=actor, actor_target=frozen_copy(actor),
            critic=critic, critic_target=frozen_copy(critic),
            actor_opt=torch.optim.Adam(actor.parameters(), lr=cfg.lr,
                                       eps=1e-8),
            critic_opt=torch.optim.Adam(critic.parameters(), lr=cfg.lr,
                                        eps=1e-8),
            beta=torch.tensor(cfg.beta_init, dtype=torch.float32, device=dev),
            beta_delta=torch.tensor(self.beta_expbase / cfg.homotopy_tau,
                                    dtype=torch.float32, device=dev))

    @torch.no_grad()
    def evaluate_action(self, state: EnvelopeDDPGState, obs: torch.Tensor,
                        preference: torch.Tensor):
        w = torch.as_tensor(preference, dtype=torch.float32,
                            device=obs.device).expand(
            obs.shape[:-1] + (self.reward_dim,))
        return state.actor(obs, w) * self.dim_info.max_action

    def draw_explore(self, b: int, generator: torch.Generator,
                     ctx: ExploreCtx) -> ExploreDraws:
        di, dev = self.dim_info, self.device
        draws = ExploreDraws(
            preference=draw_preference_normals((b,), self.reward_dim,
                                               generator, dev),
            normal=torch.randn(b, di.action_dim, generator=generator,
                               device=dev))
        if ctx.warmup:
            draws.random = draw_random_actions(di, b, generator, dev)
        return draws

    @torch.no_grad()
    def explore_with(self, state: EnvelopeDDPGState, obs: torch.Tensor,
                     draws: ExploreDraws, ctx: ExploreCtx):
        max_a = self.dim_info.max_action
        w = random_preference(draws.preference)
        a = state.actor(obs, w) * max_a
        action = torch.clamp(a + 0.1 * max_a * draws.normal, -max_a, max_a)
        if ctx.warmup:
            action = draws.random
        return state, action

    def draw_update(self, batch: Transition, generator: torch.Generator):
        return draw_preference_normals((self.cfg.weight_num,),
                                       self.reward_dim, generator,
                                       self.device)

    def update(self, state: EnvelopeDDPGState, batch: Transition,
               preference_normals: torch.Tensor):
        """One learner step, in place: critic, then the actor through the
        updated critic, polyak, and one beta step. Returns (state, metrics,
        None)."""
        cfg = self.cfg
        B, W = batch.reward.shape[0], cfg.weight_num

        def rep(x):
            return torch.cat([x] * W, dim=0)

        obs, next_obs, actions = rep(batch.obs), rep(batch.next_obs), \
            rep(batch.action)
        rewards, dones = rep(batch.reward), rep(batch.done.to(torch.float32))
        w = torch.repeat_interleave(random_preference(preference_normals), B,
                                    dim=0)
        with torch.no_grad():
            hq = state.critic_target(next_obs,
                                     state.actor_target(next_obs, w), w)
            target_q = rewards + cfg.gamma * hq * (1.0 - dones[:, None])
            wtq = torch.sum(w * target_q, dim=-1)

        beta = state.beta
        q = state.critic(obs, actions, w)
        wq = torch.sum(w * q, dim=-1)
        critic_loss = (beta * torch.mean(torch.square(wq - wtq))
                       + (1.0 - beta) * torch.mean(torch.square(q - target_q)))
        critic_params = list(state.critic.parameters())
        optimizer_step(state.critic_opt, critic_params, critic_loss,
                       cfg.grad_clip, cfg.axis_name)

        actor_params = list(state.actor.parameters())
        q_new = state.critic(obs, state.actor(obs, w), w)
        actor_loss = -torch.mean(torch.sum(w * q_new, dim=-1))
        optimizer_step(state.actor_opt, actor_params, actor_loss,
                       cfg.grad_clip, cfg.axis_name)

        polyak(state.actor_target.parameters(), actor_params, cfg.tau)
        polyak(state.critic_target.parameters(), critic_params, cfg.tau)
        new_beta = torch.clamp(beta + state.beta_delta, max=cfg.beta_uplim)
        state.beta_delta = ((new_beta - cfg.beta_init) * self.beta_expbase
                            + cfg.beta_init - new_beta)
        state.beta = new_beta
        state.step += 1
        metrics = {"critic_loss": critic_loss.detach(),
                   "actor_loss": actor_loss.detach(), "beta": beta}
        return state, metrics, None
