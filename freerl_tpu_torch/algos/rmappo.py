"""Recurrent MAPPO (rMAPPO) and rIPPO: GRU actors and critics trained by
truncated BPTT (counterpart: ``freerl_tpu/algos/rmappo.py``).

- a per-agent GRU actor over its own observation and a per-agent GRU
  critic over every agent's observation (its own in ``independent``
  mode, :func:`RIPPO`), the cells of ``nets/rnn.py``;
- the hidden states are carried by the rollout driver, one cell step per
  env step, and zeroed where the previous step ended an episode: the
  driver opts in by seeing ``init_policy_carry``; ``sample_action`` then
  takes and returns the carry, and returns the step's ``extras`` (the
  hidden states BEFORE the reset and ``done_prev``), which the driver
  stacks into (T, ...) tensors for ``update(..., extras=)``;
- the values replay each critic over the whole horizon from the hidden
  state recorded at its first step, with one extra cell step onto the
  true successor obs for the bootstrap;
- the update cuts the horizon into chunks of ``L = min(data_chunk_length,
  T)`` steps (else the largest divisor of T below it), each started from
  the hidden state recorded at its first step, and runs BPTT over them;
  each agent's K epochs shuffle the S = (T / L) * N sequences;
- MAPPO's losses and tricks, one Adam per agent (eps 1e-8, 1e-5 under
  ``adam_eps``) at ``actor_lr * frac``, and no gradient clip.

Draws: ``sample_action`` takes MAPPO's ``(b, A, P)`` noise; ``update``
takes ``(A, K_epochs, S)`` permutations of the sequences (agent i's from
JAX's ``fold_in(key, i)``, one split per epoch).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from freerl_tpu_torch.algos.common import gae
from freerl_tpu_torch.algos.mappo import (AgentAxisPPO, lr_fraction, set_lr,
                                          step)
from freerl_tpu_torch.algos.ppo import Rollout
from freerl_tpu_torch.core.normalization import RewardScaling, RunningMeanStd
from freerl_tpu_torch.distributed.dp import pmean
from freerl_tpu_torch.nets import distributions as D
from freerl_tpu_torch.nets.rnn import RecurrentActor, RecurrentVCritic


@dataclasses.dataclass(frozen=True)
class RMAPPOConfig:
    """Static hyperparameters, with the JAX package's fields, defaults and
    validators."""

    actor_lr: float = 5e-4
    gamma: float = 0.95
    lmbda: float = 0.95
    clip_param: float = 0.2
    K_epochs: int = 15
    entropy_coefficient: float = 0.01
    horizon: int = 256
    minibatch_size: int = 256        # in transitions; >= data_chunk_length
    data_chunk_length: int = 10      # the truncated-BPTT window
    hidden: Sequence[int] = (128,)
    rnn_hidden: int = 64
    num_envs: int = 1
    huber_delta: float = 10.0
    independent: bool = False        # rIPPO: own-obs critic and GAE
    # tricks
    adv_norm: bool = False
    obs_norm: bool = False
    reward_norm: bool = False
    reward_scaling: bool = False
    orthogonal_init: bool = False
    adam_eps: bool = False
    lr_decay: bool = False
    lr_decay_episodes: int = 200
    value_clip: bool = False
    huber_loss: bool = False
    layer_norm: bool = False
    masked: bool = False
    mask_dim: int = 0
    axis_name: Optional[str] = None

    def __post_init__(self):
        if self.reward_norm and self.reward_scaling:
            raise ValueError(
                "reward_norm and reward_scaling cannot both be on"
            )
        if self.masked and self.mask_dim <= 0:
            raise ValueError("masked mode needs mask_dim > 0")


@dataclasses.dataclass
class RMAPPOState:
    actors: list
    critics: list
    opts: list                         # one Adam per agent
    obs_rms: RunningMeanStd
    rew_rms: RunningMeanStd
    rew_scale: RewardScaling
    step: int = 0


@dataclasses.dataclass
class HiddenCarry:
    """The rollout's GRU states, (N, A, H) each, before the reset (the
    cell applies the reset from ``done_prev``)."""

    h_actor: torch.Tensor
    h_critic: torch.Tensor


class RMAPPO(AgentAxisPPO):
    STATS_OVER_AXIS = False

    def __init__(self, env, cfg: RMAPPOConfig = RMAPPOConfig(),
                 device="cuda"):
        super().__init__(env, cfg, device)

    def _critic_input(self, obs, i):
        if self.cfg.independent:
            return self._agent_obs(obs, i)
        return torch.cat([self._agent_obs(obs, j)
                          for j in range(self.n_agents)], dim=-1)

    def init(self, generator: torch.Generator) -> RMAPPOState:
        cfg, dev = self.cfg, self.device
        kw = dict(hidden=tuple(cfg.hidden), rnn_hidden=cfg.rnn_hidden,
                  orthogonal=cfg.orthogonal_init, layer_norm=cfg.layer_norm,
                  generator=generator, device=dev)
        actors, critics = [], []
        for i in range(self.n_agents):
            actors.append(RecurrentActor(self.obs_dims[i], self.act_dims[i],
                                         self.is_continue, **kw))
            cdim = (self.obs_dims[i] if cfg.independent
                    else sum(self.obs_dims))
            critics.append(RecurrentVCritic(cdim, **kw))
        opts = [self._adam([*a.parameters(), *c.parameters()])
                for a, c in zip(actors, critics)]
        return RMAPPOState(actors=actors, critics=critics, opts=opts,
                           **self._stats())

    def init_policy_carry(self, num_envs: int) -> HiddenCarry:
        z = torch.zeros((num_envs, self.n_agents, self.cfg.rnn_hidden),
                        device=self.device)
        return HiddenCarry(h_actor=z, h_critic=z)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def sample_action(self, state: RMAPPOState, obs: torch.Tensor, draws,
                      carry: HiddenCarry, done_prev: torch.Tensor):
        """obs (N, A, O_pad), done_prev (N,) -> (env_action, stored, logp
        (N, A), new carry, extras); the extras are the carry's hidden
        states before the reset and ``done_prev``: what the update needs
        to replay this step."""
        extras = {"h_actor": carry.h_actor, "h_critic": carry.h_critic,
                  "done_prev": done_prev}
        env_as, stored, logps, h_as, h_cs = [], [], [], [], []
        for i in range(self.n_agents):
            obs_i = self._agent_obs(obs, i)
            out, h_a = state.actors[i](obs_i, carry.h_actor[:, i], done_prev)
            _, h_c = state.critics[i](self._critic_input(obs, i),
                                      carry.h_critic[:, i], done_prev)
            a_env, a, logp = self._sample(out, obs_i,
                                          draws[:, i, :self.act_dims[i]])
            if self.is_continue:
                a_env, a = self._pad_act(a_env, i), self._pad_act(a, i)
            env_as.append(a_env)
            stored.append(a)
            logps.append(logp)
            h_as.append(h_a)
            h_cs.append(h_c)
        ax = -2 if self.is_continue else -1
        carry = HiddenCarry(h_actor=torch.stack(h_as, dim=1),
                            h_critic=torch.stack(h_cs, dim=1))
        return (torch.stack(env_as, dim=ax), torch.stack(stored, dim=ax),
                torch.stack(logps, dim=-1), carry, extras)

    @torch.no_grad()
    def evaluate_action(self, state: RMAPPOState, obs: torch.Tensor,
                        carry: HiddenCarry, done_prev: torch.Tensor):
        """The greedy action for RAW observations (normalized first under
        ``obs_norm``), and the carry with the actors' hidden states
        advanced."""
        if self.cfg.obs_norm:
            obs = state.obs_rms.normalize(obs)
        outs, h_as = [], []
        for i in range(self.n_agents):
            obs_i = self._agent_obs(obs, i)
            out, h_a = state.actors[i](obs_i, carry.h_actor[:, i], done_prev)
            h_as.append(h_a)
            if self.is_continue:
                outs.append(self._pad_act(out[0], i))
            else:
                if self.cfg.masked:
                    out = D.masked_logits(out,
                                          obs_i[..., -self.cfg.mask_dim:])
                outs.append(torch.argmax(out, dim=-1))
        carry = dataclasses.replace(carry, h_actor=torch.stack(h_as, dim=1))
        return (torch.stack(outs, dim=-2 if self.is_continue else -1),
                carry)

    # ------------------------------------------------------------------
    def _chunks(self, T: int, N: int):
        """(L, S, sequences per minibatch, minibatches per epoch)."""
        cfg = self.cfg
        L = min(cfg.data_chunk_length, T)
        if T % L:
            # the largest divisor of T not above the requested length
            L = next(d for d in range(L, 0, -1) if T % d == 0)
        S = (T // L) * N
        per_mb = max(1, min(cfg.minibatch_size // L, S))
        return L, S, per_mb, max(S // per_mb, 1)

    def draw_update(self, rollout: Rollout, generator: torch.Generator):
        """Each agent's K epochs' permutations of the S sequences,
        (A, K, S)."""
        T, N = rollout.reward.shape[:2]
        S = self._chunks(T, N)[1]
        return torch.stack([torch.stack([
            torch.randperm(S, generator=generator, device=self.device)
            for _ in range(self.cfg.K_epochs)])
            for _ in range(self.n_agents)])

    @torch.no_grad()
    def _values_full(self, state: RMAPPOState, rollout: Rollout, extras):
        """Each critic replayed over the horizon from its first recorded
        hidden state: (vs, vs_next), (T, N, A) each."""
        vs, vs_next = [], []
        dp = extras["done_prev"]
        for i, critic in enumerate(state.critics):
            h = extras["h_critic"][0, :, i]
            v_i, n_i = [], []
            for t in range(rollout.obs.shape[0]):
                v, h = critic(self._critic_input(rollout.obs[t], i), h, dp[t])
                # one extra cell step onto the true successor obs
                v_next, _ = critic(self._critic_input(rollout.next_obs[t], i),
                                   h, torch.zeros_like(dp[t]))
                v_i.append(v)
                n_i.append(v_next)
            vs.append(torch.stack(v_i))
            vs_next.append(torch.stack(n_i))
        return torch.stack(vs, dim=-1), torch.stack(vs_next, dim=-1)

    def update(self, state: RMAPPOState, rollout: Rollout, draws,
               episodes=None, extras=None):
        """One full update, in place, on the rollout and the driver's
        stacked extras; agent i's epoch e visits the sequences in the order
        ``draws[i, e]``. Returns (state, {"adv_mean"})."""
        if extras is None:
            raise ValueError("rMAPPO's update needs the driver's extras")
        if draws is None:
            raise ValueError("rMAPPO's update needs its permutations")
        cfg, a = self.cfg, self.n_agents
        T, N = rollout.reward.shape[:2]
        L, S, per_mb, n_mb = self._chunks(T, N)

        with torch.no_grad():
            vs, vs_next = self._values_full(state, rollout, extras)
            adv, v_target = gae(rollout.reward, vs, vs_next,
                                rollout.done[..., None],
                                rollout.adv_done[..., None], cfg.gamma,
                                cfg.lmbda)
            if cfg.adv_norm:
                adv = (adv - torch.mean(adv)) / (
                    torch.std(adv, correction=0) + 1e-8)

        def to_chunks(x):
            """(T, N, ...) -> (S, L, ...): chunk c of env n is row c*N+n."""
            x = x.reshape((T // L, L) + x.shape[1:]).movedim(2, 1)
            return x.reshape((S, L) + x.shape[3:])

        obs_c = to_chunks(rollout.obs)                   # (S, L, A, O)
        act_c = to_chunks(rollout.action)
        logp_old_c = to_chunks(rollout.log_pi)           # (S, L, A)
        dp_c = to_chunks(extras["done_prev"])            # (S, L)
        adv_c, vt_c = to_chunks(adv), to_chunks(v_target)
        # the chunks' first hidden states, (S, A, H)
        h_a0 = extras["h_actor"][::L].reshape((S, a, -1))
        h_c0 = extras["h_critic"][::L].reshape((S, a, -1))

        set_lr(state.opts, cfg.actor_lr, lr_fraction(cfg, episodes))
        for i in range(a):
            act_i = (act_c[..., i, :self.act_dims[i]] if self.is_continue
                     else act_c[..., i])                 # (S, L[, act])
            actor, critic = state.actors[i], state.critics[i]
            params = [*actor.parameters(), *critic.parameters()]
            for perm in draws[i]:
                for m in range(n_mb):
                    idx = perm[m * per_mb:(m + 1) * per_mb]
                    o, dp = obs_c[idx], dp_c[idx]
                    h_a, h_c = h_a0[idx, i], h_c0[idx, i]
                    outs, v = [], []
                    for t in range(L):
                        out, h_a = actor(self._agent_obs(o[:, t], i), h_a,
                                         dp[:, t])
                        v_t, h_c = critic(self._critic_input(o[:, t], i),
                                          h_c, dp[:, t])
                        outs.append(out)
                        v.append(v_t)
                    out = (tuple(torch.stack(x, dim=1) for x in zip(*outs))
                           if self.is_continue else torch.stack(outs, dim=1))
                    logp, ent = self._logp_ent(out, self._agent_obs(o, i),
                                               act_i[idx])
                    v = torch.stack(v, dim=1)            # (mb, L)
                    if cfg.independent:
                        adv_b, vt_b = adv_c[idx, :, i], vt_c[idx, :, i]
                    else:
                        adv_b, vt_b, v = adv_c[idx], vt_c[idx], v[..., None]
                    loss = self._loss(logp, ent, logp_old_c[idx, :, i],
                                      adv_b, v, vt_b, stacked=False)
                    step(state.opts[i], params,
                         pmean(list(torch.autograd.grad(loss, params)),
                               cfg.axis_name))
        state.step += 1
        return state, {"adv_mean": torch.mean(adv)}


def RIPPO(env, cfg: RMAPPOConfig = None, device="cuda") -> RMAPPO:
    """Independent recurrent PPO: own-obs GRU critic, per-agent GAE."""
    if cfg is None:
        cfg = RMAPPOConfig(independent=True)
    else:
        cfg = dataclasses.replace(cfg, independent=True)
    return RMAPPO(env, cfg, device)
