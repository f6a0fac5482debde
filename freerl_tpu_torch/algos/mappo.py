"""MAPPO (the 12-trick set) and IPPO on the agent-axis rollout
(counterpart: ``freerl_tpu/algos/mappo.py``).

- a per-agent actor over its own observation and a per-agent CENTRALIZED
  V-critic over every agent's observation, concatenated at their true
  widths; joint GAE over the agent-stacked rewards: each agent's scalar
  ratio broadcasts against the ``(mb, A)`` advantage and its critic output
  is repeated across the agent axis against the joint value target;
- IPPO (``independent``, :func:`IPPO`): each critic on its own
  observation, per-agent GAE, the grad clip at 0.5;
- the tricks ``adv_norm``, ``obs_norm``, ``reward_norm``,
  ``reward_scaling``, ``orthogonal_init``, ``adam_eps`` (eps 1e-5, else
  1e-8), ``lr_decay``, ``value_clip`` (the TARGET clipped around the
  current value, as the JAX package does), ``huber_loss`` (delta 10),
  ``layer_norm`` and ``feature_norm`` (flax's LayerNorm, ``nets/norm.py``);
- the attention critic (``attention``, :class:`SharedAttnVCritics`): one
  shared attention block; agent 0's step trains it, agents ``i > 0``
  train only their actors;
- the masked mode (logits at -1e8, masked entropy), the state-augmented
  critic (``state_dim``: the global state joins the critic's concat once,
  actors never see it), and heterogeneous action widths zero-padded to
  the widest.

One Adam per agent over that agent's actor and critic, both at
``actor_lr * frac`` (``critic_lr`` is read by HAPPO only, as in the JAX
package). With ``max_grad_norm`` set (10 for a discrete env, 0.5 under
``attention`` or IPPO, else None), the actor's and the critic's gradients
are each clipped on every minibatch with the JAX helper's form.

Homogeneous agents without attention take the STACKED path, as the JAX
package does: the agents' nets are one ``StackedDense`` net each, their
weights ``(A, out, in)``, so every layer of every agent is one batched
matmul, and one Adam steps every agent's parameters (Adam is elementwise,
so that is every agent's own Adam). Each agent still has its own
permutations, and its own clip norm: the JAX stacked update clips inside
``vmap`` over the agents, so per agent, as the loop path does.

Draws: ``sample_action`` takes ``draw_action``'s ``(b, A, P)`` Gumbel
noise or standard normals (agent i's are ``[:, i, :act_dims[i]]``, JAX's
``fold_in(key, i)`` draws); ``update`` takes ``(A, K_epochs, T*N)``
permutations (agent i's epoch e: JAX's ``fold_in(key, i)`` then one split
per epoch). Under ``lr_decay`` the update reads the device episode counter
once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from freerl_tpu_torch.algos.base import check_axis_name
from freerl_tpu_torch.algos.common import (adv_normalize,
                                           clip_grads_by_norm, gae, huber)
from freerl_tpu_torch.algos.maac import SharedAttention
from freerl_tpu_torch.algos.ppo import Rollout
from freerl_tpu_torch.core.normalization import RewardScaling, RunningMeanStd
from freerl_tpu_torch.distributed.dp import pmean
from freerl_tpu_torch.nets import distributions as D
from freerl_tpu_torch.nets.mlp import Dense, StackedDense, init_scheme
from freerl_tpu_torch.nets.norm import LayerNorm


def _dense(n, in_dim, out_dim, generator, device, scheme,
           gain=math.sqrt(2.0)):
    if n is None:
        return Dense(in_dim, out_dim, generator, device, scheme, gain=gain)
    return StackedDense(n, in_dim, out_dim, generator, device, scheme, gain)


class MLPTrunk(nn.Module):
    """relu hidden layers, with ``feature_norm`` (a LayerNorm before the
    first layer) and ``layer_norm`` (one after each layer, before the
    activation). ``n`` stacks ``n`` agents' trunks (``StackedDense``)."""

    def __init__(self, in_dim: int, hidden: Sequence[int] = (128, 128),
                 orthogonal: bool = False, layer_norm: bool = False,
                 feature_norm: bool = False,
                 generator: torch.Generator | None = None, device="cuda",
                 n: int | None = None):
        super().__init__()
        dims = [in_dim, *hidden]
        self.feature_norm = (LayerNorm(in_dim, device, n) if feature_norm
                             else None)
        self.layers = nn.ModuleList(
            _dense(n, a, b, generator, device, init_scheme(orthogonal))
            for a, b in zip(dims[:-1], dims[1:]))
        self.norms = nn.ModuleList(
            LayerNorm(h, device, n) for h in (hidden if layer_norm else ()))
        self.trunk_dim = dims[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.feature_norm is not None:
            x = self.feature_norm(x)
        for j, layer in enumerate(self.layers):
            x = layer(x)
            if self.norms:
                x = self.norms[j](x)
            x = F.relu(x)
        return x


class AgentActor(nn.Module):
    """obs -> logits, or (tanh mean, log_std broadcast to the mean) with
    ``log_std`` starting at 0; the head's orthogonal gain is 0.01."""

    def __init__(self, in_dim: int, action_dim: int, is_continue: bool,
                 hidden: Sequence[int] = (128, 128), orthogonal: bool = False,
                 layer_norm: bool = False, feature_norm: bool = False,
                 generator: torch.Generator | None = None, device="cuda",
                 n: int | None = None):
        super().__init__()
        self.trunk = MLPTrunk(in_dim, hidden, orthogonal, layer_norm,
                              feature_norm, generator, device, n)
        self.head = _dense(n, self.trunk.trunk_dim, action_dim, generator,
                           device, init_scheme(orthogonal), gain=0.01)
        shape = (action_dim,) if n is None else (n, action_dim)
        self.log_std = (nn.Parameter(torch.zeros(shape, device=device))
                        if is_continue else None)

    def forward(self, x: torch.Tensor):
        out = self.head(self.trunk(x))
        if self.log_std is None:
            return out
        mean = torch.tanh(out)
        log_std = self.log_std if self.log_std.dim() == 1 else \
            self.log_std.unsqueeze(-2)
        return mean, log_std.expand_as(mean)


class AgentVCritic(nn.Module):
    """obs -> state value (the head's orthogonal gain is 1)."""

    def __init__(self, in_dim: int, hidden: Sequence[int] = (128, 128),
                 orthogonal: bool = False, layer_norm: bool = False,
                 feature_norm: bool = False,
                 generator: torch.Generator | None = None, device="cuda",
                 n: int | None = None):
        super().__init__()
        self.trunk = MLPTrunk(in_dim, hidden, orthogonal, layer_norm,
                              feature_norm, generator, device, n)
        self.head = _dense(n, self.trunk.trunk_dim, 1, generator, device,
                           init_scheme(orthogonal), gain=1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunk(x)).squeeze(-1)


class SharedAttnVCritics(nn.Module):
    """MAPPO_attention's centralized critics: per-agent obs encoders
    (``enc``), ONE shared attention block (:class:`SharedAttention`) from
    each agent's embedding over the others', per-agent ``fc1`` and V heads
    (``v``). Returns (B, A) values for all agents in one call."""

    def __init__(self, obs_dims: Sequence[int], attention_dim: int = 128,
                 num_heads: int = 4, hidden: int = 128,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        self.attn = SharedAttention(attention_dim, num_heads, generator,
                                    device)
        self.enc = nn.ModuleList(Dense(d, attention_dim, generator, device)
                                 for d in obs_dims)
        self.fc1 = nn.ModuleList(Dense(2 * attention_dim, hidden, generator,
                                       device) for _ in obs_dims)
        self.v = nn.ModuleList(Dense(hidden, 1, generator, device)
                               for _ in obs_dims)

    def forward(self, obs_list: list) -> torch.Tensor:
        n = len(obs_list)
        embs = [F.leaky_relu(enc(o)) for enc, o in zip(self.enc, obs_list)]
        vs = []
        for i in range(n):
            others = torch.stack([embs[j] for j in range(n) if j != i], dim=1)
            attn_out = self.attn(embs[i][:, None, :], others)
            h = F.relu(self.fc1[i](torch.cat([embs[i], attn_out], dim=-1)))
            vs.append(self.v[i](h).squeeze(-1))
        return torch.stack(vs, dim=-1)


@dataclasses.dataclass(frozen=True)
class MAPPOConfig:
    """Static hyperparameters, with the JAX package's fields, defaults and
    validators."""

    actor_lr: float = 5e-4
    critic_lr: float = 5e-4        # read by HAPPO only, as in the JAX package
    gamma: float = 0.95
    lmbda: float = 0.95
    clip_param: float = 0.2
    K_epochs: int = 15
    entropy_coefficient: float = 0.01
    horizon: int = 256
    minibatch_size: int = 256
    hidden: Sequence[int] = (128, 128)
    num_envs: int = 1
    huber_delta: float = 10.0
    independent: bool = False       # IPPO mode
    # per-net grad-norm clip; MAPPO's default depends on the variant (see
    # MAPPO.__init__), IPPO() sets 0.5
    max_grad_norm: Optional[float] = None
    # tricks
    adv_norm: bool = False
    obs_norm: bool = False
    reward_norm: bool = False
    reward_scaling: bool = False
    orthogonal_init: bool = False
    adam_eps: bool = False          # Adam eps 1e-5 instead of 1e-8
    lr_decay: bool = False
    lr_decay_episodes: int = 200
    value_clip: bool = False
    huber_loss: bool = False
    layer_norm: bool = False
    feature_norm: bool = False
    # the attention critics (one shared attention block)
    attention: bool = False
    attention_heads: int = 4
    # mask-action mode: each agent's obs ends in its 0/1 availability mask
    masked: bool = False
    mask_dim: int = 0
    # state-augmented centralized critic: obs = [raw_obs, state, mask]
    state_dim: int = 0
    axis_name: Optional[str] = None

    def __post_init__(self):
        if self.reward_norm and self.reward_scaling:
            raise ValueError(
                "reward_norm and reward_scaling cannot both be on"
            )
        if self.masked and self.mask_dim <= 0:
            raise ValueError("masked mode needs mask_dim > 0")
        if self.attention and self.independent:
            raise ValueError("attention critic is centralized")
        if self.state_dim > 0 and (self.independent or self.attention):
            raise ValueError(
                "state-augmented critic is the plain centralized variant "
                "(reference MAPPO_for_mask_action_state.py supports only "
                "use_state=True there)"
            )


@dataclasses.dataclass
class MAPPOState:
    """``actors`` and ``critics``: one net per agent (lists), or on the
    stacked path one stacked net each; under ``attention`` ``critics`` is
    the one :class:`SharedAttnVCritics`. ``opts``: one Adam per agent, or
    one over the stacked nets."""

    actors: object
    critics: object
    opts: list
    obs_rms: RunningMeanStd
    rew_rms: RunningMeanStd
    rew_scale: RewardScaling
    step: int = 0


def lr_fraction(cfg, episodes) -> float:
    """``max(1 - episodes / lr_decay_episodes, 1e-3)`` in float32 under
    ``lr_decay`` (one host read of the device episode counter), else 1."""
    if not (cfg.lr_decay and episodes is not None):
        return 1.0
    ep = np.float32(int(episodes))
    return float(max(np.float32(1.0) - ep / np.float32(cfg.lr_decay_episodes),
                     np.float32(1e-3)))


def set_lr(opts, lr: float, frac: float) -> None:
    """Every param group of ``opts`` at ``lr * frac``, in float32."""
    for opt in opts:
        for group in opt.param_groups:
            group["lr"] = float(np.float32(lr) * np.float32(frac))


def clip_stacked_grads_by_norm(grads: list[torch.Tensor],
                               max_norm: float) -> list[torch.Tensor]:
    """``clip_grads_by_norm`` for each agent of stacked ``(A, ...)``
    gradients: one norm, and one scale, per agent."""
    sq = sum(torch.sum(torch.square(g).flatten(1), dim=1) for g in grads)
    scale = torch.clamp(max_norm / (torch.sqrt(sq) + 1e-6), max=1.0)
    return [g * scale.view((-1,) + (1,) * (g.dim() - 1)) for g in grads]


def value_loss(cfg, v, vt, mean=torch.mean) -> torch.Tensor:
    """The critic loss of ``v`` against the targets ``vt``: squared or
    huber (``huber_loss``); under ``value_clip`` the larger of that and the
    loss of the TARGET clipped to ``v +- clip_param`` (``jnp.clip(vt, v -
    c, v + c)``, as the JAX package writes it)."""
    err = huber if cfg.huber_loss else (lambda x, _: torch.square(x))
    loss = mean(err(vt - v, cfg.huber_delta))
    if not cfg.value_clip:
        return loss
    vt_clip = torch.minimum(torch.maximum(vt, v - cfg.clip_param),
                            v + cfg.clip_param)
    return torch.maximum(loss, mean(err(vt_clip - v, cfg.huber_delta)))


def step(opt: torch.optim.Optimizer, params: list, grads) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()


class AgentAxisPPO:
    """What MAPPO, HAPPO and rMAPPO share: the per-agent widths of a
    multi-agent env (observations ``(..., A, O_pad)``, actions ``(..., A,
    P)`` or ``(..., A)`` indices), the action distributions with the
    masked mode, the clipped-surrogate loss, the trick hooks and their
    running statistics."""

    def __init__(self, env, cfg, device="cuda"):
        check_axis_name(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.n_agents = env.n_agents
        self.obs_dims = tuple(env.agent_obs_dims)
        self.act_dims = tuple(env.agent_act_dims)
        self.act_pad = max(self.act_dims)
        self.is_continue = env.dim_info.is_continue
        self.obs_pad = env.dim_info.obs_dim

    def _agent_obs(self, obs, i):
        return obs[..., i, :self.obs_dims[i]]

    def _pad_act(self, a, i):
        """Agent i's action zero-padded to the widest agent's."""
        return F.pad(a, (0, self.act_pad - self.act_dims[i]))

    def _adam(self, params) -> torch.optim.Adam:
        return torch.optim.Adam(params, lr=self.cfg.actor_lr,
                                eps=1e-5 if self.cfg.adam_eps else 1e-8,
                                weight_decay=0.0)

    def _stats(self) -> dict:
        """The fresh running statistics of the obs and reward tricks."""
        dev, a = self.device, self.n_agents
        return dict(
            obs_rms=RunningMeanStd.create((a, self.obs_pad), dev),
            rew_rms=RunningMeanStd.create((a,), dev),
            rew_scale=RewardScaling.create(self.cfg.num_envs * a,
                                           self.cfg.gamma, dev))

    def _logp_ent(self, out, obs_i, action_i):
        """Log-prob and entropy of ``action_i`` under the actor output
        ``out`` of actor obs ``obs_i`` (one agent's, or stacked)."""
        if not self.is_continue:
            if self.cfg.masked:
                mask = obs_i[..., -self.cfg.mask_dim:]
                out = D.masked_logits(out, mask)
                return (D.categorical_log_prob(out, action_i),
                        D.masked_categorical_entropy(out, mask))
            return (D.categorical_log_prob(out, action_i),
                    D.categorical_entropy(out))
        mean, log_std = out
        std = torch.exp(log_std)
        return D.normal_log_prob(mean, std, action_i), D.normal_entropy(std)

    def _sample(self, out, obs_i, noise):
        """(env action, stored action, log-prob) from the actor output of
        actor obs ``obs_i`` and its noise (one agent's, or stacked)."""
        if not self.is_continue:
            if self.cfg.masked:
                out = D.masked_logits(out, obs_i[..., -self.cfg.mask_dim:])
            a = D.categorical_sample(out, noise)
            return a, a, D.categorical_log_prob(out, a)
        mean, log_std = out
        std = torch.exp(log_std)
        a = D.normal_sample(mean, std, noise)
        return torch.clamp(a, -1.0, 1.0), a, D.normal_log_prob(mean, std, a)

    def draw_action(self, b: int, generator: torch.Generator):
        """Gumbel noise (discrete) or standard normals, (b, A, P)."""
        shape = (b, self.n_agents, self.act_pad)
        if self.is_continue:
            return D.draw_normal(shape, generator, self.device)
        return D.draw_gumbel(shape, generator, self.device)

    # whether the running stats fold global-batch moments under a mesh
    # (rMAPPO's JAX counterpart passes no axis to its normalizers)
    STATS_OVER_AXIS = True

    def _stats_axis(self):
        return self.cfg.axis_name if self.STATS_OVER_AXIS else None

    def process_obs(self, state, next_obs, carry_obs):
        if not self.cfg.obs_norm:
            return state, next_obs, carry_obs
        state.obs_rms = state.obs_rms.update(next_obs,
                                             axis_name=self._stats_axis())
        return (state, state.obs_rms.normalize(next_obs),
                state.obs_rms.normalize(carry_obs))

    def process_reward(self, state, reward, episode_done):
        if self.cfg.reward_scaling:
            ep = episode_done[:, None].expand(reward.shape).reshape(-1)
            state.rew_scale, scaled = state.rew_scale(
                reward.reshape(-1), ep, axis_name=self._stats_axis())
            return state, scaled.reshape(reward.shape)
        if self.cfg.reward_norm:
            state.rew_rms = state.rew_rms.update(
                reward, axis_name=self._stats_axis())
            return state, state.rew_rms.normalize(reward)
        return state, reward

    def _loss(self, logp, ent, logp_old, adv, v, vt, stacked: bool):
        """Clipped surrogate minus the entropy bonus, plus the critic loss
        of ``v`` against ``vt`` (shaped alike; None for an actor-only
        step). Stacked tensors give one loss per agent, (A,)."""
        cfg = self.cfg
        mean = (lambda x: x.flatten(1).mean(1)) if stacked else torch.mean
        ratio = torch.exp(logp - logp_old)
        if not cfg.independent:
            ratio = ratio[..., None]          # joint broadcast over agents
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1 - cfg.clip_param,
                            1 + cfg.clip_param) * adv
        loss = -mean(torch.minimum(surr1, surr2)) - (
            cfg.entropy_coefficient * mean(ent))
        if v is None:
            return loss
        return loss + value_loss(cfg, v, vt, mean)


class MAPPO(AgentAxisPPO):
    def __init__(self, env, cfg: MAPPOConfig = MAPPOConfig(), device="cuda"):
        # the variants' clip defaults: MAPPO_attention clips each net at
        # 0.5, MAPPO_discrete at 10, MAPPO none
        if cfg.max_grad_norm is None:
            if cfg.attention:
                cfg = dataclasses.replace(cfg, max_grad_norm=0.5)
            elif not env.dim_info.is_continue:
                cfg = dataclasses.replace(cfg, max_grad_norm=10.0)
        super().__init__(env, cfg, device)
        self._stackable = (
            not cfg.attention
            and len(set(self.obs_dims)) == 1
            and len(set(self.act_dims)) == 1
        )

    # ------------------------------------------------------------------
    def _actor_obs(self, obs, i):
        """The agent's obs without the global-state slice (layout
        ``[raw_obs, state, mask]``)."""
        o = self._agent_obs(obs, i)
        s, m = self.cfg.state_dim, self.cfg.mask_dim
        if s == 0:
            return o
        if m == 0:
            return o[..., :-s]
        return torch.cat([o[..., :-(s + m)], o[..., -m:]], dim=-1)

    def _global_state(self, obs):
        """The once-per-env global state, sliced from agent 0's obs."""
        s, m = self.cfg.state_dim, self.cfg.mask_dim
        o = self._agent_obs(obs, 0)
        return o[..., -(s + m):-m] if m else o[..., -s:]

    def _critic_input(self, obs, i):
        if self.cfg.independent:
            return self._agent_obs(obs, i)
        parts = [self._actor_obs(obs, j) for j in range(self.n_agents)]
        if self.cfg.state_dim > 0:
            parts.append(self._global_state(obs))   # once, not per agent
        return torch.cat(parts, dim=-1)

    def _obs_list(self, obs):
        return [self._agent_obs(obs, j) for j in range(self.n_agents)]

    def _critic_dim(self, i: int) -> int:
        if self.cfg.independent:
            return self.obs_dims[i]
        s = self.cfg.state_dim
        return sum(self.obs_dims) - s * self.n_agents + s

    def _nets(self, generator: torch.Generator):
        """The actors and critics, per agent or stacked."""
        cfg, dev, a = self.cfg, self.device, self.n_agents
        kw = dict(hidden=tuple(cfg.hidden), orthogonal=cfg.orthogonal_init,
                  layer_norm=cfg.layer_norm, feature_norm=cfg.feature_norm,
                  generator=generator, device=dev)
        s = cfg.state_dim
        if self._stackable:
            return (AgentActor(self.obs_dims[0] - s, self.act_dims[0],
                               self.is_continue, n=a, **kw),
                    AgentVCritic(self._critic_dim(0), n=a, **kw))
        actors = [AgentActor(self.obs_dims[i] - s, self.act_dims[i],
                             self.is_continue, **kw) for i in range(a)]
        if cfg.attention:
            critics = SharedAttnVCritics(self.obs_dims,
                                         num_heads=cfg.attention_heads,
                                         generator=generator, device=dev)
        else:
            critics = [AgentVCritic(self._critic_dim(i), **kw)
                       for i in range(a)]
        return actors, critics

    def _agent_critic(self, critics, i):
        """The critic agent i's step trains: its own, the shared attention
        critics for agent 0, none for agents i > 0 under attention."""
        if self.cfg.attention:
            return critics if i == 0 else None
        return critics[i]

    def init(self, generator: torch.Generator) -> MAPPOState:
        actors, critics = self._nets(generator)
        if self._stackable:
            opts = [self._adam([*actors.parameters(), *critics.parameters()])]
        else:
            opts = []
            for i, actor in enumerate(actors):
                critic = self._agent_critic(critics, i)
                opts.append(self._adam(
                    [*actor.parameters(),
                     *(critic.parameters() if critic is not None else ())]))
        return MAPPOState(actors=actors, critics=critics, opts=opts,
                          **self._stats())

    # ------------------------------------------------------------------
    def _stacked_actor_obs(self, obs):
        """Every agent's actor obs, (A, rows, O'), and the rows' shape."""
        lead = obs.shape[:-2]
        aobs = torch.stack([self._actor_obs(obs, i)
                            for i in range(self.n_agents)])
        return aobs.reshape(self.n_agents, -1, aobs.shape[-1]), lead

    @torch.no_grad()
    def sample_action(self, state: MAPPOState, obs: torch.Tensor, draws):
        """obs (..., A, O_pad) -> (env_action, stored, logp (..., A))."""
        ax = -2 if self.is_continue else -1
        if self._stackable:
            a = self.n_agents
            aobs, lead = self._stacked_actor_obs(obs)
            noise = draws.movedim(-2, 0)[..., :self.act_dims[0]]
            outs = self._sample(state.actors(aobs), aobs,
                                noise.reshape(a, -1, noise.shape[-1]))
            return tuple(x.reshape((a,) + lead + x.shape[2:]).movedim(0, d)
                         for x, d in zip(outs, (ax, ax, -1)))
        env_as, stored, logps = [], [], []
        for i in range(self.n_agents):
            aobs = self._actor_obs(obs, i)
            a_env, a, logp = self._sample(
                state.actors[i](aobs), aobs,
                draws[..., i, :self.act_dims[i]])
            if self.is_continue:
                a_env, a = self._pad_act(a_env, i), self._pad_act(a, i)
            env_as.append(a_env)
            stored.append(a)
            logps.append(logp)
        return (torch.stack(env_as, dim=ax), torch.stack(stored, dim=ax),
                torch.stack(logps, dim=-1))

    @torch.no_grad()
    def evaluate_action(self, state: MAPPOState, obs: torch.Tensor):
        """The greedy action for RAW observations (normalized first under
        ``obs_norm``); masked logits honour the availability mask."""
        if self.cfg.obs_norm:
            obs = state.obs_rms.normalize(obs)
        if self._stackable:
            aobs, lead = self._stacked_actor_obs(obs)
            out = state.actors(aobs)
            if self.is_continue:
                return out[0].reshape((self.n_agents,) + lead
                                      + out[0].shape[2:]).movedim(0, -2)
            if self.cfg.masked:
                out = D.masked_logits(out, aobs[..., -self.cfg.mask_dim:])
            return torch.argmax(out, dim=-1).reshape(
                (self.n_agents,) + lead).movedim(0, -1)
        outs = []
        for i in range(self.n_agents):
            aobs = self._actor_obs(obs, i)
            out = state.actors[i](aobs)
            if not self.is_continue:
                if self.cfg.masked:
                    out = D.masked_logits(out,
                                          aobs[..., -self.cfg.mask_dim:])
                outs.append(torch.argmax(out, dim=-1))
            else:
                outs.append(self._pad_act(out[0], i))
        return torch.stack(outs, dim=-2 if self.is_continue else -1)

    # ------------------------------------------------------------------
    def draw_update(self, rollout: Rollout, generator: torch.Generator):
        """Each agent's K epochs' permutations of the T*N transitions,
        (A, K, T*N)."""
        b = rollout.reward.shape[0] * rollout.reward.shape[1]
        return torch.stack([torch.stack([
            torch.randperm(b, generator=generator, device=self.device)
            for _ in range(self.cfg.K_epochs)])
            for _ in range(self.n_agents)])

    @torch.no_grad()
    def _values(self, state: MAPPOState, obs: torch.Tensor) -> torch.Tensor:
        """Every agent's value, (T, N, A), of (T, N, A, O_pad) obs."""
        lead, a = obs.shape[:-2], self.n_agents
        flat = obs.reshape((-1,) + obs.shape[-2:])
        if self.cfg.attention:
            v = state.critics(self._obs_list(flat))
        elif self._stackable:
            cin = (torch.stack([self._critic_input(flat, i) for i in range(a)])
                   if self.cfg.independent else self._critic_input(flat, 0))
            v = state.critics(cin).T
        else:
            v = torch.stack([state.critics[i](self._critic_input(flat, i))
                             for i in range(a)], dim=-1)
        return v.reshape(lead + (a,))

    def update(self, state: MAPPOState, rollout: Rollout, draws,
               episodes=None):
        """One full update, in place: joint (or per-agent) GAE, then each
        agent's K epochs of shuffled minibatches, agent i's epoch e in the
        order ``draws[i, e]``. Returns (state, {"adv_mean"})."""
        cfg = self.cfg
        if draws is None:
            raise ValueError("MAPPO's update needs its permutations")
        a = self.n_agents
        T, N = rollout.reward.shape[:2]
        B = T * N
        mb = min(cfg.minibatch_size, B)

        with torch.no_grad():
            adv, v_target = gae(
                rollout.reward, self._values(state, rollout.obs),
                self._values(state, rollout.next_obs),
                rollout.done[..., None], rollout.adv_done[..., None],
                cfg.gamma, cfg.lmbda)
            if cfg.adv_norm:
                adv = adv_normalize(adv, 1e-8, cfg.axis_name)
            batch = dict(
                obs=rollout.obs.reshape((B, a, -1)),
                act=rollout.action.reshape(
                    (B, a, -1) if self.is_continue else (B, a)),
                logp=rollout.log_pi.reshape((B, a)),
                adv=adv.reshape((B, a)), vt=v_target.reshape((B, a)))

        set_lr(state.opts, cfg.actor_lr, lr_fraction(cfg, episodes))
        if self._stackable:
            self._update_stacked(state, batch, draws, mb)
        else:
            for i in range(a):
                self._update_agent(state, i, batch, draws[i], mb)
        state.step += 1
        return state, {"adv_mean": torch.mean(batch["adv"])}

    def _clip(self, grads, n_actor: int, clip):
        """The actor's and the critic's gradients each clipped on their own
        (an empty group, the critic of agent i > 0 under attention, stays
        empty)."""
        if self.cfg.max_grad_norm is None:
            return grads
        return [g for group in (grads[:n_actor], grads[n_actor:]) if group
                for g in clip(group, self.cfg.max_grad_norm)]

    def _update_agent(self, state, i, batch, perms, mb):
        """Agent i's K epochs on the loop path (``perms`` (K, B))."""
        cfg = self.cfg
        obs_f, adv_f, vt_f = batch["obs"], batch["adv"], batch["vt"]
        act_i = (batch["act"][:, i, :self.act_dims[i]] if self.is_continue
                 else batch["act"][:, i])
        actor, critic = state.actors[i], self._agent_critic(state.critics, i)
        params = list(actor.parameters())
        n_actor = len(params)
        if critic is not None:
            params += list(critic.parameters())
        for perm in perms:
            for m in range(perm.shape[0] // mb):
                idx = perm[m * mb:(m + 1) * mb]
                obs = obs_f[idx]
                aobs = self._actor_obs(obs, i)
                logp, ent = self._logp_ent(actor(aobs), aobs, act_i[idx])
                adv = adv_f[idx, i] if cfg.independent else adv_f[idx]
                v = vt = None
                if cfg.attention:
                    if critic is not None:
                        v, vt = critic(self._obs_list(obs)), vt_f[idx]
                else:
                    v = critic(self._critic_input(obs, i))
                    if cfg.independent:
                        vt = vt_f[idx, i]
                    else:
                        v, vt = v[:, None], vt_f[idx]
                loss = self._loss(logp, ent, batch["logp"][idx, i], adv, v,
                                  vt, stacked=False)
                grads = pmean(list(torch.autograd.grad(loss, params)),
                              cfg.axis_name)
                step(state.opts[i], params,
                     self._clip(grads, n_actor, clip_grads_by_norm))

    def _update_stacked(self, state, batch, draws, mb):
        """Every agent's K epochs at once on the stacked nets; agent i's
        minibatch m of epoch e is ``draws[i, e, m*mb:(m+1)*mb]``."""
        cfg, a = self.cfg, self.n_agents
        obs_f = batch["obs"]
        aobs = torch.stack([self._actor_obs(obs_f, i) for i in range(a)])
        act = batch["act"]
        acts = (act[..., :self.act_dims[0]] if self.is_continue
                else act).movedim(1, 0)                     # (A, B[, act])
        lps = batch["logp"].T                               # (A, B)
        if cfg.independent:
            cin = torch.stack([self._critic_input(obs_f, i)
                               for i in range(a)])          # (A, B, D)
            adv, vt = batch["adv"].T, batch["vt"].T         # (A, B)
        else:
            cin = self._critic_input(obs_f, 0)              # (B, D), shared
            adv, vt = batch["adv"], batch["vt"]             # (B, A), shared
        rows = torch.arange(a, device=self.device)[:, None]
        params = list(state.actors.parameters())
        n_actor = len(params)
        params += list(state.critics.parameters())
        for e in range(draws.shape[1]):
            for m in range(draws.shape[2] // mb):
                idx = draws[:, e, m * mb:(m + 1) * mb]       # (A, mb)
                o = aobs[rows, idx]
                logp, ent = self._logp_ent(state.actors(o), o,
                                           acts[rows, idx])
                if cfg.independent:
                    v = state.critics(cin[rows, idx])
                    adv_b, vt_b = adv[rows, idx], vt[rows, idx]
                else:
                    v = state.critics(cin[idx])[..., None]
                    adv_b, vt_b = adv[idx], vt[idx]         # (A, mb, A)
                loss = self._loss(logp, ent, lps[rows, idx], adv_b, v, vt_b,
                                  stacked=True).sum()
                grads = pmean(list(torch.autograd.grad(loss, params)),
                              cfg.axis_name)
                step(state.opts[0], params,
                     self._clip(grads, n_actor, clip_stacked_grads_by_norm))


def IPPO(env, cfg: MAPPOConfig = None, device="cuda") -> MAPPO:
    """Independent PPO: per-agent critic on its own obs, per-agent GAE, the
    grad clip at 0.5 unless the config sets one."""
    if cfg is None:
        cfg = MAPPOConfig(independent=True)
    else:
        cfg = dataclasses.replace(cfg, independent=True)
    if cfg.max_grad_norm is None:
        cfg = dataclasses.replace(cfg, max_grad_norm=0.5)
    return MAPPO(env, cfg, device)
