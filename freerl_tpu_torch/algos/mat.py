"""MAT: the Multi-Agent Transformer, one set of parameters for all agents,
a sequence over the agent axis (counterpart: ``freerl_tpu/algos/mat.py``).

- encoder: LayerNorm'd obs embedding, ``n_block`` post-LN blocks of
  unmasked self-attention over the agents, a per-agent V head and the
  representation ``rep``;
- decoder: the action embedding (discrete: one-hot plus a start-token
  column, no bias; continuous: a linear layer), blocks of causal
  self-attention and causal cross-attention in which ``rep`` is the QUERY
  and the action stream the keys and values, then a head giving logits,
  or a tanh mean with a global ``log_std`` starting at ONES and clamped to
  [-20, 2];
- the init is orthogonal, gain sqrt(2) into a ``gelu`` and 1 elsewhere,
  with zero biases; ``gelu`` is flax's tanh form;
- acting decodes autoregressively over the agents: a host loop over i,
  each step a full decoder pass whose row i is read, as the JAX scan
  does; training is teacher-forced on the shifted actions;
- the learn quirks: values are averaged over the agents before the TD
  delta; ratios are taken PER ACTION DIM (a continuous rollout's
  ``log_pi`` is (T, N, A, D)) and the min-surrogate is summed over the
  dims; clip 0.05; the transformer's gradients clipped at 10 as one
  group; one Adam, eps 1e-5, at ``lr * frac``.

Draws: ``sample_action`` takes ``draw_action``'s ``(A, b, D)`` draws,
agent i's at ``[i]``: Gumbel noise (``jax.random.categorical`` is
``argmax(logits + gumbel)``) or standard normals, JAX's ``fold_in(key,
i)`` draws. ``update`` takes the K epochs' permutations, (K, T*N).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from freerl_tpu_torch.algos.base import check_axis_name
from freerl_tpu_torch.algos.common import clip_grads_by_norm, gae
from freerl_tpu_torch.algos.mappo import (lr_fraction, set_lr, step,
                                          value_loss)
from freerl_tpu_torch.algos.ppo import Rollout
from freerl_tpu_torch.distributed.dp import pmean
from freerl_tpu_torch.nets import distributions as D
from freerl_tpu_torch.nets.mlp import Dense
from freerl_tpu_torch.nets.norm import LayerNorm

_GAIN_ACT = math.sqrt(2.0)     # into a gelu


def _orth(in_dim, out_dim, gain=1.0, generator=None, device="cuda",
          bias=True):
    return Dense(in_dim, out_dim, generator, device, "orthogonal", gain=gain,
                 bias=bias)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class MATAttention(nn.Module):
    """Multi-head attention, ``key``, ``query``, ``value``, ``proj``; the
    causal form masks with a tril over the query's length."""

    def __init__(self, n_embd: int, n_head: int, masked: bool = False,
                 generator=None, device="cuda"):
        super().__init__()
        self.n_head, self.masked = n_head, masked
        for name in ("key", "query", "value", "proj"):
            setattr(self, name, _orth(n_embd, n_embd, 1.0, generator, device))

    def forward(self, key_in, value, query):
        b, length, d = query.shape
        h = self.n_head

        def heads(x):
            return x.reshape(b, length, h, d // h).transpose(1, 2)

        k, q, v = heads(self.key(key_in)), heads(self.query(query)), \
            heads(self.value(value))
        att = (q @ k.transpose(2, 3)) / math.sqrt(d // h)
        if self.masked:
            tril = torch.tril(torch.ones(length, length, dtype=torch.bool,
                                         device=att.device))
            att = att.masked_fill(~tril, float("-inf"))
        att = torch.softmax(att, dim=-1)
        return self.proj((att @ v).transpose(1, 2).reshape(b, length, d))


class _MLP(nn.Module):
    """A block's ``Dense -> gelu -> Dense``."""

    def __init__(self, n_embd, generator, device):
        super().__init__()
        self.mlp1 = _orth(n_embd, n_embd, _GAIN_ACT, generator, device)
        self.mlp2 = _orth(n_embd, n_embd, 1.0, generator, device)

    def mlp(self, x):
        return self.mlp2(_gelu(self.mlp1(x)))


class EncodeBlock(_MLP):
    """Post-LN: ``x = LN(x + attn(x)); LN(x + mlp(x))``."""

    def __init__(self, n_embd: int, n_head: int, generator=None,
                 device="cuda"):
        super().__init__(n_embd, generator, device)
        self.attn = MATAttention(n_embd, n_head, False, generator, device)
        self.norm1 = LayerNorm(n_embd, device)
        self.norm2 = LayerNorm(n_embd, device)

    def forward(self, x):
        x = self.norm1(x + self.attn(x, x, x))
        return self.norm2(x + self.mlp(x))


class DecodeBlock(_MLP):
    """Post-LN: causal self-attention, then causal cross-attention with
    the encoder's representation as the query."""

    def __init__(self, n_embd: int, n_head: int, generator=None,
                 device="cuda"):
        super().__init__(n_embd, generator, device)
        self.attn1 = MATAttention(n_embd, n_head, True, generator, device)
        self.attn2 = MATAttention(n_embd, n_head, True, generator, device)
        self.norm1 = LayerNorm(n_embd, device)
        self.norm2 = LayerNorm(n_embd, device)
        self.norm3 = LayerNorm(n_embd, device)

    def forward(self, x, rep_enc):
        x = self.norm1(x + self.attn1(x, x, x))
        x = self.norm2(rep_enc + self.attn2(x, x, rep_enc))
        return self.norm3(x + self.mlp(x))


class MATEncoder(nn.Module):
    """obs (B, A, O) -> (v (B, A), rep (B, A, n_embd))."""

    def __init__(self, obs_dim: int, n_block: int, n_embd: int, n_head: int,
                 generator=None, device="cuda"):
        super().__init__()
        self.obs_norm = LayerNorm(obs_dim, device)
        self.embed = _orth(obs_dim, n_embd, _GAIN_ACT, generator, device)
        self.embed_norm = LayerNorm(n_embd, device)
        self.blocks = nn.ModuleList(EncodeBlock(n_embd, n_head, generator,
                                                device)
                                    for _ in range(n_block))
        self.v_hidden = _orth(n_embd, n_embd, _GAIN_ACT, generator, device)
        self.v_norm = LayerNorm(n_embd, device)
        self.v_out = _orth(n_embd, 1, 1.0, generator, device)

    def forward(self, obs):
        x = self.embed_norm(_gelu(self.embed(self.obs_norm(obs))))
        for block in self.blocks:
            x = block(x)
        v = self.v_out(self.v_norm(_gelu(self.v_hidden(x))))
        return v.squeeze(-1), x


class MATDecoder(nn.Module):
    """(shifted actions (B, A, D or D + 1), rep) -> logits, or (the head's
    pre-tanh output, log_std)."""

    def __init__(self, action_dim: int, n_block: int, n_embd: int,
                 n_head: int, discrete: bool = True, generator=None,
                 device="cuda"):
        super().__init__()
        in_dim = action_dim + 1 if discrete else action_dim
        self.embed = _orth(in_dim, n_embd, _GAIN_ACT, generator, device,
                           bias=not discrete)
        self.embed_norm = LayerNorm(n_embd, device)
        self.blocks = nn.ModuleList(DecodeBlock(n_embd, n_head, generator,
                                                device)
                                    for _ in range(n_block))
        self.head_hidden = _orth(n_embd, n_embd, _GAIN_ACT, generator,
                                 device)
        self.head_norm = LayerNorm(n_embd, device)
        self.head_out = _orth(n_embd, action_dim, 1.0, generator, device)
        self.log_std = (None if discrete else
                        nn.Parameter(torch.ones(action_dim, device=device)))

    def forward(self, shifted, rep):
        x = self.embed_norm(_gelu(self.embed(shifted)))
        for block in self.blocks:
            x = block(x, rep)
        out = self.head_out(self.head_norm(_gelu(self.head_hidden(x))))
        return out if self.log_std is None else (out, self.log_std)


@dataclasses.dataclass(frozen=True)
class MATConfig:
    """Static hyperparameters, with the JAX package's fields and defaults."""

    lr: float = 5e-4
    gamma: float = 0.95
    lmbda: float = 0.95
    clip_param: float = 0.05
    K_epochs: int = 15
    entropy_coefficient: float = 0.01
    horizon: int = 256
    minibatch_size: int = 256
    n_block: int = 1
    n_embd: int = 64
    n_head: int = 1
    num_envs: int = 1
    huber_loss: bool = False
    huber_delta: float = 10.0
    value_clip: bool = False
    adv_norm: bool = False
    lr_decay: bool = False
    lr_decay_episodes: int = 1000
    axis_name: Optional[str] = None


@dataclasses.dataclass
class MATState:
    encoder: MATEncoder
    decoder: MATDecoder
    opt: torch.optim.Optimizer       # one Adam over the whole transformer
    step: int = 0


def _log_std(log_std: torch.Tensor) -> torch.Tensor:
    return torch.clamp(log_std, -20.0, 2.0)


def _normal_logp(a, mean, log_std):
    """The per-dim Gaussian log-density, in the JAX package's form."""
    return (-0.5 * ((a - mean) / torch.exp(log_std)) ** 2 - log_std
            - 0.5 * math.log(2 * math.pi))


class MAT:
    """Runs on the on-policy driver (``train/onpolicy.py``)."""

    def __init__(self, env, cfg: MATConfig = MATConfig(), device="cuda"):
        if len(set(env.agent_act_dims)) > 1:
            raise ValueError(
                "MAT requires equal per-agent action dims (the reference "
                "makes the same assumption, MAPPO_file/MAT.py:316); got "
                f"{tuple(env.agent_act_dims)} — use MAPPO/HAPPO/MADDPG/"
                "MASAC for heterogeneous-action scenarios like "
                "simple_world_comm_v3"
            )
        check_axis_name(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.n_agents = env.n_agents
        self.obs_dim = env.dim_info.obs_dim      # MAT assumes equal dims
        self.action_dim = env.dim_info.action_dim
        self.discrete = not env.dim_info.is_continue

    def init(self, generator: torch.Generator) -> MATState:
        cfg, dev = self.cfg, self.device
        encoder = MATEncoder(self.obs_dim, cfg.n_block, cfg.n_embd,
                             cfg.n_head, generator, dev)
        decoder = MATDecoder(self.action_dim, cfg.n_block, cfg.n_embd,
                             cfg.n_head, self.discrete, generator, dev)
        opt = torch.optim.Adam([*encoder.parameters(), *decoder.parameters()],
                               lr=cfg.lr, eps=1e-5, weight_decay=0.0)
        return MATState(encoder=encoder, decoder=decoder, opt=opt)

    # ------------------------------------------------------------------
    def draw_action(self, b: int, generator: torch.Generator):
        """Each agent's decode draws, (A, b, D): Gumbel noise or standard
        normals."""
        shape = (self.n_agents, b, self.action_dim)
        if self.discrete:
            return D.draw_gumbel(shape, generator, self.device)
        return D.draw_normal(shape, generator, self.device)

    def _decode(self, state: MATState, obs, pick):
        """The autoregressive decode: agent i's action is ``pick(i, out)``
        of row i of a full decoder pass over the actions so far. Returns
        the (A,) list of picks."""
        b, a = obs.shape[:2]
        _, rep = state.encoder(obs)
        width = self.action_dim + 1 if self.discrete else self.action_dim
        shifted = torch.zeros((b, a, width), device=obs.device)
        if self.discrete:
            shifted[:, 0, 0] = 1.0
        picks = []
        for i in range(a):
            out = state.decoder(shifted, rep)
            row = (out[0][:, i], out[1]) if not self.discrete else out[:, i]
            picks.append(pick(i, row))
            if i + 1 < a:
                act = picks[-1][0]
                if self.discrete:
                    shifted[:, i + 1, 1:] = F.one_hot(
                        act, self.action_dim).to(shifted.dtype)
                    shifted[:, i + 1, 0] = 0.0
                else:
                    shifted[:, i + 1] = act
        return picks

    @torch.no_grad()
    def sample_action(self, state: MATState, obs: torch.Tensor, draws):
        """obs (B, A, O) -> (env_action, stored, logp): (B, A) and (B, A)
        for discrete actions, (B, A, D) each for continuous ones."""
        def pick(i, row):
            if self.discrete:
                a = D.categorical_sample(row, draws[i])
                return a, D.categorical_log_prob(row, a)
            out, log_std = row
            mean, log_std = torch.tanh(out), _log_std(log_std)
            a = mean + torch.exp(log_std) * draws[i]
            return a, _normal_logp(a, mean, log_std)

        actions, logps = (torch.stack(x, dim=1) for x in
                          zip(*self._decode(state, obs, pick)))
        if self.discrete:
            return actions, actions, logps
        return torch.clamp(actions, -1.0, 1.0), actions, logps

    @torch.no_grad()
    def evaluate_action(self, state: MATState, obs: torch.Tensor):
        def pick(i, row):
            if self.discrete:
                return (torch.argmax(row, dim=-1),)
            return (torch.tanh(row[0]),)

        return torch.stack([p[0] for p in self._decode(state, obs, pick)],
                           dim=1)

    # hooks for the on-policy driver -----------------------------------
    def process_obs(self, state, next_obs, carry_obs):
        return state, next_obs, carry_obs

    def process_reward(self, state, reward, episode_done):
        return state, reward

    # ------------------------------------------------------------------
    def _parallel_logp_ent_v(self, state: MATState, obs, action):
        """The teacher-forced pass: per-dim (discrete: one column)
        log-probs and entropies, and the values. obs (B, A, O)."""
        v, rep = state.encoder(obs)
        b, a = obs.shape[:2]
        if self.discrete:
            shifted = torch.zeros((b, a, self.action_dim + 1),
                                  device=obs.device)
            shifted[:, 0, 0] = 1.0
            shifted[:, 1:, 1:] = F.one_hot(action[:, :-1],
                                           self.action_dim).to(shifted.dtype)
            logits = state.decoder(shifted, rep)
            logp_all = F.log_softmax(logits, dim=-1)
            logp = torch.gather(logp_all, -1, action[..., None])
            ent = -torch.sum(torch.exp(logp_all) * logp_all, dim=-1)
            return logp, ent[..., None], v
        shifted = torch.zeros((b, a, self.action_dim), device=obs.device)
        shifted[:, 1:] = action[:, :-1]
        out, log_std = state.decoder(shifted, rep)
        mean, log_std = torch.tanh(out), _log_std(log_std)
        logp = _normal_logp(action, mean, log_std)
        ent = (0.5 + 0.5 * math.log(2 * math.pi) + log_std).expand_as(logp)
        return logp, ent, v

    def draw_update(self, rollout: Rollout, generator: torch.Generator):
        """The K epochs' permutations of the T*N transitions, (K, T*N)."""
        b = rollout.reward.shape[0] * rollout.reward.shape[1]
        return torch.stack([
            torch.randperm(b, generator=generator, device=self.device)
            for _ in range(self.cfg.K_epochs)])

    def update(self, state: MATState, rollout: Rollout, draws,
               episodes=None):
        """One full update, in place: GAE on the agent-averaged values,
        then K epochs of shuffled minibatches, epoch e in the order
        ``draws[e]``. Returns (state, {"adv_mean"})."""
        cfg = self.cfg
        if draws is None:
            raise ValueError("MAT's update needs its permutations")
        a = self.n_agents
        T, N = rollout.reward.shape[:2]
        B = T * N
        mb = min(cfg.minibatch_size, B)
        obs_all = rollout.obs.reshape((B, a, -1))
        act_all = rollout.action.reshape(
            (B, a) if self.discrete else (B, a, self.action_dim))
        logp_old = rollout.log_pi.reshape(
            (B, a, 1) if self.discrete else (B, a, self.action_dim))
        with torch.no_grad():
            # values averaged over the agents before the TD delta
            vs = state.encoder(obs_all)[0].mean(-1, keepdim=True)
            vs_next = state.encoder(rollout.next_obs.reshape(
                (B, a, -1)))[0].mean(-1, keepdim=True)
            adv, v_target = gae(
                rollout.reward, vs.reshape(T, N, 1),
                vs_next.reshape(T, N, 1), rollout.done[..., None],
                rollout.adv_done[..., None], cfg.gamma, cfg.lmbda)
            if cfg.adv_norm:
                adv = (adv - torch.mean(adv)) / (
                    torch.std(adv, correction=0) + 1e-8)
            adv_f, vt_f = adv.reshape((B, a)), v_target.reshape((B, a))

        set_lr([state.opt], cfg.lr, lr_fraction(cfg, episodes))
        params = [*state.encoder.parameters(), *state.decoder.parameters()]
        for perm in draws:
            for m in range(B // mb):
                idx = perm[m * mb:(m + 1) * mb]
                logp, ent, v = self._parallel_logp_ent_v(
                    state, obs_all[idx], act_all[idx])
                ratio = torch.exp(logp - logp_old[idx])     # (mb, A, D|1)
                adv_b = adv_f[idx][..., None]
                surr1 = ratio * adv_b
                surr2 = torch.clamp(ratio, 1 - cfg.clip_param,
                                    1 + cfg.clip_param) * adv_b
                # summed over the action dims, then averaged
                actor_loss = -torch.mean(torch.sum(
                    torch.minimum(surr1, surr2), dim=-1)) - (
                    cfg.entropy_coefficient * torch.mean(ent))
                loss = actor_loss + value_loss(cfg, v, vt_f[idx])
                grads = pmean(list(torch.autograd.grad(loss, params)),
                              cfg.axis_name)
                step(state.opt, params, clip_grads_by_norm(grads, 10.0))
        state.step += 1
        return state, {"adv_mean": torch.mean(adv_f)}
