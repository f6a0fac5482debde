"""REINFORCE, Monte-Carlo policy gradient (counterpart:
``freerl_tpu/algos/reinforce.py``).

A 1-hidden-layer-128 softmax policy, discounted returns-to-go cut at
episode ends, returns normalized within each episode, loss
``sum(-log_pi * G)``, and one Adam step (eps 1e-8) per finished episode.

``update`` takes a fixed (T, N) window from the on-policy driver and
segments it into completed episodes. Each transition gets a slot
``seg * N + env``, where ``seg`` counts the episodes its env finished
before it in the window; a slot is filled when its episode ends inside the
window. Slots are stepped in ascending order, up to ``max_eps_per_update``;
the tail of an unfinished episode is dropped (its return would be
truncated). Slot ``k`` is filled exactly when env ``k % N`` finished more
than ``k // N`` episodes, so the update reads the per-env done counts,
``(N,)``, to the host once and steps exactly the filled slots: an empty
slot leaves the params and the Adam state, its step count too, unchanged,
as the JAX scan's ``where(has, ...)`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from freerl_tpu_torch.algos.base import check_axis_name
from freerl_tpu_torch.algos.ppo import CategoricalPolicy, Rollout
from freerl_tpu_torch.core.types import DimInfo
from freerl_tpu_torch.distributed.dp import pmax, pmean
from freerl_tpu_torch.nets import distributions as D


@dataclasses.dataclass(frozen=True)
class REINFORCEConfig:
    """Static hyperparameters, with the JAX package's fields and defaults
    but ``num_envs``, which the JAX algorithm never reads (ROADMAP queue
    C)."""

    lr: float = 1e-3
    gamma: float = 0.99
    hidden: Sequence[int] = (128,)
    normalize_returns: bool = True
    # episode slots per update window: one Adam step per completed
    # episode, up to this many
    max_eps_per_update: int = 64
    axis_name: Optional[str] = None


@dataclasses.dataclass
class REINFORCEState:
    policy: CategoricalPolicy
    opt: torch.optim.Optimizer
    step: int = 0


class REINFORCE:
    def __init__(self, dim_info: DimInfo,
                 cfg: REINFORCEConfig = REINFORCEConfig(), device="cuda"):
        if dim_info.is_continue:
            raise ValueError("REINFORCE here is discrete (softmax)")
        check_axis_name(cfg)
        self.dim_info = dim_info
        self.cfg = cfg
        self.device = torch.device(device)

    def init(self, generator: torch.Generator) -> REINFORCEState:
        di = self.dim_info
        policy = CategoricalPolicy(di.obs_dim, di.action_dim,
                                   tuple(self.cfg.hidden),
                                   generator=generator, device=self.device)
        return REINFORCEState(
            policy=policy,
            opt=torch.optim.Adam(policy.parameters(), lr=self.cfg.lr,
                                 eps=1e-8))

    # on-policy driver hooks -------------------------------------------
    def draw_action(self, b: int, generator: torch.Generator) -> torch.Tensor:
        """Gumbel noise (b, A) for one ``sample_action``."""
        return D.draw_gumbel((b, self.dim_info.action_dim), generator,
                             self.device)

    @torch.no_grad()
    def sample_action(self, state: REINFORCEState, obs: torch.Tensor,
                      gumbel: torch.Tensor):
        """Returns (env_action, stored_action, log_pi)."""
        logits = state.policy(obs)
        a = D.categorical_sample(logits, gumbel)
        return a, a, D.categorical_log_prob(logits, a)

    @torch.no_grad()
    def evaluate_action(self, state: REINFORCEState, obs: torch.Tensor):
        return torch.argmax(state.policy(obs), dim=-1)

    def process_obs(self, state, next_obs, carry_obs):
        return state, next_obs, carry_obs

    def process_reward(self, state, reward, episode_done):
        return state, reward

    def draw_update(self, rollout: Rollout, generator: torch.Generator):
        """REINFORCE's update draws nothing."""
        return None

    # ------------------------------------------------------------------
    def update(self, state: REINFORCEState, rollout: Rollout, draws=None,
               episodes=None):
        """One Adam step per filled episode slot, in place. Returns (state,
        {"loss": the sum of the slots' losses}).

        Under ``axis_name`` the ranks' filled slots differ. Every rank
        steps through the slots filled on ANY rank (an all-reduced max) and
        joins each slot's gradient all-reduce, with a zero gradient where
        it has no such episode, then takes the Adam step only where it
        has one: the JAX package's local ``has`` select after the pmean.
        Where the ranks' counts differ, their parameters drift apart, as
        they do in the JAX package."""
        cfg = self.cfg
        T, N = rollout.reward.shape

        # discounted returns-to-go, a reverse loop cut at episode ends
        with torch.no_grad():
            cut = 1.0 - rollout.adv_done.to(torch.float32)
            g = torch.zeros_like(rollout.reward[0])
            returns = []
            for t in range(T - 1, -1, -1):
                g = rollout.reward[t] + cfg.gamma * g * cut[t]
                returns.append(g)
            g_f = torch.stack(returns[::-1]).reshape(-1)

            d = rollout.adv_done.to(torch.int64)                   # (T, N)
            seg = torch.cumsum(d, dim=0) - d
            n_done = torch.sum(d, dim=0)                           # (N,)
            env = torch.arange(N, device=d.device)
            slot_f = torch.where(seg < n_done, seg * N + env, -1).reshape(-1)

        obs_f = rollout.obs.reshape(T * N, -1)
        act_f = rollout.action.reshape(-1)
        # the update's one host read: which slots hold a whole episode
        k_all = torch.arange(cfg.max_eps_per_update, device=n_done.device)
        has = n_done[k_all % N] > k_all // N
        filled_here = has.tolist()
        filled = (filled_here if cfg.axis_name is None
                  else pmax(has.to(torch.int32), cfg.axis_name).tolist())
        params = list(state.policy.parameters())
        losses = []
        for k in (k for k, f in enumerate(filled) if f):
            if not filled_here[k]:
                # no episode of slot k here: a zero gradient joins the
                # all-reduce, and no Adam step follows
                pmean([torch.zeros_like(p) for p in params], cfg.axis_name)
                continue
            mask = (slot_f == k).to(torch.float32)
            nz = torch.clamp(torch.sum(mask), min=1.0)
            if cfg.normalize_returns:
                mean = torch.sum(g_f * mask) / nz
                var = torch.sum(torch.square(g_f - mean) * mask) / nz
                g_k = (g_f - mean) / (torch.sqrt(var) + 1e-8)
            else:
                g_k = g_f
            logp = D.categorical_log_prob(state.policy(obs_f), act_f)
            loss = torch.sum(-logp * g_k * mask)
            grads = pmean(list(torch.autograd.grad(loss, params)),
                          cfg.axis_name)
            for p, grad in zip(params, grads):
                p.grad = grad
            state.opt.step()
            losses.append(loss.detach())
        state.step += 1
        total = (torch.sum(torch.stack(losses)) if losses
                 else torch.zeros((), device=rollout.reward.device))
        return state, {"loss": total}
