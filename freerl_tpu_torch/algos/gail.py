"""GAIL: adversarial imitation on top of the PPO generator (counterpart:
``freerl_tpu/algos/gail.py``).

- ``Discriminator`` D(s, a): a 2x128 MLP with LeakyReLU (slope 0.01),
  optionally LayerNorm after each hidden layer; it returns logits. Its
  layers are flax ``nn.Dense`` in the JAX package, so they take the
  ``'flax'`` init (``lecun_normal``, zero bias), and its LayerNorm is flax's
  (``nets/norm.py``: eps 1e-6, the fast variance);
- the reward relabel (``compute_reward``): vanilla ``-log(1 - sigmoid(D) +
  1e-8)``; under WGAN-GP (``gp_coef > 0``) ``-log(max(1 - sigmoid(D),
  1e-4)) * reward_scale``, both exactly as the JAX package writes them;
- ``train_d``: binary cross-entropy, expert -> 1 and policy -> 0; under
  WGAN-GP the BCE halves plus 5 times the gradient penalty of D with
  respect to the expert inputs (one ``torch.autograd.grad`` of the summed
  logits with ``create_graph``: D couples no rows, LayerNorm included, so
  it is the JAX package's per-row ``vmap(grad(D))``), and Adam betas
  (0.5, 0.9); Adam eps 1e-8 (optax's default) either way;
- the expert (s, a) set on the device, sampled uniformly;
- ``train_gail``: per iteration, a rollout with the generator, the D
  step(s) on expert and policy batches, the rollout's rewards relabelled
  by D, one PPO update. Episode returns are reported on the TRUE rewards.

Every draw is an argument: ``gail_iteration`` takes an
:class:`IterationDraws` (the policy's sampling draws, the env's, the
replay indices of the D steps, PPO's permutations), which a
:class:`GAILDraws` makes from a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from freerl_tpu_torch.algos.common import optimizer_step
from freerl_tpu_torch.algos.ppo import PPO, PPOConfig, PPOState, Rollout
from freerl_tpu_torch.core.types import DimInfo
from freerl_tpu_torch.envs.base import (Env, step_auto_reset, vec_reset,
                                        vec_step_auto_reset)
from freerl_tpu_torch.nets.mlp import Dense
from freerl_tpu_torch.nets.norm import LayerNorm


class Discriminator(nn.Module):
    """(s ++ a) -> logits."""

    def __init__(self, in_dim: int, hidden: Sequence[int] = (128, 128),
                 layernorm: bool = False,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        dims = [in_dim, *hidden]
        self.layers = nn.ModuleList(
            Dense(a, b, generator, device, "flax")
            for a, b in zip(dims[:-1], dims[1:]))
        self.norms = nn.ModuleList(
            LayerNorm(h, device) for h in hidden) if layernorm else None
        self.head = Dense(dims[-1], 1, generator, device, "flax")

    def forward(self, sa: torch.Tensor) -> torch.Tensor:
        x = sa
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if self.norms is not None:
                x = self.norms[i](x)
            x = F.leaky_relu(x, 0.01)
        return self.head(x).squeeze(-1)


@dataclasses.dataclass(frozen=True)
class GAILConfig:
    d_lr: float = 4e-4
    d_hidden: Sequence[int] = (128, 128)
    d_layernorm: bool = False
    gp_coef: float = 0.0            # > 0 turns on the WGAN-GP variant
    d_batch_size: int = 256
    d_steps_per_iter: int = 1
    reward_scale: float = 2.0       # the WGAN mode's reward scale


@dataclasses.dataclass
class GAILState:
    ppo_state: PPOState
    disc: Discriminator
    d_opt: torch.optim.Adam
    step: int = 0


@dataclasses.dataclass
class ExpertData:
    """The expert (s, a) set on the device, sampled uniformly with
    replacement."""

    states: torch.Tensor
    actions: torch.Tensor

    @classmethod
    def from_npz(cls, path: str, state_key="states", action_key="actions",
                 device="cuda") -> "ExpertData":
        data = np.load(path)
        return cls(
            states=torch.as_tensor(data[state_key], dtype=torch.float32,
                                   device=device),
            actions=torch.as_tensor(data[action_key], dtype=torch.float32,
                                    device=device))

    def sample_idx(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return torch.randint(0, self.states.shape[0], (n,),
                             generator=generator, device=self.states.device)

    def gather(self, idx: torch.Tensor):
        return self.states[idx], self.actions[idx]

    def sample(self, generator: torch.Generator, n: int):
        return self.gather(self.sample_idx(generator, n))


class GAIL:
    def __init__(self, dim_info: DimInfo, ppo_cfg: PPOConfig = PPOConfig(),
                 cfg: GAILConfig = GAILConfig(), device="cuda"):
        self.dim_info = dim_info
        self.cfg = cfg
        self.device = torch.device(device)
        self.ppo = PPO(dim_info, ppo_cfg, device)

    def init(self, generator: torch.Generator) -> GAILState:
        cfg, di = self.cfg, self.dim_info
        ppo_state = self.ppo.init(generator)
        disc = Discriminator(di.obs_dim + di.action_dim, tuple(cfg.d_hidden),
                             cfg.d_layernorm, generator, self.device)
        betas = (0.5, 0.9) if cfg.gp_coef > 0 else (0.9, 0.999)
        d_opt = torch.optim.Adam(disc.parameters(), lr=cfg.d_lr, betas=betas,
                                 eps=1e-8)
        return GAILState(ppo_state=ppo_state, disc=disc, d_opt=d_opt)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def compute_reward(self, disc: Discriminator, states: torch.Tensor,
                       actions: torch.Tensor) -> torch.Tensor:
        logits = disc(torch.cat([states, actions], dim=-1))
        if self.cfg.gp_coef > 0:
            prob = torch.sigmoid(logits)
            return self.cfg.reward_scale * (
                -torch.log(torch.clamp(1.0 - prob, min=1e-4)))
        d = torch.sigmoid(logits)
        return -torch.log(1.0 - d + 1e-8)

    def train_d(self, state: GAILState, expert_s, expert_a, policy_s,
                policy_a):
        """One Adam step of D, in place. Returns (state, metrics)."""
        cfg, disc = self.cfg, state.disc
        e_sa = torch.cat([expert_s, expert_a], dim=-1)
        p_sa = torch.cat([policy_s, policy_a], dim=-1)
        gp = cfg.gp_coef > 0
        if gp:
            e_sa = e_sa.detach().requires_grad_(True)
        e_out, p_out = disc(e_sa), disc(p_sa)
        # optax's sigmoid_binary_cross_entropy at labels 1 and 0
        e_loss = torch.mean(-F.logsigmoid(e_out))
        p_loss = torch.mean(-F.logsigmoid(-p_out))
        if gp:
            grads, = torch.autograd.grad(e_out.sum(), e_sa,
                                         create_graph=True)
            penalty = torch.mean(torch.sum(torch.square(grads), dim=-1))
            d_loss = 0.5 * (e_loss + p_loss) + 5.0 * penalty
        else:
            d_loss = e_loss + p_loss
        optimizer_step(state.d_opt, list(disc.parameters()), d_loss)
        with torch.no_grad():
            metrics = {
                "d_loss": d_loss.detach(),
                "expert_prob": torch.mean(torch.sigmoid(e_out)),
                "policy_prob": torch.mean(torch.sigmoid(p_out)),
                "w_dis": (torch.mean(e_out) - torch.mean(p_out)) if gp
                else torch.zeros((), device=e_out.device),
            }
        return state, metrics


# ---------------------------------------------------------------------------
def init_logging(log_root: str, config: dict) -> str:
    """A timestamped run dir with a config.json dump."""
    run_dir = os.path.join(log_root, time.strftime("%Y%m%d-%H%M%S"))
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2, default=str)
    return run_dir


@torch.no_grad()
def collect_expert_data(env: Env, act_fn, n_transitions: int, seed: int = 0,
                        out_path: Optional[str] = None) -> ExpertData:
    """Roll a (trained) deterministic policy ``act_fn(obs) -> (N, A)`` on
    16 envs and keep ``n_transitions`` (s, a) pairs, saved as .npz when
    ``out_path`` is given."""
    num_envs = 16
    T = (n_transitions + num_envs - 1) // num_envs
    generator = torch.Generator(device=env.device).manual_seed(seed)
    env_state, obs = vec_reset(env, generator, num_envs)
    states, actions = [], []
    for _ in range(T):
        action = act_fn(obs)
        out = vec_step_auto_reset(env, env_state, action, generator,
                                  num_envs)
        states.append(obs)
        actions.append(action)
        env_state, obs = out.state, out.carry_obs
    states = torch.stack(states).reshape(-1, obs.shape[-1])[:n_transitions]
    actions = torch.stack(actions)
    actions = actions.reshape(-1, actions.shape[-1])[:n_transitions]
    if out_path:
        np.savez(out_path, states=states.cpu().numpy(),
                 actions=actions.cpu().numpy())
    return ExpertData(states=states, actions=actions.to(torch.float32))


@dataclasses.dataclass
class IterationDraws:
    """The draws of one ``gail_iteration`` over T vector steps: per step
    the policy's sampling draw, the env's step and reset draws; per D step
    the expert and the policy indices, (d_steps, d_batch); PPO's
    permutations, (K_epochs, T * N)."""

    action: list
    step: list
    reset: list
    expert_idx: torch.Tensor
    policy_idx: torch.Tensor
    perms: torch.Tensor


class GAILDraws:
    """Every draw ``train_gail`` makes, from one generator. A test hands
    ``train_gail`` a subclass that returns the JAX package's draws."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def reset(self, env: Env, num_envs: int):
        return env.draw_reset(num_envs, self.generator)

    def iteration(self, gail: GAIL, env: Env, num_envs: int, T: int,
                  n_expert: int) -> IterationDraws:
        g, dev, cfg = self.generator, gail.device, gail.cfg
        shape = (cfg.d_steps_per_iter, cfg.d_batch_size)
        return IterationDraws(
            action=[gail.ppo.draw_action(num_envs, g) for _ in range(T)],
            step=[env.draw_step(num_envs, g) for _ in range(T)],
            reset=[env.draw_reset(num_envs, g) for _ in range(T)],
            expert_idx=torch.randint(0, n_expert, shape, generator=g,
                                     device=dev),
            policy_idx=torch.randint(0, T * num_envs, shape, generator=g,
                                     device=dev),
            perms=torch.stack([
                torch.randperm(T * num_envs, generator=g, device=dev)
                for _ in range(gail.ppo.cfg.K_epochs)]))


def gail_iteration(gail: GAIL, env: Env, expert: ExpertData,
                   state: GAILState, env_state, obs: torch.Tensor,
                   draws: IterationDraws):
    """One iteration, in place: rollout, D step(s), relabel, PPO update.
    Returns (state, env_state, obs, metrics), the metrics on the device."""
    ppo, T = gail.ppo, len(draws.step)
    rows = []
    for t in range(T):
        env_a, stored_a, logp = ppo.sample_action(state.ppo_state, obs,
                                                  draws.action[t])
        out = step_auto_reset(env, env_state, env_a, draws.step[t],
                              draws.reset[t])
        rows.append((obs, stored_a, logp, out.reward, out.next_obs,
                     out.terminated, out.episode_done))
        env_state, obs = out.state, out.carry_obs
    obs_t, act_t, logp_t, true_r, next_obs_t, done_t, ep_done_t = (
        torch.stack(x) for x in zip(*rows))

    flat_s = obs_t.reshape(-1, obs_t.shape[-1])
    flat_a = (act_t.reshape(-1, act_t.shape[-1]) if act_t.dim() > 2
              else act_t.reshape(-1, 1).to(torch.float32))
    d_metrics = {}
    for e_idx, p_idx in zip(draws.expert_idx, draws.policy_idx):
        e_s, e_a = expert.gather(e_idx)
        state, d_metrics = gail.train_d(state, e_s, e_a, flat_s[p_idx],
                                        flat_a[p_idx])

    # relabel the rewards with the updated discriminator
    gail_r = gail.compute_reward(state.disc, flat_s, flat_a).reshape(
        true_r.shape)
    roll = Rollout(obs=obs_t, action=act_t, log_pi=logp_t, reward=gail_r,
                   next_obs=next_obs_t, done=done_t, adv_done=ep_done_t)
    state.ppo_state, ppo_metrics = ppo.update(state.ppo_state, roll,
                                              draws.perms)
    state.step += 1
    return state, env_state, obs, dict(
        d_metrics, mean_true_reward=torch.mean(true_r), **ppo_metrics)


def train_gail(env: Env, gail: GAIL, expert: ExpertData, num_iterations: int,
               num_envs: int = 8, seed: int = 0,
               draws: Optional[GAILDraws] = None):
    """The alternating GAIL loop, ``T = horizon // num_envs`` vector steps
    an iteration. ``draws`` defaults to a :class:`GAILDraws` on a
    generator seeded with ``seed``. Returns (state, the mean TRUE reward
    of each iteration, the metrics history); each iteration reads its
    metrics to the host once."""
    T = max(gail.ppo.cfg.horizon // num_envs, 1)
    if draws is None:
        draws = GAILDraws(torch.Generator(device=env.device).manual_seed(seed))
    state = gail.init(draws.generator)
    env_state, obs = env.reset(draws.reset(env, num_envs))
    history, record = [], []
    for _ in range(num_iterations):
        state, env_state, obs, metrics = gail_iteration(
            gail, env, expert, state, env_state, obs,
            draws.iteration(gail, env, num_envs, T, expert.states.shape[0]))
        values = torch.stack([v.detach().float().reshape(())
                              for v in metrics.values()]).cpu().tolist()
        history.append(dict(zip(metrics, values)))
        record.append(history[-1]["mean_true_reward"])
    return state, np.asarray(record), history
