"""PPO with the reference's trick set, the Beta policy and the PPO_d and
std-decay variants (counterpart: ``freerl_tpu/algos/ppo.py``).

- clipped surrogate with stored old log-probs, GAE (lambda 0.95) with the
  done (dead) vs adv_done (dead-or-truncated) split;
- ``K_epochs`` epochs over shuffled minibatches: ``B // minibatch_size``
  minibatches an epoch, the permutation's remainder unused in that epoch;
- ONE Adam over actor and critic, both at ``actor_lr``: eps 1e-6 (the JAX
  package's AdamW, weight decay 0) or eps 1e-5 under ``adam_eps``. Before
  every step the actor's and the critic's gradients are each clipped at
  0.5 with the JAX helper's form (``clip_grads_by_norm``);
- a diagonal-Gaussian actor (tanh mean times ``max_action``,
  state-independent ``log_std``), a softmax twin, and the Beta actor
  (``softplus + 1``);
- the tricks ``adv_norm`` (population std), ``obs_norm``, ``reward_norm``,
  ``reward_scaling``, ``lr_decay``, ``orthogonal_init`` (gains sqrt(2)
  hidden, 0.01 policy heads, 1.0 value head), ``adam_eps`` and ``tanh``;
  the variants ``recompute_logp`` (PPO_d: old log-probs from the
  pre-update policy) and ``std_decay`` (an external std, decayed with the
  completed episodes);
- pixel observations (``obs_shape``): the actor and the critic each put
  their own conv trunk (``nets/cnn.py``) before their hidden layers.

The learning rate decays linearly with the completed episodes: under
``lr_decay`` the device episode counter is read to the host once per
update and written into the optimizer's param group. ``std_decay``'s std
stays a device scalar.

Draws: ``sample_action`` takes what ``draw_action`` makes, Gumbel noise
(categorical) or a standard normal (Gaussian); the Beta's rejection
sampler has no fixed number of draws, so for it ``draw_action`` hands back
the caller's generator. ``update`` takes the K epochs' permutations,
``(K_epochs, T*N)`` int64, which ``draw_update`` makes with
``torch.randperm``. Tests feed in JAX's draws.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from freerl_tpu_torch.algos.base import check_axis_name
from freerl_tpu_torch.algos.common import (adv_normalize,
                                           clip_grads_by_norm, gae)
from freerl_tpu_torch.core.normalization import RewardScaling, RunningMeanStd
from freerl_tpu_torch.core.types import DimInfo
from freerl_tpu_torch.distributed.dp import pmean
from freerl_tpu_torch.nets import distributions as D
from freerl_tpu_torch.nets.cnn import conv_trunk
from freerl_tpu_torch.nets.mlp import MLP, Dense, Trunk, init_scheme


class GaussianPolicy(MLP):
    """obs -> (tanh(head) * max_action, log_std broadcast to the mean)."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (128, 128), activation: str = "relu",
                 orthogonal: bool = False, max_action: float = 1.0,
                 generator: torch.Generator | None = None, device="cuda",
                 conv: nn.Module | None = None):
        super().__init__(obs_dim, action_dim, hidden, activation, generator,
                         device, init_scheme(orthogonal), out_gain=0.01,
                         conv=conv)
        self.max_action = max_action
        self.log_std = nn.Parameter(torch.zeros(action_dim, device=device))

    def forward(self, x: torch.Tensor):
        mean = torch.tanh(super().forward(x)) * self.max_action
        return mean, self.log_std.expand_as(mean)


class BetaPolicy(Trunk):
    """obs -> (alpha, beta) = softplus(heads) + 1; the alpha head is
    created before the beta head."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (128, 128), activation: str = "relu",
                 orthogonal: bool = False,
                 generator: torch.Generator | None = None, device="cuda",
                 conv: nn.Module | None = None):
        scheme = init_scheme(orthogonal)
        super().__init__(obs_dim, hidden, activation, generator, device,
                         scheme, conv)
        self.alpha_head = Dense(self.trunk_dim, action_dim, generator, device,
                                scheme, gain=0.01)
        self.beta_head = Dense(self.trunk_dim, action_dim, generator, device,
                               scheme, gain=0.01)

    def forward(self, x: torch.Tensor):
        x = self.trunk(x)
        return D.beta_params(self.alpha_head(x), self.beta_head(x))


class CategoricalPolicy(MLP):
    """obs -> action logits."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (128, 128), activation: str = "relu",
                 orthogonal: bool = False,
                 generator: torch.Generator | None = None, device="cuda",
                 conv: nn.Module | None = None):
        super().__init__(obs_dim, action_dim, hidden, activation, generator,
                         device, init_scheme(orthogonal), out_gain=0.01,
                         conv=conv)


class VCritic(MLP):
    """obs -> state value, the trailing unit dim squeezed."""

    def __init__(self, obs_dim: int, hidden: Sequence[int] = (128, 128),
                 activation: str = "relu", orthogonal: bool = False,
                 generator: torch.Generator | None = None, device="cuda",
                 conv: nn.Module | None = None):
        super().__init__(obs_dim, 1, hidden, activation, generator, device,
                         init_scheme(orthogonal), out_gain=1.0, conv=conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).squeeze(-1)


# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Static hyperparameters, with the JAX package's fields and defaults
    but ``critic_lr``, which the JAX update never reads (one optimizer at
    ``actor_lr``; ROADMAP queue C)."""

    actor_lr: float = 1e-3
    gamma: float = 0.99
    lmbda: float = 0.95
    clip_param: float = 0.2
    K_epochs: int = 10
    entropy_coefficient: float = 0.01
    horizon: int = 2048            # total transitions per update
    minibatch_size: int = 64
    hidden: Sequence[int] = (128, 128)
    num_envs: int = 1
    # tricks
    adv_norm: bool = False
    obs_norm: bool = False
    reward_norm: bool = False      # normalize raw rewards (RunningMeanStd)
    reward_scaling: bool = False   # scale by running std of discounted return
    lr_decay: bool = False
    lr_decay_episodes: int = 200
    orthogonal_init: bool = False
    adam_eps: bool = False         # Adam eps 1e-5 instead of eps 1e-6
    tanh: bool = False
    beta_dist: bool = False
    # variants (PPO_d, std decay)
    recompute_logp: bool = False
    std_decay: bool = False
    std_init: float = 0.6
    std_min: float = 0.1
    std_decay_episodes: int = 200
    axis_name: Optional[str] = None
    # pixel observations: set to the env's (H, W, C) to give the actor
    # and the critic each its own conv trunk (nets/cnn.py)
    obs_shape: Optional[tuple] = None
    conv_arch: str = "small"
    cnn_features: int = 256

    def __post_init__(self):
        if self.reward_norm and self.reward_scaling:
            raise ValueError(
                "reward_norm and reward_scaling cannot both be on"
            )
        if self.beta_dist and self.std_decay:
            raise ValueError("std_decay applies to the Gaussian actor")


@dataclasses.dataclass
class PPOState:
    actor: nn.Module
    critic: VCritic
    opt: torch.optim.Optimizer         # one Adam over actor and critic
    obs_rms: RunningMeanStd
    rew_rms: RunningMeanStd
    rew_scale: RewardScaling
    lr_frac: float                     # current lr multiplier (host)
    ext_std: torch.Tensor              # scalar, the std_decay schedule's std
    step: int = 0


@dataclasses.dataclass
class Rollout:
    """(T, N, ...) time-major on-policy batch."""

    obs: torch.Tensor
    action: torch.Tensor
    log_pi: torch.Tensor
    reward: torch.Tensor
    next_obs: torch.Tensor
    done: torch.Tensor          # dead only (bootstrap mask)
    adv_done: torch.Tensor      # dead or truncated (GAE cut)


class PPO:
    def __init__(self, dim_info: DimInfo, cfg: PPOConfig = PPOConfig(),
                 device="cuda"):
        check_axis_name(cfg)
        self.dim_info = dim_info
        self.cfg = cfg
        self.device = torch.device(device)

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> PPOState:
        cfg, di, dev = self.cfg, self.dim_info, self.device
        act = "tanh" if cfg.tanh else "relu"
        hid, ortho = tuple(cfg.hidden), cfg.orthogonal_init
        conv = conv_trunk(cfg, generator, dev)
        if not di.is_continue:
            actor = CategoricalPolicy(di.obs_dim, di.action_dim, hid, act,
                                      ortho, generator, dev, conv)
        elif cfg.beta_dist:
            actor = BetaPolicy(di.obs_dim, di.action_dim, hid, act, ortho,
                               generator, dev, conv)
        else:
            actor = GaussianPolicy(di.obs_dim, di.action_dim, hid, act, ortho,
                                   di.max_action, generator, dev, conv)
        critic = VCritic(di.obs_dim, hid, act, ortho, generator, dev,
                         conv_trunk(cfg, generator, dev))
        opt = torch.optim.Adam(
            [*actor.parameters(), *critic.parameters()], lr=cfg.actor_lr,
            eps=1e-5 if cfg.adam_eps else 1e-6, weight_decay=0.0)
        return PPOState(
            actor=actor, critic=critic, opt=opt,
            obs_rms=RunningMeanStd.create((di.obs_dim,), dev),
            rew_rms=RunningMeanStd.create((), dev),
            rew_scale=RewardScaling.create(cfg.num_envs, cfg.gamma, dev),
            lr_frac=1.0,
            ext_std=torch.tensor(cfg.std_init, device=dev),
        )

    # ------------------------------------------------------------------
    def _std(self, log_std: torch.Tensor, ext_std: torch.Tensor):
        if self.cfg.std_decay:
            return ext_std.expand_as(log_std)
        return torch.exp(log_std)

    def _dist_logp_entropy(self, actor, obs, action, ext_std):
        if not self.dim_info.is_continue:
            logits = actor(obs)
            return (D.categorical_log_prob(logits, action),
                    D.categorical_entropy(logits))
        if self.cfg.beta_dist:
            alpha, beta = actor(obs)
            return (D.beta_log_prob(alpha, beta, action),
                    D.beta_entropy(alpha, beta))
        mean, log_std = actor(obs)
        std = self._std(log_std, ext_std)
        return D.normal_log_prob(mean, std, action), D.normal_entropy(std)

    def draw_action(self, b: int, generator: torch.Generator):
        """The draws of one ``sample_action`` over ``b`` rows: Gumbel noise
        or a standard normal, (b, A); for the Beta actor the generator
        itself."""
        di = self.dim_info
        if not di.is_continue:
            return D.draw_gumbel((b, di.action_dim), generator, self.device)
        if self.cfg.beta_dist:
            return generator
        return D.draw_normal((b, di.action_dim), generator, self.device)

    @torch.no_grad()
    def sample_action(self, state: PPOState, obs: torch.Tensor, draws):
        """Returns (env_action, stored_action, log_pi)."""
        di = self.dim_info
        if not di.is_continue:
            logits = state.actor(obs)
            a = D.categorical_sample(logits, draws)
            return a, a, D.categorical_log_prob(logits, a)
        if self.cfg.beta_dist:
            alpha, beta = state.actor(obs)
            x = D.beta_sample(alpha, beta, draws)
            return (D.beta_to_action(x, di.max_action), x,
                    D.beta_log_prob(alpha, beta, x))
        mean, log_std = state.actor(obs)
        std = self._std(log_std, state.ext_std)
        a = D.normal_sample(mean, std, draws)
        logp = D.normal_log_prob(mean, std, a)
        return torch.clamp(a, -di.max_action, di.max_action), a, logp

    @torch.no_grad()
    def evaluate_action(self, state: PPOState, obs: torch.Tensor):
        """The greedy action for RAW observations: under ``obs_norm`` the
        saved running stats normalize them first, as in training."""
        if self.cfg.obs_norm:
            obs = state.obs_rms.normalize(obs)
        if not self.dim_info.is_continue:
            return torch.argmax(state.actor(obs), dim=-1)
        if self.cfg.beta_dist:
            alpha, beta = state.actor(obs)
            return D.beta_to_action(D.beta_mean(alpha, beta),
                                    self.dim_info.max_action)
        return state.actor(obs)[0]

    @torch.no_grad()
    def value(self, state: PPOState, obs: torch.Tensor) -> torch.Tensor:
        return state.critic(obs)

    # -- trick hooks used by the on-policy loop -------------------------
    def process_obs(self, state: PPOState, next_obs, carry_obs):
        if not self.cfg.obs_norm:
            return state, next_obs, carry_obs
        # under a mesh the stats fold global-batch moments and stay
        # replicated
        state.obs_rms = state.obs_rms.update(next_obs,
                                             axis_name=self.cfg.axis_name)
        return (state, state.obs_rms.normalize(next_obs),
                state.obs_rms.normalize(carry_obs))

    def process_reward(self, state: PPOState, reward, episode_done):
        if self.cfg.reward_scaling:
            state.rew_scale, scaled = state.rew_scale(
                reward, episode_done, axis_name=self.cfg.axis_name)
            return state, scaled
        if self.cfg.reward_norm:
            state.rew_rms = state.rew_rms.update(
                reward, axis_name=self.cfg.axis_name)
            return state, state.rew_rms.normalize(reward)
        return state, reward

    # ------------------------------------------------------------------
    def draw_update(self, rollout: Rollout, generator: torch.Generator):
        """The K epochs' permutations of the T*N transitions, (K, T*N)."""
        b = rollout.reward.numel()
        return torch.stack([
            torch.randperm(b, generator=generator, device=self.device)
            for _ in range(self.cfg.K_epochs)])

    def update(self, state: PPOState, rollout: Rollout, draws, episodes=None):
        """One full PPO update, in place: GAE, then K epochs of shuffled
        minibatches, epoch ``e`` in the order ``draws[e]``. ``episodes`` is
        the device count of completed episodes (lr and std decay).
        Returns (state, metrics); besides the JAX package's two metrics it
        reports the last minibatch's losses."""
        cfg = self.cfg
        if draws is None:
            raise ValueError("PPO's update needs its permutations")
        T, N = rollout.reward.shape
        B = T * N
        mb = cfg.minibatch_size
        n_mb = B // mb
        actor, critic = state.actor, state.critic

        with torch.no_grad():
            adv, v_target = gae(
                rollout.reward, critic(rollout.obs), critic(rollout.next_obs),
                rollout.done, rollout.adv_done, cfg.gamma, cfg.lmbda)
            if cfg.adv_norm:
                adv = adv_normalize(adv, 1e-5, cfg.axis_name)
            obs_f = rollout.obs.reshape((B,) + rollout.obs.shape[2:])
            act_f = rollout.action.reshape((B,) + rollout.action.shape[2:])
            if cfg.recompute_logp:
                logp_old_f, _ = self._dist_logp_entropy(actor, obs_f, act_f,
                                                        state.ext_std)
            else:
                logp_old_f = rollout.log_pi.reshape(B)
            adv_f = adv.reshape(B)
            vt_f = v_target.reshape(B)

        if cfg.lr_decay and episodes is not None:
            # the update's one host read of the device episode counter
            ep = np.float32(int(episodes))
            frac = float(max(np.float32(1.0)
                             - ep / np.float32(cfg.lr_decay_episodes),
                             np.float32(1e-3)))
        else:
            frac = state.lr_frac
        for group in state.opt.param_groups:
            group["lr"] = float(np.float32(cfg.actor_lr) * np.float32(frac))

        actor_params = list(actor.parameters())
        params = actor_params + list(critic.parameters())
        n_actor = len(actor_params)
        for e in range(cfg.K_epochs):
            perm = draws[e]
            for i in range(n_mb):
                idx = perm[i * mb:(i + 1) * mb]
                obs_b, adv_b = obs_f[idx], adv_f[idx]
                logp, ent = self._dist_logp_entropy(actor, obs_b, act_f[idx],
                                                    state.ext_std)
                ratio = torch.exp(logp - logp_old_f[idx])
                surr1 = ratio * adv_b
                surr2 = torch.clamp(ratio, 1 - cfg.clip_param,
                                    1 + cfg.clip_param) * adv_b
                actor_loss = -torch.mean(torch.minimum(surr1, surr2)) - (
                    cfg.entropy_coefficient * torch.mean(ent))
                critic_loss = torch.mean(torch.square(vt_f[idx]
                                                      - critic(obs_b)))
                # std_decay leaves log_std out of the graph: a zero grad
                grads = pmean(list(torch.autograd.grad(
                    actor_loss + critic_loss, params, allow_unused=True,
                    materialize_grads=True)), cfg.axis_name)
                grads = (clip_grads_by_norm(grads[:n_actor], 0.5)
                         + clip_grads_by_norm(grads[n_actor:], 0.5))
                for p, g in zip(params, grads):
                    p.grad = g
                state.opt.step()

        if cfg.std_decay and episodes is not None:
            prog = torch.clamp(
                episodes.to(torch.float32) / cfg.std_decay_episodes, max=1.0)
            state.ext_std = cfg.std_init + (cfg.std_min - cfg.std_init) * prog
        state.lr_frac = frac
        state.step += 1
        metrics = {"adv_mean": torch.mean(adv_f),
                   "v_target_mean": torch.mean(vt_f)}
        if n_mb:
            metrics.update(actor_loss=actor_loss.detach(),
                           critic_loss=critic_loss.detach())
        return state, metrics
