"""DDPG with the reference's four supplements, PopArt and a discrete
variant (counterpart: ``freerl_tpu/algos/ddpg.py``).

- 2x128 ReLU actor (tanh out, scaled by ``max_action``) and an obs||act
  critic; Adam 1e-3 (eps 1e-8), gradient clip 0.5 on both nets
  (``optax.clip_by_global_norm``'s form), polyak tau 0.01;
- the supplements: critic weight decay (AdamW, decay 1e-3 passed
  explicitly: torch's default is 1e-2), Ornstein-Uhlenbeck exploration
  noise reset per episode, Welford observation normalization
  (``process_obs``; ``evaluate_action`` normalizes raw observations), and
  the fan-in / final-uniform init (``net_init``);
- the exploration-noise scale decays linearly on the device episode
  counter; ``random_steps`` of uniform warm-up actions;
- PopArt: the critic learns normalized targets, and every update rescales
  the head of the online and the target critic so their denormalized
  outputs are preserved;
- discrete actions: a softmax actor whose probabilities the critic takes
  (the buffer stores them, ``explore_stored``), or the Gumbel-softmax
  straight-through actor (``discrete_gumbel``; the buffer stores the
  one-hot of the action taken).

Every draw is an argument of ``explore_with`` / ``update`` (the Gaussian or
OU normals, the warm-up actions, the Gumbel noise of the discrete sample and
of ``gumbel_softmax``), made by ``draw_explore`` / ``draw_update`` from the
caller's generator.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from freerl_tpu_torch.algos.base import (ExploreCtx, ExploreDraws,
                                         OffPolicyAlgo, check_axis_name,
                                         draw_random_actions, frozen_copy,
                                         noise_scale, ou_step)
from freerl_tpu_torch.algos.common import optimizer_step, polyak, td_target
from freerl_tpu_torch.core.normalization import PopArt, RunningMeanStd
from freerl_tpu_torch.core.types import DimInfo, Transition
from freerl_tpu_torch.nets.distributions import (categorical_sample,
                                                 draw_gumbel)
from freerl_tpu_torch.nets.mlp import MLP


# ---------------------------------------------------------------------------
# Networks
# ---------------------------------------------------------------------------
def _schemes(scheme: str):
    """(hidden, head) init schemes: 'torch', or 'ddpg' (fan-in hidden
    layers, final-uniform head)."""
    return ("torch", "torch") if scheme == "torch" else ("fanin", "final")


class TanhActor(MLP):
    """obs -> tanh(MLP(obs)) * max_action."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (128, 128), max_action: float = 1.0,
                 scheme: str = "torch",
                 generator: torch.Generator | None = None, device="cuda"):
        hid, out = _schemes(scheme)
        super().__init__(obs_dim, action_dim, hidden, "relu", generator, device,
                         scheme=hid, out_scheme=out)
        self.max_action = max_action

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(super().forward(x)) * self.max_action


class SoftmaxActor(MLP):
    """Discrete DDPG actor: action probabilities, or the raw logits with
    ``logits_out`` (the Gumbel variant)."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (128, 128), scheme: str = "torch",
                 logits_out: bool = False,
                 generator: torch.Generator | None = None, device="cuda"):
        hid, out = _schemes(scheme)
        super().__init__(obs_dim, action_dim, hidden, "relu", generator, device,
                         scheme=hid, out_scheme=out)
        self.logits_out = logits_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logits = super().forward(x)
        return logits if self.logits_out else torch.softmax(logits, dim=-1)


def gumbel_softmax(logits: torch.Tensor, gumbel: torch.Tensor,
                   temperature: float = 1.0, hard: bool = True) -> torch.Tensor:
    """Categorical reparameterization from the Gumbel noise ``gumbel``.
    ``hard=True`` is the straight-through one-hot: the forward pass is the
    argmax, the gradient flows through the soft sample."""
    y = torch.softmax((logits + gumbel) / temperature, dim=-1)
    if hard:
        y_hard = F.one_hot(torch.argmax(y, dim=-1),
                           logits.shape[-1]).to(y.dtype)
        y = y_hard + y - y.detach()
    return y


class QCritic(MLP):
    """Q(obs, act) -> scalar."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (128, 128), scheme: str = "torch",
                 generator: torch.Generator | None = None, device="cuda"):
        hid, out = _schemes(scheme)
        super().__init__(obs_dim + action_dim, 1, hidden, "relu", generator,
                         device, scheme=hid, out_scheme=out)

    def forward(self, obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        return super().forward(torch.cat([obs, act], dim=-1))[..., 0]


# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    """Static hyperparameters, with the JAX package's fields and defaults."""

    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    gamma: float = 0.99
    tau: float = 0.01
    batch_size: int = 64
    buffer_size: int = 1_000_000
    hidden: Sequence[int] = (128, 128)
    grad_clip: float = 0.5
    num_envs: int = 1              # env batch (the OU state's rows)
    # exploration
    gauss_sigma: float = 0.1
    noise_init_scale: Optional[float] = None   # None -> constant scale 1
    noise_final_scale: float = 0.0
    noise_decay_episodes: int = 500
    # supplements
    weight_decay: bool = False     # critic AdamW, decay 1e-3
    ou_noise: bool = False
    obs_norm: bool = False         # Welford running obs normalization
    net_init: bool = False         # fan-in / final-uniform init
    # tricks
    popart: bool = False
    # discrete variant: the Gumbel-softmax straight-through actor instead
    # of the softmax-probability actor
    discrete_gumbel: bool = False
    # OU parameters
    ou_theta: float = 0.15
    ou_sigma: float = 1.0
    ou_dt: float = 1.0
    axis_name: Optional[str] = None


@dataclasses.dataclass
class DDPGState:
    actor: nn.Module
    actor_target: nn.Module
    critic: QCritic
    critic_target: QCritic
    actor_opt: torch.optim.Optimizer
    critic_opt: torch.optim.Optimizer
    ou_state: torch.Tensor             # (num_envs, action_dim)
    obs_rms: RunningMeanStd
    popart: PopArt
    step: int = 0


class DDPG(OffPolicyAlgo):
    def __init__(self, dim_info: DimInfo, cfg: DDPGConfig = DDPGConfig(),
                 device="cuda"):
        check_axis_name(cfg)
        self.dim_info = dim_info
        self.cfg = cfg
        self.device = torch.device(device)
        self.gumbel = (not dim_info.is_continue) and cfg.discrete_gumbel

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> DDPGState:
        cfg, di, dev = self.cfg, self.dim_info, self.device
        scheme = "ddpg" if cfg.net_init else "torch"
        hidden = tuple(cfg.hidden)
        if di.is_continue:
            actor = TanhActor(di.obs_dim, di.action_dim, hidden, di.max_action,
                              scheme, generator, dev)
        else:
            actor = SoftmaxActor(di.obs_dim, di.action_dim, hidden, scheme,
                                 cfg.discrete_gumbel, generator, dev)
        critic = QCritic(di.obs_dim, di.action_dim, hidden, scheme, generator,
                         dev)
        actor_opt = torch.optim.Adam(actor.parameters(), lr=cfg.actor_lr,
                                     eps=1e-8)
        if cfg.weight_decay:
            critic_opt = torch.optim.AdamW(critic.parameters(),
                                           lr=cfg.critic_lr, eps=1e-8,
                                           weight_decay=1e-3)
        else:
            critic_opt = torch.optim.Adam(critic.parameters(),
                                          lr=cfg.critic_lr, eps=1e-8)
        return DDPGState(
            actor=actor, actor_target=frozen_copy(actor),
            critic=critic, critic_target=frozen_copy(critic),
            actor_opt=actor_opt, critic_opt=critic_opt,
            ou_state=torch.zeros(cfg.num_envs, di.action_dim, device=dev),
            obs_rms=RunningMeanStd.create((di.obs_dim,), dev),
            popart=PopArt.create((), dev),
        )

    # ------------------------------------------------------------------
    @torch.no_grad()
    def select_action(self, state: DDPGState, obs: torch.Tensor):
        return state.actor(obs)

    def evaluate_action(self, state: DDPGState, obs: torch.Tensor):
        # evaluation feeds RAW observations; under obs_norm the actor was
        # trained on normalized ones
        if self.cfg.obs_norm:
            obs = state.obs_rms.normalize(obs)
        a = self.select_action(state, obs)
        if not self.dim_info.is_continue:
            return torch.argmax(a, dim=-1)
        return a

    def draw_explore(self, b: int, generator: torch.Generator,
                     ctx: ExploreCtx) -> ExploreDraws:
        di, dev = self.dim_info, self.device
        draws = ExploreDraws()
        if not di.is_continue:
            draws.gumbel = draw_gumbel((b, di.action_dim), generator, dev)
        elif self.cfg.ou_noise:
            draws.ou = torch.randn(b, di.action_dim,
                                   generator=generator, device=dev)
        else:
            draws.normal = torch.randn(b, di.action_dim, generator=generator,
                                       device=dev)
        if ctx.warmup:
            draws.random = draw_random_actions(di, b, generator, dev)
        return draws

    def explore_with(self, state: DDPGState, obs: torch.Tensor,
                     draws: ExploreDraws, ctx: ExploreCtx):
        state, action, _ = self._explore(state, obs, draws, ctx)
        return state, action

    @torch.no_grad()
    def _explore(self, state: DDPGState, obs, draws: ExploreDraws,
                 ctx: ExploreCtx):
        """(state, env action, actor output)."""
        cfg, max_a = self.cfg, self.dim_info.max_action
        out = self.select_action(state, obs)
        if not self.dim_info.is_continue:
            # the softmax actor emits probs, the Gumbel actor logits
            logits = out if cfg.discrete_gumbel else torch.log(out + 1e-8)
            action = categorical_sample(logits, draws.gumbel)
        else:
            scale = noise_scale(cfg, ctx.episodes)
            if cfg.ou_noise:
                state.ou_state = ou_step(cfg, state.ou_state, ctx.done_prev,
                                         draws.ou)
                noise = state.ou_state * scale
            else:
                noise = cfg.gauss_sigma * scale * draws.normal
            action = torch.clamp(out + noise, -max_a, max_a)
        if ctx.warmup:
            action = draws.random
        return state, action, out

    def stored_action_example(self) -> torch.Tensor:
        """Discrete DDPG stores a VECTOR action: the behaviour probs of the
        softmax actor, or the one-hot of the Gumbel actor's action."""
        return torch.zeros(self.dim_info.action_dim, device=self.device)

    def explore_stored(self, state: DDPGState, obs: torch.Tensor,
                       generator: torch.Generator, ctx: ExploreCtx):
        draws = self.draw_explore(obs.shape[0], generator, ctx)
        return self.explore_stored_with(state, obs, draws, ctx)

    def explore_stored_with(self, state: DDPGState, obs: torch.Tensor,
                            draws: ExploreDraws, ctx: ExploreCtx):
        """(state, env action, stored action). Continuous: the same action.
        Discrete: the env acts on a sampled index, the buffer keeps what
        the critic trains on."""
        state, action, out = self._explore(state, obs, draws, ctx)
        if self.dim_info.is_continue:
            return state, action, action
        if self.gumbel:
            stored = F.one_hot(action, self.dim_info.action_dim).to(
                torch.float32)
        else:
            stored = out                                  # behaviour probs
        return state, action, stored

    # ------------------------------------------------------------------
    def process_obs(self, state: DDPGState, next_obs, carry_obs):
        if not self.cfg.obs_norm:
            return state, next_obs, carry_obs
        # global-batch moments under a mesh
        state.obs_rms = state.obs_rms.update(next_obs,
                                             axis_name=self.cfg.axis_name)
        return (state, state.obs_rms.normalize(next_obs),
                state.obs_rms.normalize(carry_obs))

    # ------------------------------------------------------------------
    def draw_update(self, batch: Transition, generator: torch.Generator):
        """The Gumbel noise of the actor loss's ``gumbel_softmax``."""
        if not self.gumbel:
            return None
        return draw_gumbel((batch.obs.shape[0], self.dim_info.action_dim),
                           generator, self.device)

    @torch.no_grad()
    def _rescale_head(self, critic: QCritic, scale, shift) -> None:
        critic.head.weight.mul_(scale)
        critic.head.bias.copy_(critic.head.bias * scale + shift)

    def update(self, state: DDPGState, batch: Transition,
               draws: Optional[torch.Tensor] = None):
        """One learner step, in place. ``draws`` is the (B, A) Gumbel noise
        of the straight-through actor loss under ``discrete_gumbel``, and
        unused otherwise. Returns (state, metrics, None)."""
        cfg, adim = self.cfg, self.dim_info.action_dim
        reward = batch.reward.reshape(-1)
        done = batch.done.reshape(-1)
        if (not self.dim_info.is_continue
                and (batch.action.dim() < 2 or batch.action.shape[-1] != adim)):
            # index-stored batches (direct update() calls); the training
            # loop stores vector actions through explore_stored
            action = F.one_hot(batch.action.reshape(-1).to(torch.int64),
                               adim).to(torch.float32)
        else:
            action = batch.action.reshape(-1, adim)
        if self.gumbel and draws is None:
            raise ValueError("discrete_gumbel's update needs its Gumbel draws")

        # --- critic ----------------------------------------------------
        with torch.no_grad():
            next_action = state.actor_target(batch.next_obs)
            if self.gumbel:
                # target logits -> a deterministic one-hot
                next_action = F.one_hot(torch.argmax(next_action, dim=-1),
                                        adim).to(torch.float32)
            next_q = state.critic_target(batch.next_obs, next_action)
            if cfg.popart:
                next_q = state.popart.denormalize(next_q)
            target = td_target(reward, cfg.gamma, next_q, done)
            if cfg.popart:
                # old target head and old stats above; now adapt, rescale
                # both heads in place, and learn the normalized target
                state.popart, scale, shift = state.popart.adapt(target)
                self._rescale_head(state.critic, scale, shift)
                self._rescale_head(state.critic_target, scale, shift)
                target = state.popart.normalize(target)

        critic_params = list(state.critic.parameters())
        q = state.critic(batch.obs, action)
        critic_loss = torch.mean(torch.square(q - target))
        optimizer_step(state.critic_opt, critic_params, critic_loss,
                       cfg.grad_clip, cfg.axis_name)

        # --- actor (through the updated critic) ------------------------
        actor_params = list(state.actor.parameters())
        a = state.actor(batch.obs)
        if self.gumbel:
            a = gumbel_softmax(a, draws, 1.0, hard=True)
        actor_loss = -torch.mean(state.critic(batch.obs, a))
        optimizer_step(state.actor_opt, actor_params, actor_loss,
                       cfg.grad_clip, cfg.axis_name)

        polyak(state.actor_target.parameters(), actor_params, cfg.tau)
        polyak(state.critic_target.parameters(), critic_params, cfg.tau)
        state.step += 1
        metrics = {"critic_loss": critic_loss.detach(),
                   "actor_loss": actor_loss.detach()}
        return state, metrics, None
