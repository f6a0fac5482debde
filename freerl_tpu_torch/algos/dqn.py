"""DQN and its trick matrix: Double, Dueling, PER, Noisy, N-step,
Categorical (C51), all on = Rainbow (counterpart:
``freerl_tpu/algos/dqn.py``).

TD backup ``r + gamma^m * max_a Q'(s', a) * (1 - d)``, per-step polyak
tau, Adam(lr 1e-3, eps 1e-8; optax and torch both add eps outside the
square root), MSE loss (IS-weighted under PER, cross-entropy under C51),
the Double-DQN argmax from the online net, C51 with 51 atoms on
[-100, 100]. Pixel observations (``obs_shape``) and a data-parallel axis
(``axis_name``) raise ``NotImplementedError`` rather than being silently
ignored.

Every random draw is an argument or comes from the caller's
``torch.Generator``: ``update`` takes the noise of its three noisy
forwards, ``learn_per`` its stratification uniforms. The learner state is
updated in place and returned, so the call shapes stay those of the JAX
package.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from freerl_tpu_torch.algos.base import ExploreCtx, OffPolicyAlgo
from freerl_tpu_torch.algos.common import c51_project, polyak, td_target
from freerl_tpu_torch.buffers.nstep import (nstep_count, nstep_fold,
                                            nstep_sample_range)
from freerl_tpu_torch.core.types import DimInfo, Transition
from freerl_tpu_torch.nets.mlp import Dense
from freerl_tpu_torch.nets.noisy import NoisyDense, NoisyHeads


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    """Static hyperparameters, with the JAX package's fields and defaults."""

    lr: float = 1e-3
    gamma: float = 0.99
    tau: float = 0.01
    batch_size: int = 256
    hidden: Sequence[int] = (128,)
    buffer_size: int = 1_000_000
    epsilon: float = 0.1
    double: bool = False
    dueling: bool = False
    per: bool = False
    # PER sampling backend: 'cumsum' (inverse CDF over the leaves) or
    # 'tree' (the sum-tree descent, a CUDA kernel on the card)
    per_sampler: str = "cumsum"
    noisy: bool = False
    n_step: int = 1          # >1 enables the N_Step trick
    categorical: bool = False
    n_atoms: int = 51
    v_min: float = -100.0
    v_max: float = 100.0
    obs_shape: Optional[tuple] = None
    conv_arch: str = "small"
    cnn_features: int = 256
    # accepted, and ignored on the uniform path exactly as the JAX
    # package's DQN.make_buffer ignores it (ROADMAP queue C)
    bf16_replay: bool = False
    axis_name: Optional[str] = None

    @property
    def explore_epsilon(self) -> float:
        """Noisy nets replace epsilon-greedy exploration."""
        return 0.0 if self.noisy else self.epsilon


def _check_ported(cfg: DQNConfig) -> None:
    todo = [name for name in ("obs_shape", "axis_name")
            if getattr(cfg, name) is not None]
    if todo:
        raise NotImplementedError(
            f"DQN options {todo} are not ported to freerl_tpu_torch yet "
            "(ROADMAP.md queue A: pixel observations with nets/cnn.py in "
            "slice 6, data parallelism in slice 8)"
        )
    if cfg.per_sampler not in ("tree", "cumsum"):
        raise ValueError(f"unknown per_sampler {cfg.per_sampler!r}")


class QNetwork(NoisyHeads):
    """One module covering all 8 head combinations: (noisy) x (dueling) x
    (C51). The trunk stays plain ``Dense`` under Noisy; the A head is
    created before the V head.

    Plain output: (..., A) Q-values. Categorical output: (..., A, atoms)
    logits. ``forward(x, noise)`` takes one ``(eps_in, eps_out)`` per noisy
    head (A, then V), or None for the noiseless forward.
    """

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (128,),
                 generator: torch.Generator | None = None, device="cuda", *,
                 noisy: bool = False, dueling: bool = False,
                 categorical: bool = False, n_atoms: int = 51):
        super().__init__(obs_dim, hidden, "relu", generator, device)
        self.action_dim, self.n_atoms = action_dim, n_atoms
        self.dueling, self.categorical = dueling, categorical
        per_action = n_atoms if categorical else 1

        def head(features):
            if noisy:
                return NoisyDense(self.trunk_dim, features,
                                  generator=generator, device=device)
            return Dense(self.trunk_dim, features, generator, device)

        self.head = head(action_dim * per_action)
        if dueling:
            self.v_head = head(per_action)
        if noisy:
            self.heads = ("head", "v_head") if dueling else ("head",)

    def forward(self, x: torch.Tensor, noise=None) -> torch.Tensor:
        x = self.trunk(x)
        a = self.head_out("head", x, noise)
        if self.categorical:
            a = a.reshape(x.shape[:-1] + (self.action_dim, self.n_atoms))
        if self.dueling:
            v = self.head_out("v_head", x, noise)
            axis = -1
            if self.categorical:
                v = v.reshape(x.shape[:-1] + (1, self.n_atoms))
                axis = -2
            a = v + a - torch.mean(a, dim=axis, keepdim=True)
        return a


@dataclasses.dataclass
class DQNState:
    net: QNetwork
    target_net: QNetwork
    opt: torch.optim.Adam
    step: int = 0


class DQN(OffPolicyAlgo):
    """DQN: static config in the object, learner state in
    :class:`DQNState`."""

    def __init__(self, dim_info: DimInfo, cfg: DQNConfig = DQNConfig(),
                 device="cuda"):
        if dim_info.is_continue:
            raise ValueError(
                "DQN is discrete-action; wrap continuous envs with "
                "DisToConWrapper (make(..., dis_to_con=True))")
        _check_ported(cfg)
        self.dim_info = dim_info
        self.cfg = cfg
        self.device = torch.device(device)
        if cfg.categorical:
            self.atoms = torch.linspace(cfg.v_min, cfg.v_max, cfg.n_atoms,
                                        device=self.device)

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> DQNState:
        cfg = self.cfg
        net = QNetwork(self.dim_info.obs_dim, self.dim_info.action_dim,
                       tuple(cfg.hidden), generator, self.device,
                       noisy=cfg.noisy, dueling=cfg.dueling,
                       categorical=cfg.categorical, n_atoms=cfg.n_atoms)
        target = copy.deepcopy(net).requires_grad_(False)
        opt = torch.optim.Adam(net.parameters(), lr=cfg.lr, eps=1e-8)
        return DQNState(net=net, target_net=target, opt=opt)

    # ------------------------------------------------------------------
    def q_values(self, net: QNetwork, obs: torch.Tensor,
                 noise=None) -> torch.Tensor:
        """(..., A) Q-values; under C51 the mean of each action's atom
        distribution."""
        out = net(obs, noise)
        if self.cfg.categorical:
            return torch.sum(torch.softmax(out, dim=-1) * self.atoms, dim=-1)
        return out

    @torch.no_grad()
    def select_action(self, state: DQNState, obs: torch.Tensor,
                      generator: torch.Generator | None = None):
        """Greedy (batched) action. Under Noisy with a ``generator``, every
        row draws its own noise: one independent explorer per env, as the
        reference's single env resamples its noise every step."""
        noise = None
        if self.cfg.noisy and generator is not None:
            noise = state.net.draw_noise(generator, rows=obs.shape[0])
        return torch.argmax(self.q_values(state.net, obs, noise), dim=-1)

    def evaluate_action(self, state: DQNState, obs: torch.Tensor):
        return self.select_action(state, obs)

    def draw_update_noise(self, state: DQNState, generator: torch.Generator):
        """The three independent draws of a Noisy update: online, target
        and double forwards."""
        return tuple(state.net.draw_noise(generator) for _ in range(3))

    # ------------------------------------------------------------------
    def update(self, state: DQNState, batch: Transition,
               eff_gamma: Optional[torch.Tensor] = None,
               is_weights: Optional[torch.Tensor] = None,
               noise=None):
        """One learner step, in place. ``noise`` is the (online, target,
        double) triple of :meth:`draw_update_noise` under Noisy; without
        it the noisy heads run noiseless. Returns
        (state, metrics, priorities): |td| per sample, or the per-sample
        cross-entropy under C51."""
        cfg = self.cfg
        gamma = eff_gamma if eff_gamma is not None else cfg.gamma
        w = is_weights if is_weights is not None else 1.0
        n_online, n_target, n_double = noise or (None, None, None)
        action = batch.action.reshape(-1).to(torch.int64)
        reward = batch.reward.reshape(-1)
        done = batch.done.reshape(-1).to(torch.float32)
        bidx = torch.arange(action.shape[0], device=action.device)

        with torch.no_grad():
            if cfg.double:
                next_a = torch.argmax(
                    self.q_values(state.net, batch.next_obs, n_double), -1)
            if cfg.categorical:
                next_probs = torch.softmax(
                    state.target_net(batch.next_obs, n_target), dim=-1)
                if not cfg.double:
                    next_a = torch.argmax(
                        torch.sum(next_probs * self.atoms, dim=-1), dim=-1)
                g = (gamma if isinstance(gamma, torch.Tensor)
                     else torch.full_like(reward, gamma))
                tz = reward[:, None] + (g * (1.0 - done))[:, None] * self.atoms
                proj = c51_project(next_probs[bidx, next_a], tz, self.atoms)
            else:
                next_q = self.q_values(state.target_net, batch.next_obs,
                                       n_target)
                next_v = (next_q[bidx, next_a] if cfg.double
                          else torch.amax(next_q, dim=-1))
                target = td_target(reward, gamma, next_v, done)

        if cfg.categorical:
            out = state.net(batch.obs, n_online)
            logp = F.log_softmax(out, dim=-1)[bidx, action]           # (B, N)
            per_sample = -torch.sum(proj * logp, dim=-1)
            loss = torch.mean(w * per_sample)
        else:
            q = self.q_values(state.net, batch.obs, n_online)[bidx, action]
            td = q - target
            loss = torch.mean(w * torch.square(td))
            per_sample = torch.abs(td)
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        state.opt.step()
        polyak(state.target_net.parameters(), state.net.parameters(),
               cfg.tau)
        state.step += 1
        priorities = per_sample.detach()
        metrics = {"loss": loss.detach(), "td_abs_mean": priorities.mean()}
        return state, metrics, priorities

    # ------------------------------------------------------------------
    # Train-loop adapter (consumed by freerl_tpu_torch.train.loop)
    # ------------------------------------------------------------------
    def make_buffer(self, example: Transition, num_envs: int = 0):
        from freerl_tpu_torch.buffers.per import PERBuffer
        from freerl_tpu_torch.buffers.uniform import ReplayBuffer

        if self.cfg.per:
            # PER rounds capacity to the next power of two itself
            return PERBuffer.create(self.cfg.buffer_size, example,
                                    sampler=self.cfg.per_sampler)
        return ReplayBuffer.create(
            self.cfg.buffer_size, example, add_batch=num_envs
        )

    def explore(self, state: DQNState, obs: torch.Tensor,
                generator: torch.Generator, ctx: ExploreCtx):
        """Epsilon-greedy (or pure noisy-net) exploration, batched:
        uniform-random actions during the ``random_steps`` warmup, then
        epsilon-greedy."""
        b = obs.shape[0]
        greedy = self.select_action(state, obs, generator)
        rand = torch.randint(0, self.dim_info.action_dim, (b,),
                             generator=generator, device=obs.device)
        use_rand = torch.rand(b, generator=generator,
                              device=obs.device) < self.cfg.explore_epsilon
        action = torch.where(use_rand, rand, greedy)
        if ctx.random_steps > 0 and ctx.total_env_steps < ctx.random_steps:
            action = rand
        return state, action

    def learn_step(self, state: DQNState, buffer, generator: torch.Generator,
                   num_envs: int):
        """Sample (uniform or PER, one step or n) + update (+ priority
        write-back). ``num_envs`` is the ring stride between same-env
        successors (see buffers/nstep.py)."""
        cfg = self.cfg
        noise = (self.draw_update_noise(state, generator) if cfg.noisy
                 else None)
        if cfg.per:
            return self.learn_per(state, buffer,
                                  buffer.draw(generator, cfg.batch_size),
                                  num_envs, noise)
        eff_gamma = None
        if cfg.n_step > 1:
            d = torch.randint(
                0, nstep_count(buffer.size, buffer.capacity, num_envs,
                               cfg.n_step),
                (cfg.batch_size,), generator=generator,
                device=buffer.data.obs.device)
            idx = nstep_sample_range(buffer.size, buffer.capacity,
                                     buffer.pos, d)
            batch, eff_gamma = nstep_fold(buffer.data, idx, num_envs,
                                          cfg.n_step, cfg.gamma)
        else:
            batch = buffer.sample(generator, cfg.batch_size)
        state, metrics, _ = self.update(state, batch, eff_gamma, None, noise)
        return state, buffer, metrics

    def learn_per(self, state: DQNState, buffer, r: torch.Tensor,
                  num_envs: int = 1, noise=None):
        """The PER learner step from its stratification uniforms ``r`` (B,):
        sample (and fold n steps from each drawn slot), IS-weighted update,
        priority write-back. The metrics also carry the drawn ``idx`` and
        ``is_weights``."""
        cfg = self.cfg
        idx, w = buffer.sample_idx(r)
        eff_gamma = None
        if cfg.n_step > 1:
            batch, eff_gamma = nstep_fold(buffer.data, idx, num_envs,
                                          cfg.n_step, cfg.gamma)
        else:
            batch = buffer.gather(idx)
        state, metrics, prio = self.update(state, batch, eff_gamma, w, noise)
        buffer.update_priorities(idx, prio)
        return state, buffer, {**metrics, "idx": idx, "is_weights": w}
