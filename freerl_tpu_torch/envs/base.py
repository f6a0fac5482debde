"""Batched environment protocol (counterpart: ``freerl_tpu/envs/base.py``).

An environment is a pair of functions over a dataclass of ``(B, ...)``
state tensors, with every random draw passed in as an argument:

    reset(reset_draw)               -> (state, obs)
    step(state, action, step_draw)  -> (state, obs, reward, terminated, truncated)

``draw_reset(n, generator)`` and ``draw_step(n, generator)`` make those draws
from an explicit ``torch.Generator``, so a test can feed in exactly the
numbers another implementation drew. The functions act on the whole batch
at once; there is no vmap. Termination and truncation stay separate signals
for the ``done`` (bootstrap) vs ``episode_done`` convention.

``FixedResetWrapper`` pins every reset to one draw; ``DisToConWrapper``
puts a discrete action set in front of a continuous-action env.
"""
from __future__ import annotations

import dataclasses

import torch

from freerl_tpu_torch.core.types import DimInfo


class Env:
    """Base class for batched environments. Subclasses hold only static
    configuration and their device; all dynamic state lives in the state
    dataclass."""

    dim_info: DimInfo
    max_steps: int = 1000           # truncation horizon
    reward_threshold: float | None = None
    name: str = "Env"

    def __init__(self, device="cuda"):
        self.device = torch.device(device)

    def reset(self, reset_draw: torch.Tensor):
        raise NotImplementedError

    def step(self, state, action: torch.Tensor, step_draw: torch.Tensor):
        raise NotImplementedError

    def draw_reset(self, n: int, generator: torch.Generator) -> torch.Tensor:
        raise NotImplementedError

    def draw_step(self, n: int, generator: torch.Generator) -> torch.Tensor:
        raise NotImplementedError

    def observation(self, state) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass
class StepOut:
    """Output of an auto-resetting step.

    ``next_obs`` is the TRUE successor observation (pre-reset), which goes
    into replay; ``carry_obs``/``state`` are post-reset and feed the next
    actor step.
    """

    state: object
    carry_obs: torch.Tensor
    next_obs: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor

    @property
    def episode_done(self) -> torch.Tensor:
        return torch.logical_or(self.terminated, self.truncated)


def record_scalarize(env: Env, reward: torch.Tensor) -> torch.Tensor:
    """Scalarize a (possibly vector) step reward for episode records:
    multi-objective envs provide ``record_weights``; scalar rewards pass
    through."""
    if reward.dim() > 1:
        weights = getattr(env, "record_weights", None)
        if weights is None:
            weights = torch.ones(reward.shape[-1])
        return reward @ torch.as_tensor(weights, dtype=torch.float32,
                                        device=reward.device)
    return reward


def _select(mask: torch.Tensor, a, b):
    """Field-wise ``where(mask, a, b)`` over two state dataclasses, with
    ``mask`` of shape (B,) broadcast over trailing dims."""
    def pick(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
        return torch.where(m, x, y)

    return type(a)(**{f.name: pick(getattr(a, f.name), getattr(b, f.name))
                      for f in dataclasses.fields(a)})


def step_auto_reset(env: Env, state, action, step_draw,
                    reset_draw) -> StepOut:
    """Step the batch and, where an episode ended, reset in place: a
    branch-free ``torch.where`` select between the stepped and the reset
    state."""
    new_state, obs, reward, terminated, truncated = env.step(
        state, action, step_draw
    )
    done = torch.logical_or(terminated, truncated)
    reset_state, reset_obs = env.reset(reset_draw)
    return StepOut(
        state=_select(done, reset_state, new_state),
        carry_obs=torch.where(done[:, None], reset_obs, obs),
        next_obs=obs,
        reward=reward,
        terminated=terminated,
        truncated=truncated,
    )


def vec_reset(env: Env, generator: torch.Generator, num_envs: int):
    """Reset a batch of ``num_envs`` independent instances."""
    return env.reset(env.draw_reset(num_envs, generator))


def vec_step_auto_reset(env: Env, state, action, generator: torch.Generator,
                        num_envs: int) -> StepOut:
    """Auto-resetting step of the whole batch, with its draws made from
    ``generator``."""
    step_draw = env.draw_step(num_envs, generator)
    reset_draw = env.draw_reset(num_envs, generator)
    return step_auto_reset(env, state, action, step_draw, reset_draw)


class _Wrapper(Env):
    """An env around another: forwards the protocol and, for anything else,
    attribute reads. Subclasses override what they change."""

    def __init__(self, env: Env):
        super().__init__(env.device)
        self.env = env
        self.dim_info = env.dim_info
        self.max_steps = env.max_steps
        self.reward_threshold = env.reward_threshold
        self.name = env.name

    def __getattr__(self, name):
        if name == "env":                   # not set yet: no recursion
            raise AttributeError(name)
        return getattr(self.env, name)

    def draw_reset(self, n: int, generator: torch.Generator) -> torch.Tensor:
        return self.env.draw_reset(n, generator)

    def draw_step(self, n: int, generator: torch.Generator):
        return self.env.draw_step(n, generator)

    def reset(self, reset_draw: torch.Tensor):
        return self.env.reset(reset_draw)

    def step(self, state, action, step_draw):
        return self.env.step(state, action, step_draw)

    def observation(self, state):
        return self.env.observation(state)


class FixedResetWrapper(_Wrapper):
    """Pin every reset (initial and auto-reset) to one start state: the
    reset draw made once from ``seed``, whatever draw a reset is given.

    The reference resets its env with the same seed every episode during
    single-agent training; with Noisy-net exploration that fixed start is
    load-bearing (see the JAX package's ``FixedResetWrapper``).
    """

    def __init__(self, env: Env, seed: int = 0):
        super().__init__(env)
        generator = torch.Generator(device=env.device).manual_seed(seed)
        self._reset_draw = env.draw_reset(1, generator)

    def reset(self, reset_draw: torch.Tensor):
        n = reset_draw.shape[0]
        pinned = self._reset_draw.expand((n,) + self._reset_draw.shape[1:])
        return self.env.reset(pinned.clone())


class DisToConWrapper(_Wrapper):
    """Expose a continuous-action env through a discrete action set.

    1-D boxes get ``n_bins`` linearly interpolated actions; N-D boxes get
    ``bins_per_dim ** N`` actions decoded base-k per dimension (digit i of
    the action index drives dimension i).
    """

    def __init__(self, env: Env, n_bins: int = 16, bins_per_dim: int = 2):
        inner = env.dim_info
        if not inner.is_continue:
            raise ValueError("DisToConWrapper wraps continuous envs only")
        super().__init__(env)
        self.act_shape = inner.action_dim
        if inner.action_dim == 1:
            self.n_actions = n_bins
            self.bins_per_dim = n_bins
        else:
            self.n_actions = bins_per_dim ** inner.action_dim
            self.bins_per_dim = bins_per_dim
        self.dim_info = DimInfo(
            obs_dim=inner.obs_dim,
            action_dim=self.n_actions,
            is_continue=False,
            max_action=inner.max_action,
        )
        self.name = env.name + f"-dis{self.n_actions}"
        self.low = -inner.max_action
        self.high = inner.max_action

    def to_continuous(self, action: torch.Tensor) -> torch.Tensor:
        """(B,) action indices -> (B, action dims) continuous actions."""
        k = self.bins_per_dim
        action = action.to(torch.int64)
        digits = torch.stack(
            [(action // (k ** i)) % k for i in range(self.act_shape)], dim=-1
        ).to(torch.float32)
        return self.low + digits / (k - 1) * (self.high - self.low)

    def step(self, state, action, step_draw):
        return self.env.step(state, self.to_continuous(action), step_draw)
