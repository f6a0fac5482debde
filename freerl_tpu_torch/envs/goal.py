"""Goal-conditioned Pendulum for Hindsight Experience Replay (counterpart:
``freerl_tpu/envs/goal.py``).

Pendulum-v1 with a 3-dim goal ``[cos, sin, thdot]`` appended to the
observation (obs_dim 6), a fresh goal per episode (``cos ~ U[0, 1)``,
``sin = sqrt(1 - cos^2)``, ``thdot = 2 * U[0, 1)``), and a sparse reward
from the goal-state distance ``costs = (g_cos - cos)^2 + (g_sin - sin)^2 +
0.1 * (g_w - w)^2``: 0 if ``costs < tolerance`` else -1 (``'her'``), or
``-costs`` (``'shaping'``).

Conventions kept from the reference: the reward of a transition (o, a, o')
comes from the CURRENT observation o, not the successor. The goal draw is
part of the reset draw: ``draw_reset`` returns (n, 4), the Pendulum's
(theta, theta_dot) and the goal's two uniforms. ``achieved``,
``with_goal`` and ``goal_reward`` let ``train/her.py`` relabel goals with
tensor ops.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from freerl_tpu_torch.core import jax_prng
from freerl_tpu_torch.core.types import DimInfo
from freerl_tpu_torch.envs.base import Env
from freerl_tpu_torch.envs.classic import Pendulum, PendulumState


@dataclasses.dataclass
class GoalPendulumState:
    """The Pendulum's state fields, flat (so the auto-reset select works
    field by field), and the goal (B, 3)."""

    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor
    goal: torch.Tensor

    @property
    def inner(self) -> PendulumState:
        return PendulumState(self.theta, self.theta_dot, self.t)


class GoalPendulum(Env):
    """Pendulum-v1 with a per-episode goal appended to the observation."""

    name = "GoalPendulum-v1"
    max_steps = 200
    reward_threshold = None
    goal_dim = 3
    dim_info = DimInfo(obs_dim=6, action_dim=1, is_continue=True,
                       max_action=2.0)

    def __init__(self, reward_mode: str = "her", tolerance: float = 0.5,
                 device="cuda"):
        if reward_mode not in ("her", "shaping"):
            raise ValueError(f"unknown reward_mode {reward_mode!r}")
        super().__init__(device)
        self.reward_mode = reward_mode
        self.tolerance = tolerance
        self._inner = Pendulum(device=device)

    # -- HER hooks ----------------------------------------------------------
    def achieved(self, obs: torch.Tensor) -> torch.Tensor:
        """The achieved goal of an (augmented) observation: its first 3
        dims."""
        return obs[..., : self.goal_dim]

    def with_goal(self, obs: torch.Tensor, goal: torch.Tensor) -> torch.Tensor:
        """Replace the goal slice of an augmented observation."""
        return torch.cat([obs[..., : self.goal_dim], goal], dim=-1)

    def goal_reward(self, goal: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        """The distance between the goal and the CURRENT observation's
        state."""
        cur = obs[..., : self.goal_dim]
        costs = (
            (goal[..., 0] - cur[..., 0]) ** 2
            + (goal[..., 1] - cur[..., 1]) ** 2
            + 0.1 * (goal[..., 2] - cur[..., 2]) ** 2
        )
        if self.reward_mode == "shaping":
            return -costs
        return torch.where(costs < self.tolerance, 0.0, -1.0)

    @staticmethod
    def goal_from_draw(u: torch.Tensor) -> torch.Tensor:
        """The goal (n, 3) from its two uniforms (n, 2) on [0, 1)."""
        costheta = u[:, 0]
        sintheta = torch.sqrt(1.0 - costheta ** 2)
        return torch.stack([costheta, sintheta, 2.0 * u[:, 1]], dim=1)

    # -- Env protocol --------------------------------------------------------
    def draw_reset(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """(n, 4): the Pendulum's reset draw, then the goal's uniforms."""
        inner = self._inner.draw_reset(n, generator)
        u = torch.rand((n, 2), generator=generator, device=self.device)
        return torch.cat([inner, u], dim=1)

    def key_reset_draw(self, key) -> torch.Tensor:
        k_in, k_goal = jax_prng.split(key)
        g1, g2 = jax_prng.split(k_goal)
        u = np.stack([jax_prng.uniform(g, (), 0.0, 1.0) for g in (g1, g2)])
        return torch.cat([self._inner.key_reset_draw(k_in),
                          self._host_draw(u)], dim=1)

    def draw_step(self, n: int, generator: torch.Generator):
        return None

    def key_step_draw(self, keys):
        return None

    def reset(self, draw: torch.Tensor):
        inner, inner_obs = self._inner.reset(draw[:, :2])
        goal = self.goal_from_draw(draw[:, 2:])
        state = GoalPendulumState(inner.theta, inner.theta_dot, inner.t, goal)
        return state, torch.cat([inner_obs, goal], dim=1)

    def observation(self, state: GoalPendulumState) -> torch.Tensor:
        return torch.cat([self._inner.observation(state.inner), state.goal],
                         dim=1)

    def step(self, state: GoalPendulumState, action: torch.Tensor, step_draw):
        obs_now = self.observation(state)
        inner, inner_obs, _, term, trunc = self._inner.step(
            state.inner, action, step_draw)
        reward = self.goal_reward(state.goal, obs_now)
        new = GoalPendulumState(inner.theta, inner.theta_dot, inner.t,
                                state.goal)
        return new, torch.cat([inner_obs, state.goal], dim=1), reward, \
            term, trunc
