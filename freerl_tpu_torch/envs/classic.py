"""Classic-control dynamics as batched step functions on ``(B,)`` tensors
(counterpart: ``freerl_tpu/envs/classic.py``).

The JAX package's re-derivation of gymnasium's CartPole-v1,
MountainCar-v0, MountainCarContinuous-v0 and Pendulum-v1: the same
constants, observations, rewards and termination/truncation rules, float32
throughout, and every expression in the JAX version's order of float
operations. The dynamics are deterministic; the only draws are the
resets', an argument of ``reset`` that ``draw_reset`` makes from a
``torch.Generator``. ``step`` takes a step draw for the protocol's sake and
ignores it (``draw_step`` returns None). Truncation counts only where the
episode did not terminate. Where XLA fuses a multiply and an add of the
JAX version's step into one rounding (Pendulum's), the port rounds once
too (``fma32``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from freerl_tpu_torch.core import jax_prng
from freerl_tpu_torch.core.types import DimInfo
from freerl_tpu_torch.envs.base import Env


def fma32(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded to float32 as a fused multiply-add rounds it
    (``a``, ``b`` float32 tensors or numbers, at least one a tensor; ``c``
    a float32 tensor): the product is exact in float64, and the float64
    sum rounds to the float32 of the exact value bar a float64 sum on a
    float32 tie (one case in about 2^29). Numbers stay kernel arguments:
    no host-to-device copy."""
    def f64(x):
        return x.double() if torch.is_tensor(x) else float(np.float32(x))

    return (f64(a) * f64(b) + c.double()).float()


def _uniform(n, shape, low, high, generator, device):
    u = torch.rand((n,) + shape, generator=generator, device=device)
    return u * (high - low) + low


class _Classic(Env):
    """Deterministic dynamics: no step draw."""

    def draw_step(self, n: int, generator: torch.Generator):
        return None

    def key_step_draw(self, keys):
        return None

    def _t0(self, n: int) -> torch.Tensor:
        return torch.zeros(n, dtype=torch.int32, device=self.device)


# ---------------------------------------------------------------------------
# CartPole-v1
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CartPoleState:
    x: torch.Tensor
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor


class CartPole(_Classic):
    """CartPole-v1: 2 discrete actions, reward 1/step, 500-step truncation."""

    name = "CartPole-v1"
    max_steps = 500
    reward_threshold = 475.0
    dim_info = DimInfo(obs_dim=4, action_dim=2, is_continue=False)

    gravity = 9.8
    masscart = 1.0
    masspole = 0.1
    total_mass = masscart + masspole
    length = 0.5  # half the pole length
    polemass_length = masspole * length
    force_mag = 10.0
    tau = 0.02
    theta_threshold = 12 * 2 * math.pi / 360
    x_threshold = 2.4

    def draw_reset(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """The initial (x, x_dot, theta, theta_dot), (n, 4), U(+-0.05)."""
        return _uniform(n, (4,), -0.05, 0.05, generator, self.device)

    def key_reset_draw(self, key) -> torch.Tensor:
        return self._host_draw(jax_prng.uniform(key, (4,), -0.05, 0.05))

    def reset(self, vals: torch.Tensor):
        state = CartPoleState(vals[:, 0], vals[:, 1], vals[:, 2], vals[:, 3],
                              self._t0(vals.shape[0]))
        return state, self.observation(state)

    def observation(self, state: CartPoleState) -> torch.Tensor:
        return torch.stack([state.x, state.x_dot, state.theta,
                            state.theta_dot], dim=1)

    def step(self, state: CartPoleState, action: torch.Tensor, step_draw):
        force = torch.where(action == 1, self.force_mag, -self.force_mag)
        costheta = torch.cos(state.theta)
        sintheta = torch.sin(state.theta)
        temp = (
            force + self.polemass_length * state.theta_dot**2 * sintheta
        ) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length
            * (4.0 / 3.0 - self.masspole * costheta**2 / self.total_mass)
        )
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass
        # explicit Euler, gymnasium's default integrator
        x = state.x + self.tau * state.x_dot
        x_dot = state.x_dot + self.tau * xacc
        theta = state.theta + self.tau * state.theta_dot
        theta_dot = state.theta_dot + self.tau * thetaacc
        new = CartPoleState(x, x_dot, theta, theta_dot, state.t + 1)
        terminated = ((torch.abs(x) > self.x_threshold)
                      | (torch.abs(theta) > self.theta_threshold))
        truncated = (new.t >= self.max_steps) & ~terminated
        reward = torch.ones_like(x)
        return new, self.observation(new), reward, terminated, truncated


# ---------------------------------------------------------------------------
# MountainCar-v0 / MountainCarContinuous-v0
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class MountainCarState:
    position: torch.Tensor
    velocity: torch.Tensor
    t: torch.Tensor


class _MountainCarBase(_Classic):
    min_position = -1.2
    max_position = 0.6
    max_speed = 0.07

    def draw_reset(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """The initial position, (n,), U(-0.6, -0.4)."""
        return _uniform(n, (), -0.6, -0.4, generator, self.device)

    def key_reset_draw(self, key) -> torch.Tensor:
        return self._host_draw(jax_prng.uniform(key, (), -0.6, -0.4))

    def reset(self, pos: torch.Tensor):
        state = MountainCarState(pos, torch.zeros_like(pos),
                                 self._t0(pos.shape[0]))
        return state, self.observation(state)

    def observation(self, state: MountainCarState) -> torch.Tensor:
        return torch.stack([state.position, state.velocity], dim=1)

    def _move(self, state: MountainCarState, velocity: torch.Tensor):
        """Clip speed and position; a car at the left wall stops."""
        velocity = torch.clamp(velocity, -self.max_speed, self.max_speed)
        position = torch.clamp(state.position + velocity, self.min_position,
                               self.max_position)
        velocity = torch.where(
            (position <= self.min_position) & (velocity < 0), 0.0, velocity)
        return MountainCarState(position, velocity, state.t + 1)


class MountainCar(_MountainCarBase):
    """MountainCar-v0: 3 discrete actions, -1/step, 200-step truncation."""

    name = "MountainCar-v0"
    max_steps = 200
    reward_threshold = -110.0
    dim_info = DimInfo(obs_dim=2, action_dim=3, is_continue=False)

    goal_position = 0.5
    force = 0.001
    gravity = 0.0025

    def step(self, state: MountainCarState, action: torch.Tensor, step_draw):
        new = self._move(state, state.velocity + (
            (action.to(torch.float32) - 1.0) * self.force
            + torch.cos(3 * state.position) * (-self.gravity)
        ))
        terminated = new.position >= self.goal_position
        truncated = (new.t >= self.max_steps) & ~terminated
        reward = torch.full_like(new.position, -1.0)
        return new, self.observation(new), reward, terminated, truncated


class MountainCarContinuous(_MountainCarBase):
    """MountainCarContinuous-v0: 1-D box action in [-1,1], 999-step horizon."""

    name = "MountainCarContinuous-v0"
    max_steps = 999
    reward_threshold = 90.0
    dim_info = DimInfo(obs_dim=2, action_dim=1, is_continue=True,
                       max_action=1.0)

    goal_position = 0.45
    goal_velocity = 0.0
    power = 0.0015

    def step(self, state: MountainCarState, action: torch.Tensor, step_draw):
        force = torch.clamp(action.reshape(-1), -1.0, 1.0)
        new = self._move(state, state.velocity + force * self.power
                         - 0.0025 * torch.cos(3 * state.position))
        terminated = ((new.position >= self.goal_position)
                      & (new.velocity >= self.goal_velocity))
        truncated = (new.t >= self.max_steps) & ~terminated
        reward = torch.where(terminated, 100.0, 0.0) - 0.1 * force**2
        return new, self.observation(new), reward, terminated, truncated


# ---------------------------------------------------------------------------
# Pendulum-v1
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PendulumState:
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor


class Pendulum(_Classic):
    """Pendulum-v1: 1-D torque in [-2,2], cost-based reward, 200-step horizon."""

    name = "Pendulum-v1"
    max_steps = 200
    reward_threshold = None
    dim_info = DimInfo(obs_dim=3, action_dim=1, is_continue=True,
                       max_action=2.0)

    max_speed = 8.0
    max_torque = 2.0
    dt = 0.05
    g = 10.0
    m = 1.0
    l = 1.0  # noqa: E741  (the pendulum's length, gymnasium's name)

    def draw_reset(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """The initial (theta, theta_dot), (n, 2): U(+-pi) and U(+-1)."""
        theta = _uniform(n, (), -math.pi, math.pi, generator, self.device)
        theta_dot = _uniform(n, (), -1.0, 1.0, generator, self.device)
        return torch.stack([theta, theta_dot], dim=1)

    def key_reset_draw(self, key) -> torch.Tensor:
        k1, k2 = jax_prng.split(key)
        return self._host_draw(np.stack([
            jax_prng.uniform(k1, (), -math.pi, math.pi),
            jax_prng.uniform(k2, (), -1.0, 1.0)]))

    def reset(self, vals: torch.Tensor):
        state = PendulumState(vals[:, 0], vals[:, 1], self._t0(vals.shape[0]))
        return state, self.observation(state)

    def observation(self, state: PendulumState) -> torch.Tensor:
        return torch.stack([torch.cos(state.theta), torch.sin(state.theta),
                            state.theta_dot], dim=1)

    def step(self, state: PendulumState, action: torch.Tensor, step_draw):
        u = torch.clamp(action.reshape(-1), -self.max_torque, self.max_torque)
        th, thdot = state.theta, state.theta_dot
        # Python's floor modulo, as jnp's %: torch.remainder, not fmod
        norm_th = torch.remainder(th + math.pi, 2 * math.pi) - math.pi
        # norm_th**2 + 0.1 * thdot**2 + 0.001 * u**2, with XLA's two fusions
        cost = fma32(0.001, u * u, fma32(0.1, thdot * thdot,
                                         norm_th * norm_th))
        # thdot + (3g/2l sin(th) + 3/(ml^2) u) dt, each add fused
        accel = fma32(3 * self.g / (2 * self.l), torch.sin(th),
                      3.0 / (self.m * self.l**2) * u)
        newthdot = fma32(accel, self.dt, thdot)
        newthdot = torch.clamp(newthdot, -self.max_speed, self.max_speed)
        newth = fma32(newthdot, self.dt, th)
        new = PendulumState(newth, newthdot, state.t + 1)
        terminated = torch.zeros_like(newth, dtype=torch.bool)
        truncated = new.t >= self.max_steps
        return new, self.observation(new), -cost, terminated, truncated
