"""LunarLander-v2 and LunarLanderContinuous-v2 as a batched rigid-body
simulation on ``(B,)`` tensors (counterpart:
``freerl_tpu/envs/lunar_lander.py``).

The physics is the JAX package's re-derivation of gymnasium's Box2D env:
one rigid hull with two rigidly attached legs, gravity -10, impulse-based
main/side engines with stochastic dispersion, a 2-contact LCP for the leg
normal impulses with a Coulomb friction cone, positional projection out of
the ground, a hard-impact crash and a Box2D-like sleep timer. The same
simplifications apply (flat terrain, no leg joints, no wind).

Every expression keeps the JAX version's order of float operations, so the
two agree to float32 rounding step for step. Every random draw is an
argument: ``reset`` takes the initial force ``f`` of shape (B, 2), uniform
in +-INITIAL_RANDOM; ``step`` takes the engine dispersion ``disp`` of shape
(B, 2), uniform in +-1/SCALE. ``draw_reset``/``draw_step`` make them from a
``torch.Generator``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from freerl_tpu_torch.core import jax_prng
from freerl_tpu_torch.core.types import DimInfo
from freerl_tpu_torch.envs.base import Env

# --- gymnasium constants -------------------------------------------------
FPS = 50.0
DT = 1.0 / FPS
SCALE = 30.0
MAIN_ENGINE_POWER = 13.0
SIDE_ENGINE_POWER = 0.6
INITIAL_RANDOM = 1000.0
LEG_AWAY = 20.0 / SCALE
LEG_DOWN = 18.0 / SCALE
LEG_W, LEG_H = 2.0 / SCALE, 8.0 / SCALE
SIDE_ENGINE_HEIGHT = 14.0 / SCALE
SIDE_ENGINE_AWAY = 12.0 / SCALE
VIEWPORT_W, VIEWPORT_H = 600.0, 400.0
W = VIEWPORT_W / SCALE           # 20
H = VIEWPORT_H / SCALE           # 13.33
HELIPAD_Y = H / 4.0
GRAVITY = -10.0

# hull polygon (body frame, metres): the gym lander shape, density 5
_LANDER_POLY = np.array(
    [(-14, 17), (-17, 0), (-17, -10), (17, -10), (17, 0), (14, 17)],
    np.float64,
) / SCALE
_HULL_DENSITY = 5.0
_LEG_DENSITY = 1.0


def _poly_mass_inertia(poly, density):
    """Area, centroid and moment of inertia of a polygon (about centroid)."""
    x, y = poly[:, 0], poly[:, 1]
    x1, y1 = np.roll(x, -1), np.roll(y, -1)
    cross = x * y1 - x1 * y
    area = 0.5 * np.sum(cross)
    cx = np.sum((x + x1) * cross) / (6 * area)
    cy = np.sum((y + y1) * cross) / (6 * area)
    # second moment about origin
    ix = np.sum(cross * (y**2 + y * y1 + y1**2)) / 12.0
    iy = np.sum(cross * (x**2 + x * x1 + x1**2)) / 12.0
    i_origin = density * (ix + iy)
    mass = density * area
    i_centroid = i_origin - mass * (cx**2 + cy**2)
    return mass, (cx, cy), i_centroid


_HULL_MASS, _HULL_C, _HULL_I = _poly_mass_inertia(_LANDER_POLY, _HULL_DENSITY)
_LEG_MASS = _LEG_DENSITY * LEG_W * LEG_H
# leg tip offsets in body frame: at rest the center sits LEG_DOWN above ground
_LEG_TIPS = np.array(
    [(-LEG_AWAY, -LEG_DOWN), (LEG_AWAY, -LEG_DOWN)], np.float64
)
_MASS = _HULL_MASS + 2 * _LEG_MASS
_INERTIA = _HULL_I + sum(
    _LEG_MASS * (t[0] ** 2 + t[1] ** 2) for t in _LEG_TIPS
)
# hull sample points for crash detection
_HULL_PTS = _LANDER_POLY.copy()


@dataclasses.dataclass
class LanderState:
    """Batched lander state: every field has shape (B,)."""

    x: torch.Tensor
    y: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    angle: torch.Tensor
    omega: torch.Tensor
    leg1: torch.Tensor          # contact flags (float 0/1)
    leg2: torch.Tensor
    prev_shaping: torch.Tensor
    rest_time: torch.Tensor     # seconds below sleep tolerance
    t: torch.Tensor             # int32 step counter


def _shaping(obs):
    return (
        -100.0 * torch.sqrt(obs[:, 0] ** 2 + obs[:, 1] ** 2)
        - 100.0 * torch.sqrt(obs[:, 2] ** 2 + obs[:, 3] ** 2)
        - 100.0 * torch.abs(obs[:, 4])
        + 10.0 * obs[:, 6]
        + 10.0 * obs[:, 7]
    )


class _LunarLanderBase(Env):
    """The physics shared by both action spaces; a subclass maps its
    actions to engine powers in ``_engine_powers``."""

    max_steps = 1000
    reward_threshold = 200.0

    mass = float(_MASS)
    inertia = float(_INERTIA)

    def __init__(self, device="cuda"):
        super().__init__(device)
        tips = torch.as_tensor(_LEG_TIPS, dtype=torch.float32,
                               device=self.device)
        hull = torch.as_tensor(_HULL_PTS, dtype=torch.float32,
                               device=self.device)
        self.tip_x, self.tip_y = tips[:, 0], tips[:, 1]      # (2,)
        self.hull_x, self.hull_y = hull[:, 0], hull[:, 1]    # (6,)

    # ------------------------------------------------------------------
    def draw_reset(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """Initial force f, (n, 2), uniform in +-INITIAL_RANDOM."""
        u = torch.rand((n, 2), generator=generator, device=self.device)
        return u * (2 * INITIAL_RANDOM) - INITIAL_RANDOM

    def key_reset_draw(self, key) -> torch.Tensor:
        k1, _ = jax_prng.split(key)
        return self._host_draw(jax_prng.uniform(
            k1, (2,), -INITIAL_RANDOM, INITIAL_RANDOM))

    def draw_step(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """Engine dispersion, (n, 2), uniform in +-1/SCALE."""
        u = torch.rand((n, 2), generator=generator, device=self.device)
        return (u * 2.0 - 1.0) / SCALE

    def key_step_draw(self, keys) -> torch.Tensor:
        """The JAX lander's dispersion: ``fold_in(key, 7)`` split in two,
        the first half's uniforms in +-1 over SCALE."""
        keys = np.asarray(keys, np.uint32).reshape(-1, 2)
        k1 = jax_prng.split(jax_prng.fold_in(keys, 7))[:, 0]
        return self._host_rows(jax_prng.uniform(k1, (2,), -1.0, 1.0)
                               / np.float32(SCALE))

    # ------------------------------------------------------------------
    def reset(self, f: torch.Tensor):
        n = f.shape[0]
        # gym applies the random force to the center during the first step;
        # equivalently seed the velocity with F/m * dt
        vx = f[:, 0] / self.mass * DT * FPS * DT
        vy = f[:, 1] / self.mass * DT * FPS * DT
        zeros = torch.zeros(n, dtype=torch.float32, device=self.device)
        state = LanderState(
            x=torch.full((n,), W / 2, device=self.device),
            y=torch.full((n,), H, device=self.device),
            vx=vx, vy=vy,
            angle=zeros, omega=zeros, leg1=zeros, leg2=zeros,
            prev_shaping=zeros, rest_time=zeros,
            t=torch.zeros(n, dtype=torch.int32, device=self.device),
        )
        obs = self.observation(state)
        state.prev_shaping = _shaping(obs)
        return state, obs

    def observation(self, state: LanderState) -> torch.Tensor:
        return torch.stack([
            (state.x - W / 2) / (W / 2),
            (state.y - (HELIPAD_Y + LEG_DOWN)) / (H / 2),
            state.vx * (W / 2) / FPS,
            state.vy * (H / 2) / FPS,
            state.angle,
            20.0 * state.omega / FPS,
            state.leg1,
            state.leg2,
        ], dim=1)

    @staticmethod
    def _engine_powers(action):
        """(main power, side power, side direction), each (B,)."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    def step(self, state: LanderState, action: torch.Tensor,
             disp: torch.Tensor):
        m_power, s_power, direction = self._engine_powers(action)
        d0, d1 = disp[:, 0], disp[:, 1]

        sin, cos = torch.sin(state.angle), torch.cos(state.angle)
        tip0, tip1 = sin, cos             # body 'up' axis in world frame
        side0, side1 = -cos, sin

        # main engine: impulse -(ox,oy)*POWER*m_power at offset (ox,oy)
        ox = tip0 * (4.0 / SCALE + 2.0 * d0) + side0 * d1
        oy = -tip1 * (4.0 / SCALE + 2.0 * d0) - side1 * d1
        jx = -ox * MAIN_ENGINE_POWER * m_power
        jy = -oy * MAIN_ENGINE_POWER * m_power
        rx, ry = ox, oy                   # impulse applied at (x+ox, y+oy)
        fx = jx / DT
        fy = float(np.float32(GRAVITY * self.mass)) + jy / DT
        torque = (rx * jy - ry * jx) / DT

        # side engines
        sx = tip0 * d0 + side0 * (3.0 * d1 + direction * SIDE_ENGINE_AWAY)
        sy = -tip1 * d0 - side1 * (3.0 * d1 + direction * SIDE_ENGINE_AWAY)
        jsx = -sx * SIDE_ENGINE_POWER * s_power
        jsy = -sy * SIDE_ENGINE_POWER * s_power
        rsx = sx - tip0 * 17.0 / SCALE
        rsy = sy + tip1 * SIDE_ENGINE_HEIGHT
        fx = fx + jsx / DT
        fy = fy + jsy / DT
        torque = torque + (rsx * jsy - rsy * jsx) / DT

        # semi-implicit Euler
        vx = state.vx + fx / self.mass * DT
        vy = state.vy + fy / self.mass * DT
        omega = state.omega + torque / self.inertia * DT

        # --- leg ground contacts (impulse-based, e=0) ------------------
        # exact 2-contact LCP for the normal impulses, then friction
        # clamped by the Coulomb cone; penetration is corrected
        # positionally below. Leg quantities are (B, 2).
        sin2, cos2 = torch.sin(state.angle), torch.cos(state.angle)
        inv_m = 1.0 / self.mass
        inv_i = 1.0 / self.inertia
        mu = 0.8

        rx = self.tip_x * cos2[:, None] - self.tip_y * sin2[:, None]
        ry = self.tip_x * sin2[:, None] + self.tip_y * cos2[:, None]
        pen = HELIPAD_Y - (state.y[:, None] + ry)
        # slop window keeps resting contacts active across the
        # integrate/project cycle (Box2D linearSlop analogue)
        touch = pen > -0.01
        vpy = vy[:, None] + omega[:, None] * rx
        b = torch.where(touch, -vpy, 0.0)
        rx0, rx1 = rx[:, 0], rx[:, 1]
        b0, b1 = b[:, 0], b[:, 1]
        a00 = inv_m + rx0 * rx0 * inv_i
        a11 = inv_m + rx1 * rx1 * inv_i
        a01 = inv_m + rx0 * rx1 * inv_i
        det = a00 * a11 - a01 * a01
        # candidate: both contacts active
        j0_bb = (b0 * a11 - b1 * a01) / det
        j1_bb = (b1 * a00 - b0 * a01) / det
        # candidates: single contact active
        j0_s = torch.clamp(b0 / a00, min=0.0)
        j1_s = torch.clamp(b1 / a11, min=0.0)
        both_ok = (j0_bb >= 0.0) & (j1_bb >= 0.0)
        j0 = torch.where(both_ok, j0_bb, torch.where(j1_bb < 0.0, j0_s, 0.0))
        j1 = torch.where(both_ok, j1_bb, torch.where(j0_bb < 0.0, j1_s, 0.0))
        vy = vy + (j0 + j1) * inv_m
        omega = omega + (rx0 * j0 + rx1 * j1) * inv_i

        # friction (after normals): zero tangential tip velocity within cone
        jns = torch.stack([j0, j1], dim=1)
        vpx = vx[:, None] - omega[:, None] * ry
        k_t = inv_m + ry * ry * inv_i
        jt = torch.clamp(-vpx / k_t * 0.5, -mu * jns, mu * jns) * touch
        vx = vx + torch.sum(jt, dim=1) * inv_m
        omega = omega - torch.sum(ry * jt, dim=1) * inv_i

        c1 = touch[:, 0].to(torch.float32)
        c2 = touch[:, 1].to(torch.float32)
        # mild angular damping stands in for the leg revolute-joint springs
        touch_any = torch.maximum(c1, c2)
        omega = omega * (1.0 - 0.15 * touch_any)

        x = state.x + vx * DT
        y = state.y + vy * DT
        angle = state.angle + omega * DT

        # positional projection: lift the body out of the ground by the
        # deepest leg penetration (velocity untouched: no energy injection)
        sin3, cos3 = torch.sin(angle), torch.cos(angle)
        tip_ys = (
            y[:, None]
            + self.tip_x * sin3[:, None]
            + self.tip_y * cos3[:, None]
        )
        deepest = torch.amax(HELIPAD_Y - tip_ys, dim=1)
        max_pen = torch.clamp(deepest - 0.005, min=0.0)
        y = y + 0.5 * max_pen

        # --- hull crash check -----------------------------------------
        hpy = (self.hull_x * torch.sin(angle)[:, None]
               + self.hull_y * torch.cos(angle)[:, None])
        hull_low = torch.amin(y[:, None] + hpy, dim=1)
        # crash if the hull reaches the ground, or the touchdown impulse
        # exceeds what the legs can absorb (~1.5 m/s vertical)
        hard_impact = (j0 + j1) > self.mass * 1.5
        body_contact = (hull_low <= HELIPAD_Y) | hard_impact

        new = LanderState(
            x=x, y=y, vx=vx, vy=vy, angle=angle, omega=omega,
            leg1=c1, leg2=c2,
            prev_shaping=state.prev_shaping,
            rest_time=state.rest_time,
            t=state.t + 1,
        )
        obs = self.observation(new)

        shaping = _shaping(obs)
        reward = shaping - state.prev_shaping
        reward = reward - 0.30 * m_power - 0.03 * s_power

        # sleep detection (Box2D: linear tol 0.01 m/s for 0.5 s)
        still = (
            (torch.abs(vx) < 0.05)
            & (torch.abs(vy) < 0.08)
            & (torch.abs(omega) < 0.08)
            & ((c1 + c2) > 0)
        )
        rest_time = torch.where(still, state.rest_time + DT, 0.0)
        landed = rest_time >= 0.5

        game_over = body_contact | (torch.abs(obs[:, 0]) >= 1.0)
        terminated = game_over | landed
        reward = torch.where(game_over, -100.0,
                             torch.where(landed, 100.0, reward))
        truncated = (new.t >= self.max_steps) & ~terminated

        new.prev_shaping = shaping
        new.rest_time = rest_time
        return new, obs, reward, terminated, truncated


class LunarLander(_LunarLanderBase):
    """Discrete: 0 noop, 1 fire left (push right), 2 main, 3 fire right."""

    name = "LunarLander-v2"
    dim_info = DimInfo(obs_dim=8, action_dim=4, is_continue=False)

    @staticmethod
    def _engine_powers(action):
        m_power = (action == 2).to(torch.float32)
        is_side = (action == 1) | (action == 3)
        s_power = is_side.to(torch.float32)
        # gym: direction = action - 2 (1 -> -1 left engine, 3 -> +1 right)
        direction = (action.to(torch.float32) - 2.0) * is_side
        return m_power, s_power, direction


class LunarLanderContinuous(_LunarLanderBase):
    """Continuous, (B, 2) actions clipped to [-1, 1]: a0 is the main
    throttle (off at a0 <= 0, else 50-100% power), a1 the lateral engines
    (off within +-0.5, else the left or right engine at 50-100%)."""

    name = "LunarLanderContinuous-v2"
    dim_info = DimInfo(obs_dim=8, action_dim=2, is_continue=True,
                       max_action=1.0)

    @staticmethod
    def _engine_powers(action):
        a = torch.clamp(action.reshape(-1, 2), -1.0, 1.0)
        a0, a1 = a[:, 0], a[:, 1]
        m_power = torch.where(a0 > 0.0, 0.5 + 0.5 * torch.clamp(a0, 0.0, 1.0),
                              0.0)
        fire_side = torch.abs(a1) > 0.5
        s_power = torch.where(fire_side,
                              torch.clamp(torch.abs(a1), 0.5, 1.0), 0.0)
        direction = torch.sign(a1) * fire_side
        return m_power, s_power, direction
