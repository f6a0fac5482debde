"""BipedalWalker-v3 as a batched articulated rigid-body simulation on
``(B, ...)`` tensors (counterpart: ``freerl_tpu/envs/bipedal.py``).

The physics is the JAX package's re-derivation of gym's Box2D walker: a
hull and two 2-segment legs (5 rigid bodies), revolute hips and knees with
speed-limited motors, a random-walk grass terrain, the 24-dim observation
(hull state, joint angles and speeds, foot contacts, 10 lidar rays), the
forward-progress shaping reward with a torque cost, -100 when the hull
touches the ground.

The solver is the JAX version's sequential impulses, step for step: warm
starting from last step's accumulated impulses, 16 velocity iterations
over the 4 joints (motor, limit, point constraint) and the 12 leg-ground
contacts (friction, then normal), then integration and 6 position
iterations. The Gauss-Seidel order is the result, so the solver is
vectorized over envs, and otherwise only where the order cannot show: the
bodies' velocities, spins, positions and angles live in ``(B, 5, ...)``
tensors that each joint or contact update writes through views, in the
JAX order; the left and right legs share no body, so contact ``k`` of the
left leg and ``k + 6`` of the right are solved as one pair, and so are the
two knees (``_GROUPS``, ``_PAIRS``). Every body sees the same sequence of
float operations as in the JAX loop. Terms that do not change within a
phase (lever arms, effective masses, contact normals) are computed once
per phase, with the operations the JAX loop repeats. Masses, inertias and
anchors are Python floats holding the JAX package's float32 values, so
none of them costs a kernel. Expressions keep the JAX version's order of
operations.

Every random draw is an argument: ``reset`` takes ``(B, 210)`` uniforms,
the terrain walk's 200 steps in [-1, 1) and the ``(5, 2)`` spawn noise in
+-1e-3; ``draw_reset`` makes them. The step draws nothing
(``draw_step`` returns None), as the JAX step ignores its key.

On the card, ``step`` and ``reset`` run the hand-written kernels of
``ops/bipedal.py`` (``csrc/bipedal_step.cu``: each a row's whole step or
reset in one thread, one launch for the batch); on the CPU they run the
batched torch code above, ``_step_ref`` and ``_reset_ref``, which is the
kernels' plain version.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from freerl_tpu_torch.core import jax_prng
from freerl_tpu_torch.core.types import DimInfo
from freerl_tpu_torch.envs.base import Env
from freerl_tpu_torch.ops import bipedal as kernels

FPS = 50.0
DT = 1.0 / FPS
SCALE = 30.0
MOTORS_TORQUE = 80.0
SPEED_HIP = 4.0
SPEED_KNEE = 6.0
LIDAR_RANGE = 160.0 / SCALE
FRICTION = 2.5
GRAVITY = -10.0

TERRAIN_STEP = 14.0 / SCALE
TERRAIN_LENGTH = 200
TERRAIN_HEIGHT = 400.0 / SCALE / 4.0
TERRAIN_STARTPAD = 20
TERRAIN_GRASS = 10

HULL_POLY = np.array(
    [(-30, 9), (6, 9), (34, 1), (34, -8), (-30, -8)], np.float64
) / SCALE
LEG_DOWN = -8.0 / SCALE
LEG_W, LEG_H = 8.0 / SCALE, 34.0 / SCALE

VIEWPORT_W, VIEWPORT_H = 600.0, 400.0

HIP_LO, HIP_HI = -0.8, 1.1
KNEE_LO, KNEE_HI = -1.6, -0.1


def _poly_mass_inertia(poly, density):
    x, y = poly[:, 0], poly[:, 1]
    x1, y1 = np.roll(x, -1), np.roll(y, -1)
    cross = x * y1 - x1 * y
    area = 0.5 * abs(np.sum(cross))
    ix = abs(np.sum(cross * (y**2 + y * y1 + y1**2)) / 12.0)
    iy = abs(np.sum(cross * (x**2 + x * x1 + x1**2)) / 12.0)
    return density * area, density * (ix + iy)


def _f32(x):
    """A Python float holding float32(x): the value the JAX package's
    float32 constant arrays hold."""
    return float(np.float32(x))


_HULL_MASS, _HULL_I = _poly_mass_inertia(HULL_POLY, 5.0)
_ULEG_MASS = 1.0 * LEG_W * LEG_H
_ULEG_I = _ULEG_MASS * (LEG_W**2 + LEG_H**2) / 12.0
_LLEG_W = 0.8 * LEG_W
_LLEG_MASS = 1.0 * _LLEG_W * LEG_H
_LLEG_I = _LLEG_MASS * (_LLEG_W**2 + LEG_H**2) / 12.0

# body order: 0 hull, 1 u-leg L, 2 l-leg L, 3 u-leg R, 4 l-leg R
_MASS = np.array([_HULL_MASS, _ULEG_MASS, _LLEG_MASS, _ULEG_MASS, _LLEG_MASS],
                 np.float32)
_INERTIA = np.array([_HULL_I, _ULEG_I, _LLEG_I, _ULEG_I, _LLEG_I], np.float32)
INV_M = [float(np.float32(1.0) / m) for m in _MASS]
INV_I = [float(np.float32(1.0) / i) for i in _INERTIA]

# revolute joints: (body_a, body_b, anchor_a, anchor_b)
_JOINTS = [
    (0, 1, (0.0, LEG_DOWN), (0.0, LEG_H / 2)),     # hip L
    (1, 2, (0.0, -LEG_H / 2), (0.0, LEG_H / 2)),   # knee L
    (0, 3, (0.0, LEG_DOWN), (0.0, LEG_H / 2)),     # hip R
    (3, 4, (0.0, -LEG_H / 2), (0.0, LEG_H / 2)),   # knee R
]
J_A = [j[0] for j in _JOINTS]
J_B = [j[1] for j in _JOINTS]
ANCH_A = [(_f32(j[2][0]), _f32(j[2][1])) for j in _JOINTS]
ANCH_B = [(_f32(j[3][0]), _f32(j[3][1])) for j in _JOINTS]
J_SPEED = [SPEED_HIP, SPEED_KNEE, SPEED_HIP, SPEED_KNEE]
J_LO = [HIP_LO, KNEE_LO, HIP_LO, KNEE_LO]
J_HI = [HIP_HI, KNEE_HI, HIP_HI, KNEE_HI]
# per joint, the f32 sums inv_m[A] + inv_m[B] and inv_i[A] + inv_i[B]
K_M = [_f32(np.float32(INV_M[a]) + np.float32(INV_M[b]))
       for a, b in zip(J_A, J_B)]
K_ANG = [_f32(np.float32(INV_I[a]) + np.float32(INV_I[b]))
         for a, b in zip(J_A, J_B)]

# ground contact points, body frame: the 4 corners of each lower leg and
# the 2 bottom corners of each upper leg (12 points)
_LLEG_CORNERS = [
    (-_LLEG_W / 2, -LEG_H / 2), (_LLEG_W / 2, -LEG_H / 2),
    (-_LLEG_W / 2, LEG_H / 2), (_LLEG_W / 2, LEG_H / 2),
]
_ULEG_BOTTOM = [(-LEG_W / 2, -LEG_H / 2), (LEG_W / 2, -LEG_H / 2)]
FOOT_BODIES = [2] * 4 + [1] * 2 + [4] * 4 + [3] * 2
_FOOT_PTS = np.array(_LLEG_CORNERS + _ULEG_BOTTOM + _LLEG_CORNERS
                     + _ULEG_BOTTOM, np.float32)
N_CONTACT = len(FOOT_BODIES)
_FOOT_L = slice(0, 4)     # lower-leg L corners (obs contact flag)
_FOOT_R = slice(6, 10)    # lower-leg R corners

_LIDAR_SAMPLES = 24
N_DRAW = TERRAIN_LENGTH + 10      # terrain uniforms, then the spawn noise


@dataclasses.dataclass(frozen=True)
class _Group:
    """Joints solved together: ``a``, ``b`` and ``j`` select their bodies
    and joints on a body or joint axis (an int for one joint, a strided
    slice for a pair); the pair shares its masses, inertias and anchors."""

    a: object
    b: object
    j: object
    inv_m_a: float
    inv_m_b: float
    inv_i_a: float
    inv_i_b: float
    k_m: float
    k_ang: float
    anch_a: tuple
    anch_b: tuple


def _group(a, b, j, first: int) -> _Group:
    return _Group(a, b, j, INV_M[J_A[first]], INV_M[J_B[first]],
                  INV_I[J_A[first]], INV_I[J_B[first]], K_M[first],
                  K_ANG[first], ANCH_A[first], ANCH_B[first])


# The JAX solver takes the joints in the order hip L, knee L, hip R,
# knee R. Knee L (bodies 1, 2) and hip R (0, 3) share no body, so they
# commute, and hip L, hip R, then both knees at once (bodies 1, 3 -> 2, 4)
# is the same sequence of float operations on every body.
_GROUPS = (
    _group(0, 1, 0, 0),                                         # hip L
    _group(0, 3, 2, 2),                                         # hip R
    _group(slice(1, None, 2), slice(2, None, 2), slice(1, None, 2), 1),
)


@dataclasses.dataclass(frozen=True)
class _Pair:
    """Contacts ``k`` (left leg) and ``k + 6`` (right leg), selected by
    ``c`` on the contact axis, on the bodies ``body`` selects; the legs
    share no body, so the pair is solved at once, each contact in its
    JAX order on its own leg."""

    c: slice
    body: slice
    inv_m: float
    inv_i: float


_PAIRS = tuple(
    _Pair(slice(k, None, 6), slice(FOOT_BODIES[k], None, 2),
          INV_M[FOOT_BODIES[k]], INV_I[FOOT_BODIES[k]])
    for k in range(N_CONTACT // 2))


def _joint_mass(g: _Group, ra: torch.Tensor, rb: torch.Tensor):
    """The point constraint's effective-mass entries (k11, k22, k12)."""
    k11 = g.k_m + g.inv_i_a * ra[..., 1] ** 2 + g.inv_i_b * rb[..., 1] ** 2
    k22 = g.k_m + g.inv_i_a * ra[..., 0] ** 2 + g.inv_i_b * rb[..., 0] ** 2
    k12 = (-g.inv_i_a * ra[..., 0] * ra[..., 1]
           - g.inv_i_b * rb[..., 0] * rb[..., 1])
    return k11, k22, k12


def _by_joint(per_group: list) -> torch.Tensor:
    """Per-group values (hip L, hip R, knees) back on the joint axis."""
    hip_l, hip_r, knees = per_group
    return torch.stack([hip_l, knees[:, 0], hip_r, knees[:, 1]], dim=1)


def _by_contact(per_pair: list) -> torch.Tensor:
    """Per-pair (B, 2) values back on the contact axis, (B, 12)."""
    return torch.stack(per_pair, dim=2).reshape(per_pair[0].shape[0], -1)


@dataclasses.dataclass
class WalkerState:
    """Batched walker state; B rows."""

    pos: torch.Tensor          # (B, 5, 2)
    vel: torch.Tensor          # (B, 5, 2)
    angle: torch.Tensor        # (B, 5)
    omega: torch.Tensor        # (B, 5)
    terrain: torch.Tensor      # (B, TERRAIN_LENGTH) heights
    prev_shaping: torch.Tensor  # (B,)
    t: torch.Tensor            # (B,) int32
    # warm-start impulse caches, carried across steps
    acc_joint: torch.Tensor    # (B, 4, 2) revolute point impulses
    acc_motor: torch.Tensor    # (B, 4) motor angular impulses
    acc_limit: torch.Tensor    # (B, 4) joint-limit angular impulses
    acc_cn: torch.Tensor       # (B, 12) contact normal impulses
    acc_ct: torch.Tensor       # (B, 12) contact tangent impulses


def _rot(c, s, vx, vy):
    """The rotation by the angle of cosine ``c`` and sine ``s`` of the
    vector (vx, vy), as the JAX ``_rot``: ``(c vx - s vy, s vx + c vy)``."""
    return c * vx - s * vy, s * vx + c * vy


def _cross(r: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Scalar cross ``r0 p1 - r1 p0`` of (..., 2) vectors."""
    return r[..., 0] * p[..., 1] - r[..., 1] * p[..., 0]


def _perp(r: torch.Tensor) -> torch.Tensor:
    """(-r1, r0): ``w * perp(r)`` is the JAX ``stack([-w r1, w r0])`` and
    ``sum(p * perp(r))`` is ``cross(r, p)``, to the bit."""
    return torch.stack([-r[..., 1], r[..., 0]], dim=-1)


def _vec(x, y) -> torch.Tensor:
    return torch.stack([x, y], dim=-1)


class BipedalWalker(Env):
    name = "BipedalWalker-v3"
    max_steps = 1600
    reward_threshold = 300.0
    dim_info = DimInfo(obs_dim=24, action_dim=4, is_continue=True,
                       max_action=1.0)

    def __init__(self, device="cuda"):
        super().__init__(device)
        dev = self.device

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        self.foot_bodies = t(FOOT_BODIES, torch.int64)
        self.foot_x, self.foot_y = t(_FOOT_PTS[:, 0]), t(_FOOT_PTS[:, 1])
        hull = HULL_POLY.astype(np.float32)
        self.hull_x, self.hull_y = t(hull[:, 0]), t(hull[:, 1])
        self.j_a, self.j_b = t(J_A, torch.int64), t(J_B, torch.int64)
        self.j_lo = t(np.float32(J_LO))
        self.j_hi = t(np.float32(J_HI))
        self.j_speed = t(np.float32(J_SPEED))
        self.inv_i_ja = t(np.float32([INV_I[b] for b in J_A]))
        self.inv_i_jb = t(np.float32([INV_I[b] for b in J_B]))
        self.k_ang = t(np.float32(K_ANG))
        self.rel_ref = t([0, 1, 0, 3], torch.int64)  # obs: relative angles
        # lidar: ray i leaves the hull centre at angle 1.5 i / 10 from -y;
        # sample k sits at the fraction (k + 1) / 24 of the range
        self.fr = (torch.arange(_LIDAR_SAMPLES, dtype=torch.float32,
                                device=dev) + 1) / _LIDAR_SAMPLES
        a = 1.5 * torch.arange(10, dtype=torch.float32, device=dev) / 10.0
        dx, dy = torch.sin(a) * LIDAR_RANGE, -torch.cos(a) * LIDAR_RANGE
        self.lidar_dx = (self.fr[None, :] * dx[:, None]).reshape(-1)
        self.lidar_dy = (self.fr[None, :] * dy[:, None]).reshape(-1)
        init_x = TERRAIN_STEP * TERRAIN_STARTPAD / 2.0
        init_y = TERRAIN_HEIGHT + 2.0 * LEG_H - LEG_DOWN + 0.02
        self.spawn_pos = t(np.array([
            [init_x, init_y],
            [init_x, init_y + LEG_DOWN - LEG_H / 2],
            [init_x, init_y + LEG_DOWN - 1.5 * LEG_H],
            [init_x, init_y + LEG_DOWN - LEG_H / 2],
            [init_x, init_y + LEG_DOWN - 1.5 * LEG_H],
        ], np.float32))
        self.spawn_angle = t(np.float32([0.0, 0.05, 0.05, -0.05, -0.05]))
        self.gravity_dt = t(np.float32([0.0, GRAVITY]) * np.float32(DT))

    # ------------------------------------------------------------------
    def draw_reset(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """(n, 210): the terrain walk's uniforms in [-1, 1), then the
        (5, 2) spawn noise in +-1e-3."""
        u = torch.rand((n, N_DRAW), generator=generator, device=self.device)
        return torch.cat([u[:, :TERRAIN_LENGTH] * 2.0 - 1.0,
                          u[:, TERRAIN_LENGTH:] * 2e-3 - 1e-3], dim=1)

    def key_reset_draw(self, key) -> torch.Tensor:
        """The JAX walker's key chain: one split a terrain step, then the
        spawn noise from the reset key's second half."""
        k, k_n = jax_prng.split(key)
        us = []
        for _ in range(TERRAIN_LENGTH):
            k, kr = jax_prng.split(k)
            us.append(jax_prng.uniform(kr, (), -1.0, 1.0))
        noise = jax_prng.uniform(k_n, (5, 2), -1e-3, 1e-3)
        return self._host_draw(np.concatenate([np.stack(us),
                                               noise.reshape(-1)]))

    def draw_step(self, n: int, generator: torch.Generator):
        return None

    def key_step_draw(self, keys):
        return None

    def _gen_terrain(self, u: torch.Tensor) -> torch.Tensor:
        """Grass-only random walk (gym _generate_terrain, GRASS state): a
        sequential 200-step loop over the batch."""
        rnd = u / SCALE
        y = torch.full((u.shape[0],), TERRAIN_HEIGHT, device=u.device)
        vel = torch.zeros_like(y)
        ys = []
        for i in range(TERRAIN_LENGTH):
            vel = 0.8 * vel + 0.01 * torch.sign(TERRAIN_HEIGHT - y)
            if i > TERRAIN_STARTPAD:
                vel = vel + rnd[:, i]
            y = y + vel
            ys.append(y)
        return torch.stack(ys, dim=1)

    @staticmethod
    def _segment(x: torch.Tensor):
        """The terrain segment under x: (index, fraction along it)."""
        fx = torch.clamp(x / TERRAIN_STEP, 0.0, TERRAIN_LENGTH - 1.001)
        fi = torch.floor(fx)
        return fi.to(torch.int64), fx - fi

    def _terrain_height(self, terrain, x):
        """Piecewise-linear height lookup, x of shape (B, k): a per-row
        gather on the (B, 200) terrain."""
        i, frac = self._segment(x)
        h0 = torch.gather(terrain, 1, i)
        h1 = torch.gather(terrain, 1, i + 1)
        return h0 * (1 - frac) + h1 * frac

    def _terrain_normal(self, terrain, x):
        """Unit surface normals of the segments under x (B, k): (B, k, 2)."""
        i, _ = self._segment(x)
        dy = torch.gather(terrain, 1, i + 1) - torch.gather(terrain, 1, i)
        n = torch.stack([-dy, torch.full_like(dy, TERRAIN_STEP)], dim=-1)
        return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)

    def _foot_contacts(self, pos, angle, terrain):
        """World positions (B, 12, 2) of the contact points, and their
        separation from the ground (B, 12); negative is penetrating."""
        b = self.foot_bodies
        ang = angle[:, b]
        wx, wy = _rot(torch.cos(ang), torch.sin(ang), self.foot_x,
                      self.foot_y)
        world = pos[:, b] + torch.stack([wx, wy], dim=-1)
        sep = world[..., 1] - self._terrain_height(terrain, world[..., 0])
        return world, sep

    # ------------------------------------------------------------------
    def reset(self, draw: torch.Tensor):
        """The plain version for a CPU draw, the kernel K3 for a CUDA one."""
        return kernels.reset(self, draw)

    def step(self, state: WalkerState, action: torch.Tensor, step_draw=None):
        """The plain version for CPU tensors, the kernel K2 for CUDA ones."""
        return kernels.step(self, state, action)

    def _reset_ref(self, draw: torch.Tensor):
        n = draw.shape[0]
        dev = self.device
        terrain = self._gen_terrain(draw[:, :TERRAIN_LENGTH])
        pos = self.spawn_pos + draw[:, TERRAIN_LENGTH:].reshape(n, 5, 2)
        zeros = lambda *shape: torch.zeros((n,) + shape, device=dev)  # noqa: E731
        state = WalkerState(
            pos=pos, vel=zeros(5, 2),
            angle=self.spawn_angle.expand(n, 5).clone(), omega=zeros(5),
            terrain=terrain, prev_shaping=zeros(),
            t=torch.zeros(n, dtype=torch.int32, device=dev),
            acc_joint=zeros(4, 2), acc_motor=zeros(4), acc_limit=zeros(4),
            acc_cn=zeros(N_CONTACT), acc_ct=zeros(N_CONTACT),
        )
        obs = self.observation(state)
        state.prev_shaping = (130.0 * state.pos[:, 0, 0] / SCALE
                              - 5.0 * torch.abs(state.angle[:, 0]))
        return state, obs

    def observation(self, state: WalkerState) -> torch.Tensor:
        angle, omega, vel = state.angle, state.omega, state.vel
        rel = angle[:, 1:] - angle[:, self.rel_ref]
        rel_w = omega[:, 1:] - omega[:, self.rel_ref]
        _, sep = self._foot_contacts(state.pos, angle, state.terrain)
        c_l = torch.any(sep[:, _FOOT_L] < 0.01, dim=1).to(torch.float32)
        c_r = torch.any(sep[:, _FOOT_R] < 0.01, dim=1).to(torch.float32)

        # lidar: the first sample of each ray at or below the ground
        px = state.pos[:, 0, 0:1] + self.lidar_dx
        py = state.pos[:, 0, 1:2] + self.lidar_dy
        below = (py <= self._terrain_height(state.terrain, px)).reshape(
            -1, 10, _LIDAR_SAMPLES)
        first = torch.argmax(below.to(torch.uint8), dim=-1)
        lidar = torch.where(torch.any(below, dim=-1), self.fr[first], 1.0)
        return torch.cat([
            torch.stack([
                angle[:, 0],
                2.0 * omega[:, 0] / FPS,
                0.3 * vel[:, 0, 0] * (VIEWPORT_W / SCALE) / FPS,
                0.3 * vel[:, 0, 1] * (VIEWPORT_H / SCALE) / FPS,
                rel[:, 0], rel_w[:, 0] / SPEED_HIP,
                rel[:, 1], rel_w[:, 1] / SPEED_KNEE,
                c_l,
                rel[:, 2], rel_w[:, 2] / SPEED_HIP,
                rel[:, 3], rel_w[:, 3] / SPEED_KNEE,
                c_r,
            ], dim=1),
            lidar,
        ], dim=1)

    # ------------------------------------------------------------------
    def _step_ref(self, state: WalkerState, action: torch.Tensor,
                  step_draw=None):
        """One 1/50 s step of the whole batch: warm start, 16 velocity
        iterations, integration, 6 position iterations, in the JAX
        version's Gauss-Seidel order (see ``_GROUPS`` and ``_PAIRS`` for
        the pairs solved together)."""
        n = state.pos.shape[0]
        a = torch.clamp(action.reshape(n, 4), -1.0, 1.0)
        terrain = state.terrain

        # the bodies' velocities and spins; every update below writes into
        # these two tensors through views
        vel = state.vel + self.gravity_dt                    # (B, 5, 2)
        omega = state.omega.clone()                          # (B, 5)
        cos, sin = torch.cos(state.angle), torch.sin(state.angle)
        ra = [_vec(*_rot(cos[:, g.a], sin[:, g.a], *g.anch_a)) for g in _GROUPS]
        rb = [_vec(*_rot(cos[:, g.b], sin[:, g.b], *g.anch_b)) for g in _GROUPS]
        motor_speed = self.j_speed * torch.sign(a)
        max_imp = MOTORS_TORQUE * torch.abs(a) * DT
        neg_max_imp = -max_imp

        world, sep0 = self._foot_contacts(state.pos, state.angle, terrain)
        touching = sep0 < 0.005
        touch_f = touching.to(torch.float32)
        rf = world - state.pos[:, self.foot_bodies]          # (B, 12, 2)
        cn = self._terrain_normal(terrain, world[..., 0])    # (B, 12, 2)
        ct = torch.stack([cn[..., 1], -cn[..., 0]], dim=-1)

        rel0 = state.angle[:, self.j_b] - state.angle[:, self.j_a]
        at_lo = rel0 <= self.j_lo
        at_hi = rel0 >= self.j_hi
        limit_on = at_lo | at_hi
        # the limit's clamp: >= 0 at the lower stop, <= 0 at the upper
        lim_min = torch.where(at_lo, 0.0, -torch.inf)
        lim_max = torch.where(at_hi, 0.0, torch.inf)

        # -- warm start: re-apply last step's impulses -------------------
        acc_l = torch.where(limit_on, state.acc_limit, 0.0)
        acc_n = torch.where(touching, state.acc_cn, 0.0)
        acc_t = torch.where(touching, state.acc_ct, 0.0)
        accJ = [state.acc_joint[:, g.j] for g in _GROUPS]
        accM = [state.acc_motor[:, g.j] for g in _GROUPS]
        accL = [acc_l[:, g.j] for g in _GROUPS]
        accN = [acc_n[:, q.c] for q in _PAIRS]
        accT = [acc_t[:, q.c] for q in _PAIRS]
        for i, g in enumerate(_GROUPS):
            p = accJ[i]
            ang = accM[i] + accL[i]
            vel[:, g.a].sub_(p * g.inv_m_a)
            vel[:, g.b].add_(p * g.inv_m_b)
            omega[:, g.a].sub_((_cross(ra[i], p) + ang) * g.inv_i_a)
            omega[:, g.b].add_((_cross(rb[i], p) + ang) * g.inv_i_b)
        for k, q in enumerate(_PAIRS):
            p = (accN[k][..., None] * cn[:, q.c]
                 + accT[k][..., None] * ct[:, q.c])
            vel[:, q.body].add_(p * q.inv_m)
            omega[:, q.body].add_(_cross(rf[:, q.c], p) * q.inv_i)

        # -- what the velocity iterations hold fixed ---------------------
        perp_ra = [_perp(r) for r in ra]
        perp_rb = [_perp(r) for r in rb]
        # the point constraint's impulse p = (kx * c0 + ky * c1) / det is
        # the JAX -(k22 c0 - k12 c1) / det, -(-k12 c0 + k11 c1) / det
        kx, ky, det = [], [], []
        for i, g in enumerate(_GROUPS):
            k11, k22, k12 = _joint_mass(g, ra[i], rb[i])
            det.append((k11 * k22 - k12 * k12)[..., None])
            kx.append(_vec(-k22, k12))
            ky.append(_vec(k12, -k11))
        r_c = [rf[:, q.c] for q in _PAIRS]
        n_c = [cn[:, q.c] for q in _PAIRS]
        t_c = [ct[:, q.c] for q in _PAIRS]
        tf_c = [touch_f[:, q.c] for q in _PAIRS]
        perp_rc = [_perp(r) for r in r_c]
        k_t = [q.inv_m + q.inv_i * _cross(r_c[k], t_c[k]) ** 2
               for k, q in enumerate(_PAIRS)]
        k_n = [q.inv_m + q.inv_i * _cross(r_c[k], n_c[k]) ** 2
               for k, q in enumerate(_PAIRS)]
        joint_w = [(omega[:, g.a], omega[:, g.b]) for g in _GROUPS]
        joint_v = [(vel[:, g.a], vel[:, g.b]) for g in _GROUPS]
        joint_lim = [(motor_speed[:, g.j], neg_max_imp[:, g.j],
                      max_imp[:, g.j], limit_on[:, g.j], lim_min[:, g.j],
                      lim_max[:, g.j]) for g in _GROUPS]
        pair_vw = [(vel[:, q.body], omega[:, q.body]) for q in _PAIRS]

        # -- velocity iterations with accumulated-impulse clamping ------
        for _ in range(16):
            for i, g in enumerate(_GROUPS):
                w_a, w_b = joint_w[i]
                speed, lo, hi, on, l_min, l_max = joint_lim[i]
                # motor
                rel_w = w_b - w_a
                new = torch.clamp(accM[i] + (speed - rel_w) / g.k_ang, lo, hi)
                d = new - accM[i]
                accM[i] = new
                w_a.sub_(d * g.inv_i_a)
                w_b.add_(d * g.inv_i_b)
                # joint limit hard stop
                rel_w = w_b - w_a
                raw = accL[i] - rel_w / g.k_ang
                new = torch.where(on, torch.clamp(raw, l_min, l_max), 0.0)
                d = new - accL[i]
                accL[i] = new
                w_a.sub_(d * g.inv_i_a)
                w_b.add_(d * g.inv_i_b)
            for i, g in enumerate(_GROUPS):
                (v_a, v_b), (w_a, w_b) = joint_v[i], joint_w[i]
                c_dot = ((v_b + w_b[..., None] * perp_rb[i])
                         - (v_a + w_a[..., None] * perp_ra[i]))
                p = (kx[i] * c_dot[..., 0:1] + ky[i] * c_dot[..., 1:2]) / det[i]
                accJ[i] = accJ[i] + p
                v_a.sub_(p * g.inv_m_a)
                v_b.add_(p * g.inv_m_b)
                w_a.sub_(torch.sum(p * perp_ra[i], -1) * g.inv_i_a)
                w_b.add_(torch.sum(p * perp_rb[i], -1) * g.inv_i_b)
            for k, q in enumerate(_PAIRS):
                v, w = pair_vw[k]
                # friction first (Box2D order), bounded by mu * acc normal
                vp = v + w[..., None] * perp_rc[k]
                max_f = FRICTION * accN[k]
                new = torch.clamp(
                    accT[k] - torch.sum(vp * t_c[k], -1) / k_t[k],
                    -max_f, max_f) * tf_c[k]
                d = new - accT[k]
                accT[k] = new
                p = d[..., None] * t_c[k]
                v.add_(p * q.inv_m)
                w.add_(torch.sum(p * perp_rc[k], -1) * q.inv_i)
                # normal: accumulated >= 0
                vp = v + w[..., None] * perp_rc[k]
                new = torch.clamp(
                    accN[k] - torch.sum(vp * n_c[k], -1) / k_n[k],
                    min=0.0) * tf_c[k]
                d = new - accN[k]
                accN[k] = new
                p = d[..., None] * n_c[k]
                v.add_(p * q.inv_m)
                w.add_(torch.sum(p * perp_rc[k], -1) * q.inv_i)

        pos = state.pos + vel * DT
        angle = state.angle + omega * DT

        # -- position phase: nonlinear Gauss-Seidel, angular-aware ------
        for _ in range(6):
            for g in _GROUPS:
                ra2 = _vec(*_rot(torch.cos(angle[:, g.a]),
                                 torch.sin(angle[:, g.a]), *g.anch_a))
                rb2 = _vec(*_rot(torch.cos(angle[:, g.b]),
                                 torch.sin(angle[:, g.b]), *g.anch_b))
                C = (pos[:, g.b] + rb2) - (pos[:, g.a] + ra2)
                norm = torch.linalg.vector_norm(C, dim=-1, keepdim=True)
                C = C * torch.clamp(norm, max=0.2) / torch.clamp(norm, min=1e-9)
                k11, k22, k12 = _joint_mass(g, ra2, rb2)
                p = (_vec(-k22, k12) * C[..., 0:1]
                     + _vec(k12, -k11) * C[..., 1:2]) / (
                         k11 * k22 - k12 * k12)[..., None]
                pos[:, g.a].sub_(p * g.inv_m_a)
                pos[:, g.b].add_(p * g.inv_m_b)
                angle[:, g.a].sub_(_cross(ra2, p) * g.inv_i_a)
                angle[:, g.b].add_(_cross(rb2, p) * g.inv_i_b)
            # joint limit position correction, inertia-weighted: all four
            # from the same angles, then added in joint order (the hull,
            # body 0, takes hip L's before hip R's)
            rel = angle[:, self.j_b] - angle[:, self.j_a]
            viol = torch.clamp(rel, self.j_lo, self.j_hi) - rel
            viol = torch.clamp(viol, -0.14, 0.14)
            corr_a = -viol * self.inv_i_ja / self.k_ang
            corr_b = viol * self.inv_i_jb / self.k_ang
            angle[:, 0:2].add_(corr_a[:, 0:2])    # hip L on 0, knee L on 1
            angle[:, 0::3].add_(corr_a[:, 2:4])   # hip R on 0, knee R on 3
            angle[:, 1:].add_(corr_b)
            # foot-ground penetration, angular-aware push-out
            wf, sep = self._foot_contacts(pos, angle, terrain)
            nrm = self._terrain_normal(terrain, wf[..., 0])
            push = torch.clamp(0.2 * (sep + 0.005), -0.2, 0.0)
            for q in _PAIRS:
                r = wf[:, q.c] - pos[:, q.body]
                nc = nrm[:, q.c]
                k_nc = q.inv_m + q.inv_i * _cross(r, nc) ** 2
                p = (-push[:, q.c] / k_nc)[..., None] * nc
                pos[:, q.body].add_(p * q.inv_m)
                angle[:, q.body].add_(_cross(r, p) * q.inv_i)

        new = WalkerState(
            pos=pos, vel=vel, angle=angle, omega=omega, terrain=terrain,
            prev_shaping=state.prev_shaping, t=state.t + 1,
            acc_joint=_by_joint(accJ), acc_motor=_by_joint(accM),
            acc_limit=_by_joint(accL),
            acc_cn=_by_contact(accN), acc_ct=_by_contact(accT),
        )
        obs = self.observation(new)

        shaping = 130.0 * pos[:, 0, 0] / SCALE - 5.0 * torch.abs(angle[:, 0])
        reward = shaping - state.prev_shaping
        reward = reward - torch.sum(0.00035 * MOTORS_TORQUE * torch.abs(a),
                                    dim=1)

        # hull-ground contact => crash
        hx, hy = _rot(torch.cos(angle[:, 0:1]), torch.sin(angle[:, 0:1]),
                      self.hull_x, self.hull_y)
        hx = pos[:, 0, 0:1] + hx
        hy = pos[:, 0, 1:2] + hy
        game_over = torch.any(hy <= self._terrain_height(terrain, hx), dim=1)
        finished = pos[:, 0, 0] > (
            (TERRAIN_LENGTH - TERRAIN_GRASS) * TERRAIN_STEP)
        terminated = game_over | finished
        reward = torch.where(game_over, -100.0, reward)
        truncated = (new.t >= self.max_steps) & ~terminated
        new.prev_shaping = shaping
        return new, obs, reward, terminated, truncated
