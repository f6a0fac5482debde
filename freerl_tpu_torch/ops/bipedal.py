"""BipedalWalker's step and reset as CUDA kernels (``csrc/bipedal_step.cu``:
K2 ``bipedal_step``, K3 ``bipedal_reset``), their wrappers, and the
geometry buffer they read.

Neither replaces a TPU kernel: the JAX package's walker
(``freerl_tpu/envs/bipedal.py``) is plain XLA, which fuses its step into
one program. The port's plain version, ``BipedalWalker._step_ref`` and
``_reset_ref`` (``envs/bipedal.py``), issues some 9,500 small kernels a
step; each kernel here does a row's whole step or reset in one thread.

``step`` and ``reset`` take the plain version for CPU tensors and the
kernel for CUDA tensors; there is no fallback between the two.
``step_launches`` and ``reset_launches`` count the kernels' launches, so a
run can show that its path went through them.

The kernels hard-code the walker's topology and none of its mass
properties: ``pack_geometry`` packs the anchors, inverse masses and
inertias, joint limits and speeds, foot and hull points, lidar offsets,
spawn state and step scalars from the plain version's own tables
(``_GROUPS``, ``_PAIRS``, the env's tensors, the module constants) into one
float32 buffer laid out as ``GEOM_SECTIONS`` says, the layout the CUDA
source's ``kGeom*`` offsets name.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from freerl_tpu_torch.ops import _build

step_launches = 0
reset_launches = 0

# per joint (hip L, knee L, hip R, knee R): the constants of the _GROUPS
# entry that solves it, then the joint's own speed, limits, inertias and
# k_ang (the plain version's per-joint tensors)
JOINT_FIELDS = ("anch_ax", "anch_ay", "anch_bx", "anch_by", "inv_m_a",
                "inv_m_b", "inv_i_a", "inv_i_b", "k_m", "k_ang", "speed",
                "lo", "hi", "inv_i_ja", "inv_i_jb", "k_ang_j")
# per contact: its foot point (body frame) and its _PAIRS entry's inverse
# mass and inertia
CONTACT_FIELDS = ("foot_x", "foot_y", "inv_m", "inv_i")
# the Python scalars of the plain version's step and reset, as float32
SCALARS = ("gravity_dt_x", "gravity_dt_y", "dt", "terrain_step",
           "terrain_height", "seg_max", "finish_x", "torque_cost", "view_x",
           "view_y")
GEOM_SECTIONS = (("joints", 4 * len(JOINT_FIELDS)),
                 ("contacts", 12 * len(CONTACT_FIELDS)),
                 ("hull", 10), ("lidar_dx", 240), ("lidar_dy", 240),
                 ("lidar_fr", 24), ("spawn_pos", 10), ("spawn_angle", 5),
                 ("scalars", len(SCALARS)))
GEOM_SIZE = sum(n for _, n in GEOM_SECTIONS)

# the kernels' outputs: contiguous fields of one float32 buffer, in order,
# each (B,) + shape
STEP_OUT = (("pos", (5, 2)), ("vel", (5, 2)), ("angle", (5,)),
            ("omega", (5,)), ("prev_shaping", ()), ("acc_joint", (4, 2)),
            ("acc_motor", (4,)), ("acc_limit", (4,)), ("acc_cn", (12,)),
            ("acc_ct", (12,)), ("obs", (24,)), ("reward", ()))
RESET_OUT = (("terrain", (200,)),) + STEP_OUT[:-1]
# float operations a row, as the CUDA source counts them (``kStepOps``,
# ``kResetOps``, ``kLidarSampleOps``, section by section there): K2's step
# but its lidar, K3's reset but its lidar, and each lidar sample a row's
# data needs
STEP_OPS, RESET_OPS, LIDAR_SAMPLE_OPS = 20_262, 1_771, 13


def _size(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


def section_offset(name: str) -> int:
    """Where a section of ``GEOM_SECTIONS`` starts in the buffer."""
    off = 0
    for sec, n in GEOM_SECTIONS:
        if sec == name:
            return off
        off += n
    raise KeyError(name)


def out_offsets(layout) -> dict:
    """Each field's offset in units of B, and ``'total'``."""
    out, off = {}, 0
    for name, shape in layout:
        out[name] = off
        off += _size(shape)
    out["total"] = off
    return out


def pack_geometry(env) -> np.ndarray:
    """The geometry buffer of ``env`` (a ``BipedalWalker``), float32
    ``(GEOM_SIZE,)``, from its own tables."""
    from freerl_tpu_torch.envs import bipedal as w

    def host(t):
        return t.detach().cpu().numpy().astype(np.float32).reshape(-1)

    # the group that solves each joint
    group_of = {0: w._GROUPS[0], 2: w._GROUPS[1], 1: w._GROUPS[2],
                3: w._GROUPS[2]}
    speed, lo, hi = host(env.j_speed), host(env.j_lo), host(env.j_hi)
    ija, ijb, kang = host(env.inv_i_ja), host(env.inv_i_jb), host(env.k_ang)
    joints = []
    for j in range(4):
        g = group_of[j]
        joints.append([*g.anch_a, *g.anch_b, g.inv_m_a, g.inv_m_b, g.inv_i_a,
                       g.inv_i_b, g.k_m, g.k_ang, speed[j], lo[j], hi[j],
                       ija[j], ijb[j], kang[j]])
    fx, fy = host(env.foot_x), host(env.foot_y)
    contacts = [[fx[c], fy[c], w._PAIRS[c % 6].inv_m, w._PAIRS[c % 6].inv_i]
                for c in range(w.N_CONTACT)]
    hull = np.stack([host(env.hull_x), host(env.hull_y)], 1)
    grav = host(env.gravity_dt)
    scalars = [grav[0], grav[1], w.DT, w.TERRAIN_STEP, w.TERRAIN_HEIGHT,
               w.TERRAIN_LENGTH - 1.001,
               (w.TERRAIN_LENGTH - w.TERRAIN_GRASS) * w.TERRAIN_STEP,
               0.00035 * w.MOTORS_TORQUE, w.VIEWPORT_W / w.SCALE,
               w.VIEWPORT_H / w.SCALE]
    parts = dict(joints=joints, contacts=contacts, hull=hull,
                 lidar_dx=host(env.lidar_dx), lidar_dy=host(env.lidar_dy),
                 lidar_fr=host(env.fr), spawn_pos=host(env.spawn_pos),
                 spawn_angle=host(env.spawn_angle), scalars=scalars)
    out = np.concatenate([np.asarray(parts[name], np.float32).reshape(-1)
                          for name, _ in GEOM_SECTIONS])
    assert out.shape == (GEOM_SIZE,), out.shape
    return out


def geometry(env, device: torch.device) -> torch.Tensor:
    """``pack_geometry(env)`` on ``device``, made once per env and
    device."""
    cache = env.__dict__.setdefault("_geom", {})
    if device not in cache:
        cache[device] = torch.from_numpy(pack_geometry(env)).to(device)
    return cache[device]


_fns = None   # the kernels' C entry points, resolved on first use


def _resolve():
    """Build or load the library once, check its layout against this
    module's and cache its entry points with their argument types."""
    global _fns
    lib = _build.load("bipedal_step")
    sizes = (lib.bipedal_geom_size(), lib.bipedal_step_floats(),
             lib.bipedal_reset_floats(), lib.bipedal_step_ops(),
             lib.bipedal_reset_ops(), lib.bipedal_lidar_sample_ops())
    want = (GEOM_SIZE, out_offsets(STEP_OUT)["total"],
            out_offsets(RESET_OUT)["total"], STEP_OPS, RESET_OPS,
            LIDAR_SAMPLE_OPS)
    if sizes != want:
        raise RuntimeError(f"bipedal_step.cu's layout and operation counts "
                           f"{sizes} are not ops/bipedal.py's {want}")
    p, i = ctypes.c_void_p, ctypes.c_int
    step = lib.bipedal_step_launch
    step.argtypes = [p] * 18 + [i, i, p]
    step.restype = i
    reset = lib.bipedal_reset_launch
    reset.argtypes = [p, p, p, p, i, p]
    reset.restype = i
    floor = lib.bipedal_floor_launch
    floor.argtypes = [i, p]
    floor.restype = i
    _fns = (step, reset, floor)
    return _fns


def _device_of(name: str, tensors: list) -> torch.device | None:
    """None where every tensor lies on the CPU, the CUDA device where all
    lie on one; raises otherwise."""
    devs = {t.device for t in tensors}
    if devs == {torch.device("cpu")}:
        return None
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: tensors on {sorted(map(str, devs))}; all "
                         f"must be on one CUDA device (or all on the CPU)")
    return next(iter(devs))


def _split(buf: torch.Tensor, n: int, layout) -> dict:
    off = out_offsets(layout)
    return {name: buf[off[name] * n:(off[name] + _size(shape)) * n].view(
        (n,) + tuple(shape)) for name, shape in layout}


def _f32(name: str, t: torch.Tensor) -> torch.Tensor:
    if t.dtype is not torch.float32:
        raise TypeError(f"{name}: needs float32, got {t.dtype}")
    return t.contiguous()


def step(env, state, action: torch.Tensor):
    """``env.step(state, action)``: the plain version for CPU tensors, K2
    for CUDA tensors. Returns (state, obs, reward, terminated, truncated),
    the new state's terrain the old one's."""
    global step_launches
    fields = ("terrain", "pos", "vel", "angle", "omega", "prev_shaping", "t",
              "acc_joint", "acc_motor", "acc_limit", "acc_cn", "acc_ct")
    ins = [getattr(state, f) for f in fields]
    dev = _device_of("bipedal_step", ins + [action])
    if dev is None:
        return env._step_ref(state, action)
    n = state.pos.shape[0]
    shapes = dict(STEP_OUT, terrain=(200,), t=())
    for f, x in zip(fields, ins):
        if tuple(x.shape) != (n,) + tuple(shapes[f]):
            raise ValueError(f"bipedal_step: {f} of shape {tuple(x.shape)}")
    if state.t.dtype is not torch.int32:
        raise TypeError(f"bipedal_step: t needs int32, got {state.t.dtype}")
    ins = [x.contiguous() if f == "t" else _f32(f, x)
           for f, x in zip(fields, ins)]
    act = _f32("action", action.reshape(n, 4))
    out = torch.empty(out_offsets(STEP_OUT)["total"] * n, device=dev)
    t_out = torch.empty(n, dtype=torch.int32, device=dev)
    flags = torch.empty((2, n), dtype=torch.bool, device=dev)
    if n == 0:
        return _step_result(state, out, t_out, flags, n)
    launch = (_fns or _resolve())[0]
    rc = launch(geometry(env, dev).data_ptr(), *[x.data_ptr() for x in ins],
                act.data_ptr(), out.data_ptr(), t_out.data_ptr(),
                flags[0].data_ptr(), flags[1].data_ptr(), n, env.max_steps,
                torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"bipedal_step_launch failed: CUDA error {rc}")
    step_launches += 1
    return _step_result(state, out, t_out, flags, n)


def _step_result(state, out, t_out, flags, n):
    f = _split(out, n, STEP_OUT)
    obs, reward = f.pop("obs"), f.pop("reward")
    new = type(state)(terrain=state.terrain, t=t_out, **f)
    return new, obs, reward, flags[0], flags[1]


def reset(env, draw: torch.Tensor):
    """``env.reset(draw)``: the plain version for a CPU draw, K3 for a CUDA
    one. Returns (state, obs)."""
    global reset_launches
    dev = _device_of("bipedal_reset", [draw])
    if dev is None:
        return env._reset_ref(draw)
    n = draw.shape[0]
    if tuple(draw.shape) != (n, 210):
        raise ValueError(f"bipedal_reset: draw of shape {tuple(draw.shape)}")
    draw = _f32("draw", draw)
    out = torch.empty(out_offsets(RESET_OUT)["total"] * n, device=dev)
    t_out = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        launch = (_fns or _resolve())[1]
        rc = launch(geometry(env, dev).data_ptr(), draw.data_ptr(),
                    out.data_ptr(), t_out.data_ptr(), n,
                    torch._C._cuda_getCurrentRawStream(dev.index))
        if rc != 0:
            raise RuntimeError(f"bipedal_reset_launch failed: CUDA error "
                               f"{rc}")
        reset_launches += 1
    from freerl_tpu_torch.envs.bipedal import WalkerState

    f = _split(out, n, RESET_OUT)
    obs = f.pop("obs")
    return WalkerState(t=t_out, **f), obs


def floor_launcher(n: int, device: int = 0):
    """A call that launches the library's empty kernel on K2's / K3's grid
    for ``n`` rows, on the current stream: the launch floor."""
    floor = (_fns or _resolve())[2]

    def empty():
        if floor(n, torch._C._cuda_getCurrentRawStream(device)):
            raise RuntimeError("bipedal_floor_launch failed")
    return empty
