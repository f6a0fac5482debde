"""The walker's kernels (``ops/bipedal.py``, ``csrc/bipedal_step.cu``: K2
``bipedal_step``, K3 ``bipedal_reset``) and what surrounds them.

On the CPU: the geometry buffer the kernels read, packed from the plain
version's own tables, field by field; the CUDA source's layout constants
against the Python layout; ``BipedalWalker.step`` / ``.reset`` on CPU
tensors exactly the plain version (``_step_ref`` / ``_reset_ref``, which
``tests/test_torch_bipedal.py`` holds against the JAX walker), with no
launch counted; tensors on two devices refused; the source built with
``-fmad=false``. Tests marked ``gpu`` hold K2 and K3 against the plain
version on the card and skip without one; this file imports no JAX, so
they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_bipedal_kernel.py

Tolerance on the card: K3's terrain walk bit-equal to the plain version
on the CPU (the same float32 operations, no transcendental function on
the walk; the plain version on the card is no yardstick for it, as
torch's kernels there round in their own way: a division by a scalar is
a product by its reciprocal), and the start state within rtol 1e-5 / atol
2e-5 (its contact flags read cos and sin); K2 within chip_smoke.py's
card-against-CPU rule for the walker, rtol 1e-5 / atol 2e-5 on every
row-step, at most 0.5% of row-steps past it and none past 5e-3, at most
0.1% of done flags flipped (cos / sin round differently in the two, and
a crash step amplifies it).
"""
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from freerl_tpu_torch.envs import bipedal as w
from freerl_tpu_torch.envs.base import step_auto_reset
from freerl_tpu_torch.ops import _build
from freerl_tpu_torch.ops import bipedal as k

torch.set_num_threads(1)

CU = os.path.join(os.path.dirname(k.__file__), "..", "csrc",
                  "bipedal_step.cu")


def _cu_constants() -> dict:
    """Every ``constexpr int`` of the CUDA source, evaluated in order."""
    src = open(CU).read()
    out = {}
    for decl in re.findall(r"constexpr int (k\w+ = [^;]+);", src):
        for part in re.split(r",\s*(?=k\w+ =)", decl):
            name, expr = (" ".join(x.split()) for x in part.split("=", 1))
            out[name] = eval(expr, {}, dict(out))
    return out


def test_cuda_layout_is_the_python_layout():
    """The geometry sections, the joint, contact and scalar fields, and
    the step's and reset's output fields sit where both sides say."""
    c = _cu_constants()
    assert c["kGeomSize"] == k.GEOM_SIZE
    for sec, name in (("joints", "kGeomJoints"), ("contacts", "kGeomContacts"),
                      ("hull", "kGeomHull"), ("lidar_dx", "kGeomLidarDx"),
                      ("lidar_dy", "kGeomLidarDy"),
                      ("lidar_fr", "kGeomLidarFr"),
                      ("spawn_pos", "kGeomSpawnPos"),
                      ("spawn_angle", "kGeomSpawnAngle"),
                      ("scalars", "kGeomScalars")):
        assert c[name] == k.section_offset(sec), sec
    assert c["kJointStride"] == len(k.JOINT_FIELDS)
    assert c["kContactStride"] == len(k.CONTACT_FIELDS)
    joint = ["kJAnchAx", "kJAnchAy", "kJAnchBx", "kJAnchBy", "kJInvMa",
             "kJInvMb", "kJInvIa", "kJInvIb", "kJKm", "kJKang", "kJSpeed",
             "kJLo", "kJHi", "kJInvIja", "kJInvIjb", "kJKangJ"]
    assert [c[n] for n in joint] == list(range(len(k.JOINT_FIELDS)))
    assert [c[n] for n in ("kCFootX", "kCFootY", "kCInvM", "kCInvI")] == \
        list(range(len(k.CONTACT_FIELDS)))
    scalars = ["kSGravX", "kSGravY", "kSDt", "kSTerrainStep",
               "kSTerrainHeight", "kSSegMax", "kSFinishX", "kSTorqueCost",
               "kSViewX", "kSViewY"]
    assert [c[n] for n in scalars] == list(range(len(k.SCALARS)))
    for prefix, layout in (("kStep", k.STEP_OUT), ("kReset", k.RESET_OUT)):
        off = k.out_offsets(layout)
        names = {"pos": "Pos", "vel": "Vel", "angle": "Angle",
                 "omega": "Omega", "prev_shaping": "Prev",
                 "acc_joint": "AccJoint", "acc_motor": "AccMotor",
                 "acc_limit": "AccLimit", "acc_cn": "AccCn",
                 "acc_ct": "AccCt", "obs": "Obs", "reward": "Reward",
                 "terrain": "Terrain"}
        for field, _ in layout:
            assert c[prefix + names[field]] == off[field], (prefix, field)
        assert c[prefix + "Floats"] == off["total"]


def test_operation_counts_are_the_sources():
    """The float operations a row that chip_smoke.py's bound counts are
    the CUDA source's totals: K2's sections (16 velocity and 6 position
    iterations), K3's terrain walk past the start pad, a lidar sample."""
    c = _cu_constants()
    assert (c["kStepOps"], c["kResetOps"], c["kLidarSampleOps"]) == (
        k.STEP_OPS, k.RESET_OPS, k.LIDAR_SAMPLE_OPS)
    assert c["kStepOps"] == (c["kOpsSetup"] + c["kOpsWarm"] + c["kOpsHold"]
                             + 16 * c["kOpsVelocityIteration"]
                             + c["kOpsIntegrate"]
                             + 6 * c["kOpsPositionIteration"]
                             + c["kOpsObserve"] + c["kOpsReward"])
    assert (c["kTerrain"], c["kStartpad"]) == (w.TERRAIN_LENGTH,
                                               w.TERRAIN_STARTPAD)


def test_geometry_is_the_plain_versions_tables():
    """Field by field: each joint takes the constants of the ``_GROUPS``
    entry that solves it and its own per-joint tensors, each contact its
    foot point and its ``_PAIRS`` entry's inverse mass and inertia; the
    hull, lidar and spawn tables are the env's; the scalars are the
    module's, as float32."""
    env = w.BipedalWalker(device="cpu")
    geom = k.pack_geometry(env)
    assert geom.dtype == np.float32 and geom.shape == (k.GEOM_SIZE,)
    joints = geom[:k.section_offset("contacts")].reshape(4, -1)
    solver = {0: w._GROUPS[0], 1: w._GROUPS[2], 2: w._GROUPS[1],
              3: w._GROUPS[2]}
    for j in range(4):
        g, row = solver[j], dict(zip(k.JOINT_FIELDS, joints[j]))
        assert (row["anch_ax"], row["anch_ay"]) == g.anch_a == w.ANCH_A[j]
        assert (row["anch_bx"], row["anch_by"]) == g.anch_b == w.ANCH_B[j]
        assert [row[f] for f in ("inv_m_a", "inv_m_b", "inv_i_a", "inv_i_b",
                                 "k_m", "k_ang")] == [
            g.inv_m_a, g.inv_m_b, g.inv_i_a, g.inv_i_b, g.k_m, g.k_ang]
        assert (row["inv_m_a"], row["inv_m_b"]) == (w.INV_M[w.J_A[j]],
                                                    w.INV_M[w.J_B[j]])
        assert [row[f] for f in ("speed", "lo", "hi", "inv_i_ja",
                                 "inv_i_jb", "k_ang_j")] == [
            np.float32(w.J_SPEED[j]), np.float32(w.J_LO[j]),
            np.float32(w.J_HI[j]), np.float32(w.INV_I[w.J_A[j]]),
            np.float32(w.INV_I[w.J_B[j]]), np.float32(w.K_ANG[j])]
    contacts = geom[k.section_offset("contacts"):
                    k.section_offset("hull")].reshape(12, -1)
    for c in range(12):
        row = dict(zip(k.CONTACT_FIELDS, contacts[c]))
        assert (row["foot_x"], row["foot_y"]) == tuple(w._FOOT_PTS[c])
        q = w._PAIRS[c % 6]
        assert (row["inv_m"], row["inv_i"]) == (q.inv_m, q.inv_i)
        assert (row["inv_m"], row["inv_i"]) == (
            w.INV_M[w.FOOT_BODIES[c]], w.INV_I[w.FOOT_BODIES[c]])

    def section(name, n):
        return geom[k.section_offset(name):k.section_offset(name) + n]

    np.testing.assert_array_equal(
        section("hull", 10).reshape(5, 2), w.HULL_POLY.astype(np.float32))
    for name, t in (("lidar_dx", env.lidar_dx), ("lidar_dy", env.lidar_dy),
                    ("lidar_fr", env.fr), ("spawn_pos", env.spawn_pos),
                    ("spawn_angle", env.spawn_angle)):
        np.testing.assert_array_equal(section(name, t.numel()),
                                      t.numpy().reshape(-1), err_msg=name)
    scalars = dict(zip(k.SCALARS, section("scalars", len(k.SCALARS))))
    want = dict(
        gravity_dt_x=0.0, gravity_dt_y=np.float32(-10.0) * np.float32(0.02),
        dt=w.DT, terrain_step=w.TERRAIN_STEP,
        terrain_height=w.TERRAIN_HEIGHT, seg_max=w.TERRAIN_LENGTH - 1.001,
        finish_x=(w.TERRAIN_LENGTH - w.TERRAIN_GRASS) * w.TERRAIN_STEP,
        torque_cost=0.00035 * w.MOTORS_TORQUE,
        view_x=w.VIEWPORT_W / w.SCALE, view_y=w.VIEWPORT_H / w.SCALE)
    assert scalars == {name: np.float32(v) for name, v in want.items()}


def _fields(out) -> list:
    state, *rest = out
    return [getattr(state, f.name) for f in dataclasses.fields(state)] + \
        list(rest)


@pytest.mark.parametrize("steps", [40])
def test_cpu_step_and_reset_are_the_plain_version(steps):
    """On CPU tensors ``reset`` and ``step`` return exactly what
    ``_reset_ref`` and ``_step_ref`` return, through crashes and
    auto-resets, and count no launch."""
    env = w.BipedalWalker(device="cpu")
    gen = torch.Generator().manual_seed(3)
    before = (k.step_launches, k.reset_launches)
    draw = env.draw_reset(64, gen)
    got, want = env.reset(draw), env._reset_ref(draw)
    for a, b in zip(_fields(got), _fields(want)):
        assert torch.equal(a, b)
    state = got[0]
    for _ in range(steps):
        action = torch.rand(64, 4, generator=gen) * 2.4 - 1.2
        got = env.step(state, action)
        want = env._step_ref(state, action)
        for a, b in zip(_fields(got), _fields(want)):
            assert torch.equal(a, b)
        state = step_auto_reset(env, state, action, None,
                                env.draw_reset(64, gen)).state
    assert (k.step_launches, k.reset_launches) == before


def test_tensors_on_two_devices_are_refused():
    """A CUDA tensor beside CPU ones is refused, not quietly stepped on
    the CPU (the meta device stands in for the card here)."""
    env = w.BipedalWalker(device="cpu")
    state, _ = env.reset(env.draw_reset(2, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="one CUDA device"):
        k.step(env, state, torch.zeros(2, 4, device="meta"))
    with pytest.raises(ValueError, match="one CUDA device"):
        k.reset(env, torch.zeros(2, 210, device="meta"))


def test_source_builds_without_contraction(tmp_path, monkeypatch):
    """The walker's source is compiled with ``-fmad=false`` on top of the
    common flags; the other sources without it."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    log = tmp_path / "calls.txt"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    f'echo "$@" >> {log}\n'
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'echo lib > "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.build_all(["bipedal_step", "sumtree_descend"])
    calls = log.read_text().splitlines()
    walker = next(c for c in calls if "bipedal_step.cu" in c)
    tree = next(c for c in calls if "sumtree_descend.cu" in c)
    assert "-fmad=false" in walker.split() and "-fmad=false" not in tree
    assert "--use_fast_math" not in walker
    assert "arch=compute_90a,code=sm_90a" in walker


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _to(x, dev):
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _to(getattr(x, f.name), dev)
                          for f in dataclasses.fields(x)})
    return x.to(dev)


class _Plain(w.BipedalWalker):
    """The walker whose step and reset are the plain version on any
    device."""

    def step(self, state, action, step_draw=None):
        return self._step_ref(state, action)

    def reset(self, draw):
        return self._reset_ref(draw)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 4, 8, 10, 130, 1024])
def test_reset_kernel_is_the_plain_version(cuda, n):
    """n rows (one, the main path's 4, 8 and 10, part of a second block,
    and 1,024) against the plain version on the CPU from the same draws:
    the terrain bit-equal, every other field within rtol 1e-5 / atol
    2e-5."""
    env = w.BipedalWalker(device=cuda)
    draw = env.draw_reset(n, torch.Generator(device=cuda).manual_seed(n))
    before = k.reset_launches
    got = env.reset(draw)
    torch.cuda.synchronize()
    assert k.reset_launches == before + 1
    want = w.BipedalWalker(device="cpu").reset(draw.cpu())
    assert torch.equal(got[0].terrain.cpu(), want[0].terrain)
    for a, b in zip(_fields(got), _fields(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        a, b = a.cpu().double(), b.double()
        assert bool(((a - b).abs() <= 2e-5 + 1e-5 * b.abs()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("b", [4, 8, 10, 256])
def test_step_kernel_holds_to_the_plain_version(cuda, b):
    """b rows (the main path's 4, 8 and 10, each a part of one block, and
    two whole blocks), 100 auto-resetting steps, each from the plain
    version's state with its draws, at chip_smoke.py's rule."""
    env, plain = w.BipedalWalker(device=cuda), _Plain(device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    steps = 100
    state, _ = plain.reset(plain.draw_reset(b, gen))
    flips = stiff = 0
    worst = 0.0
    fields = ("next_obs", "carry_obs", "reward")
    before = k.step_launches
    for _ in range(steps):
        action = torch.rand(b, 4, generator=gen, device=cuda) * 2.0 - 1.0
        draw = plain.draw_reset(b, gen)
        want = step_auto_reset(plain, state, action, None, draw)
        got = step_auto_reset(env, state, action, None, draw)
        same = want.episode_done == got.episode_done
        flips += int((~same).sum())
        a, c = (torch.cat([getattr(o, f).reshape(b, -1) for f in fields]
                          + [getattr(o.state, f.name).reshape(b, -1).float()
                             for f in dataclasses.fields(o.state)], 1)[same]
                for o in (want, got))
        err = (a - c).abs()
        stiff += int((~(err <= 2e-5 + 1e-5 * a.abs()).all(1)).sum())
        worst = max(worst, float(err.max()))
        state = want.state
    assert k.step_launches == before + steps
    assert stiff <= 0.005 * b * steps and worst <= 5e-3
    assert flips <= 0.001 * b * steps


@pytest.mark.gpu
def test_kernels_refuse_bad_input(cuda):
    env = w.BipedalWalker(device=cuda)
    state, _ = env.reset(env.draw_reset(4, torch.Generator(
        device=cuda).manual_seed(0)))
    with pytest.raises(TypeError):
        env.step(state, torch.zeros(4, 4, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        env.reset(torch.zeros(4, 200, device=cuda))
    with pytest.raises(ValueError):
        env.step(state, torch.zeros(4, 4))
