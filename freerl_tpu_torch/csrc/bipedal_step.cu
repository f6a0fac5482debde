// BipedalWalker-v3's step (K2) and reset (K3), one thread per env row.
//
// Replaces no TPU kernel: the JAX package's walker
// (freerl_tpu/envs/bipedal.py, step at :287, reset at :185) is plain XLA,
// vmapped over envs, and XLA fuses each step into one program. The port's
// plain version (freerl_tpu_torch/envs/bipedal.py: BipedalWalker._step_ref
// and _reset_ref) writes the same solver as batched torch ops, unrolled in
// Python: the warm start, 16 velocity iterations over 4 joints and 12
// contacts, 6 position iterations, the 240 lidar samples, and for the reset
// a 200-step terrain walk. That is about 9,500 small kernels a step, so on
// the card the walker's vector step was bound by launches from the host.
// These two kernels do the same work in one launch each.
//
// What bounds them on this card: neither bytes nor operations. A row reads
// about 1.2 KB (its state, action and terrain) and writes about 400 B, and
// does some 25,000 float operations, all of them a chain: each Gauss-Seidel
// update reads what the one before wrote. So the time is the chain's
// latency in one thread, and a batch of B rows fills B / 128 blocks. The
// design keeps the chain in registers: each row's 5 bodies (position,
// velocity, angle, spin) and its 40 warm-start impulses live in registers
// for the whole step, the loops are unrolled so every body and contact
// index is a constant, and the geometry (anchors, masses, inertias, limits,
// foot and hull points, the lidar offsets, which the Python side packs
// from the plain version's own tables: freerl_tpu_torch/ops/bipedal.py)
// is staged once per block in shared memory. The terrain row is read from
// global memory through L1.
//
// Arithmetic: the plain version's, operation for operation, in its
// Gauss-Seidel order (hip L, hip R, knee L, knee R; for each contact pair k
// the left leg's contact k, then the right leg's k + 6, friction before
// normal), with IEEE float32 rounding at every step. The source is built
// with -fmad=false (freerl_tpu_torch/ops/_build.py), so no multiply-add is
// contracted unless written as __fmaf_rn, which only the 2-norms use: the
// CPU's torch.linalg.vector_norm of a pair computes sqrt(fma(y, y, x * x)).
// cosf / sinf / sqrtf / division are the precise ones. Torch's own kernels
// round some operations otherwise (a division by a scalar is a product by
// its reciprocal on the card; cos and sin differ in the last bit), and a
// crash step amplifies such differences, so the result is held to the
// plain version within a tolerance, not to the bit (chip_smoke.py).
//
// The kernels allocate nothing: the wrapper hands in the output buffers.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBodies = 5;
constexpr int kJoints = 4;
constexpr int kContacts = 12;
constexpr int kTerrain = 200;
constexpr int kRays = 10;
constexpr int kSamples = 24;
constexpr int kObs = 24;
constexpr int kDraw = kTerrain + 10;
constexpr int kStartpad = 20;

// Topology, not mass properties: joint j links bodies ja(j) -> jb(j)
// (hip L, knee L, hip R, knee R); contact c sits on body foot_body(c);
// the relative angles of the observation are angle[k + 1] - angle[ja(k)].
// The plain version solves the joints in its _GROUPS' order (hip L, hip R,
// then both knees: joint_order) and the contacts in its _PAIRS' order (k,
// then k + 6: contact_order). Every loop over them is unrolled, so each is
// a constant where it is used.
__host__ __device__ constexpr int ja(int j) { return j == 1 || j == 3 ? j : 0; }
__host__ __device__ constexpr int jb(int j) { return j + 1; }
__host__ __device__ constexpr int foot_body(int c) {
  return c < 4 ? 2 : c < 6 ? 1 : c < 10 ? 4 : 3;
}
__host__ __device__ constexpr int joint_order(int o) {
  return o == 1 ? 2 : o == 2 ? 1 : o;
}
__host__ __device__ constexpr int contact_order(int o) {
  return o % 2 == 0 ? o / 2 : o / 2 + 6;
}

// The geometry buffer (float32), as freerl_tpu_torch/ops/bipedal.py packs
// it: per joint, the constants of the group that solves it, then its own
// limit, speed and inertia entries; per contact, its foot point and its
// body's inverse mass and inertia; the hull polygon; the lidar offsets
// and sample fractions; the spawn state; the scalars of the step.
constexpr int kJointStride = 16;
constexpr int kJAnchAx = 0, kJAnchAy = 1, kJAnchBx = 2, kJAnchBy = 3;
constexpr int kJInvMa = 4, kJInvMb = 5, kJInvIa = 6, kJInvIb = 7;
constexpr int kJKm = 8, kJKang = 9, kJSpeed = 10, kJLo = 11, kJHi = 12;
constexpr int kJInvIja = 13, kJInvIjb = 14, kJKangJ = 15;
constexpr int kContactStride = 4;
constexpr int kCFootX = 0, kCFootY = 1, kCInvM = 2, kCInvI = 3;

constexpr int kGeomJoints = 0;
constexpr int kGeomContacts = kGeomJoints + kJoints * kJointStride;
constexpr int kGeomHull = kGeomContacts + kContacts * kContactStride;
constexpr int kGeomLidarDx = kGeomHull + 10;
constexpr int kGeomLidarDy = kGeomLidarDx + kRays * kSamples;
constexpr int kGeomLidarFr = kGeomLidarDy + kRays * kSamples;
constexpr int kGeomSpawnPos = kGeomLidarFr + kSamples;
constexpr int kGeomSpawnAngle = kGeomSpawnPos + 2 * kBodies;
constexpr int kGeomScalars = kGeomSpawnAngle + kBodies;
// the scalars, in this order
constexpr int kSGravX = 0, kSGravY = 1, kSDt = 2, kSTerrainStep = 3;
constexpr int kSTerrainHeight = 4, kSSegMax = 5, kSFinishX = 6;
constexpr int kSTorqueCost = 7, kSViewX = 8, kSViewY = 9;
constexpr int kGeomSize = kGeomScalars + 10;

// The outputs, each a contiguous field of the float buffer, at these
// offsets in units of B (the batch): the step's, then the reset's.
constexpr int kStepPos = 0, kStepVel = 10, kStepAngle = 20, kStepOmega = 25;
constexpr int kStepPrev = 30, kStepAccJoint = 31, kStepAccMotor = 39;
constexpr int kStepAccLimit = 43, kStepAccCn = 47, kStepAccCt = 59;
constexpr int kStepObs = 71, kStepReward = 95, kStepFloats = 96;
constexpr int kResetTerrain = 0, kResetPos = 200, kResetVel = 210;
constexpr int kResetAngle = 220, kResetOmega = 225, kResetPrev = 230;
constexpr int kResetAccJoint = 231, kResetAccMotor = 239;
constexpr int kResetAccLimit = 243, kResetAccCn = 247, kResetAccCt = 259;
constexpr int kResetObs = 271, kResetFloats = 295;

// Float operations a row, counted from the code below, for the bound
// chip_smoke.py states (a comparison, a select, a min / max, a floor, a
// conversion, cos, sin, sqrt and a division count one each). K2's step
// but its lidar, by section: the setup (the bodies' velocities, cos and
// sin, the joints' lever arms, motor targets and limit states, the
// contacts' points, separations and normals), the warm start, what the
// velocity iterations hold fixed, one velocity iteration, the
// integration, one position iteration, the observation but its lidar, and
// the reward and crash test. K3's reset: the terrain walk (6 a step, 2
// more past the start pad), the spawn, the observation but its lidar, the
// shaping. Each lidar sample a row's data needs (its ray's samples up to
// the first at or below the ground, all 24 where none is) costs
// kLidarSampleOps: two additions, the height lookup and a comparison.
// ops/bipedal.py holds the same three totals, and checks them against
// this library's when it loads it.
constexpr int kOpsSetup = 494, kOpsWarm = 208, kOpsHold = 180;
constexpr int kOpsVelocityIteration = 756, kOpsIntegrate = 15;
constexpr int kOpsPositionIteration = 1160, kOpsObserve = 199;
constexpr int kOpsReward = 110;
constexpr int kStepOps = kOpsSetup + kOpsWarm + kOpsHold +
                         16 * kOpsVelocityIteration + kOpsIntegrate +
                         6 * kOpsPositionIteration + kOpsObserve + kOpsReward;
constexpr int kResetOps = kTerrain * 6 + (kTerrain - kStartpad - 1) * 2 +
                          10 + kOpsObserve + 4;
constexpr int kLidarSampleOps = 13;

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// sqrt(fma(y, y, x * x)): the CPU's torch.linalg.vector_norm of (x, y)
__device__ __forceinline__ float norm2(float x, float y) {
  return sqrtf(__fmaf_rn(y, y, x * x));
}

struct Geom {
  const float* g;   // shared memory
  __device__ float j(int joint, int field) const {
    return g[kGeomJoints + joint * kJointStride + field];
  }
  __device__ float c(int contact, int field) const {
    return g[kGeomContacts + contact * kContactStride + field];
  }
  __device__ float s(int field) const { return g[kGeomScalars + field]; }
};

// _segment: the terrain segment under x and the fraction along it
__device__ __forceinline__ void segment(const Geom& G, float x, int& i,
                                        float& frac) {
  float fx = clampf(x / G.s(kSTerrainStep), 0.0f, G.s(kSSegMax));
  float fi = floorf(fx);
  i = static_cast<int>(fi);
  frac = fx - fi;
}

// _terrain_height
__device__ __forceinline__ float height(const Geom& G,
                                        const float* __restrict__ terrain,
                                        float x) {
  int i;
  float frac;
  segment(G, x, i, frac);
  return terrain[i] * (1.0f - frac) + terrain[i + 1] * frac;
}

// _terrain_normal: the unit normal of the segment under x
__device__ __forceinline__ void normal(const Geom& G,
                                       const float* __restrict__ terrain,
                                       float x, float& nx, float& ny) {
  int i;
  float frac;
  segment(G, x, i, frac);
  const float dy = terrain[i + 1] - terrain[i];
  const float step = G.s(kSTerrainStep);
  const float n = norm2(-dy, step);
  nx = -dy / n;
  ny = step / n;
}

// _foot_contacts for contact c: its world point and its separation
__device__ __forceinline__ void foot(const Geom& G,
                                     const float* __restrict__ terrain, int c,
                                     const float (&px)[kBodies],
                                     const float (&py)[kBodies],
                                     const float (&ang)[kBodies], float& wx,
                                     float& wy, float& sep) {
  const int b = foot_body(c);
  const float co = cosf(ang[b]), si = sinf(ang[b]);
  const float fx = G.c(c, kCFootX), fy = G.c(c, kCFootY);
  wx = px[b] + (co * fx - si * fy);
  wy = py[b] + (si * fx + co * fy);
  sep = wy - height(G, terrain, wx);
}

// observation(): the 24 floats of a row's state
__device__ __forceinline__ void observe(const Geom& G, const float* __restrict__ terrain,
                        const float (&px)[kBodies], const float (&py)[kBodies],
                        const float (&vx)[kBodies], const float (&vy)[kBodies],
                        const float (&ang)[kBodies],
                        const float (&om)[kBodies], float (&obs)[kObs]) {
  float rel[kJoints], relw[kJoints];
#pragma unroll
  for (int k = 0; k < kJoints; ++k) {
    rel[k] = ang[k + 1] - ang[ja(k)];
    relw[k] = om[k + 1] - om[ja(k)];
  }
  bool c_l = false, c_r = false;
#pragma unroll
  for (int c = 0; c < kContacts; ++c) {
    if (c >= 4 && c < 6) continue;
    if (c >= 10) continue;
    float wx, wy, sep;
    foot(G, terrain, c, px, py, ang, wx, wy, sep);
    if (c < 4) c_l = c_l || sep < 0.01f;
    else c_r = c_r || sep < 0.01f;
  }
  obs[0] = ang[0];
  obs[1] = 2.0f * om[0] / 50.0f;
  obs[2] = 0.3f * vx[0] * G.s(kSViewX) / 50.0f;
  obs[3] = 0.3f * vy[0] * G.s(kSViewY) / 50.0f;
  obs[4] = rel[0];
  obs[5] = relw[0] / 4.0f;
  obs[6] = rel[1];
  obs[7] = relw[1] / 6.0f;
  obs[8] = c_l ? 1.0f : 0.0f;
  obs[9] = rel[2];
  obs[10] = relw[2] / 4.0f;
  obs[11] = rel[3];
  obs[12] = relw[3] / 6.0f;
  obs[13] = c_r ? 1.0f : 0.0f;
  // lidar: the first sample of each ray at or below the ground
  const float* dx = G.g + kGeomLidarDx;
  const float* dy = G.g + kGeomLidarDy;
  const float* fr = G.g + kGeomLidarFr;
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    float hit = 1.0f;
    for (int k = 0; k < kSamples; ++k) {
      const float x = px[0] + dx[r * kSamples + k];
      const float y = py[0] + dy[r * kSamples + k];
      if (y <= height(G, terrain, x)) {
        hit = fr[k];
        break;
      }
    }
    obs[14 + r] = hit;
  }
}

// the shaping term: 130 x / SCALE - 5 |angle|
__device__ __forceinline__ float shaping(float x0, float a0) {
  return 130.0f * x0 / 30.0f - 5.0f * fabsf(a0);
}

__device__ __forceinline__ void load_geom(const float* __restrict__ geom,
                                          float* smem) {
  for (int k = threadIdx.x; k < kGeomSize; k += blockDim.x) smem[k] = geom[k];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    step_kernel(const float* __restrict__ geom,
                const float* __restrict__ terrain_all,
                const float* __restrict__ pos_in,
                const float* __restrict__ vel_in,
                const float* __restrict__ angle_in,
                const float* __restrict__ omega_in,
                const float* __restrict__ prev_in,
                const int32_t* __restrict__ t_in,
                const float* __restrict__ acc_joint_in,
                const float* __restrict__ acc_motor_in,
                const float* __restrict__ acc_limit_in,
                const float* __restrict__ acc_cn_in,
                const float* __restrict__ acc_ct_in,
                const float* __restrict__ action, float* __restrict__ out,
                int32_t* __restrict__ t_out, uint8_t* __restrict__ term_out,
                uint8_t* __restrict__ trunc_out, int n, int max_steps) {
  __shared__ float smem[kGeomSize];
  load_geom(geom, smem);
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const Geom G{smem};
  const float* terrain = terrain_all + static_cast<int64_t>(row) * kTerrain;

  float px[kBodies], py[kBodies], vx[kBodies], vy[kBodies], ang[kBodies],
      om[kBodies];
  float co[kBodies], si[kBodies];
#pragma unroll
  for (int b = 0; b < kBodies; ++b) {
    px[b] = pos_in[row * 10 + 2 * b];
    py[b] = pos_in[row * 10 + 2 * b + 1];
    // vel = state.vel + gravity_dt
    vx[b] = vel_in[row * 10 + 2 * b] + G.s(kSGravX);
    vy[b] = vel_in[row * 10 + 2 * b + 1] + G.s(kSGravY);
    ang[b] = angle_in[row * 5 + b];
    om[b] = omega_in[row * 5 + b];
    co[b] = cosf(ang[b]);
    si[b] = sinf(ang[b]);
  }
  const float dt = G.s(kSDt);

  // -- joints: lever arms, motor targets, limit states, warm impulses ----
  float a[kJoints], rax[kJoints], ray[kJoints], rbx[kJoints], rby[kJoints];
  float speed[kJoints], max_imp[kJoints], lmin[kJoints], lmax[kJoints];
  bool on[kJoints];
  float accJx[kJoints], accJy[kJoints], accM[kJoints], accL[kJoints];
#pragma unroll
  for (int j = 0; j < kJoints; ++j) {
    a[j] = clampf(action[row * 4 + j], -1.0f, 1.0f);
    const int A = ja(j), B = jb(j);
    const float ax = G.j(j, kJAnchAx), ay = G.j(j, kJAnchAy);
    const float bx = G.j(j, kJAnchBx), by = G.j(j, kJAnchBy);
    rax[j] = co[A] * ax - si[A] * ay;
    ray[j] = si[A] * ax + co[A] * ay;
    rbx[j] = co[B] * bx - si[B] * by;
    rby[j] = si[B] * bx + co[B] * by;
    speed[j] = G.j(j, kJSpeed) * signf(a[j]);
    max_imp[j] = 80.0f * fabsf(a[j]) * dt;
    const float rel0 = ang[B] - ang[A];
    const bool at_lo = rel0 <= G.j(j, kJLo);
    const bool at_hi = rel0 >= G.j(j, kJHi);
    on[j] = at_lo || at_hi;
    lmin[j] = at_lo ? 0.0f : -INFINITY;
    lmax[j] = at_hi ? 0.0f : INFINITY;
    accJx[j] = acc_joint_in[row * 8 + 2 * j];
    accJy[j] = acc_joint_in[row * 8 + 2 * j + 1];
    accM[j] = acc_motor_in[row * 4 + j];
    accL[j] = on[j] ? acc_limit_in[row * 4 + j] : 0.0f;
  }

  // -- contacts: lever arms, normals, tangents, warm impulses -----------
  float rfx[kContacts], rfy[kContacts], cnx[kContacts], cny[kContacts];
  float tf[kContacts], accN[kContacts], accT[kContacts];
#pragma unroll
  for (int c = 0; c < kContacts; ++c) {
    const int b = foot_body(c);
    float wx, wy, sep;
    foot(G, terrain, c, px, py, ang, wx, wy, sep);
    const bool touching = sep < 0.005f;
    tf[c] = touching ? 1.0f : 0.0f;
    rfx[c] = wx - px[b];
    rfy[c] = wy - py[b];
    normal(G, terrain, wx, cnx[c], cny[c]);
    accN[c] = touching ? acc_cn_in[row * 12 + c] : 0.0f;
    accT[c] = touching ? acc_ct_in[row * 12 + c] : 0.0f;
  }

  // -- warm start: re-apply last step's impulses ------------------------
#pragma unroll
  for (int o = 0; o < kJoints; ++o) {
    const int j = joint_order(o), A = ja(j), B = jb(j);
    const float pxj = accJx[j], pyj = accJy[j];
    const float angimp = accM[j] + accL[j];
    vx[A] -= pxj * G.j(j, kJInvMa);
    vy[A] -= pyj * G.j(j, kJInvMa);
    vx[B] += pxj * G.j(j, kJInvMb);
    vy[B] += pyj * G.j(j, kJInvMb);
    om[A] -= (rax[j] * pyj - ray[j] * pxj + angimp) * G.j(j, kJInvIa);
    om[B] += (rbx[j] * pyj - rby[j] * pxj + angimp) * G.j(j, kJInvIb);
  }
#pragma unroll
  for (int o = 0; o < kContacts; ++o) {
    const int c = contact_order(o), b = foot_body(c);
    // ct = (cn_y, -cn_x)
    const float pxc = accN[c] * cnx[c] + accT[c] * cny[c];
    const float pyc = accN[c] * cny[c] + accT[c] * -cnx[c];
    vx[b] += pxc * G.c(c, kCInvM);
    vy[b] += pyc * G.c(c, kCInvM);
    om[b] += (rfx[c] * pyc - rfy[c] * pxc) * G.c(c, kCInvI);
  }

  // -- what the velocity iterations hold fixed --------------------------
  float kxx[kJoints], kxy[kJoints], kyx[kJoints], kyy[kJoints], det[kJoints];
#pragma unroll
  for (int j = 0; j < kJoints; ++j) {
    const float ia = G.j(j, kJInvIa), ib = G.j(j, kJInvIb), km = G.j(j, kJKm);
    const float k11 = km + ia * (ray[j] * ray[j]) + ib * (rby[j] * rby[j]);
    const float k22 = km + ia * (rax[j] * rax[j]) + ib * (rbx[j] * rbx[j]);
    const float k12 = -ia * rax[j] * ray[j] - ib * rbx[j] * rby[j];
    det[j] = k11 * k22 - k12 * k12;
    kxx[j] = -k22;
    kxy[j] = k12;
    kyx[j] = k12;
    kyy[j] = -k11;
  }
  float kt[kContacts], kn[kContacts];
#pragma unroll
  for (int c = 0; c < kContacts; ++c) {
    const float im = G.c(c, kCInvM), ii = G.c(c, kCInvI);
    // t = (cn_y, -cn_x)
    const float crt = rfx[c] * -cnx[c] - rfy[c] * cny[c];
    const float crn = rfx[c] * cny[c] - rfy[c] * cnx[c];
    kt[c] = im + ii * (crt * crt);
    kn[c] = im + ii * (crn * crn);
  }

  // -- velocity iterations with accumulated-impulse clamping ------------
  for (int it = 0; it < 16; ++it) {
#pragma unroll
    for (int o = 0; o < kJoints; ++o) {
      const int j = joint_order(o), A = ja(j), B = jb(j);
      const float ia = G.j(j, kJInvIa), ib = G.j(j, kJInvIb);
      const float kang = G.j(j, kJKang);
      // motor
      float relw = om[B] - om[A];
      float nw = clampf(accM[j] + (speed[j] - relw) / kang, -max_imp[j],
                        max_imp[j]);
      float d = nw - accM[j];
      accM[j] = nw;
      om[A] -= d * ia;
      om[B] += d * ib;
      // joint limit hard stop
      relw = om[B] - om[A];
      const float raw = accL[j] - relw / kang;
      nw = on[j] ? clampf(raw, lmin[j], lmax[j]) : 0.0f;
      d = nw - accL[j];
      accL[j] = nw;
      om[A] -= d * ia;
      om[B] += d * ib;
    }
#pragma unroll
    for (int o = 0; o < kJoints; ++o) {
      const int j = joint_order(o), A = ja(j), B = jb(j);
      // perp(r) = (-r_y, r_x)
      const float cdx = (vx[B] + om[B] * -rby[j]) - (vx[A] + om[A] * -ray[j]);
      const float cdy = (vy[B] + om[B] * rbx[j]) - (vy[A] + om[A] * rax[j]);
      const float pxj = (kxx[j] * cdx + kyx[j] * cdy) / det[j];
      const float pyj = (kxy[j] * cdx + kyy[j] * cdy) / det[j];
      accJx[j] = accJx[j] + pxj;
      accJy[j] = accJy[j] + pyj;
      vx[A] -= pxj * G.j(j, kJInvMa);
      vy[A] -= pyj * G.j(j, kJInvMa);
      vx[B] += pxj * G.j(j, kJInvMb);
      vy[B] += pyj * G.j(j, kJInvMb);
      om[A] -= (pxj * -ray[j] + pyj * rax[j]) * G.j(j, kJInvIa);
      om[B] += (pxj * -rby[j] + pyj * rbx[j]) * G.j(j, kJInvIb);
    }
#pragma unroll
    for (int o = 0; o < kContacts; ++o) {
      const int c = contact_order(o), b = foot_body(c);
      const float im = G.c(c, kCInvM), ii = G.c(c, kCInvI);
      const float tx = cny[c], ty = -cnx[c];
      // friction first (Box2D order), bounded by mu * acc normal
      float vpx = vx[b] + om[b] * -rfy[c];
      float vpy = vy[b] + om[b] * rfx[c];
      const float max_f = 2.5f * accN[c];
      float nw = clampf(accT[c] - (vpx * tx + vpy * ty) / kt[c], -max_f,
                        max_f) * tf[c];
      float d = nw - accT[c];
      accT[c] = nw;
      float pxc = d * tx, pyc = d * ty;
      vx[b] += pxc * im;
      vy[b] += pyc * im;
      om[b] += (pxc * -rfy[c] + pyc * rfx[c]) * ii;
      // normal: accumulated >= 0
      vpx = vx[b] + om[b] * -rfy[c];
      vpy = vy[b] + om[b] * rfx[c];
      nw = fmaxf(accN[c] - (vpx * cnx[c] + vpy * cny[c]) / kn[c], 0.0f) *
           tf[c];
      d = nw - accN[c];
      accN[c] = nw;
      pxc = d * cnx[c];
      pyc = d * cny[c];
      vx[b] += pxc * im;
      vy[b] += pyc * im;
      om[b] += (pxc * -rfy[c] + pyc * rfx[c]) * ii;
    }
  }

#pragma unroll
  for (int b = 0; b < kBodies; ++b) {
    px[b] = px[b] + vx[b] * dt;
    py[b] = py[b] + vy[b] * dt;
    ang[b] = ang[b] + om[b] * dt;
  }

  // -- position phase: nonlinear Gauss-Seidel, angular-aware ------------
  for (int it = 0; it < 6; ++it) {
#pragma unroll
    for (int o = 0; o < kJoints; ++o) {
      const int j = joint_order(o), A = ja(j), B = jb(j);
      const float ia = G.j(j, kJInvIa), ib = G.j(j, kJInvIb), km = G.j(j, kJKm);
      const float ax = G.j(j, kJAnchAx), ay = G.j(j, kJAnchAy);
      const float bx = G.j(j, kJAnchBx), by = G.j(j, kJAnchBy);
      const float ca = cosf(ang[A]), sa = sinf(ang[A]);
      const float cb = cosf(ang[B]), sb = sinf(ang[B]);
      const float r2ax = ca * ax - sa * ay, r2ay = sa * ax + ca * ay;
      const float r2bx = cb * bx - sb * by, r2by = sb * bx + cb * by;
      float Cx = (px[B] + r2bx) - (px[A] + r2ax);
      float Cy = (py[B] + r2by) - (py[A] + r2ay);
      const float nrm = norm2(Cx, Cy);
      const float lo = fminf(nrm, 0.2f), hi = fmaxf(nrm, 1e-9f);
      Cx = Cx * lo / hi;
      Cy = Cy * lo / hi;
      const float k11 = km + ia * (r2ay * r2ay) + ib * (r2by * r2by);
      const float k22 = km + ia * (r2ax * r2ax) + ib * (r2bx * r2bx);
      const float k12 = -ia * r2ax * r2ay - ib * r2bx * r2by;
      const float dt2 = k11 * k22 - k12 * k12;
      const float pxj = (-k22 * Cx + k12 * Cy) / dt2;
      const float pyj = (k12 * Cx + -k11 * Cy) / dt2;
      px[A] -= pxj * G.j(j, kJInvMa);
      py[A] -= pyj * G.j(j, kJInvMa);
      px[B] += pxj * G.j(j, kJInvMb);
      py[B] += pyj * G.j(j, kJInvMb);
      ang[A] -= (r2ax * pyj - r2ay * pxj) * ia;
      ang[B] += (r2bx * pyj - r2by * pxj) * ib;
    }
    // joint limit position correction, inertia-weighted: all four from
    // the same angles, then added in joint order (the hull, body 0, takes
    // hip L's before hip R's)
    float corr_a[kJoints], corr_b[kJoints];
#pragma unroll
    for (int j = 0; j < kJoints; ++j) {
      const float rel = ang[jb(j)] - ang[ja(j)];
      float viol = clampf(rel, G.j(j, kJLo), G.j(j, kJHi)) - rel;
      viol = clampf(viol, -0.14f, 0.14f);
      corr_a[j] = -viol * G.j(j, kJInvIja) / G.j(j, kJKangJ);
      corr_b[j] = viol * G.j(j, kJInvIjb) / G.j(j, kJKangJ);
    }
    ang[0] += corr_a[0];
    ang[1] += corr_a[1];
    ang[0] += corr_a[2];
    ang[3] += corr_a[3];
    ang[1] += corr_b[0];
    ang[2] += corr_b[1];
    ang[3] += corr_b[2];
    ang[4] += corr_b[3];
    // foot-ground penetration, angular-aware push-out: every contact's
    // point, separation and normal from the same state, then each pair
    float wfx[kContacts], wfy[kContacts], nx[kContacts], ny[kContacts],
        push[kContacts];
#pragma unroll
    for (int c = 0; c < kContacts; ++c) {
      float sep;
      foot(G, terrain, c, px, py, ang, wfx[c], wfy[c], sep);
      normal(G, terrain, wfx[c], nx[c], ny[c]);
      push[c] = clampf(0.2f * (sep + 0.005f), -0.2f, 0.0f);
    }
#pragma unroll
    for (int o = 0; o < kContacts; ++o) {
      const int c = contact_order(o), b = foot_body(c);
      const float im = G.c(c, kCInvM), ii = G.c(c, kCInvI);
      const float rx = wfx[c] - px[b], ry = wfy[c] - py[b];
      const float cr = rx * ny[c] - ry * nx[c];
      const float knc = im + ii * (cr * cr);
      const float f = -push[c] / knc;
      const float pxc = f * nx[c], pyc = f * ny[c];
      px[b] += pxc * im;
      py[b] += pyc * im;
      ang[b] += (rx * pyc - ry * pxc) * ii;
    }
  }

  // -- the new state, its observation, reward and flags ------------------
  float obs[kObs];
  observe(G, terrain, px, py, vx, vy, ang, om, obs);
  const float shape = shaping(px[0], ang[0]);
  float reward = shape - prev_in[row];
  float cost = 0.0f;
#pragma unroll
  for (int j = 0; j < kJoints; ++j) {
    const float cj = G.s(kSTorqueCost) * fabsf(a[j]);
    cost = j == 0 ? cj : cost + cj;
  }
  reward = reward - cost;
  // hull-ground contact => crash
  bool game_over = false;
  const float ch = cosf(ang[0]), sh = sinf(ang[0]);
  const float* hull = G.g + kGeomHull;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float hx = px[0] + (ch * hull[2 * k] - sh * hull[2 * k + 1]);
    const float hy = py[0] + (sh * hull[2 * k] + ch * hull[2 * k + 1]);
    game_over = game_over || hy <= height(G, terrain, hx);
  }
  const bool finished = px[0] > G.s(kSFinishX);
  const bool terminated = game_over || finished;
  if (game_over) reward = -100.0f;
  const int32_t t_new = t_in[row] + 1;

  const int64_t n64 = n;
#pragma unroll
  for (int b = 0; b < kBodies; ++b) {
    out[kStepPos * n64 + row * 10 + 2 * b] = px[b];
    out[kStepPos * n64 + row * 10 + 2 * b + 1] = py[b];
    out[kStepVel * n64 + row * 10 + 2 * b] = vx[b];
    out[kStepVel * n64 + row * 10 + 2 * b + 1] = vy[b];
    out[kStepAngle * n64 + row * 5 + b] = ang[b];
    out[kStepOmega * n64 + row * 5 + b] = om[b];
  }
  out[kStepPrev * n64 + row] = shape;
#pragma unroll
  for (int j = 0; j < kJoints; ++j) {
    out[kStepAccJoint * n64 + row * 8 + 2 * j] = accJx[j];
    out[kStepAccJoint * n64 + row * 8 + 2 * j + 1] = accJy[j];
    out[kStepAccMotor * n64 + row * 4 + j] = accM[j];
    out[kStepAccLimit * n64 + row * 4 + j] = accL[j];
  }
#pragma unroll
  for (int c = 0; c < kContacts; ++c) {
    out[kStepAccCn * n64 + row * 12 + c] = accN[c];
    out[kStepAccCt * n64 + row * 12 + c] = accT[c];
  }
#pragma unroll
  for (int k = 0; k < kObs; ++k) out[kStepObs * n64 + row * kObs + k] = obs[k];
  out[kStepReward * n64 + row] = reward;
  t_out[row] = t_new;
  term_out[row] = terminated ? 1 : 0;
  trunc_out[row] = (t_new >= max_steps && !terminated) ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
    reset_kernel(const float* __restrict__ geom,
                 const float* __restrict__ draw, float* __restrict__ out,
                 int32_t* __restrict__ t_out, int n) {
  __shared__ float smem[kGeomSize];
  load_geom(geom, smem);
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const Geom G{smem};
  const int64_t n64 = n;
  const float* u = draw + static_cast<int64_t>(row) * kDraw;
  float* terrain = out + kResetTerrain * n64 + static_cast<int64_t>(row) *
                                                   kTerrain;

  // _gen_terrain: the grass-only random walk
  const float th = G.s(kSTerrainHeight);
  float y = th, vel = 0.0f;
  for (int i = 0; i < kTerrain; ++i) {
    vel = 0.8f * vel + 0.01f * signf(th - y);
    if (i > kStartpad) vel = vel + u[i] / 30.0f;
    y = y + vel;
    terrain[i] = y;
  }

  float px[kBodies], py[kBodies], vx[kBodies], vy[kBodies], ang[kBodies],
      om[kBodies];
#pragma unroll
  for (int b = 0; b < kBodies; ++b) {
    px[b] = G.g[kGeomSpawnPos + 2 * b] + u[kTerrain + 2 * b];
    py[b] = G.g[kGeomSpawnPos + 2 * b + 1] + u[kTerrain + 2 * b + 1];
    vx[b] = 0.0f;
    vy[b] = 0.0f;
    ang[b] = G.g[kGeomSpawnAngle + b];
    om[b] = 0.0f;
  }
  // the terrain row this thread wrote is read back through its own writes
  float obs[kObs];
  observe(G, terrain, px, py, vx, vy, ang, om, obs);

#pragma unroll
  for (int b = 0; b < kBodies; ++b) {
    out[kResetPos * n64 + row * 10 + 2 * b] = px[b];
    out[kResetPos * n64 + row * 10 + 2 * b + 1] = py[b];
    out[kResetVel * n64 + row * 10 + 2 * b] = 0.0f;
    out[kResetVel * n64 + row * 10 + 2 * b + 1] = 0.0f;
    out[kResetAngle * n64 + row * 5 + b] = ang[b];
    out[kResetOmega * n64 + row * 5 + b] = 0.0f;
  }
  out[kResetPrev * n64 + row] = shaping(px[0], ang[0]);
  for (int k = 0; k < 8; ++k) out[kResetAccJoint * n64 + row * 8 + k] = 0.0f;
  for (int k = 0; k < 4; ++k) {
    out[kResetAccMotor * n64 + row * 4 + k] = 0.0f;
    out[kResetAccLimit * n64 + row * 4 + k] = 0.0f;
  }
  for (int k = 0; k < 12; ++k) {
    out[kResetAccCn * n64 + row * 12 + k] = 0.0f;
    out[kResetAccCt * n64 + row * 12 + k] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kObs; ++k)
    out[kResetObs * n64 + row * kObs + k] = obs[k];
  t_out[row] = 0;
}

__global__ void empty_kernel() {}

inline int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// The layout's sizes, read by the wrapper to check its packing.
int bipedal_geom_size() { return kGeomSize; }
int bipedal_step_floats() { return kStepFloats; }
int bipedal_reset_floats() { return kResetFloats; }
// The float operations a row the bound counts (see kStepOps).
int bipedal_step_ops() { return kStepOps; }
int bipedal_reset_ops() { return kResetOps; }
int bipedal_lidar_sample_ops() { return kLidarSampleOps; }

// K2: one step of n rows. Each input is a contiguous (n, ...) field of the
// walker's state; out is (kStepFloats * n) floats, the new state's fields,
// the observation and the reward, each a contiguous (n, ...) field at its
// offset. Returns the launch's CUDA error (0 on success).
int bipedal_step_launch(const float* geom, const float* terrain,
                        const float* pos, const float* vel, const float* angle,
                        const float* omega, const float* prev_shaping,
                        const int32_t* t, const float* acc_joint,
                        const float* acc_motor, const float* acc_limit,
                        const float* acc_cn, const float* acc_ct,
                        const float* action, float* out, int32_t* t_out,
                        uint8_t* terminated, uint8_t* truncated, int n,
                        int max_steps, void* stream) {
  if (n <= 0) return 0;
  step_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      geom, terrain, pos, vel, angle, omega, prev_shaping, t, acc_joint,
      acc_motor, acc_limit, acc_cn, acc_ct, action, out, t_out, terminated,
      truncated, n, max_steps);
  return static_cast<int>(cudaGetLastError());
}

// K3: the reset of n rows from their (n, 210) draws; out is
// (kResetFloats * n) floats, the terrain and the start state's fields and
// observation at their offsets. Returns the launch's CUDA error.
int bipedal_reset_launch(const float* geom, const float* draw, float* out,
                         int32_t* t_out, int n, void* stream) {
  if (n <= 0) return 0;
  reset_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      geom, draw, out, t_out, n);
  return static_cast<int>(cudaGetLastError());
}

// The empty kernel on K2's / K3's grid for n rows: the launch floor.
int bipedal_floor_launch(int n, void* stream) {
  if (n <= 0) return 0;
  empty_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
