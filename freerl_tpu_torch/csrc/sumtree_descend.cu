// Batched stratified sum-tree descent for prioritized replay (PER sampling).
//
// Replaces the TPU kernel freerl_tpu/ops/sumtree_pallas.py:_top_kernel /
// sumtree_descend (the pl.pallas_call at line 92). That kernel walks the top
// levels with one-hot MXU lookups only because Mosaic has no vector gather;
// a Hopper thread indexes memory directly, so this kernel does the whole
// descent, all `depth` levels and the final clip, in one launch.
//
// Tree layout: root at index 1, children of node n at 2n and 2n+1, leaves at
// [capacity, 2*capacity). For each mass u the descent reads the left child's
// sum; if u > left it goes right and subtracts left from u. The result is
// clip(node - capacity, 0, capacity - 1). The descent only compares and
// subtracts in f32 (nothing to contract into an FMA, no reassociation), so
// the result is bit for bit that of the plain version
// (freerl_tpu_torch/ops/sumtree.py:sumtree_descend_ref).
//
// What bounds it on this card: the chain of dependent loads, not bytes. At
// the main path's shape (capacity 2^20, depth 20, B 256) a call needs about
// 15 KB (the distinct nodes read, u in, idx out): a few nanoseconds at
// 3.35 TB/s. The whole 8 MB tree sits in the 50 MB L2, so each level a
// sample descends costs one L2 round trip if it is fetched on its own, and
// the time is (dependent load rounds) x (L2 latency) plus the launch.
//
// Design: spend lanes to shorten the chain. A group of G lanes serves one
// sample and descends K levels per load round. The left children a sample
// can need in the K levels below node n are the 2^K - 1 even nodes
// 2(n*2^t + p), t < K, p < 2^t: K short contiguous runs (row t spans
// 2^(t+1) floats; at K = 7 the deepest row is four 128-byte lines). Each
// lane loads its share of them (slot s of the subtree in heap order,
// L = ceil((2^K - 1) / G) loads a lane, all issued at once), so the group
// pays one memory latency for K levels; then the group walks the K levels
// in registers, reading each needed left child from the lane that holds it
// with __shfl_sync. Every lane of a group carries the same node and mass,
// and every round has the same length for every sample, so no lane
// diverges. Depth 20 takes ceil(20 / K) dependent rounds (3 at K = 7,
// against 20 dependent steps in a one-thread-per-sample descent); a depth
// that is not a multiple of K ends with a shorter round with lanes masked.
// There is no shared-memory staging: the top rounds read the same lines for
// every sample and L1/L2 serve them. A block holds 128 / G samples, so
// B = 256 spreads over 256 * G / 128 blocks (64 at G = 32).
//
// K and G are compile-time constants (SUMTREE_LEVELS_PER_ROUND,
// SUMTREE_GROUP). The default, K = 7 with G = 32 (four loads a lane), was
// the fastest of the pairs scripts/sumtree_sweep.py builds with -D and
// times; PERF.md has the times. The kernel allocates nothing.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef SUMTREE_LEVELS_PER_ROUND
#define SUMTREE_LEVELS_PER_ROUND 7
#endif
#ifndef SUMTREE_GROUP
#define SUMTREE_GROUP 32
#endif

namespace {

constexpr int kThreads = 128;
constexpr int kLevels = SUMTREE_LEVELS_PER_ROUND;  // K
constexpr int kGroup = SUMTREE_GROUP;              // G
constexpr int kSlots = (1 << kLevels) - 1;         // left children per round
constexpr int kLoads = (kSlots + kGroup - 1) / kGroup;
static_assert(kGroup >= 1 && kGroup <= 32 && (kGroup & (kGroup - 1)) == 0,
              "a group is a power of two of at most 32 lanes");
static_assert(kLevels >= 1 && kLevels <= 10, "1 <= K <= 10");

// Level T of a round: the left child of heap position h is slot h - 1, one
// of row T's slots [2^T - 1, 2^(T+1) - 2]. Pick the register that holds it
// (the same choice in every lane of the group), read it from the lane that
// holds it, compare and step; then level T + 1, while T + 1 < r.
template <int T>
__device__ __forceinline__ void walk(const float (&v)[kLoads], int r, int& h,
                                     float& mass) {
  if constexpr (T < kLevels) {
    if (T < r) {
      constexpr int kFirst = ((1 << T) - 1) / kGroup;
      constexpr int kLast = ((1 << (T + 1)) - 2) / kGroup;
      const int s = h - 1;
      float held = v[kFirst];
#pragma unroll
      for (int i = kFirst + 1; i <= kLast; ++i) {
        if (s >= i * kGroup) held = v[i];
      }
      const float left = __shfl_sync(0xffffffffu, held, s % kGroup, kGroup);
      const bool right = mass > left;
      h = 2 * h + (right ? 1 : 0);
      mass = right ? __fsub_rn(mass, left) : mass;
      walk<T + 1>(v, r, h, mass);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
sumtree_descend_kernel(const float* __restrict__ tree,
                       const float* __restrict__ u,
                       int32_t* __restrict__ out,
                       int B, int depth, int capacity) {
  const int lane = threadIdx.x % kGroup;
  const int b = (blockIdx.x * kThreads + threadIdx.x) / kGroup;
  // Groups past the batch run the same rounds on the last sample, so that
  // every lane of a warp takes part in each shuffle; they store nothing.
  float mass = __ldg(u + (b < B ? b : B - 1));

  // Slot s = i * G + lane is heap position s + 1 of the K-level subtree
  // below the current node: row t (its left child is t + 1 levels down) and
  // offset p within the row. They do not change from round to round.
  int row[kLoads], off[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int h = i * kGroup + lane + 1;
    row[i] = 31 - __clz(h);
    off[i] = h - (1 << row[i]);
  }

  int node = 1;
  for (int level = 0; level < depth; level += kLevels) {
    const int r = depth - level < kLevels ? depth - level : kLevels;
    const int n_slots = (1 << r) - 1;
    float v[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      v[i] = i * kGroup + lane < n_slots
                 ? __ldg(tree + 2 * ((node << row[i]) + off[i]))
                 : 0.0f;
    }
    int h = 1;  // heap position of the current node within the round
    walk<0>(v, r, h, mass);
    node = (node << r) + (h - (1 << r));
  }
  if (b < B && lane == 0) {
    int leaf = node - capacity;
    leaf = leaf < 0 ? 0 : leaf;
    leaf = leaf > capacity - 1 ? capacity - 1 : leaf;
    out[b] = leaf;
  }
}

__global__ void empty_kernel() {}

constexpr int kSamplesPerBlock = kThreads / kGroup;
constexpr int kMaxBatch = (INT_MAX - kThreads) / kGroup;

int blocks_for(int B) {
  return (B + kSamplesPerBlock - 1) / kSamplesPerBlock;
}

}  // namespace

// tree: (2*capacity,) f32; u: (B,) f32; out: (B,) int32, all on the device.
// capacity == 2^depth, depth <= 30, B >= 1. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int sumtree_descend_launch(const float* tree, const float* u,
                                      int32_t* out, int B, int depth,
                                      int capacity, void* stream) {
  if (B < 1 || B > kMaxBatch || depth < 0 || depth > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sumtree_descend_kernel<<<blocks_for(B), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      tree, u, out, B, depth, capacity);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on the descent's grid for B samples: the launch floor the
// descent is timed against. Returns cudaGetLastError().
extern "C" int sumtree_descend_floor_launch(int B, void* stream) {
  if (B < 1 || B > kMaxBatch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  empty_kernel<<<blocks_for(B), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
