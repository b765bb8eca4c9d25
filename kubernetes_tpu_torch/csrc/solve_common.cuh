// Device helpers shared by the greedy (K1), constrained (K2), preemption
// (K3) and shard-candidate (K4) kernels: the fit test, the resource
// score, the (score, index) argmax step, a block-wide minimum of a
// struct key, and the cluster step of K1 and K2 (a (score, index)
// argmax over a thread-block cluster through distributed shared memory).
// Each matches its plain PyTorch version in ops/assignment.py and
// ops/scores.py op for op: every float op is an explicit round-to-nearest
// intrinsic, so nvcc never contracts a multiply-add into an FMA (the
// build also passes -fmad=false).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace solve {

// Step-phase cycle counters for tools/step_profile.py, compiled only with
// -DSOLVE_STEP_PROFILE (every mark is empty otherwise): thread 0 of CTA 0
// adds the clock64 cycles since its previous mark to counter i. A kernel
// opens with STEP_START() and reads `rank` and `tid` in scope.
#ifdef SOLVE_STEP_PROFILE
__device__ unsigned long long g_step_cycles[16];
#define STEP_START() unsigned long long step_t_ = clock64()
#define STEP_MARK(i)                                         \
  do {                                                       \
    if (rank == 0 && tid == 0) {                             \
      const unsigned long long now_ = clock64();             \
      solve::g_step_cycles[i] += now_ - step_t_;             \
      step_t_ = now_;                                        \
    }                                                        \
  } while (0)

// copy the counters out and zero them (host)
inline int read_step_cycles(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) {
    err = cudaMemcpyFromSymbol(out, g_step_cycles, sizeof(g_step_cycles));
  }
  const unsigned long long zero[16] = {};
  if (err == cudaSuccess) {
    err = cudaMemcpyToSymbol(g_step_cycles, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
#else
#define STEP_START() \
  do {               \
  } while (0)
#define STEP_MARK(i) \
  do {               \
  } while (0)
#endif

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPodsCol = 3;        // tensors/node_tensor.py PODS
constexpr int kNumFixedDims = 4;   // tensors/node_tensor.py NUM_FIXED_DIMS
constexpr int kNoIndex = 0x7fffffff;
constexpr float kMaxNodeScore = 100.0f;
constexpr float kEps = 1e-4f;

__device__ __forceinline__ int add_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int sub_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// assignment._fits: every non-pods request <= 0 short-circuits to the
// pods-dim check
__device__ __forceinline__ bool pod_all_zero(const int* preq, int r) {
  bool all_zero = true;
  for (int d = 0; d < r; ++d) {
    if (d != kPodsCol && preq[d] > 0) all_zero = false;
  }
  return all_zero;
}

// assignment._fits for one (pod, node): the pods dim always, the fixed
// dims strictly, scalar dims only when the pod requests them. Dim d of
// the node lies at a[d * stride] and q[d * stride] (1 for [N, R] rows in
// device memory, the slice length for a CTA's columns in shared memory).
__device__ __forceinline__ bool fits_node_strided(
    const int* a, const int* q, int stride, const int* preq, int r,
    bool all_zero) {
  bool fits_all = true;
  bool fits_pods = true;
  for (int d = 0; d < r; ++d) {
    const int s = preq[d];
    bool ok = s <= sub_wrap(a[d * stride], q[d * stride]);
    if (d >= kNumFixedDims && s == 0) ok = true;
    fits_all = fits_all && ok;
    if (d == kPodsCol) fits_pods = ok;
  }
  return all_zero ? fits_pods : fits_all;
}

__device__ __forceinline__ bool fits_node(
    const int* a, const int* q, const int* preq, int r, bool all_zero) {
  return fits_node_strided(a, q, 1, preq, r, all_zero);
}

// floor((d0 + d1) / 2 + eps): the two per-dim terms summed dim0 + dim1
__device__ __forceinline__ float half_sum_floor(float d0, float d1) {
  return floorf(__fadd_rn(__fdiv_rn(__fadd_rn(d0, d1), 2.0f), kEps));
}

// ops/scores.py least/most/balanced for one node, f32 op by op
__device__ __forceinline__ float combined_score(
    float cap0, float cap1, float req0, float req1,
    int w_least, int w_balanced, int w_most) {
  const float safe0 = fmaxf(cap0, 1.0f);
  const float safe1 = fmaxf(cap1, 1.0f);
  const bool out0 = (cap0 == 0.0f) || (req0 > cap0);
  const bool out1 = (cap1 == 0.0f) || (req1 > cap1);
  float score = 0.0f;
  if (w_least) {
    float r0 = floorf(__fadd_rn(
        __fdiv_rn(__fmul_rn(__fsub_rn(cap0, req0), kMaxNodeScore), safe0), kEps));
    float r1 = floorf(__fadd_rn(
        __fdiv_rn(__fmul_rn(__fsub_rn(cap1, req1), kMaxNodeScore), safe1), kEps));
    float s = half_sum_floor(out0 ? 0.0f : r0, out1 ? 0.0f : r1);
    score = __fadd_rn(score, __fmul_rn(static_cast<float>(w_least), s));
  }
  if (w_balanced) {
    float f0 = (cap0 == 0.0f) ? 1.0f : __fdiv_rn(req0, safe0);
    float f1 = (cap1 == 0.0f) ? 1.0f : __fdiv_rn(req1, safe1);
    float diff = fabsf(__fsub_rn(f0, f1));
    float ba = truncf(__fadd_rn(__fmul_rn(__fsub_rn(1.0f, diff), kMaxNodeScore), kEps));
    if (f0 >= 1.0f || f1 >= 1.0f) ba = 0.0f;
    score = __fadd_rn(score, __fmul_rn(static_cast<float>(w_balanced), ba));
  }
  if (w_most) {
    float r0 = floorf(__fadd_rn(__fdiv_rn(__fmul_rn(req0, kMaxNodeScore), safe0), kEps));
    float r1 = floorf(__fadd_rn(__fdiv_rn(__fmul_rn(req1, kMaxNodeScore), safe1), kEps));
    float s = half_sum_floor(out0 ? 0.0f : r0, out1 ? 0.0f : r1);
    score = __fadd_rn(score, __fmul_rn(static_cast<float>(w_most), s));
  }
  return score;
}

// (score, index) max with the lower index winning ties
__device__ __forceinline__ void better(float& s, int& i, float os, int oi) {
  if (os > s || (os == s && oi < i)) {
    s = os;
    i = oi;
  }
}

struct ScoreIndex {
  float score;
  int index;
};

// block-wide (score, index) argmax; every thread passes its own best and
// gets the block's (score, index) back. s_score/s_index are kWarps-long
// shared arrays. Contains __syncthreads(): call from every thread of the
// block.
__device__ __forceinline__ ScoreIndex block_best(
    float best, int best_i, float* s_score, int* s_index) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    better(best, best_i, os, oi);
  }
  if (lane == 0) {
    s_score[warp] = best;
    s_index[warp] = best_i;
  }
  __syncthreads();
  best = s_score[lane];  // kWarps == 32: one slot per lane
  best_i = s_index[lane];
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    better(best, best_i, os, oi);
  }
  return {__shfl_sync(0xffffffffu, best, 0), __shfl_sync(0xffffffffu, best_i, 0)};
}

// block_best's index alone
__device__ __forceinline__ int block_argmax(
    float best, int best_i, float* s_score, int* s_index) {
  return block_best(best, best_i, s_score, s_index).index;
}

// __shfl_down_sync / __shfl_sync of a trivially copyable struct, word by word
template <class T>
__device__ __forceinline__ T shfl_down_words(T v, int off) {
  static_assert(sizeof(T) % sizeof(int) == 0, "shuffle whole 32-bit words");
  int w[sizeof(T) / sizeof(int)];
  memcpy(w, &v, sizeof(T));
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T) / sizeof(int)); ++i) {
    w[i] = __shfl_down_sync(0xffffffffu, w[i], off);
  }
  memcpy(&v, w, sizeof(T));
  return v;
}

template <class T>
__device__ __forceinline__ T shfl_words(T v, int src) {
  int w[sizeof(T) / sizeof(int)];
  memcpy(w, &v, sizeof(T));
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T) / sizeof(int)); ++i) {
    w[i] = __shfl_sync(0xffffffffu, w[i], src);
  }
  memcpy(&v, w, sizeof(T));
  return v;
}

// block-wide minimum of a key under a strict total order `less` (a key
// that carries a unique index makes the result independent of the
// reduction order). Every thread passes its own key and gets the block's
// minimum back. s_warp is a kWarps-long shared array. Contains
// __syncthreads(): call from every thread of the block.
template <class T, class Less>
__device__ __forceinline__ T block_min(T v, T* s_warp, Less less) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const T o = shfl_down_words(v, off);
    if (less(o, v)) v = o;
  }
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  v = s_warp[lane];  // kWarps == 32: one slot per lane
  for (int off = 16; off > 0; off >>= 1) {
    const T o = shfl_down_words(v, off);
    if (less(o, v)) v = o;
  }
  return shfl_words(v, 0);
}

// -- the cluster step (K1, K2) ----------------------------------------------
//
// K1 and K2 run as ONE thread-block cluster of C CTAs (C <= 16), CTA k
// owning the contiguous node rows [k * N / C, (k + 1) * N / C). A step's
// winner is the (score, index) maximum over the cluster: max score, then
// min global index, which is the one-block argmax whatever the slices.
// Each warp folds its lanes' bests with two redux.sync, lanes 0..C-1
// store the warp's best into slot [rank * warps + warp] of every CTA of
// the cluster (distributed shared memory), one cluster barrier publishes
// the stores, and every warp of every CTA folds the C * warps slots of
// its own CTA: all threads of the cluster get the winner, and no CTA
// waits on another after the barrier.

constexpr int kMaxCluster = 16;       // non-portable cluster size on sm_90
constexpr int kClusterThreads = 512;  // most threads per CTA of a cluster
constexpr int kClusterWarps = kClusterThreads / 32;

// a float's bits as a uint32 whose unsigned order is the float order;
// -0 takes +0's key so equal scores tie exactly as `>` ties them
__device__ __forceinline__ unsigned ordered_bits(float f) {
  unsigned u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// (score, index) as one key whose unsigned maximum is the max score and,
// among equal scores, the LOWEST index; 0 (below every real score) is
// "no candidate"
__device__ __forceinline__ unsigned long long pack_best(float score, int index) {
  if (index == kNoIndex) return 0ull;
  return (static_cast<unsigned long long>(ordered_bits(score)) << 32) |
         static_cast<unsigned>(~index);
}

__device__ __forceinline__ int best_index(unsigned long long key) {
  return key == 0ull ? kNoIndex : static_cast<int>(~static_cast<unsigned>(key));
}

// warp-wide maximum of a key, returned to every lane: the high words'
// maximum, then the low words' maximum among the lanes that hold it.
// Call from all 32 lanes.
__device__ __forceinline__ unsigned long long warp_max_key(unsigned long long k) {
  const unsigned hi = static_cast<unsigned>(k >> 32);
  const unsigned top = __reduce_max_sync(0xffffffffu, hi);
  const unsigned lo =
      __reduce_max_sync(0xffffffffu, hi == top ? static_cast<unsigned>(k) : 0u);
  return (static_cast<unsigned long long>(top) << 32) | lo;
}

// every thread of the cluster arrives, then waits: arrive has release
// and wait acquire semantics by default, so shared (local and remote) and
// global stores made before it are visible to every thread of the cluster
// after it; also a CTA-wide barrier. Call from every thread of every CTA;
// .aligned: each warp reaches it converged.
__device__ __forceinline__ void cluster_barrier() {
  __syncwarp();
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// barrier.cluster split in its two halves, for a warp that has work to
// overlap with the cluster's wait (each thread arrives once, then waits
// once, per barrier)
__device__ __forceinline__ void cluster_arrive() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The first half of a cluster step: the warp's maximum key goes into slot
// [rank * warps + warp] of every CTA's `slots`, then the warp arrives at
// the cluster barrier. `slots` is a shared array of at least
// cluster * warps-per-CTA keys, the same array in every CTA, that no
// thread of the cluster reads or writes between this step's barrier and
// the previous one (a caller with no other cluster barrier in its step
// alternates two arrays by step parity: a CTA that runs ahead stores
// into the other array, and the next step's barrier lies between it and
// this one's readers).
__device__ __forceinline__ void cluster_publish(
    unsigned long long key, unsigned long long* slots, int cluster, int rank) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  key = warp_max_key(key);
  if (lane < cluster) {
    unsigned long long* dst =
        cooperative_groups::this_cluster().map_shared_rank(slots, lane);
    dst[rank * warps + warp] = key;
  }
  cluster_arrive();
}

// The second half: wait for the cluster, then fold the C * warps slots
// of this CTA; every lane gets the cluster-wide maximum key.
__device__ __forceinline__ unsigned long long cluster_collect(
    const unsigned long long* slots, int cluster) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  cluster_wait();
  unsigned long long best = 0ull;
  for (int i = lane; i < cluster * warps; i += 32) {
    const unsigned long long k = slots[i];
    best = k > best ? k : best;
  }
  return warp_max_key(best);
}

// One cluster step: the cluster-wide maximum of every thread's key,
// returned to every thread (cluster_publish, then cluster_collect).
// Contains one cluster barrier.
__device__ __forceinline__ unsigned long long cluster_best(
    unsigned long long key, unsigned long long* slots, int cluster, int rank) {
  cluster_publish(key, slots, cluster, rank);
  return cluster_collect(slots, cluster);
}

// first node row of CTA `rank`'s slice: rows [slice_lo(rank),
// slice_lo(rank + 1)) (ops/cluster_plan.slice_bounds)
__device__ __forceinline__ int slice_lo(int rank, int cluster, int n) {
  return static_cast<int>(static_cast<long long>(rank) * n / cluster);
}

}  // namespace solve
