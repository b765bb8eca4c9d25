// Device helpers shared by the greedy (K1), constrained (K2), preemption
// (K3) and mesh (K4) kernels: the fit test, the resource score, the
// (score, index) argmax step, the staging of a chunk of pods, the cluster
// step of K1, K2 and K4's batch entry (a (score, index) argmax over a
// thread-block cluster through distributed shared memory), the greedy
// batch loop that K1 and K4's batch entry share, and the host side of
// launching one cluster.
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
// opens with STEP_START() and reads `rank` and `tid` in scope. STEP_TIME
// starts a clock in any thread and STEP_ADD(i, ...) adds the cycles since
// it to counter i (for a phase that thread 0 of CTA 0 does not run).
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
#define STEP_TIME(name) const unsigned long long name = clock64()
#define STEP_ADD(i, name) atomicAdd(&solve::g_step_cycles[i], clock64() - (name))

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
#define STEP_TIME(name) \
  do {                  \
  } while (0)
#define STEP_ADD(i, name) \
  do {                    \
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

// -- a chunk of pods staged in shared memory (K1, K4's batch entry) ---------

constexpr int kChunk = 32;  // pods staged at once: one bit each per row

// a chunk's pod parameters in shared memory: request [kChunk][R], nzr
// [kChunk][2], mask row, flags (bit 0 active, bit 1 all-zero request)
struct PodChunk {
  int* req;
  int* nzr;
  int* midx;
  int* flags;
};

// int32 words of a PodChunk
__host__ __device__ __forceinline__ size_t pod_chunk_words(int r) {
  return static_cast<size_t>(kChunk) * (r + 4);
}

__device__ __forceinline__ PodChunk pod_chunk_at(int* base, int r) {
  PodChunk c;
  c.req = base;
  c.nzr = c.req + kChunk * r;
  c.midx = c.nzr + kChunk * 2;
  c.flags = c.midx + kChunk;
  return c;
}

// stage pods [t0, t0 + kChunk) of a batch of b (past b: inactive). Call
// from every thread of the CTA between two __syncthreads().
__device__ __forceinline__ void stage_pod_chunk(
    const PodChunk& c, const int* pod_req, const int* pod_nzr,
    const int* midx, const uint8_t* active, int t0, int b, int r, int u) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int steps = min(kChunk, b - t0);
  for (int i = tid; i < steps * r; i += nt) {
    c.req[i] = pod_req[static_cast<size_t>(t0) * r + i];
  }
  for (int i = tid; i < kChunk; i += nt) {
    const int p = t0 + i;
    int flags = 0;
    int m = 0;
    int z0 = 0;
    int z1 = 0;
    if (p < b) {
      flags = (active[p] ? 1 : 0) |
              (pod_all_zero(pod_req + static_cast<size_t>(p) * r, r) ? 2 : 0);
      m = midx[p];
      m = m < 0 ? 0 : (m >= u ? u - 1 : m);  // gathers clamp, as in JAX
      z0 = pod_nzr[p * 2];
      z1 = pod_nzr[p * 2 + 1];
    }
    c.flags[i] = flags;
    c.midx[i] = m;
    c.nzr[i * 2] = z0;
    c.nzr[i * 2 + 1] = z1;
  }
}

// valid AND the chunk's mask rows, one bit per pod, for the rows [lo, lo
// + len) of an n-column mask ([U, n] rows, [n] valid): s_bits[l] holds
// row lo + l's bits, each written and later read by the thread that
// owns the row.
__device__ __forceinline__ void chunk_mask_bits(
    unsigned* s_bits, const uint8_t* valid, const uint8_t* rows, int n,
    int lo, int len, const int* s_pmidx) {
  for (int l = threadIdx.x; l < len; l += blockDim.x) {
    const size_t j = static_cast<size_t>(lo + l);
    unsigned bits = 0u;
    if (valid[j]) {
#pragma unroll 8
      for (int i = 0; i < kChunk; ++i) {
        if (rows[static_cast<size_t>(s_pmidx[i]) * n + j]) bits |= 1u << i;
      }
    }
    s_bits[l] = bits;
  }
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

// -- the greedy batch over a cluster (K1, K4's batch entry) -----------------
//
// A CTA's share of a greedy batch solve: thread i owns the rows lo + i,
// lo + i + threads, ... of the CTA's slice [lo, hi) of a view of node
// rows (K1: all N rows; K4: one shard), view row j being the cluster-wide
// index off + j. Per active pod t: each thread scores its own rows, one
// cluster step (cluster_publish / cluster_collect, slots alternating by
// step parity) gives every thread the winner (max score, then min
// cluster-wide index), `on_step(t, slots)` runs in every thread, and the
// thread that owns the winner bumps its own copy with no barrier.
//   resident  (template flag): the slice's alloc / req / nzr columns live
//             in shared memory for the launch, loaded once and written to
//             req_out / nzr_out once at the end; per chunk of 32 pods each
//             thread folds valid AND the pods' mask rows into one 32-bit
//             word per row, so a step reads no device memory.
//   streaming the state is read from and bumped in req_out / nzr_out, the
//             mask row read from device memory (L2).
// The pods' parameters are staged 32 at a time, behind two CTA barriers
// per chunk. An inactive pod is a skip that every CTA takes alike.

// dynamic shared memory of one CTA: the chunk's pod parameters, then
// (resident) alloc [R][cap], req [R][cap], nzr [2][cap] and mask bits
// [cap] (ops/greedy_kernel.py plan_for, ops/shard_kernel.py
// plan_for_batch)
inline size_t greedy_smem_bytes(int r, int cap, bool resident) {
  size_t ints = pod_chunk_words(r);
  if (resident) ints += static_cast<size_t>(cap) * (2 * r + 3);
  return ints * sizeof(int);
}

struct GreedyRows {
  const int* alloc;      // [n, R]
  const int* req_in;     // [n, R]
  int* req_out;          // [n, R]; (req_out, nzr_out) may be (req_in,
  const int* nzr_in;     // [n, 2]   nzr_in): updated in place
  int* nzr_out;          // [n, 2]
  const uint8_t* valid;  // [n]
  const uint8_t* rows;   // [U, n] the view's mask columns
  int n;                 // the view's rows
  int lo, hi;            // this CTA's slice of them
  int off;               // view row j is cluster-wide index off + j
  int cap;               // the largest CTA slice: the resident stride
};

struct GreedyPods {
  const int* pod_req;     // [B, R]
  const int* pod_nzr;     // [B, 2]
  const int* midx;        // [B]
  const uint8_t* active;  // [B]
  int* asg;               // [B] out: the winner's cluster-wide index or -1
  int r, b, u;
  int w_least, w_balanced, w_most;
  // the scored entry (kScored): [B, prior_n] f32, pod t's row added to
  // the resource score of cluster-wide index i at prior[t * prior_n + i]
  const float* prior = nullptr;
  int prior_n = 0;
};

using ClusterSlots = unsigned long long[kMaxCluster * kClusterWarps];

// The whole batch; call from every thread of every CTA of the cluster
// (s_dyn: greedy_smem_bytes of dynamic shared memory; s_slots: a static
// shared array, the same in every CTA). Ends with a cluster barrier.
// kScored (K1's scored entry, the sinkhorn commit scan): a feasible
// row's score is prior[t][i] + the resource score, rounded once, where
// i is its cluster-wide index; each step reads one coalesced slice of
// the prior row per CTA and nothing else changes.
template <bool kResident, bool kScored = false, class OnStep>
__device__ __forceinline__ void greedy_cluster_solve(
    const GreedyRows& v, const GreedyPods& a, int* s_dyn,
    ClusterSlots* s_slots, int cluster, int rank, OnStep on_step) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int r = a.r;
  const int lo = v.lo;
  const int len = v.hi - v.lo;
  const int cap = v.cap;
  const PodChunk chunk = pod_chunk_at(s_dyn, r);
  int* s_alloc = s_dyn + pod_chunk_words(r);  // [R][cap]  (resident)
  int* s_req = s_alloc + r * cap;             // [R][cap]
  int* s_nzr = s_req + r * cap;               // [2][cap]
  unsigned* s_bits = reinterpret_cast<unsigned*>(s_nzr + 2 * cap);  // [cap]

  if (kResident || v.req_out != v.req_in) {
    for (int l = tid; l < len; l += nt) {
      const size_t j = static_cast<size_t>(lo + l);
      for (int d = 0; d < r; ++d) {
        if (kResident) {
          s_alloc[d * cap + l] = v.alloc[j * r + d];
          s_req[d * cap + l] = v.req_in[j * r + d];
        } else {
          v.req_out[j * r + d] = v.req_in[j * r + d];
        }
      }
      if (kResident) {
        s_nzr[l] = v.nzr_in[j * 2];
        s_nzr[cap + l] = v.nzr_in[j * 2 + 1];
      } else {
        v.nzr_out[j * 2] = v.nzr_in[j * 2];
        v.nzr_out[j * 2 + 1] = v.nzr_in[j * 2 + 1];
      }
    }
  }
  // every CTA of the cluster is running before any store into its slots
  cluster_barrier();

  const int stride = kResident ? cap : 1;
  int phase = 0;
  STEP_START();
  for (int t0 = 0; t0 < a.b; t0 += kChunk) {
    const int steps = min(kChunk, a.b - t0);
    __syncthreads();  // the previous chunk's readers are done
    stage_pod_chunk(chunk, a.pod_req, a.pod_nzr, a.midx, a.active, t0, a.b,
                    r, a.u);
    __syncthreads();
    if (kResident) {  // valid AND the chunk's mask rows, one bit per pod
      chunk_mask_bits(s_bits, v.valid, v.rows, v.n, lo, len, chunk.midx);
    }

    STEP_MARK(0);  // chunk staging
    for (int i = 0; i < steps; ++i) {
      const int t = t0 + i;
      const int flags = chunk.flags[i];
      // an inactive (padding or gang-masked) pod places nowhere and
      // changes nothing: every CTA skips its step alike
      if (!(flags & 1)) {
        if (rank == 0 && tid == 0) a.asg[t] = -1;
        continue;
      }
      const int* preq = chunk.req + i * r;
      const int p0 = chunk.nzr[i * 2];
      const int p1 = chunk.nzr[i * 2 + 1];
      const bool all_zero = flags & 2;
      const uint8_t* mrow = v.rows + static_cast<size_t>(chunk.midx[i]) * v.n;

      STEP_MARK(1);  // the last step's bump, this step's parameters
      float best = -INFINITY;
      int best_j = kNoIndex;
      for (int l = tid; l < len; l += nt) {
        const int j = lo + l;
        // the scored entry's prior, loaded first so that its latency
        // overlaps the fit test and the score
        const float pv =
            kScored ? a.prior[static_cast<size_t>(t) * a.prior_n + v.off + j] : 0.0f;
        const bool ok = kResident ? ((s_bits[l] >> i) & 1u) != 0u
                                  : (v.valid[j] && mrow[j]);
        if (!ok) continue;
        const int* al = kResident ? s_alloc + l : v.alloc + static_cast<size_t>(j) * r;
        const int* q = kResident ? s_req + l : v.req_out + static_cast<size_t>(j) * r;
        if (!fits_node_strided(al, q, stride, preq, r, all_zero)) continue;
        const int n0 = kResident ? s_nzr[l] : v.nzr_out[j * 2];
        const int n1 = kResident ? s_nzr[cap + l] : v.nzr_out[j * 2 + 1];
        float score = combined_score(
            static_cast<float>(al[0]), static_cast<float>(al[stride]),
            static_cast<float>(add_wrap(n0, p0)),
            static_cast<float>(add_wrap(n1, p1)),
            a.w_least, a.w_balanced, a.w_most);
        if (kScored) score = __fadd_rn(pv, score);  // `row + score_dyn`
        if (score > best) {  // a thread's rows ascend: the first max is kept
          best = score;
          best_j = j;
        }
      }
      STEP_MARK(2);  // scoring this thread's rows
      unsigned long long* slots = s_slots[phase & 1];
      cluster_publish(
          pack_best(best, best_j == kNoIndex ? kNoIndex : v.off + best_j),
          slots, cluster, rank);
      const int win = best_index(cluster_collect(slots, cluster));
      STEP_MARK(3);  // the cluster step
      ++phase;
      on_step(t, static_cast<const unsigned long long*>(slots));
      if (rank == 0 && tid == 0) a.asg[t] = win == kNoIndex ? -1 : win;
      const int wl = win - v.off - lo;  // the winner's row in this slice
      if (win != kNoIndex && wl >= 0 && wl < len && wl % nt == tid) {
        const size_t j = static_cast<size_t>(lo + wl);
        int* q = kResident ? s_req + wl : v.req_out + j * r;
        for (int d = 0; d < r; ++d) q[d * stride] = add_wrap(q[d * stride], preq[d]);
        if (kResident) {
          s_nzr[wl] = add_wrap(s_nzr[wl], p0);
          s_nzr[cap + wl] = add_wrap(s_nzr[cap + wl], p1);
        } else {
          v.nzr_out[j * 2] = add_wrap(v.nzr_out[j * 2], p0);
          v.nzr_out[j * 2 + 1] = add_wrap(v.nzr_out[j * 2 + 1], p1);
        }
      }
    }
  }

  if (kResident) {
    for (int l = tid; l < len; l += nt) {
      const size_t j = static_cast<size_t>(lo + l);
      for (int d = 0; d < r; ++d) v.req_out[j * r + d] = s_req[d * cap + l];
      v.nzr_out[j * 2] = s_nzr[l];
      v.nzr_out[j * 2 + 1] = s_nzr[cap + l];
    }
  }
  // no CTA leaves while another may still store into its shared memory
  cluster_barrier();
}

// -- launching ONE cluster (host) -------------------------------------------

// a cluster's threads and CTAs as the kernels take them
inline bool valid_cluster_shape(int cluster, int threads, int min_threads = 32) {
  return cluster >= 1 && cluster <= kMaxCluster && threads >= min_threads &&
         threads <= kClusterThreads && threads % 32 == 0;
}

// the launch of one cluster of `cluster` CTAs of `threads` threads, each
// with `smem` bytes of dynamic shared memory (16 CTAs is sm_90's
// non-portable maximum, so the kernel opts in)
template <class Kernel>
cudaError_t configure_cluster(Kernel kernel, cudaLaunchConfig_t* cfg,
                              cudaLaunchAttribute* attr, int cluster,
                              int threads, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster, 1, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// how many clusters of this shape the card holds at once
// (cudaOccupancyMaxActiveClusters; 0 when it refuses the shape)
template <class Kernel>
int cluster_occupancy(Kernel kernel, int cluster, int threads, int smem) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure_cluster(kernel, &cfg, &attr, cluster, threads, smem);
  int count = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused configuration admits no cluster
    return 0;
  }
  return count;
}

// launch one cluster on `stream`; returns the launch's cudaError_t
template <class Kernel, class... Args>
int launch_cluster(Kernel kernel, int cluster, int threads, int smem,
                   cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure_cluster(kernel, &cfg, &attr, cluster, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// static shared memory of one CTA of a kernel, or -1
template <class Kernel>
int static_smem_bytes(Kernel kernel) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return static_cast<int>(attr.sharedSizeBytes);
}

}  // namespace solve
