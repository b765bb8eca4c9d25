// Device helpers shared by the greedy (K1), constrained (K2), preemption
// (K3) and shard-candidate (K4) kernels: the fit test, the resource
// score, the (score, index) argmax step and a block-wide minimum of a
// struct key.
// Each matches its plain PyTorch version in ops/assignment.py and
// ops/scores.py op for op: every float op is an explicit round-to-nearest
// intrinsic, so nvcc never contracts a multiply-add into an FMA (the
// build also passes -fmad=false).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace solve {

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
// dims strictly, scalar dims only when the pod requests them
__device__ __forceinline__ bool fits_node(
    const int* a, const int* q, const int* preq, int r, bool all_zero) {
  bool fits_all = true;
  bool fits_pods = true;
  for (int d = 0; d < r; ++d) {
    const int s = preq[d];
    bool ok = s <= sub_wrap(a[d], q[d]);
    if (d >= kNumFixedDims && s == 0) ok = true;
    fits_all = fits_all && ok;
    if (d == kPodsCol) fits_pods = ok;
  }
  return all_zero ? fits_pods : fits_all;
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

}  // namespace solve
