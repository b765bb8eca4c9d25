// Greedy batch solve for Hopper (sm_90a): the whole pod batch in ONE launch.
//
// Replaces: kubernetes_tpu/ops/pallas_solver.py::_solver_kernel (entry
// pallas_greedy_solve, step body _step_fit_score_argmax). Its plain PyTorch
// version is kubernetes_tpu_torch/ops/assignment.py::_greedy_assign_impl,
// and the wrapper is kubernetes_tpu_torch/ops/greedy_kernel.py.
//
// What it computes, for each pod t in solve order:
//   fit      against free = alloc - req (the pods dim always; fixed dims
//            strictly; scalar dims only when requested; a pod whose other
//            requests are all zero checks only the pods dim), AND the pod's
//            static-mask row rows[midx[t]] AND valid;
//   score    w_least*Least + w_balanced*Balanced + w_most*Most on
//            (cpu, memKiB), in float32 with the +1e-4 floors of
//            ops/scores.py. The node total and the pod's non-zero request
//            are summed in int32 and THEN cast (exact below 2^31). Every
//            float op is an explicit round-to-nearest intrinsic, so nvcc
//            never contracts a multiply-add into an FMA (and the build also
//            passes -fmad=false);
//   pick     masked argmax, the LOWEST node index wins among equal maxima;
//            asg[t] = -1 when nothing is feasible or the pod is inactive;
//   bump     req/nzr of the winner by the pod's request.
//
// Design: one block of 1024 threads walks the B pods in order (an inactive
// pod costs one uniform branch, no step); thread k owns
// nodes k, k+1024, ... Per pod: each thread fits and scores its nodes and
// keeps its best (score, index); a warp-shuffle reduction then a reduction
// over the 32 warp results in shared memory picks the winner; thread 0
// writes asg[t] and bumps the winner's row in device memory; __syncthreads()
// orders that write before the next pod's reads. The state (req_out,
// nzr_out) lives in device memory -- at the burst's N = 5,632 and R = 4 the
// state, alloc and mask rows (~320 KB) stay in L2.
//
// What bounds it on this card: neither bytes nor operations. The inputs are
// read once in principle (a few hundred KB) and the work is ~40 fp32 ops per
// pod x node pair (~1 GFLOP for a 4,096 x 5,632 batch: ~15 us at 67 TFLOP/s),
// but pod t+1 depends on pod t's pick, so the batch is a chain of B
// dependent block-wide steps on ONE SM: per step a pass over the node state
// from L1/L2 plus two block barriers and a two-level reduction. The simple
// design leaves on the table: the other 131 SMs (a thread-block cluster with
// distributed shared memory, or a cooperative grid with one grid barrier per
// pod), keeping each thread's node state in registers or shared memory
// instead of re-reading it per step, and recomputing only the winner's
// score after a bump instead of every node's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

__global__ void __launch_bounds__(kThreads) greedy_solve_kernel(
    const int* __restrict__ alloc,          // [N, R]
    const int* __restrict__ req_in,         // [N, R]
    const int* __restrict__ nzr_in,         // [N, 2]
    const uint8_t* __restrict__ valid,      // [N]
    const int* __restrict__ pod_req,        // [B, R]
    const int* __restrict__ pod_nzr,        // [B, 2]
    const uint8_t* __restrict__ rows,       // [U, N]
    const int* __restrict__ midx,           // [B]
    const uint8_t* __restrict__ active,     // [B]
    int* asg,                               // [B]   out
    int* req_out,                           // [N, R] out (carry)
    int* nzr_out,                           // [N, 2] out (carry)
    int n, int r, int b, int u,
    int w_least, int w_balanced, int w_most) {
  __shared__ float s_score[kWarps];
  __shared__ int s_index[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int j = tid; j < n; j += kThreads) {
    for (int d = 0; d < r; ++d) req_out[j * r + d] = req_in[j * r + d];
    nzr_out[j * 2] = nzr_in[j * 2];
    nzr_out[j * 2 + 1] = nzr_in[j * 2 + 1];
  }
  __syncthreads();

  for (int t = 0; t < b; ++t) {
    // an inactive (padding or gang-masked) pod never bumps the state, so
    // the whole block skips its step: the branch is uniform across it
    if (!active[t]) {
      if (tid == 0) asg[t] = -1;
      continue;
    }
    const int* preq = pod_req + static_cast<size_t>(t) * r;
    const int p0 = pod_nzr[t * 2];
    const int p1 = pod_nzr[t * 2 + 1];
    // assignment._fits: every non-pods request <= 0 short-circuits to the
    // pods-dim check
    bool all_zero = true;
    for (int d = 0; d < r; ++d) {
      if (d != kPodsCol && preq[d] > 0) all_zero = false;
    }
    int m = midx[t];
    m = m < 0 ? 0 : (m >= u ? u - 1 : m);  // gathers clamp, as in JAX
    const uint8_t* mask = rows + static_cast<size_t>(m) * n;

    float best = -INFINITY;
    int best_i = kNoIndex;
    for (int j = tid; j < n; j += kThreads) {
      if (!valid[j] || !mask[j]) continue;
      const int* a = alloc + static_cast<size_t>(j) * r;
      const int* q = req_out + static_cast<size_t>(j) * r;
      bool fits_all = true;
      bool fits_pods = true;
      for (int d = 0; d < r; ++d) {
        const int s = preq[d];
        bool ok = s <= sub_wrap(a[d], q[d]);
        if (d >= kNumFixedDims && s == 0) ok = true;
        fits_all = fits_all && ok;
        if (d == kPodsCol) fits_pods = ok;
      }
      if (!(all_zero ? fits_pods : fits_all)) continue;
      const float req0 = static_cast<float>(add_wrap(nzr_out[j * 2], p0));
      const float req1 = static_cast<float>(add_wrap(nzr_out[j * 2 + 1], p1));
      const float score = combined_score(
          static_cast<float>(a[0]), static_cast<float>(a[1]), req0, req1,
          w_least, w_balanced, w_most);
      if (score > best) {  // nodes ascend, so the first max is kept
        best = score;
        best_i = j;
      }
    }
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
    if (warp == 0) {
      best = s_score[lane];  // kWarps == 32: one slot per lane
      best_i = s_index[lane];
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
        better(best, best_i, os, oi);
      }
      if (lane == 0) {
        const bool placed = best_i != kNoIndex;
        asg[t] = placed ? best_i : -1;
        if (placed) {
          int* q = req_out + static_cast<size_t>(best_i) * r;
          for (int d = 0; d < r; ++d) q[d] = add_wrap(q[d], preq[d]);
          nzr_out[best_i * 2] = add_wrap(nzr_out[best_i * 2], p0);
          nzr_out[best_i * 2 + 1] = add_wrap(nzr_out[best_i * 2 + 1], p1);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int greedy_solve_launch(
    const void* alloc, const void* req_in, const void* nzr_in,
    const void* valid, const void* pod_req, const void* pod_nzr,
    const void* rows, const void* midx, const void* active,
    void* asg, void* req_out, void* nzr_out,
    int n, int r, int b, int u,
    int w_least, int w_balanced, int w_most, void* stream) {
  greedy_solve_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(alloc), static_cast<const int*>(req_in),
      static_cast<const int*>(nzr_in), static_cast<const uint8_t*>(valid),
      static_cast<const int*>(pod_req), static_cast<const int*>(pod_nzr),
      static_cast<const uint8_t*>(rows), static_cast<const int*>(midx),
      static_cast<const uint8_t*>(active), static_cast<int*>(asg),
      static_cast<int*>(req_out), static_cast<int*>(nzr_out),
      n, r, b, u, w_least, w_balanced, w_most);
  return static_cast<int>(cudaGetLastError());
}
