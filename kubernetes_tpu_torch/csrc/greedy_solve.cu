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

#include "solve_common.cuh"

namespace {

using namespace solve;

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
    const bool all_zero = pod_all_zero(preq, r);
    int m = midx[t];
    m = m < 0 ? 0 : (m >= u ? u - 1 : m);  // gathers clamp, as in JAX
    const uint8_t* mask = rows + static_cast<size_t>(m) * n;

    float best = -INFINITY;
    int best_i = kNoIndex;
    for (int j = tid; j < n; j += kThreads) {
      if (!valid[j] || !mask[j]) continue;
      const int* a = alloc + static_cast<size_t>(j) * r;
      const int* q = req_out + static_cast<size_t>(j) * r;
      if (!fits_node(a, q, preq, r, all_zero)) continue;
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
    best_i = block_argmax(best, best_i, s_score, s_index);
    if (tid == 0) {
      const bool placed = best_i != kNoIndex;
      asg[t] = placed ? best_i : -1;
      if (placed) {
        int* q = req_out + static_cast<size_t>(best_i) * r;
        for (int d = 0; d < r; ++d) q[d] = add_wrap(q[d], preq[d]);
        nzr_out[best_i * 2] = add_wrap(nzr_out[best_i * 2], p0);
        nzr_out[best_i * 2 + 1] = add_wrap(nzr_out[best_i * 2 + 1], p1);
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
