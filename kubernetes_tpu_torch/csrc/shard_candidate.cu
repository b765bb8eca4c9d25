// Shard candidate for Hopper (sm_90a): ONE pod step of the node-sharded
// mesh tier, over every shard that lives on one device, in ONE launch.
//
// Replaces: kubernetes_tpu/ops/pallas_solver.py::_shard_candidate_kernel
// (entry pallas_shard_candidate, step body _step_fit_score_argmax, the
// same body the greedy kernel K1 runs per pod). Its plain PyTorch version
// is kubernetes_tpu_torch/ops/shard_kernel.py::shard_candidate_plain, and
// the wrapper is kubernetes_tpu_torch/ops/shard_kernel.py. The caller is
// the mesh solve in kubernetes_tpu_torch/ops/assignment.py, which owns
// the cross-shard combine (max score, then min global index) and the
// winner's bump, as the JAX package's shard_map body does around the
// Pallas kernel.
//
// What it computes, for pod t of the batch and each shard k (block k):
//   fit      against free = alloc_k - req_k over the shard's n_loc[k] rows
//            (K1's fits_node: the pods dim always, fixed dims strictly,
//            scalar dims only when requested, the all-zero short cut),
//            AND the pod's mask row rows_k[midx[t]] (the shard's own
//            columns) AND valid_k;
//   score    K1's combined_score on (cpu, memKiB), every float op an
//            explicit round-to-nearest intrinsic (and -fmad=false);
//   pick     the masked argmax, the LOWEST shard-local index winning ties.
// Output: out_score[k] = the best score, out_idx[k] = its shard-local
// index; (-inf, 0) when no row of the shard is feasible, as the TPU
// kernel's masked argmax gives. Never the kNoIndex sentinel: the caller
// adds the shard's offset to the index, and the sentinel would overflow.
//
// Design: one block of 1,024 threads per shard; thread j owns rows j,
// j + 1024, ...; a warp-shuffle then shared-memory (score, index)
// reduction (solve_common.cuh block_best). The shard pointers ride the
// launch as one by-value struct, so shards that share a device (the mesh
// ["cuda:0"] * 4 on one card) cost one launch per pod step, not one each.
// Nothing is written but the two outputs: the bump is the caller's.
//
// What bounds it on this card: the launch. At the mesh burst's shard
// shape (n_loc = 1,408, R = 4, U = 8) one launch over four shards reads
// ~59 KB (alloc and req 45 KB, nzr 11 KB, valid and one mask row 3 KB):
// ~0.00002 ms at 3.35 TB/s, and ~60 operations per row (~0.3 M per
// launch: ~0.00001 ms). A launch costs a few microseconds, and a batch
// of B pods is B dependent launches, each followed by the combine and the
// bump. The simple design leaves on the table: one persistent launch per
// batch that walks the pods and does the combine and the bump itself
// (the whole-batch kernel K1 is exactly that for one shard), or a CUDA
// graph of the per-step launches.

#include "solve_common.cuh"

namespace {

using namespace solve;

constexpr int kMaxShards = 16;

struct ShardPtrs {
  const int* alloc[kMaxShards];      // [n_loc, R]
  const int* req[kMaxShards];        // [n_loc, R]
  const int* nzr[kMaxShards];        // [n_loc, 2]
  const uint8_t* valid[kMaxShards];  // [n_loc]
  const uint8_t* rows[kMaxShards];   // [U, n_loc] the shard's mask columns
  int n_loc[kMaxShards];
};

__global__ void __launch_bounds__(kThreads) shard_candidate_kernel(
    ShardPtrs s,
    const int* __restrict__ pod_req,   // [R]  the pod's request row
    const int* __restrict__ pod_nzr,   // [2]
    const int* __restrict__ midx,      // [1]  its mask row
    int r, int u,
    int w_least, int w_balanced, int w_most,
    float* out_score,                  // [P] out
    int* out_idx) {                    // [P] out
  __shared__ float s_score[kWarps];
  __shared__ int s_index[kWarps];
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int n = s.n_loc[k];
  const int* alloc = s.alloc[k];
  const int* req = s.req[k];
  const int* nzr = s.nzr[k];
  const uint8_t* valid = s.valid[k];
  const int p0 = pod_nzr[0];
  const int p1 = pod_nzr[1];
  const bool all_zero = pod_all_zero(pod_req, r);
  int m = midx[0];
  m = m < 0 ? 0 : (m >= u ? u - 1 : m);  // gathers clamp, as in JAX
  const uint8_t* mask = s.rows[k] + static_cast<size_t>(m) * n;

  float best = -INFINITY;
  int best_i = kNoIndex;
  for (int j = tid; j < n; j += kThreads) {
    if (!valid[j] || !mask[j]) continue;
    const int* a = alloc + static_cast<size_t>(j) * r;
    const int* q = req + static_cast<size_t>(j) * r;
    if (!fits_node(a, q, pod_req, r, all_zero)) continue;
    const float req0 = static_cast<float>(add_wrap(nzr[j * 2], p0));
    const float req1 = static_cast<float>(add_wrap(nzr[j * 2 + 1], p1));
    const float score = combined_score(
        static_cast<float>(a[0]), static_cast<float>(a[1]), req0, req1,
        w_least, w_balanced, w_most);
    if (score > best) {  // rows ascend, so the first max is kept
      best = score;
      best_i = j;
    }
  }
  const ScoreIndex b = block_best(best, best_i, s_score, s_index);
  if (tid == 0) {
    const bool found = b.index != kNoIndex;
    out_score[k] = found ? b.score : -INFINITY;
    out_idx[k] = found ? b.index : 0;
  }
}

}  // namespace

// One launch over p <= 16 shards (one block each) on the given stream.
// The pointer arrays are host arrays of p device pointers. Returns the
// launch's cudaError_t (cudaErrorInvalidValue for a bad p).
extern "C" int shard_candidate_launch(
    int p, const void* const* alloc, const void* const* req,
    const void* const* nzr, const void* const* valid,
    const void* const* rows, const int* n_loc,
    const void* pod_req, const void* pod_nzr, const void* midx,
    int r, int u, int w_least, int w_balanced, int w_most,
    void* out_score, void* out_idx, void* stream) {
  if (p <= 0 || p > kMaxShards) return static_cast<int>(cudaErrorInvalidValue);
  ShardPtrs s;
  memset(&s, 0, sizeof(s));
  for (int k = 0; k < p; ++k) {
    s.alloc[k] = static_cast<const int*>(alloc[k]);
    s.req[k] = static_cast<const int*>(req[k]);
    s.nzr[k] = static_cast<const int*>(nzr[k]);
    s.valid[k] = static_cast<const uint8_t*>(valid[k]);
    s.rows[k] = static_cast<const uint8_t*>(rows[k]);
    s.n_loc[k] = n_loc[k];
  }
  shard_candidate_kernel<<<p, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, static_cast<const int*>(pod_req), static_cast<const int*>(pod_nzr),
      static_cast<const int*>(midx), r, u, w_least, w_balanced, w_most,
      static_cast<float*>(out_score), static_cast<int*>(out_idx));
  return static_cast<int>(cudaGetLastError());
}
