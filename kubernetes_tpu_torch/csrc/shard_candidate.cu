// The node-sharded mesh's greedy solve for Hopper (sm_90a), over the
// shards that live on one device: two entries in one source.
//
// Replaces: kubernetes_tpu/ops/pallas_solver.py::_shard_candidate_kernel
// (entry pallas_shard_candidate, step body _step_fit_score_argmax, the
// same body the greedy kernel K1 runs per pod) and, around it, the scan
// body of kubernetes_tpu/ops/assignment.py::_mesh_shard_solver (the
// shards' candidates, the best-of-shards pmax/pmin combine and the
// winner's bump, per pod step). The wrapper is
// kubernetes_tpu_torch/ops/shard_kernel.py; the plain PyTorch versions are
// shard_candidate_plain (one step) and mesh_batch_plain (a batch) there.
//
// What it computes, for pod t and each shard k of the device:
//   fit      against free = alloc_k - req_k over the shard's n_loc[k] rows
//            (K1's fits_node: the pods dim always, fixed dims strictly,
//            scalar dims only when requested, the all-zero short cut),
//            AND the pod's mask row rows_k[midx[t]] (the shard's own
//            columns) AND valid_k;
//   score    K1's combined_score on (cpu, memKiB), every float op an
//            explicit round-to-nearest intrinsic (and -fmad=false);
//   candidate the masked argmax, the LOWEST shard-local index winning
//            ties; (-inf, 0) when no row of the shard is feasible, as the
//            TPU kernel's masked argmax gives (never the kNoIndex
//            sentinel: a caller adds the shard's offset to the index);
//   combine  (batch entry) max score over the shards, then the MIN global
//            index (shard offset + local index); -inf means no node;
//   bump     (batch entry) req/nzr of the winner by the pod's request.
//
// Two entries, routed by the mesh's layout (ops/assignment.py
// _mesh_greedy), neither a fallback for the other:
//
// shard_batch_launch: when every shard of the mesh lives on this device,
//   the WHOLE batch in ONE launch of ONE thread-block cluster (C <= 16
//   CTAs, ops/cluster_plan.plan_shards). The CTA slices follow the shard
//   boundaries: every CTA's rows lie inside one shard (4 shards of 1,408
//   rows: 4 CTAs of 352 rows each), thread i of a CTA owns its rows lo +
//   i, lo + i + threads, ... A pod step is K1's: each thread scores its
//   own rows, two redux.sync and one store per warp into every CTA's
//   slots (distributed shared memory), ONE cluster barrier, after which
//   every thread folds the slots into the device's winner (max score,
//   then min device row: the shards' rows stacked in order, which IS the
//   global order when the device holds every shard) and the winner's
//   owner bumps its own copy without a barrier. The first CTA of each
//   shard's first warp folds that shard's CTAs' slots into the shard's
//   candidate and writes it to score/index[t, col + k], so every step's
//   per-shard candidates stay visible. An inactive pod writes nothing
//   there and changes nothing (asg[t] = -1).
//     resident  (the shape gate, a template flag): a CTA's alloc / req /
//               nzr columns live in shared memory for the launch, loaded
//               once and written back to the shards' req / nzr (updated
//               in place) at the end; per chunk of 32 pods each thread
//               folds valid AND the pods' mask rows into one 32-bit word
//               per row, so a step reads no device memory.
//     streaming (above what C CTAs hold, ~5,160 rows per CTA at R = 4):
//               the same kernel reads the state and the mask row from
//               device memory (L2), bumped in place by the owning thread.
//   The pods' parameters are staged 32 at a time. The loop is K1's own,
//   solve_common.cuh greedy_cluster_solve, run over the CTA's slice of
//   its shard with the shard's first device row as the index offset; the
//   candidate write is the step hook it calls after each collect.
//
// shard_candidate_launch: a mesh over several devices exchanges every
//   step's candidates between devices, which one launch cannot, so its
//   caller runs one launch per pod step per device and does the combine
//   and the bump with torch ops on the first device. One block of 1,024
//   threads per shard, every shard of the device in one launch; a
//   warp-shuffle then shared-memory (score, index) reduction
//   (solve_common.cuh block_best). Writes only score/index.
//
// What bounds the batch launch on this card: neither bytes nor
// operations. Its inputs are read once in principle (~90 KB of state at
// the mesh burst's 4 x 1,408 rows, R = 4, plus the pod rows) and a step
// is ~60 operations per row, but pod t+1 depends on pod t's pick, so the
// batch is a chain of B dependent cluster steps and a step's latency is
// the time: one row's score per thread, then the cluster barrier. The
// design keeps the chain on the card (no host work between steps, where
// the step route pays ~8-10 eager torch calls per pod) and a step's
// state on chip; the per-shard candidates cost one extra warp fold on
// one CTA per shard after the barrier. The step route is bound by its
// host: one launch plus the combine and the bump per pod.

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

// -- the batch entry --------------------------------------------------------

struct BatchArgs {
  const int* alloc[kMaxShards];      // [n_loc, R]
  int* req[kMaxShards];              // [n_loc, R] updated in place
  int* nzr[kMaxShards];              // [n_loc, 2] updated in place
  const uint8_t* valid[kMaxShards];  // [n_loc]
  const uint8_t* rows[kMaxShards];   // [U, n_loc] the shard's mask columns
  int n_loc[kMaxShards];
  int off[kMaxShards];               // the shard's first device row
  int first_cta[kMaxShards + 1];     // shard k's CTAs: [first_cta[k], first_cta[k + 1])
  int cta_shard[kMaxCluster];        // the shard of each CTA
  int cta_lo[kMaxCluster];           // its first shard-local row
  int cta_hi[kMaxCluster];           // one past its last
  GreedyPods pods;                   // the batch, asg [B] out: device row or -1
  float* score;                      // [B, ld] out: shard k's candidate in
  int* index;                        //   column col + k, active steps only
  int ld, col, cap;
};

template <bool kResident>
__global__ void __launch_bounds__(kClusterThreads, 1) shard_batch_kernel(BatchArgs a) {
  extern __shared__ int s_dyn[];
  __shared__ ClusterSlots s_slots[2];
  const int cluster =
      static_cast<int>(cooperative_groups::this_cluster().num_blocks());
  const int rank =
      static_cast<int>(cooperative_groups::this_cluster().block_rank());
  const int tid = threadIdx.x;
  const int warps = blockDim.x >> 5;
  const int k = a.cta_shard[rank];
  const int off = a.off[k];
  const GreedyRows v{
      a.alloc[k], a.req[k], a.req[k], a.nzr[k], a.nzr[k], a.valid[k],
      a.rows[k], a.n_loc[k], a.cta_lo[rank], a.cta_hi[rank], off, a.cap};
  // the first CTA of each shard's first warp folds that shard's CTAs'
  // slots into its candidate: max score, then min row
  const bool writes_candidate = rank == a.first_cta[k] && tid < 32;
  const int from = a.first_cta[k] * warps;
  const int to = a.first_cta[k + 1] * warps;
  greedy_cluster_solve<kResident>(
      v, a.pods, s_dyn, s_slots, cluster, rank,
      [&](int t, const unsigned long long* slots) {
        if (!writes_candidate) return;
        unsigned long long cand = 0ull;
        for (int s = from + tid; s < to; s += 32) {
          const unsigned long long key = slots[s];
          cand = key > cand ? key : cand;
        }
        cand = warp_max_key(cand);
        if (tid == 0) {
          const size_t at = static_cast<size_t>(t) * a.ld + a.col + k;
          a.score[at] = cand ? from_ordered_bits(static_cast<unsigned>(cand >> 32))
                             : -INFINITY;
          a.index[at] = cand ? best_index(cand) - off : 0;
        }
      });
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

// static shared memory of one CTA of the batch kernel (the slots), or -1
extern "C" int shard_batch_static_smem(int resident) {
  return resident ? static_smem_bytes(shard_batch_kernel<true>)
                  : static_smem_bytes(shard_batch_kernel<false>);
}

// how many batch clusters of this shape the card can hold at once (0: none)
extern "C" int shard_batch_max_clusters(int cluster, int threads, int smem,
                                        int resident) {
  if (!valid_cluster_shape(cluster, threads)) return 0;
  return resident
      ? cluster_occupancy(shard_batch_kernel<true>, cluster, threads, smem)
      : cluster_occupancy(shard_batch_kernel<false>, cluster, threads, smem);
}

// The whole batch over p <= 16 shards of one device in ONE cluster of
// `cluster` CTAs (ops/cluster_plan.plan_shards): the pointer arrays are
// host arrays of p device pointers, n_loc the shards' rows, cta_shard /
// cta_lo / cta_hi each CTA's shard and shard-local rows (the CTAs of a
// shard consecutive and covering it in order). req / nzr are updated in
// place; asg [B] takes the winner's device row (or -1), score / index
// [B, ld] shard k's candidate in column col + k of every active step.
// Returns the launch's cudaError_t, or cudaErrorInvalidValue when the
// shards, the slices or the plan do not match what the kernel needs.
extern "C" int shard_batch_launch(
    int p, const void* const* alloc, void* const* req, void* const* nzr,
    const void* const* valid, const void* const* rows, const int* n_loc,
    const int* cta_shard, const int* cta_lo, const int* cta_hi,
    const void* pod_req, const void* pod_nzr, const void* midx,
    const void* active, void* asg, void* score, void* index, int ld, int col,
    int r, int b, int u, int w_least, int w_balanced, int w_most,
    int cluster, int threads, int resident, int smem, void* stream) {
  if (p <= 0 || p > kMaxShards || !valid_cluster_shape(cluster, threads) ||
      cluster < p || r < 2 || u < 1 || col < 0 || ld < col + p) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BatchArgs a;
  memset(&a, 0, sizeof(a));
  int dev_rows = 0;
  for (int k = 0; k < p; ++k) {
    a.alloc[k] = static_cast<const int*>(alloc[k]);
    a.req[k] = static_cast<int*>(req[k]);
    a.nzr[k] = static_cast<int*>(nzr[k]);
    a.valid[k] = static_cast<const uint8_t*>(valid[k]);
    a.rows[k] = static_cast<const uint8_t*>(rows[k]);
    a.n_loc[k] = n_loc[k];
    a.off[k] = dev_rows;
    dev_rows += n_loc[k];
  }
  // the CTAs of shard k are consecutive and cover its rows in order
  int cap = 0;
  int next = 0;
  for (int c = 0; c < cluster; ++c) {
    const int k = cta_shard[c];
    if (k < 0 || k >= p || (c > 0 && k < cta_shard[c - 1])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (c == 0 || k != cta_shard[c - 1]) {
      if (k != next) return static_cast<int>(cudaErrorInvalidValue);
      a.first_cta[k] = c;
      next = k + 1;
      if (cta_lo[c] != 0) return static_cast<int>(cudaErrorInvalidValue);
    } else if (cta_lo[c] != cta_hi[c - 1]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (cta_hi[c] < cta_lo[c] ||
        (c + 1 == cluster || cta_shard[c + 1] != k) != (cta_hi[c] == n_loc[k])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.cta_shard[c] = k;
    a.cta_lo[c] = cta_lo[c];
    a.cta_hi[c] = cta_hi[c];
    if (cta_hi[c] - cta_lo[c] > cap) cap = cta_hi[c] - cta_lo[c];
  }
  if (next != p || dev_rows < 1 ||
      static_cast<size_t>(smem) < greedy_smem_bytes(r, cap, resident)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.first_cta[p] = cluster;
  a.pods = GreedyPods{static_cast<const int*>(pod_req),
                      static_cast<const int*>(pod_nzr),
                      static_cast<const int*>(midx),
                      static_cast<const uint8_t*>(active),
                      static_cast<int*>(asg), r, b, u,
                      w_least, w_balanced, w_most};
  a.score = static_cast<float*>(score);
  a.index = static_cast<int*>(index);
  a.ld = ld;
  a.col = col;
  a.cap = cap;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return resident
      ? launch_cluster(shard_batch_kernel<true>, cluster, threads, smem, s, a)
      : launch_cluster(shard_batch_kernel<false>, cluster, threads, smem, s, a);
}
