// Greedy batch solve for Hopper (sm_90a): the whole pod batch in ONE
// launch of ONE thread-block cluster.
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
// What bounds it on this card: neither bytes nor operations. The inputs are
// read once in principle (a few hundred KB) and the work is ~40 fp32 ops per
// pod x node pair (~1 GFLOP for a 4,096 x 5,632 batch: ~15 us at 33.5e12
// unfused ops/s), but pod t+1 depends on pod t's pick, so the batch is a
// chain of B dependent steps, and a step's latency is the time.
//
// Design: one cluster of C CTAs (C <= 16, ops/cluster_plan.py), CTA k
// owning the contiguous rows [k * N / C, (k + 1) * N / C), thread i of a
// CTA the rows lo + i, lo + i + threads, ... (one row each at the burst
// shape: 352 rows per CTA). A step is then a pass over a thread's own rows,
// two redux.sync, one store into each CTA's shared memory and ONE cluster
// barrier (solve_common.cuh cluster_best, slots alternating by step
// parity), after which every thread knows the winner; the thread that owns
// it bumps its own copy, so the bump needs no barrier of its own.
//   resident  (the shape gate, a template flag): a CTA's alloc / req / nzr
//             columns live in shared memory for the whole launch, loaded
//             once and written back to req_out / nzr_out once at the end;
//             per chunk of 32 pods each thread folds valid AND the pods'
//             mask rows into one 32-bit word per row, so a step reads no
//             device memory at all.
//   streaming (above what C CTAs hold, ~5,160 rows per CTA at R = 4) the
//             same kernel reads the state from req_out / nzr_out and the
//             mask row from device memory (L2), bumped in place by the
//             owning thread.
// The pods' parameters (request, nzr, mask row, flags) are staged into
// shared memory 32 pods at a time, behind two CTA barriers per chunk.
// An inactive pod is a skip that every CTA takes alike. The loop is
// solve_common.cuh greedy_cluster_solve, which K4's batch entry runs too.
//
// The scored entry (a prior operand; the kScored instantiations):
// replaces kubernetes_tpu/ops/assignment.py:1576 sinkhorn_assign's commit
// scan -- an XLA lax.scan, not a Pallas kernel -- whose step is the step
// above with score = where(feasible, prior[t] + combined_score, -inf).
// Its plain PyTorch version is ops/assignment.py::sinkhorn_commit. Bound:
// K1's own bytes and operations plus the [B, N] f32 prior, B * N * 4
// bytes read once (205 MB at ChurnSinkhorn/50000's 1,024 x 50,048: 0.06
// ms at 3.35 TB/s), so the chain of dependent steps still bounds it. The
// design changes nothing else: each step reads one coalesced slice of
// the prior row per CTA (thread i, row lo + i), each value loaded before
// its row's fit test so that the load's latency overlaps the test and
// the score, and adds it with one round-to-nearest add; the greedy
// instantiations compile without it.

#include "solve_common.cuh"

namespace {

using namespace solve;

struct Args {
  const int* alloc;          // [N, R]
  const int* req_in;         // [N, R]
  const int* nzr_in;         // [N, 2]
  const uint8_t* valid;      // [N]
  const uint8_t* rows;       // [U, N]
  int* req_out;              // [N, R] out (carry)
  int* nzr_out;              // [N, 2] out (carry)
  int n;
  GreedyPods pods;           // the batch, asg [B] out
};

// a CTA's rows at most: the resident stride
__host__ __device__ int slice_cap(int n, int cluster) {
  return (n + cluster - 1) / cluster;
}

template <bool kResident, bool kScored>
__global__ void __launch_bounds__(kClusterThreads, 1) greedy_cluster_kernel(Args a) {
  extern __shared__ int s_dyn[];
  __shared__ ClusterSlots s_slots[2];
  const int cluster =
      static_cast<int>(cooperative_groups::this_cluster().num_blocks());
  const int rank =
      static_cast<int>(cooperative_groups::this_cluster().block_rank());
  const GreedyRows v{
      a.alloc, a.req_in, a.req_out, a.nzr_in, a.nzr_out, a.valid, a.rows,
      a.n, slice_lo(rank, cluster, a.n), slice_lo(rank + 1, cluster, a.n),
      0, slice_cap(a.n, cluster)};
  greedy_cluster_solve<kResident, kScored>(
      v, a.pods, s_dyn, s_slots, cluster, rank,
      [](int, const unsigned long long*) {});
}

}  // namespace

#ifdef SOLVE_STEP_PROFILE
extern "C" int greedy_solve_step_cycles(unsigned long long* out) {
  return solve::read_step_cycles(out);
}
#endif

// static shared memory of one CTA of the kernel (the slots), or -1
extern "C" int greedy_solve_static_smem(int resident) {
  return resident ? static_smem_bytes(greedy_cluster_kernel<true, false>)
                  : static_smem_bytes(greedy_cluster_kernel<false, false>);
}

// how many clusters of this shape the card can hold at once (0: none)
extern "C" int greedy_solve_max_clusters(int cluster, int threads, int smem,
                                         int resident, int scored) {
  if (!valid_cluster_shape(cluster, threads)) return 0;
  if (scored) {
    return resident
        ? cluster_occupancy(greedy_cluster_kernel<true, true>, cluster, threads, smem)
        : cluster_occupancy(greedy_cluster_kernel<false, true>, cluster, threads, smem);
  }
  return resident
      ? cluster_occupancy(greedy_cluster_kernel<true, false>, cluster, threads, smem)
      : cluster_occupancy(greedy_cluster_kernel<false, false>, cluster, threads, smem);
}

// Launches one cluster of `cluster` CTAs of `threads` threads with `smem`
// bytes of dynamic shared memory each (ops/cluster_plan.plan_launch); a
// non-null `prior` ([B, N] f32) launches the scored entry. Returns the
// launch's cudaError_t, or cudaErrorInvalidValue when the plan does not
// match what the kernel needs.
extern "C" int greedy_solve_launch(
    const void* alloc, const void* req_in, const void* nzr_in,
    const void* valid, const void* pod_req, const void* pod_nzr,
    const void* rows, const void* midx, const void* active,
    void* asg, void* req_out, void* nzr_out, const void* prior,
    int n, int r, int b, int u,
    int w_least, int w_balanced, int w_most,
    int cluster, int threads, int resident, int smem, void* stream) {
  if (!valid_cluster_shape(cluster, threads) || n < 1 || cluster > n || r < 2 || u < 1 ||
      static_cast<size_t>(smem) <
          greedy_smem_bytes(r, slice_cap(n, cluster), resident)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args args{
      static_cast<const int*>(alloc), static_cast<const int*>(req_in),
      static_cast<const int*>(nzr_in), static_cast<const uint8_t*>(valid),
      static_cast<const uint8_t*>(rows), static_cast<int*>(req_out),
      static_cast<int*>(nzr_out), n,
      GreedyPods{static_cast<const int*>(pod_req),
                 static_cast<const int*>(pod_nzr),
                 static_cast<const int*>(midx),
                 static_cast<const uint8_t*>(active), static_cast<int*>(asg),
                 r, b, u, w_least, w_balanced, w_most,
                 static_cast<const float*>(prior), n}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (prior != nullptr) {
    return resident
        ? launch_cluster(greedy_cluster_kernel<true, true>, cluster, threads, smem, s, args)
        : launch_cluster(greedy_cluster_kernel<false, true>, cluster, threads, smem, s, args);
  }
  return resident
      ? launch_cluster(greedy_cluster_kernel<true, false>, cluster, threads, smem, s, args)
      : launch_cluster(greedy_cluster_kernel<false, false>, cluster, threads, smem, s, args);
}
