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
// An inactive pod is a skip that every CTA takes alike.

#include "solve_common.cuh"

namespace {

using namespace solve;

constexpr int kChunk = 32;  // pods staged at once: one bit each per row

struct Args {
  const int* alloc;          // [N, R]
  const int* req_in;         // [N, R]
  const int* nzr_in;         // [N, 2]
  const uint8_t* valid;      // [N]
  const int* pod_req;        // [B, R]
  const int* pod_nzr;        // [B, 2]
  const uint8_t* rows;       // [U, N]
  const int* midx;           // [B]
  const uint8_t* active;     // [B]
  int* asg;                  // [B]   out
  int* req_out;              // [N, R] out (carry)
  int* nzr_out;              // [N, 2] out (carry)
  int n, r, b, u;
  int w_least, w_balanced, w_most;
};

// dynamic shared memory: the chunk's pod parameters, then (resident) a
// CTA's alloc [R][cap], req [R][cap], nzr [2][cap] and mask bits [cap]
// (ops/greedy_kernel.py plan_for)
size_t dynamic_smem_bytes(int n, int r, int cluster, bool resident) {
  const size_t cap = (static_cast<size_t>(n) + cluster - 1) / cluster;
  size_t ints = static_cast<size_t>(kChunk) * (r + 4);
  if (resident) ints += cap * (2 * r + 3);
  return ints * sizeof(int);
}

template <bool kResident>
__global__ void __launch_bounds__(kClusterThreads, 1) greedy_cluster_kernel(Args a) {
  extern __shared__ int s_dyn[];
  __shared__ unsigned long long s_slots[2][kMaxCluster * kClusterWarps];
  const int cluster =
      static_cast<int>(cooperative_groups::this_cluster().num_blocks());
  const int rank =
      static_cast<int>(cooperative_groups::this_cluster().block_rank());
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n = a.n;
  const int r = a.r;
  const int lo = slice_lo(rank, cluster, n);
  const int hi = slice_lo(rank + 1, cluster, n);
  const int len = hi - lo;
  const int cap = (n + cluster - 1) / cluster;
  int* s_preq = s_dyn;                     // [kChunk][R]
  int* s_pnzr = s_preq + kChunk * r;       // [kChunk][2]
  int* s_pmidx = s_pnzr + kChunk * 2;      // [kChunk]
  int* s_pflags = s_pmidx + kChunk;        // [kChunk] bit 0 active, 1 all-zero
  int* s_alloc = s_pflags + kChunk;        // [R][cap]  (resident)
  int* s_req = s_alloc + r * cap;          // [R][cap]
  int* s_nzr = s_req + r * cap;            // [2][cap]
  unsigned* s_bits = reinterpret_cast<unsigned*>(s_nzr + 2 * cap);  // [cap]

  for (int l = tid; l < len; l += nt) {
    const size_t j = static_cast<size_t>(lo + l);
    for (int d = 0; d < r; ++d) {
      if (kResident) {
        s_alloc[d * cap + l] = a.alloc[j * r + d];
        s_req[d * cap + l] = a.req_in[j * r + d];
      } else {
        a.req_out[j * r + d] = a.req_in[j * r + d];
      }
    }
    if (kResident) {
      s_nzr[l] = a.nzr_in[j * 2];
      s_nzr[cap + l] = a.nzr_in[j * 2 + 1];
    } else {
      a.nzr_out[j * 2] = a.nzr_in[j * 2];
      a.nzr_out[j * 2 + 1] = a.nzr_in[j * 2 + 1];
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
    for (int i = tid; i < steps * r; i += nt) {
      s_preq[i] = a.pod_req[static_cast<size_t>(t0) * r + i];
    }
    for (int i = tid; i < kChunk; i += nt) {
      const int p = t0 + i;
      int flags = 0;
      int m = 0;
      int z0 = 0;
      int z1 = 0;
      if (p < a.b) {
        flags = (a.active[p] ? 1 : 0) |
                (pod_all_zero(a.pod_req + static_cast<size_t>(p) * r, r) ? 2 : 0);
        m = a.midx[p];
        m = m < 0 ? 0 : (m >= a.u ? a.u - 1 : m);  // gathers clamp, as in JAX
        z0 = a.pod_nzr[p * 2];
        z1 = a.pod_nzr[p * 2 + 1];
      }
      s_pflags[i] = flags;
      s_pmidx[i] = m;
      s_pnzr[i * 2] = z0;
      s_pnzr[i * 2 + 1] = z1;
    }
    __syncthreads();
    if (kResident) {  // valid AND the chunk's mask rows, one bit per pod
      for (int l = tid; l < len; l += nt) {
        const size_t j = static_cast<size_t>(lo + l);
        unsigned bits = 0u;
        if (a.valid[j]) {
#pragma unroll 8
          for (int i = 0; i < kChunk; ++i) {
            if (a.rows[static_cast<size_t>(s_pmidx[i]) * n + j]) bits |= 1u << i;
          }
        }
        s_bits[l] = bits;  // read and written by this thread only
      }
    }

    STEP_MARK(0);  // chunk staging
    for (int i = 0; i < steps; ++i) {
      const int t = t0 + i;
      const int flags = s_pflags[i];
      // an inactive (padding or gang-masked) pod never bumps the state:
      // every CTA skips its step alike
      if (!(flags & 1)) {
        if (rank == 0 && tid == 0) a.asg[t] = -1;
        continue;
      }
      const int* preq = s_preq + i * r;
      const int p0 = s_pnzr[i * 2];
      const int p1 = s_pnzr[i * 2 + 1];
      const bool all_zero = flags & 2;
      const uint8_t* mrow = a.rows + static_cast<size_t>(s_pmidx[i]) * n;

      STEP_MARK(1);  // the last step's bump, this step's parameters
      float best = -INFINITY;
      int best_i = kNoIndex;
      for (int l = tid; l < len; l += nt) {
        const int j = lo + l;
        const bool ok = kResident ? ((s_bits[l] >> i) & 1u) != 0u
                                  : (a.valid[j] && mrow[j]);
        if (!ok) continue;
        const int* al = kResident ? s_alloc + l : a.alloc + static_cast<size_t>(j) * r;
        const int* q = kResident ? s_req + l : a.req_out + static_cast<size_t>(j) * r;
        if (!fits_node_strided(al, q, stride, preq, r, all_zero)) continue;
        const int n0 = kResident ? s_nzr[l] : a.nzr_out[j * 2];
        const int n1 = kResident ? s_nzr[cap + l] : a.nzr_out[j * 2 + 1];
        const float score = combined_score(
            static_cast<float>(al[0]), static_cast<float>(al[stride]),
            static_cast<float>(add_wrap(n0, p0)),
            static_cast<float>(add_wrap(n1, p1)),
            a.w_least, a.w_balanced, a.w_most);
        if (score > best) {  // a thread's rows ascend: the first max is kept
          best = score;
          best_i = j;
        }
      }
      STEP_MARK(2);  // scoring this thread's rows
      const int win = best_index(cluster_best(
          pack_best(best, best_i), s_slots[phase & 1], cluster, rank));
      STEP_MARK(3);  // the cluster step
      ++phase;
      if (rank == 0 && tid == 0) a.asg[t] = win == kNoIndex ? -1 : win;
      if (win != kNoIndex && win >= lo && win < hi && (win - lo) % nt == tid) {
        const int l = win - lo;  // this thread owns the winner's row
        int* q = kResident ? s_req + l : a.req_out + static_cast<size_t>(win) * r;
        for (int d = 0; d < r; ++d) q[d * stride] = add_wrap(q[d * stride], preq[d]);
        if (kResident) {
          s_nzr[l] = add_wrap(s_nzr[l], p0);
          s_nzr[cap + l] = add_wrap(s_nzr[cap + l], p1);
        } else {
          a.nzr_out[win * 2] = add_wrap(a.nzr_out[win * 2], p0);
          a.nzr_out[win * 2 + 1] = add_wrap(a.nzr_out[win * 2 + 1], p1);
        }
      }
    }
  }

  if (kResident) {
    for (int l = tid; l < len; l += nt) {
      const size_t j = static_cast<size_t>(lo + l);
      for (int d = 0; d < r; ++d) a.req_out[j * r + d] = s_req[d * cap + l];
      a.nzr_out[j * 2] = s_nzr[l];
      a.nzr_out[j * 2 + 1] = s_nzr[cap + l];
    }
  }
  // no CTA leaves while another may still store into its shared memory
  cluster_barrier();
}

template <bool kResident>
cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                      int cluster, int threads, int smem) {
  auto kernel = greedy_cluster_kernel<kResident>;
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

template <bool kResident>
int max_clusters(int cluster, int threads, int smem) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<kResident>(&cfg, &attr, cluster, threads, smem);
  int count = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveClusters(&count, greedy_cluster_kernel<kResident>, &cfg);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused configuration admits no cluster
    return 0;
  }
  return count;
}

template <bool kResident>
int launch(const Args& args, int cluster, int threads, int smem,
           cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<kResident>(&cfg, &attr, cluster, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, greedy_cluster_kernel<kResident>, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int cluster, int threads) {
  return cluster >= 1 && cluster <= kMaxCluster && threads >= 32 &&
         threads <= kClusterThreads && threads % 32 == 0;
}

}  // namespace

#ifdef SOLVE_STEP_PROFILE
extern "C" int greedy_solve_step_cycles(unsigned long long* out) {
  return solve::read_step_cycles(out);
}
#endif

// static shared memory of one CTA of the kernel (the slots), or -1
extern "C" int greedy_solve_static_smem(int resident) {
  cudaFuncAttributes attr;
  const cudaError_t err = resident
      ? cudaFuncGetAttributes(&attr, greedy_cluster_kernel<true>)
      : cudaFuncGetAttributes(&attr, greedy_cluster_kernel<false>);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return static_cast<int>(attr.sharedSizeBytes);
}

// how many clusters of this shape the card can hold at once (0: none)
extern "C" int greedy_solve_max_clusters(int cluster, int threads, int smem,
                                         int resident) {
  if (!valid_shape(cluster, threads)) return 0;
  return resident ? max_clusters<true>(cluster, threads, smem)
                  : max_clusters<false>(cluster, threads, smem);
}

// Launches one cluster of `cluster` CTAs of `threads` threads with `smem`
// bytes of dynamic shared memory each (ops/cluster_plan.plan_launch).
// Returns the launch's cudaError_t, or cudaErrorInvalidValue when the
// plan does not match what the kernel needs.
extern "C" int greedy_solve_launch(
    const void* alloc, const void* req_in, const void* nzr_in,
    const void* valid, const void* pod_req, const void* pod_nzr,
    const void* rows, const void* midx, const void* active,
    void* asg, void* req_out, void* nzr_out,
    int n, int r, int b, int u,
    int w_least, int w_balanced, int w_most,
    int cluster, int threads, int resident, int smem, void* stream) {
  if (!valid_shape(cluster, threads) || n < 1 || cluster > n || r < 2 || u < 1 ||
      static_cast<size_t>(smem) < dynamic_smem_bytes(n, r, cluster, resident)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args args{
      static_cast<const int*>(alloc), static_cast<const int*>(req_in),
      static_cast<const int*>(nzr_in), static_cast<const uint8_t*>(valid),
      static_cast<const int*>(pod_req), static_cast<const int*>(pod_nzr),
      static_cast<const uint8_t*>(rows), static_cast<const int*>(midx),
      static_cast<const uint8_t*>(active), static_cast<int*>(asg),
      static_cast<int*>(req_out), static_cast<int*>(nzr_out),
      n, r, b, u, w_least, w_balanced, w_most};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return resident ? launch<true>(args, cluster, threads, smem, s)
                  : launch<false>(args, cluster, threads, smem, s);
}
