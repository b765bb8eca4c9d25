// Constrained batch solve for Hopper (sm_90a): the whole pod batch in ONE
// launch of ONE thread-block cluster, with hard topology spread, required
// inter-pod (anti-)affinity and the full default score plugin set.
//
// Replaces: kubernetes_tpu/ops/pallas_constrained.py::_constrained_kernel
// (entry pallas_constrained_solve). Its plain PyTorch version is
// kubernetes_tpu_torch/ops/assignment.py::greedy_assign_constrained (the
// port of the reference's XLA scan), and the wrapper is
// kubernetes_tpu_torch/ops/constrained_kernel.py, which passes each
// family's live row count (live_rows) and hands the kernel fresh copies of
// those rows of every count tensor to replay into, one per CTA.
//
// What it computes, for each active pod t in solve order (inactive pods
// never place, so they change nothing):
//   fit         K1's fit test, static-mask row and valid (solve_common.cuh);
//   spread      per hard-spread slot: the node's value of the group's key
//               exists and count[value] + self - min over valid values
//               <= maxSkew (podtopologyspread/filtering.go:322);
//   affinity    every incoming affinity row positive at the node's value,
//               or the first-pod escape (no match anywhere for the pod's
//               rows and the pod matches itself); no incoming anti row and
//               no matching existing-pod anti row positive
//               (interpodaffinity/filtering.go:404-516);
//   score       K1's resource score, then in the reference's order: the
//               static direct row; preferred NodeAffinity max-scaled;
//               TaintToleration reversed; SelectorSpread with the 2/3 zone
//               blend; soft spread flipped-linear; preferred inter-pod
//               affinity [min, max]-scaled. Each normaliser runs over THIS
//               step's feasible set. Every float op is an explicit
//               round-to-nearest intrinsic (and -fmad=false); the zone blend
//               is the one fused multiply-add, because the reference's
//               compiler evaluates f_node / 3 as f_node * (1/3)f fused with
//               the add;
//   pick        masked argmax, the LOWEST node index wins among equal maxima;
//   replay      the winner bumps req/nzr and every live family's counts at
//               its own value of each row's topology key.
//
// What bounds it on this card: neither bytes nor operations but the chain:
// pod t+1's feasibility depends on pod t's pick and counts, so a batch is B
// dependent steps, and a step's latency is the time.
//
// Design: one cluster of C CTAs (C <= 16, ops/cluster_plan.py), CTA k
// owning the contiguous rows [k * N / C, (k + 1) * N / C), one row per
// thread at the burst shape, plus one parameter warp per CTA that owns no
// rows. The counts stay in VALUE space, as the XLA scan keeps them. A step:
//   pass 1   each thread's rows: feasibility (each row's checks stop at
//            its first failing constraint), the raw value of every score
//            family, and its part of the normalisers (integer maxima, zone
//            sums by warp-aggregated shared atomics, the soft total and
//            minimum, the preferred-affinity minimum and maximum: every one
//            exact and free of order). The warps' parts meet in shared
//            memory (a CTA barrier), and the CTA's part goes into slot
//            [rank] of every CTA (distributed shared memory);
//   cluster barrier 1; every warp folds the C parts: the step's
//            normalisers, the same in every CTA. Meanwhile the parameter
//            warp, which has no candidate, arrives at cluster barrier 2 at
//            once and stages the next active pod's parameters and replay
//            amounts (double-buffered by step parity) before it waits;
//   pass 2   each thread composes its feasible rows' f32 scores in the
//            reference's exact operation order and keeps its (score,
//            index) best; cluster barrier 2 (solve_common.cuh
//            cluster_publish / cluster_collect) gives every thread the
//            winner;
//   replay   every CTA replays the pick into its OWN copy of the
//            value-space counts (deterministic in t, the IPA float adds
//            included, so no exchange is needed), with the amounts the
//            parameter warp staged; the thread that owns the winner's row
//            bumps req/nzr and the node-space SelectorSpread counts, which
//            only it reads. A CTA barrier opens the next step.
// Two cluster barriers and two CTA barriers a step, against five block
// barriers on one SM before. Each hard-spread group's minimum over its
// valid values is kept incrementally with its multiplicity (a bump adds 1
// at one value, so the minimum moves only when the last value at the
// minimum is bumped, or a count wraps): recounted then, not every step.
// The affinity rows' totals (the first-pod escape) are kept the same way.
//   resident  (the shape gate, a template flag): a CTA's alloc / req / nzr
//             columns and its rows' pass-1 results live in shared memory;
//   streaming above what C CTAs hold: the same kernel keeps them in device
//             memory (L2), each row touched only by its owning thread.
// Per-pod signature rows (direct / nodeaff / taint), the mask row and the
// static per-node topology values are read from L1/L2 for the current pod
// and the CTA's own rows only.

#include <limits.h>
#include <string.h>

#include "solve_common.cuh"

namespace {

using namespace solve;

constexpr int kMaxSlots = 4;      // topology.MAX_CONSTRAINTS_PER_POD etc.
constexpr int kMaxGroups = 16;    // topology.MAX_GROUPS
constexpr int kMaxSelGroups = 8;  // scoring.MAX_SEL_GROUPS
constexpr int kMaxAffRows = 16;   // affinity.MAX_AFF_ROWS / MAX_ANTI_ROWS
constexpr int kMaxExistRows = 64; // affinity.MAX_EXIST_ROWS
constexpr int kMaxIpaRows = 16;   // scoring.MAX_IPA_ROWS
constexpr int kMaxZones = 64;     // scoring.MAX_ZONES
constexpr int kBig = 1 << 20;     // the spread / soft "no value" sentinel
constexpr float kThird = 0.333333343f;      // float32(1 / 3)
constexpr float kTwoThirds = 0.666666687f;  // float32(2 / 3)

// Operands, in the order the wrapper passes their pointers. Scratch
// tensors (the *_counts copies and the three per-node arrays) are written
// by the kernel; everything else is read only. A value-space count tensor
// holds C copies of its live rows, [C, rows, V]: CTA k replays into copy k.
struct Ptrs {
  const int* alloc;          // [N, R]
  const int* req_in;         // [N, R]
  const int* nzr_in;         // [N, 2]
  const uint8_t* valid;      // [N]
  const int* pod_req;        // [B, R]
  const int* pod_nzr;        // [B, 2]
  const uint8_t* rows;       // [U, N]
  const int* midx;           // [B]
  const uint8_t* active;     // [B]
  // hard topology spread
  int* sp_counts;            // [C, g_sp, V_sp] scratch
  const uint8_t* sp_vvalid;  // [>= g_sp, V_sp]
  const int* sp_nv;          // [>= g_sp, N]
  const int* sp_groups;      // [B, C_sp]
  const int* sp_skew;        // [B, C_sp]
  const int* sp_self;        // [B, C_sp]
  const int* sp_match;       // [B, sp_match_w]
  // required inter-pod affinity
  const int* af_nv;          // [K, N]
  int* aff_counts;           // [C, ra, V_aff] scratch
  const int* aff_key;        // [>= ra]
  const int* aff_rows;       // [B, C_aff]
  const uint8_t* self_match; // [B]
  const int* aff_bump;       // [B, aff_bump_w]
  int* anti_counts;          // [C, rt, V_anti] scratch
  const int* anti_key;       // [>= rt]
  const int* anti_rows;      // [B, C_anti]
  const int* anti_bump;      // [B, anti_bump_w]
  int* exist_counts;         // [C, re, V_exist] scratch
  const int* exist_key;      // [>= re]
  const uint8_t* exist_match;  // [B, exist_w]
  const int* exist_bump;     // [B, exist_w]
  // scoring
  const float* direct;       // [S, N]
  const int* nodeaff;        // [S, N]
  const int* taint;          // [S, N]
  const int* pod_sig;        // [B]
  int* sel_counts;           // [g_sel, N] scratch (node space, one copy)
  const int* zone_id;        // [N]
  const int* sel_group;      // [B]
  const int* sel_match;      // [B, sel_match_w]
  int* soft_counts;          // [C, gt, V_soft] scratch
  const int* soft_nv;        // [>= gt, N]
  const int* soft_groups;    // [B, C_soft]
  const int* soft_match;     // [B, soft_match_w]
  const int* ipa_nv;         // [>= rp, N]
  float* ipa_counts;         // [C, rp, V_ipa] scratch
  float* ipa_wcounts;        // [C, rp, V_ipa] scratch
  const float* ipa_weight;   // [B, ipa_w]
  const float* ipa_match;    // [B, ipa_w]
  const float* ipa_bump;     // [B, ipa_w]
  const float* weights;      // [5]: NodeAffinity, TaintToleration,
                             //      SelectorSpread, soft spread, IPA
  // outputs, and each row's pass-1 results (streaming side)
  int* asg;                  // [B]
  int* req_out;              // [N, R]
  int* nzr_out;              // [N, 2]
  uint8_t* node_flags;       // [N] bit 0 feasible, bit 1 soft-eligible
  int* soft_raw;             // [N]
  float* ipa_raw;            // [N]
};

// Shapes and live row counts, in the order the wrapper passes them.
struct Dims {
  int n, r, b, u, s, z;
  int w_least, w_balanced, w_most;
  int g_sp, v_sp, c_sp, sp_match_w;
  int k, ra, v_aff, c_aff, aff_bump_w;
  int rt, v_anti, c_anti, anti_bump_w;
  int re, v_exist, exist_w;
  int g_sel, sel_match_w;
  int gt, v_soft, c_soft, soft_match_w;
  int rp, v_ipa, ipa_w;
};

constexpr int kNumPtrs = sizeof(Ptrs) / sizeof(void*);
constexpr int kNumDims = sizeof(Dims) / sizeof(int);

// dynamic shared memory: the pod requests (two buffers), then (resident) a
// CTA's alloc [R][cap], req [R][cap], nzr [2][cap], its rows' pass-1 soft
// and preferred-affinity raw values [2][cap] and flags [cap]
// (ops/constrained_kernel.py plan_for)
size_t dynamic_smem_bytes(int n, int r, int cluster, bool resident) {
  const size_t cap = (static_cast<size_t>(n) + cluster - 1) / cluster;
  size_t bytes = sizeof(int) * 2 * static_cast<size_t>(r);
  if (resident) bytes += cap * (sizeof(int) * (2 * r + 4) + 1);
  return bytes;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int warp_min(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {  // wraps, as int32 sums do
  for (int off = 16; off > 0; off >>= 1)
    v = add_wrap(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// value of a row's topology key at node j: -1 where the row is padding
// (key < 0) or the node lacks the key (assignment.row_node_values)
__device__ __forceinline__ int row_value(
    const int* af_nv, int key, int n, int j) {
  return key < 0 ? -1 : af_nv[static_cast<size_t>(key) * n + j];
}

// the step's normalisers (or a part of them); the IPA extrema as
// ordered_bits keys, so every field folds with one redux.sync
struct Norm {
  int any_feas, na_max, tt_max, sel_max, have_zones;
  int soft_total, soft_min, dom_any;
  unsigned ipa_min, ipa_max;
};

__device__ __forceinline__ Norm norm_identity() {
  return {0, INT_MIN, INT_MIN, INT_MIN, 0, 0, kBig, 0,
          ordered_bits(INFINITY), ordered_bits(-INFINITY)};
}

// every lane gets the warp's fold of its lanes' parts
__device__ __forceinline__ Norm warp_norm(Norm x) {
  constexpr unsigned kAll = 0xffffffffu;
  x.any_feas = __any_sync(kAll, x.any_feas);
  x.na_max = __reduce_max_sync(kAll, x.na_max);
  x.tt_max = __reduce_max_sync(kAll, x.tt_max);
  x.sel_max = __reduce_max_sync(kAll, x.sel_max);
  x.have_zones = __any_sync(kAll, x.have_zones);
  x.soft_total = static_cast<int>(
      __reduce_add_sync(kAll, static_cast<unsigned>(x.soft_total)));
  x.soft_min = __reduce_min_sync(kAll, x.soft_min);
  x.dom_any = __any_sync(kAll, x.dom_any);
  x.ipa_min = __reduce_min_sync(kAll, x.ipa_min);
  x.ipa_max = __reduce_max_sync(kAll, x.ipa_max);
  return x;
}

// one pod's parameters and replay amounts, staged by the parameter warp
struct PodParams {
  int t;  // the pod; >= b when the batch is done
  int sp_g[kMaxSlots], sp_skew[kMaxSlots], sp_self[kMaxSlots];
  int aff_row[kMaxSlots], anti_row[kMaxSlots], soft_g[kMaxSlots];
  int exist_rows[kMaxExistRows];
  int n_exist;
  float ipa_w[kMaxIpaRows], ipa_m[kMaxIpaRows];
  int mask_row, all_zero, sig, sel_g, has_soft, self_match, p0, p1;
  // the replay's amount for every live row of each family
  int sp_match[kMaxGroups], aff_bump[kMaxAffRows], anti_bump[kMaxAffRows];
  int exist_bump[kMaxExistRows], soft_match[kMaxGroups];
  int sel_match[kMaxSelGroups];
  float ipa_bump[kMaxIpaRows];
};

// Stage the first active pod at or after `from` into P (its request into
// preq). Called by ONE whole warp. After the scan for the pod, every load
// is issued before the first store, so staging costs two memory latencies.
__device__ void stage_pod(const Ptrs& p, const Dims& d, int from,
                          PodParams& P, int* preq) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int t = d.b;
  for (int base = from; base < d.b; base += 32) {
    const int i = base + lane;
    const unsigned act = __ballot_sync(kAll, i < d.b && p.active[i]);
    if (act) {
      t = base + __ffs(act) - 1;
      break;
    }
  }
  if (lane == 0) P.t = t;
  if (t >= d.b) return;  // uniform across the warp
  // lane c: slot c, row c of each family, dim c of the request
  const int c = lane;
  const bool sp = c < kMaxSlots && c < d.c_sp;
  const int g = sp ? p.sp_groups[t * d.c_sp + c] : -1;
  const int skew = sp ? p.sp_skew[t * d.c_sp + c] : 0;
  const int self = sp ? p.sp_self[t * d.c_sp + c] : 0;
  const int ar = c < kMaxSlots && c < d.c_aff ? p.aff_rows[t * d.c_aff + c] : -1;
  const int tr = c < kMaxSlots && c < d.c_anti ? p.anti_rows[t * d.c_anti + c] : -1;
  const int sg = c < kMaxSlots && c < d.c_soft ? p.soft_groups[t * d.c_soft + c] : -1;
  const bool ipa = c < d.rp;  // rp <= kMaxIpaRows
  const float ipa_w = ipa ? p.ipa_weight[t * d.ipa_w + c] : 0.0f;
  const float ipa_m = ipa ? p.ipa_match[t * d.ipa_w + c] : 0.0f;
  const float ipa_b = ipa ? p.ipa_bump[t * d.ipa_w + c] : 0.0f;
  const bool ex0 = c < d.re && p.exist_match[t * d.exist_w + c];
  const bool ex1 = c + 32 < d.re && p.exist_match[t * d.exist_w + c + 32];
  const int exb0 = c < d.re ? p.exist_bump[t * d.exist_w + c] : 0;
  const int exb1 = c + 32 < d.re ? p.exist_bump[t * d.exist_w + c + 32] : 0;
  const int sp_match = c < d.g_sp ? p.sp_match[t * d.sp_match_w + c] : 0;
  const int aff_bump = c < d.ra ? p.aff_bump[t * d.aff_bump_w + c] : 0;
  const int anti_bump = c < d.rt ? p.anti_bump[t * d.anti_bump_w + c] : 0;
  const int soft_match = c < d.gt ? p.soft_match[t * d.soft_match_w + c] : 0;
  const int sel_match = c < d.g_sel ? p.sel_match[t * d.sel_match_w + c] : 0;
  const int q = c < d.r ? p.pod_req[static_cast<size_t>(t) * d.r + c] : 0;
  const int midx = p.midx[t];
  const int sig = p.pod_sig[t];
  const int sel_group = p.sel_group[t];
  const int self_match = p.self_match[t];
  const int p0 = p.pod_nzr[t * 2];
  const int p1 = p.pod_nzr[t * 2 + 1];

  if (c < kMaxSlots) {
    P.sp_g[c] = (g < 0 || g >= d.g_sp) ? -1 : g;  // beyond the live rows: absent
    P.sp_skew[c] = skew;
    P.sp_self[c] = self;
    P.aff_row[c] = (ar < 0 || ar >= d.ra) ? -1 : ar;
    P.anti_row[c] = (tr < 0 || tr >= d.rt) ? -1 : tr;
    P.soft_g[c] = (sg < 0 || sg >= d.gt) ? -1 : sg;
  }
  const unsigned soft_any =
      __ballot_sync(kAll, c < kMaxSlots && sg >= 0 && sg < d.gt);
  if (c < kMaxIpaRows) {
    P.ipa_w[c] = ipa_w;
    P.ipa_m[c] = ipa_m;
    P.ipa_bump[c] = ipa_b;
  }
  // the pod's existing-pod anti-affinity rows, in row order
  const unsigned below = (1u << lane) - 1u;
  const unsigned bits0 = __ballot_sync(kAll, ex0);
  const unsigned bits1 = __ballot_sync(kAll, ex1);
  if (ex0) P.exist_rows[__popc(bits0 & below)] = c;
  if (ex1) P.exist_rows[__popc(bits0) + __popc(bits1 & below)] = c + 32;
  if (c < d.re) P.exist_bump[c] = exb0;
  if (c + 32 < d.re) P.exist_bump[c + 32] = exb1;
  if (c < d.g_sp) P.sp_match[c] = sp_match;
  if (c < d.ra) P.aff_bump[c] = aff_bump;
  if (c < d.rt) P.anti_bump[c] = anti_bump;
  if (c < d.gt) P.soft_match[c] = soft_match;
  if (c < d.g_sel) P.sel_match[c] = sel_match;
  // the request, and assignment._fits's all-zero test on it
  bool nonzero = c < d.r && c != kPodsCol && q > 0;
  if (c < d.r) preq[c] = q;
  for (int x = c + 32; x < d.r; x += 32) {  // requests of more than 32 dims
    const int v = p.pod_req[static_cast<size_t>(t) * d.r + x];
    preq[x] = v;
    nonzero |= x != kPodsCol && v > 0;
  }
  const unsigned any_nonzero = __ballot_sync(kAll, nonzero);
  if (lane == 0) {
    P.n_exist = __popc(bits0) + __popc(bits1);
    P.mask_row = clampi(midx, 0, d.u - 1);  // gathers clamp, as in JAX
    P.all_zero = any_nonzero == 0u;
    P.sig = clampi(sig, 0, d.s - 1);
    P.sel_g = (sel_group < 0 || sel_group >= d.g_sel) ? -1 : sel_group;
    P.has_soft = soft_any != 0u;
    P.self_match = self_match;
    P.p0 = p0;
    P.p1 = p1;
  }
}

// Each group in `groups` (a bit mask): its minimum count over its valid
// values (INT_MAX when it has none) and how many valid values hold it.
// Call from every thread of the CTA, after a barrier that makes the counts
// final; ends with one.
__device__ void recount_minima(unsigned groups, const int* counts,
                               const uint8_t* vvalid, int v_sp,
                               int* s_gmin, int* s_gmult) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nt = blockDim.x;
  if (tid < kMaxGroups && ((groups >> tid) & 1u)) {
    s_gmin[tid] = INT_MAX;
    s_gmult[tid] = 0;
  }
  __syncthreads();
  for (unsigned rest = groups; rest; rest &= rest - 1u) {
    const int g = __ffs(rest) - 1;
    int lo = INT_MAX;
    for (int v = tid; v < v_sp; v += nt)
      if (vvalid[g * v_sp + v]) lo = min(lo, counts[g * v_sp + v]);
    lo = warp_min(lo);
    if (lane == 0 && lo != INT_MAX) atomicMin(&s_gmin[g], lo);
  }
  __syncthreads();
  for (unsigned rest = groups; rest; rest &= rest - 1u) {
    const int g = __ffs(rest) - 1;
    const int lo = s_gmin[g];
    int at = 0;
    for (int v = tid; v < v_sp; v += nt)
      at += vvalid[g * v_sp + v] && counts[g * v_sp + v] == lo;
    at = warp_sum(at);
    if (lane == 0 && at != 0) atomicAdd(&s_gmult[g], at);
  }
  __syncthreads();
}

template <bool kResident>
__global__ void __launch_bounds__(kClusterThreads, 1) constrained_cluster_kernel(
    Ptrs p, Dims d) {
  extern __shared__ int s_dyn[];
  __shared__ PodParams s_pod[2];
  __shared__ Norm s_wnorm[kClusterWarps];
  __shared__ Norm s_norm_slots[kMaxCluster];
  __shared__ int s_zone_slots[kMaxCluster * kMaxZones];
  __shared__ int s_ztot[kClusterWarps][kMaxZones];
  __shared__ int s_zsum[kMaxZones];
  __shared__ unsigned long long s_cand[kMaxCluster * kClusterWarps];
  __shared__ int s_aff_key[kMaxAffRows];
  __shared__ int s_anti_key[kMaxAffRows];
  __shared__ int s_exist_key[kMaxExistRows];
  __shared__ int s_aff_tot[kMaxAffRows];
  __shared__ int s_gmin[kMaxGroups];
  __shared__ int s_gmult[kMaxGroups];
  __shared__ unsigned s_recount;

  const int cluster =
      static_cast<int>(cooperative_groups::this_cluster().num_blocks());
  const int rank =
      static_cast<int>(cooperative_groups::this_cluster().block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nt = blockDim.x;
  const int row_threads = nt - 32;  // the last warp owns no rows
  const bool param_warp = tid >= row_threads;
  const int n = d.n;
  const int r = d.r;
  const int lo = slice_lo(rank, cluster, n);
  const int hi = slice_lo(rank + 1, cluster, n);
  const int len = hi - lo;
  const int cap = (n + cluster - 1) / cluster;

  int* s_preq = s_dyn;                          // [2][R]
  int* s_alloc = s_preq + 2 * r;                // [R][cap] (resident)
  int* s_req = s_alloc + r * cap;               // [R][cap]
  int* s_nzr = s_req + r * cap;                 // [2][cap]
  int* s_rows = s_nzr + 2 * cap;                // [2][cap] pass-1 results
  uint8_t* s_flags = reinterpret_cast<uint8_t*>(s_rows + 2 * cap);  // [cap]
  // each row's pass-1 results, read back in pass 2 by the thread that
  // wrote them: shared memory (resident, at the row's slice index) or
  // device memory (streaming, at the row)
  uint8_t* row_flags = kResident ? s_flags : p.node_flags;
  int* row_soft = kResident ? s_rows : p.soft_raw;
  float* row_ipa = kResident ? reinterpret_cast<float*>(s_rows + cap) : p.ipa_raw;

  // this CTA's copies of the value-space counts
  int* sp_counts = p.sp_counts + static_cast<size_t>(rank) * d.g_sp * d.v_sp;
  int* aff_counts = p.aff_counts + static_cast<size_t>(rank) * d.ra * d.v_aff;
  int* anti_counts = p.anti_counts + static_cast<size_t>(rank) * d.rt * d.v_anti;
  int* exist_counts =
      p.exist_counts + static_cast<size_t>(rank) * d.re * d.v_exist;
  int* soft_counts = p.soft_counts + static_cast<size_t>(rank) * d.gt * d.v_soft;
  float* ipa_counts = p.ipa_counts + static_cast<size_t>(rank) * d.rp * d.v_ipa;
  float* ipa_wcounts =
      p.ipa_wcounts + static_cast<size_t>(rank) * d.rp * d.v_ipa;

  for (int l = tid; l < len; l += nt) {
    const size_t j = static_cast<size_t>(lo + l);
    for (int q = 0; q < r; ++q) {
      if (kResident) {
        s_alloc[q * cap + l] = p.alloc[j * r + q];
        s_req[q * cap + l] = p.req_in[j * r + q];
      } else {
        p.req_out[j * r + q] = p.req_in[j * r + q];
      }
    }
    if (kResident) {
      s_nzr[l] = p.nzr_in[j * 2];
      s_nzr[cap + l] = p.nzr_in[j * 2 + 1];
    } else {
      p.nzr_out[j * 2] = p.nzr_in[j * 2];
      p.nzr_out[j * 2 + 1] = p.nzr_in[j * 2 + 1];
    }
  }
  if (rank == 0) {
    for (int t = tid; t < d.b; t += nt) p.asg[t] = -1;
  }
  // row keys clamp into the key table, as JAX's gather does
  for (int i = tid; i < d.ra; i += nt) {
    const int key = p.aff_key[i];
    s_aff_key[i] = key < 0 ? -1 : min(key, d.k - 1);
    s_aff_tot[i] = 0;
  }
  for (int i = tid; i < d.rt; i += nt) {
    const int key = p.anti_key[i];
    s_anti_key[i] = key < 0 ? -1 : min(key, d.k - 1);
  }
  for (int i = tid; i < d.re; i += nt) {
    const int key = p.exist_key[i];
    s_exist_key[i] = key < 0 ? -1 : min(key, d.k - 1);
  }
  if (tid == 0) s_recount = 0u;
  for (int z = tid; z < kMaxZones; z += nt) s_zsum[z] = 0;
  // preferred inter-pod affinity scores only when some row has a value
  // anywhere (the reference's ipa_live)
  bool ipa_any = false;
  for (int i = tid; i < d.rp * n; i += nt) ipa_any |= p.ipa_nv[i] >= 0;
  const bool ipa_on = __syncthreads_or(ipa_any) && d.rp > 0;
  // the affinity rows' totals over values (the first-pod escape reads
  // them); kept exact in shared memory and bumped by the replay
  for (int row = 0; row < d.ra; ++row) {
    int part = 0;
    for (int v = tid; v < d.v_aff; v += nt)
      part = add_wrap(part, aff_counts[row * d.v_aff + v]);
    part = warp_sum(part);
    if (lane == 0 && part != 0) atomicAdd(&s_aff_tot[row], part);
  }
  recount_minima(d.g_sp >= 32 ? 0xffffffffu : (1u << d.g_sp) - 1u, sp_counts,
                 p.sp_vvalid, d.v_sp, s_gmin, s_gmult);
  if (param_warp) stage_pod(p, d, 0, s_pod[0], s_preq);
  // every CTA of the cluster is running before any store into its slots
  cluster_barrier();

  const int iters = (cap + row_threads - 1) / row_threads;
  int cur = 0;
  STEP_START();
  while (true) {
    STEP_MARK(0);  // loop
    __syncthreads();  // the last replay's counts, totals and minima are final
    STEP_MARK(1);  // CTA barrier 1
    const PodParams& P = s_pod[cur];
    const int t = P.t;
    if (t >= d.b) break;  // the same in every thread of the cluster
    const unsigned stale = s_recount;
    if (stale) {
      recount_minima(stale, sp_counts, p.sp_vvalid, d.v_sp, s_gmin, s_gmult);
      if (tid == 0) s_recount = 0u;
    }
    const int* preq = s_preq + cur * r;
    const bool all_zero = P.all_zero;
    const int sig = P.sig;
    const int sel_g = P.sel_g;
    const bool has_soft = P.has_soft;
    int sp_min[kMaxSlots];
    int aff_total = 0;
#pragma unroll
    for (int c = 0; c < kMaxSlots; ++c) {
      const int g = P.sp_g[c];
      sp_min[c] = g < 0 ? kBig : min(kBig, s_gmin[g]);
      if (P.aff_row[c] >= 0) aff_total = add_wrap(aff_total, s_aff_tot[P.aff_row[c]]);
    }
    const bool escape = aff_total == 0 && P.self_match;
    STEP_MARK(2);  // recounts, slot minima, escape

    // -- pass 1: feasibility, raw family values, normalisers ------------
    const uint8_t* mrow = p.rows + static_cast<size_t>(P.mask_row) * n;
    Norm red = norm_identity();
    if (!param_warp) {
      for (int it = 0; it < iters; ++it) {
        const int l = tid + it * row_threads;
        const bool in = l < len;
        const int j = lo + l;
        const int ri = kResident ? l : j;
        bool feas = in && p.valid[j] && mrow[j];
        if (feas) {
          feas = kResident
              ? fits_node_strided(s_alloc + l, s_req + l, cap, preq, r, all_zero)
              : fits_node(p.alloc + static_cast<size_t>(j) * r,
                          p.req_out + static_cast<size_t>(j) * r, preq, r,
                          all_zero);
        }
        for (int c = 0; feas && c < kMaxSlots; ++c) {
          const int g = P.sp_g[c];
          if (g < 0) continue;
          const int v = p.sp_nv[static_cast<size_t>(g) * n + j];
          const int cnt = sp_counts[g * d.v_sp + clampi(v, 0, d.v_sp - 1)];
          feas = v >= 0 &&
                 sub_wrap(add_wrap(cnt, P.sp_self[c]), sp_min[c]) <= P.sp_skew[c];
        }
        if (feas && d.ra > 0) {
          bool aff_all = true;
          for (int c = 0; aff_all && c < kMaxSlots; ++c) {
            const int row = P.aff_row[c];
            if (row < 0) continue;
            const int v = row_value(p.af_nv, s_aff_key[row], n, j);
            aff_all = v >= 0 &&
                      aff_counts[row * d.v_aff + clampi(v, 0, d.v_aff - 1)] > 0;
          }
          feas = aff_all || escape;
        }
        for (int c = 0; feas && c < kMaxSlots; ++c) {
          const int row = P.anti_row[c];
          if (row < 0) continue;
          const int v = row_value(p.af_nv, s_anti_key[row], n, j);
          feas = !(v >= 0 &&
                   anti_counts[row * d.v_anti + clampi(v, 0, d.v_anti - 1)] > 0);
        }
        for (int i = 0; feas && i < P.n_exist; ++i) {
          const int row = P.exist_rows[i];
          const int v = row_value(p.af_nv, s_exist_key[row], n, j);
          feas = !(v >= 0 &&
                   exist_counts[row * d.v_exist + clampi(v, 0, d.v_exist - 1)] > 0);
        }
        const size_t sj = static_cast<size_t>(sig) * n + j;
        red.any_feas |= feas;
        if (in) {
          red.na_max = max(red.na_max, feas ? p.nodeaff[sj] : 0);
          red.tt_max = max(red.tt_max, feas ? p.taint[sj] : 0);
        }
        if (sel_g >= 0) {  // uniform
          const int sel = feas ? p.sel_counts[static_cast<size_t>(sel_g) * n + j] : 0;
          if (in) red.sel_max = max(red.sel_max, sel);
          const int zone = in ? p.zone_id[j] : -1;
          const bool in_zone = feas && zone >= 0;
          red.have_zones |= in_zone;
          const int key = in_zone ? clampi(zone, 0, d.z - 1) : -1;
          const unsigned same = __match_any_sync(0xffffffffu, key);
          const int sum = __reduce_add_sync(same, sel);
          if (key >= 0 && lane == __ffs(same) - 1 && sum != 0)
            atomicAdd(&s_zsum[key], sum);
        }
        bool eligible = true;
        if (has_soft && feas) {
          int raw = 0;
          for (int c = 0; c < kMaxSlots; ++c) {
            const int g = P.soft_g[c];
            if (g < 0) continue;
            const int v = p.soft_nv[static_cast<size_t>(g) * n + j];
            if (v < 0) {
              eligible = false;
            } else {
              raw = add_wrap(raw, soft_counts[g * d.v_soft + min(v, d.v_soft - 1)]);
            }
          }
          row_soft[ri] = raw;
          if (eligible) {
            red.soft_total = add_wrap(red.soft_total, raw);
            red.soft_min = min(red.soft_min, raw);
            red.dom_any = 1;
          }
        }
        if (ipa_on) {
          float raw = 0.0f;
          if (feas) {
            for (int row = 0; row < d.rp; ++row) {
              const int v = p.ipa_nv[static_cast<size_t>(row) * n + j];
              const int vc = clampi(v, 0, d.v_ipa - 1);
              const float a = v >= 0 ? ipa_counts[row * d.v_ipa + vc] : 0.0f;
              const float w = v >= 0 ? ipa_wcounts[row * d.v_ipa + vc] : 0.0f;
              raw = __fadd_rn(raw, __fadd_rn(__fmul_rn(a, P.ipa_w[row]),
                                             __fmul_rn(w, P.ipa_m[row])));
            }
            row_ipa[ri] = raw;
          }
          if (in) {
            red.ipa_min = min(red.ipa_min, ordered_bits(raw));
            red.ipa_max = max(red.ipa_max, ordered_bits(raw));
          }
        }
        if (in) row_flags[ri] = (feas ? 1 : 0) | (eligible ? 2 : 0);
      }
    }
    STEP_MARK(3);  // pass 1
    red = warp_norm(red);
    if (lane == 0) s_wnorm[warp] = red;
    STEP_MARK(4);  // warp fold
    __syncthreads();
    STEP_MARK(5);  // CTA barrier 2
    // the CTA's part into slot [rank] of every CTA
    if (warp == 0) {
      Norm part = lane < nt / 32 ? s_wnorm[lane] : norm_identity();
      part = warp_norm(part);
      if (lane < cluster) {
        cooperative_groups::this_cluster().map_shared_rank(&s_norm_slots[0], lane)[rank] = part;
      }
    } else if (sel_g >= 0) {
      for (int i = tid - 32; i < cluster * d.z; i += nt - 32) {
        const int dst = i / d.z;
        const int z = i - dst * d.z;
        cooperative_groups::this_cluster().map_shared_rank(
            &s_zone_slots[0], dst)[rank * d.z + z] = s_zsum[z];
      }
    }
    STEP_MARK(6);  // CTA fold and publish
    cluster_barrier();
    STEP_MARK(7);  // cluster barrier 1

    for (int z = tid; z < kMaxZones; z += nt) s_zsum[z] = 0;
    float best = -INFINITY;
    int best_i = kNoIndex;
    if (param_warp) {
      // no row, so no candidate: arrive at the pick's cluster barrier at
      // once, and stage the next active pod's parameters into the other
      // buffer while the rows are scored
      cluster_publish(0ull, s_cand, cluster, rank);
      stage_pod(p, d, t + 1, s_pod[cur ^ 1], s_preq + (cur ^ 1) * r);
    } else {
      Norm g = lane < cluster ? s_norm_slots[lane] : norm_identity();
      g = warp_norm(g);
      int sel_max_zone = 0;
      if (sel_g >= 0) {
        int tot0 = 0;
        int tot1 = 0;
        for (int c = 0; c < cluster; ++c) {
          if (lane < d.z) tot0 = add_wrap(tot0, s_zone_slots[c * d.z + lane]);
          if (lane + 32 < d.z) tot1 = add_wrap(tot1, s_zone_slots[c * d.z + lane + 32]);
        }
        s_ztot[warp][lane] = tot0;
        s_ztot[warp][lane + 32] = tot1;
        sel_max_zone = __reduce_max_sync(
            0xffffffffu, max(lane < d.z ? tot0 : INT_MIN,
                             lane + 32 < d.z ? tot1 : INT_MIN));
        __syncwarp();
      }

      // -- pass 2: compose the scores, argmax ---------------------------
      const float w_na = p.weights[0];
      const float w_tt = p.weights[1];
      const float w_sel = p.weights[2];
      const float w_soft = p.weights[3];
      const float w_ipa = p.weights[4];
      const float na_den = static_cast<float>(max(g.na_max, 1));
      const float tt_den = static_cast<float>(max(g.tt_max, 1));
      const float sel_den = static_cast<float>(max(g.sel_max, 1));
      const float zone_den = static_cast<float>(max(sel_max_zone, 1));
      const int soft_min = g.dom_any ? g.soft_min : kBig;
      const float soft_diff = static_cast<float>(sub_wrap(g.soft_total, soft_min));
      const float ipa_mn = fminf(0.0f, from_ordered_bits(g.ipa_min));
      const float ipa_mx = fmaxf(0.0f, from_ordered_bits(g.ipa_max));
      const float ipa_diff = __fsub_rn(ipa_mx, ipa_mn);
      for (int l = tid; l < len; l += row_threads) {
        const int j = lo + l;
        const int ri = kResident ? l : j;
        const uint8_t flags = row_flags[ri];
        if (!(flags & 1)) continue;
        const int n0 = kResident ? s_nzr[l] : p.nzr_out[j * 2];
        const int n1 = kResident ? s_nzr[cap + l] : p.nzr_out[j * 2 + 1];
        const int a0 = kResident ? s_alloc[l] : p.alloc[static_cast<size_t>(j) * r];
        const int a1 = kResident ? s_alloc[cap + l] : p.alloc[static_cast<size_t>(j) * r + 1];
        float score = combined_score(
            static_cast<float>(a0), static_cast<float>(a1),
            static_cast<float>(add_wrap(n0, P.p0)),
            static_cast<float>(add_wrap(n1, P.p1)),
            d.w_least, d.w_balanced, d.w_most);
        const size_t sj = static_cast<size_t>(sig) * n + j;
        score = __fadd_rn(score, p.direct[sj]);
        // preferred NodeAffinity: max-scaled over the feasible set
        const float na = floorf(__fdiv_rn(
            __fmul_rn(100.0f, static_cast<float>(p.nodeaff[sj])), na_den));
        score = __fadd_rn(score, g.na_max > 0 ? __fmul_rn(w_na, na) : 0.0f);
        // TaintToleration: reversed
        const float tt = floorf(__fdiv_rn(
            __fmul_rn(100.0f, static_cast<float>(p.taint[sj])), tt_den));
        score = __fadd_rn(score, __fmul_rn(
            w_tt, g.tt_max > 0 ? __fsub_rn(100.0f, tt) : 100.0f));
        // SelectorSpread: inverted counts, zone-blended 2/3
        if (sel_g >= 0) {
          const int sel = p.sel_counts[static_cast<size_t>(sel_g) * n + j];
          const float f_node = g.sel_max > 0
              ? __fdiv_rn(__fmul_rn(100.0f, static_cast<float>(sub_wrap(g.sel_max, sel))), sel_den)
              : 100.0f;
          const int zone = p.zone_id[j];
          const int zs = s_ztot[warp][clampi(zone, 0, d.z - 1)];
          const float f_zone = sel_max_zone > 0
              ? __fdiv_rn(__fmul_rn(100.0f, static_cast<float>(sub_wrap(sel_max_zone, zs))), zone_den)
              : 100.0f;
          const float blended = (g.have_zones && zone >= 0)
              ? __fmaf_rn(f_node, kThird, __fmul_rn(kTwoThirds, f_zone))
              : f_node;
          score = __fadd_rn(score, __fmul_rn(w_sel, floorf(blended)));
        }
        // soft topology spread: flipped-linear against (total - min)
        if (has_soft) {
          float soft;
          if (soft_diff == 0.0f) {
            soft = 100.0f;
          } else if (!(flags & 2)) {
            soft = 0.0f;
          } else {
            soft = floorf(__fdiv_rn(__fmul_rn(100.0f, static_cast<float>(
                sub_wrap(g.soft_total, row_soft[ri]))), soft_diff));
          }
          score = __fadd_rn(score, __fmul_rn(w_soft, soft));
        }
        // preferred inter-pod affinity: [min, max] -> [0, 100]
        if (ipa_on) {
          const float ipa = ipa_diff > 0.0f
              ? floorf(__fadd_rn(__fdiv_rn(__fmul_rn(100.0f, __fsub_rn(row_ipa[ri], ipa_mn)),
                                           fmaxf(ipa_diff, 1e-9f)), 1e-4f))
              : 0.0f;
          score = __fadd_rn(score, __fmul_rn(w_ipa, ipa));
        }
        if (score > best) {  // a thread's rows ascend: the first max is kept
          best = score;
          best_i = j;
        }
      }
    }
    STEP_MARK(8);  // normaliser fold and pass 2
    if (!param_warp) cluster_publish(pack_best(best, best_i), s_cand, cluster, rank);
    const int choice = best_index(cluster_collect(s_cand, cluster));

    STEP_MARK(9);  // cluster barrier 2 and the pick
    // -- replay -----------------------------------------------------------
    if (choice != kNoIndex) {
      if (rank == 0 && tid == 0) p.asg[t] = choice;
      if (choice >= lo && choice < hi && (choice - lo) % row_threads == tid) {
        // this thread owns the winner's row: its node-space state
        const int l = choice - lo;
        int* q = kResident ? s_req + l : p.req_out + static_cast<size_t>(choice) * r;
        const int stride = kResident ? cap : 1;
        for (int x = 0; x < r; ++x) q[x * stride] = add_wrap(q[x * stride], preq[x]);
        int* nz = kResident ? s_nzr + l : p.nzr_out + choice * 2;
        const int nstride = kResident ? cap : 1;
        nz[0] = add_wrap(nz[0], P.p0);
        nz[nstride] = add_wrap(nz[nstride], P.p1);
        for (int k = 0; k < d.g_sel; ++k) {
          int* c = &p.sel_counts[static_cast<size_t>(k) * n + choice];
          *c = add_wrap(*c, P.sel_match[k]);
        }
      }
      // this CTA's copy of the value-space counts: one lane per row, and
      // family f's rows on warp f % warps, so no warp serialises the
      // loads of several families behind each other
      const int warps = nt >> 5;
      if (warp == 0 % warps) {
        for (int k = lane; k < d.g_sp; k += 32) {
          const int v = p.sp_nv[static_cast<size_t>(k) * n + choice];
          if (v >= 0 && P.sp_match[k] > 0) {
            const int vi = min(v, d.v_sp - 1);
            int* c = &sp_counts[k * d.v_sp + vi];
            const int old = *c;
            *c = add_wrap(old, 1);
            // the group's minimum moves only when the last valid value at
            // it is bumped, or a count wraps
            if (p.sp_vvalid[k * d.v_sp + vi] &&
                ((old == s_gmin[k] && --s_gmult[k] == 0) || *c < old)) {
              atomicOr(&s_recount, 1u << k);
            }
          }
        }
      }
      if (warp == 1 % warps) {
        for (int k = lane; k < d.ra; k += 32) {
          const int v = row_value(p.af_nv, s_aff_key[k], n, choice);
          const int bump = P.aff_bump[k];
          if (v >= 0) {
            int* c = &aff_counts[k * d.v_aff + min(v, d.v_aff - 1)];
            *c = add_wrap(*c, bump);
            s_aff_tot[k] = add_wrap(s_aff_tot[k], bump);
          }
        }
      }
      if (warp == 2 % warps) {
        for (int k = lane; k < d.rt; k += 32) {
          const int v = row_value(p.af_nv, s_anti_key[k], n, choice);
          if (v >= 0) {
            int* c = &anti_counts[k * d.v_anti + min(v, d.v_anti - 1)];
            *c = add_wrap(*c, P.anti_bump[k]);
          }
        }
      }
      if (warp == 3 % warps) {
        for (int k = lane; k < d.re; k += 32) {
          const int v = row_value(p.af_nv, s_exist_key[k], n, choice);
          if (v >= 0) {
            int* c = &exist_counts[k * d.v_exist + min(v, d.v_exist - 1)];
            *c = add_wrap(*c, P.exist_bump[k]);
          }
        }
      }
      if (warp == 4 % warps) {
        for (int k = lane; k < d.gt; k += 32) {
          const int v = p.soft_nv[static_cast<size_t>(k) * n + choice];
          if (v >= 0) {
            int* c = &soft_counts[k * d.v_soft + min(v, d.v_soft - 1)];
            *c = add_wrap(*c, P.soft_match[k]);
          }
        }
      }
      if (warp == 5 % warps) {
        for (int k = lane; k < d.rp; k += 32) {
          const int v = p.ipa_nv[static_cast<size_t>(k) * n + choice];
          if (v >= 0) {
            const int at = k * d.v_ipa + min(v, d.v_ipa - 1);
            ipa_counts[at] = __fadd_rn(ipa_counts[at], P.ipa_m[k]);
            ipa_wcounts[at] = __fadd_rn(ipa_wcounts[at], P.ipa_bump[k]);
          }
        }
      }
    }
    STEP_MARK(10);  // replay
    cur ^= 1;
  }

  if (kResident) {
    for (int l = tid; l < len; l += nt) {
      const size_t j = static_cast<size_t>(lo + l);
      for (int q = 0; q < r; ++q) p.req_out[j * r + q] = s_req[q * cap + l];
      p.nzr_out[j * 2] = s_nzr[l];
      p.nzr_out[j * 2 + 1] = s_nzr[cap + l];
    }
  }
  // no CTA leaves while another may still store into its shared memory
  cluster_barrier();
}

}  // namespace

#ifdef SOLVE_STEP_PROFILE
extern "C" int constrained_solve_step_cycles(unsigned long long* out) {
  return solve::read_step_cycles(out);
}
#endif

// static shared memory of one CTA of the kernel, or -1
extern "C" int constrained_solve_static_smem(int resident) {
  return resident ? static_smem_bytes(constrained_cluster_kernel<true>)
                  : static_smem_bytes(constrained_cluster_kernel<false>);
}

// at least one row warp beside the parameter warp
constexpr int kMinThreads = 64;

// how many clusters of this shape the card can hold at once (0: none)
extern "C" int constrained_solve_max_clusters(int cluster, int threads,
                                              int smem, int resident) {
  if (!valid_cluster_shape(cluster, threads, kMinThreads)) return 0;
  return resident
      ? cluster_occupancy(constrained_cluster_kernel<true>, cluster, threads, smem)
      : cluster_occupancy(constrained_cluster_kernel<false>, cluster, threads, smem);
}

// ptrs: kNumPtrs device pointers in Ptrs order; dims: kNumDims ints in Dims
// order; then the launch plan (ops/cluster_plan.plan_launch): one cluster
// of `cluster` CTAs of `threads` threads with `smem` bytes of dynamic
// shared memory each. Returns the launch's cudaError_t, or
// cudaErrorInvalidValue when the operand counts, a row count or the plan
// do not match what the kernel holds.
extern "C" int constrained_solve_launch(
    const void* const* ptrs, int n_ptrs, const int* dims, int n_dims,
    int cluster, int threads, int resident, int smem, void* stream) {
  if (n_ptrs != kNumPtrs || n_dims != kNumDims) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Ptrs p;
  Dims d;
  memcpy(&p, ptrs, sizeof(Ptrs));
  memcpy(&d, dims, sizeof(Dims));
  if (d.c_sp > kMaxSlots || d.c_aff > kMaxSlots || d.c_anti > kMaxSlots ||
      d.c_soft > kMaxSlots || d.g_sp > kMaxGroups || d.gt > kMaxGroups ||
      d.g_sel > kMaxSelGroups || d.ra > kMaxAffRows ||
      d.rt > kMaxAffRows || d.re > kMaxExistRows || d.rp > kMaxIpaRows ||
      d.z > kMaxZones || d.z < 1 || d.s < 1 || d.u < 1 || d.n < 1 ||
      d.r < 2 || (d.k < 1 && d.ra + d.rt + d.re > 0) ||
      !valid_cluster_shape(cluster, threads, kMinThreads) || cluster > d.n ||
      static_cast<size_t>(smem) < dynamic_smem_bytes(d.n, d.r, cluster, resident)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return resident
      ? launch_cluster(constrained_cluster_kernel<true>, cluster, threads, smem, st, p, d)
      : launch_cluster(constrained_cluster_kernel<false>, cluster, threads, smem, st, p, d);
}
