// Constrained batch solve for Hopper (sm_90a): the whole pod batch in ONE
// launch, with hard topology spread, required inter-pod (anti-)affinity and
// the full default score plugin set.
//
// Replaces: kubernetes_tpu/ops/pallas_constrained.py::_constrained_kernel
// (entry pallas_constrained_solve). Its plain PyTorch version is
// kubernetes_tpu_torch/ops/assignment.py::greedy_assign_constrained (the
// port of the reference's XLA scan), and the wrapper is
// kubernetes_tpu_torch/ops/constrained_kernel.py, which passes each
// family's live row count (live_rows) and hands the kernel fresh copies of
// those rows of every count tensor to replay into.
//
// What it computes, for each active pod t in solve order (inactive pods
// take one block-uniform skip: they never place, so they change nothing):
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
// Design: one block of 1,024 threads walks the batch in order, as K1 does;
// thread k owns nodes k, k + 1024, ... The count tensors work in VALUE
// space as the XLA scan does (the TPU kernel's node-space matrices and
// one-hot extracts exist only because Mosaic has no lane gather). At
// N = 5,632 with every family at its packer maximum the live state is a few
// MB: beyond one block's 227 KB of shared memory but resident in the 50 MB
// L2, so it lives in global memory and shared memory holds the per-pod
// parameters, the per-step reductions and the [Z] zone sums. One step:
//   (a) per-pod parameters into shared memory; each live spread slot's
//       minimum over values (one block reduction over V);
//   (b) one pass over the nodes: feasibility, the raw value of every score
//       family, and the per-step normalisers folded as it goes (integer
//       maxima, zone sums by warp-aggregated shared atomics, the soft total
//       and minimum, the preferred-affinity minimum and maximum -- every one
//       exact and free of order: the counts, weights and their sums are
//       integers below 2^24);
//   (c) warp-shuffle then cross-warp reductions;
//   (d) a second pass composes each feasible node's f32 score in the
//       reference's exact operation order and takes the (score, index)
//       argmax;
//   (e) one thread per live count row replays it at the chosen node.
//
// What bounds it on this card: like K1, neither bytes nor operations but
// the chain: pod t+1's feasibility depends on pod t's pick and counts, so a
// batch is B dependent block-wide steps on ONE SM, each five block barriers
// and two passes over the node rows from L1/L2. The one-block design leaves
// on the table: the other 131 SMs (a cluster of blocks sharing the state
// through distributed shared memory, with one cluster barrier per pod),
// node slices resident in registers or shared memory instead of re-read
// each step, and spread minima and affinity totals kept incrementally
// instead of re-reduced over V every step.

#include <limits.h>
#include <string.h>

#include "solve_common.cuh"

namespace {

using namespace solve;

constexpr int kMaxSlots = 4;      // topology.MAX_CONSTRAINTS_PER_POD etc.
constexpr int kMaxAffRows = 16;   // affinity.MAX_AFF_ROWS / MAX_ANTI_ROWS
constexpr int kMaxExistRows = 64; // affinity.MAX_EXIST_ROWS
constexpr int kMaxIpaRows = 16;   // scoring.MAX_IPA_ROWS
constexpr int kMaxZones = 64;     // scoring.MAX_ZONES
constexpr int kBig = 1 << 20;     // the spread / soft "no value" sentinel
constexpr float kThird = 0.333333343f;      // float32(1 / 3)
constexpr float kTwoThirds = 0.666666687f;  // float32(2 / 3)

// Operands, in the order the wrapper passes their pointers. Scratch
// tensors (the *_counts copies and the three per-node arrays) are written
// by the kernel; everything else is read only.
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
  int* sp_counts;            // [g_sp, V_sp] scratch
  const uint8_t* sp_vvalid;  // [>= g_sp, V_sp]
  const int* sp_nv;          // [>= g_sp, N]
  const int* sp_groups;      // [B, C_sp]
  const int* sp_skew;        // [B, C_sp]
  const int* sp_self;        // [B, C_sp]
  const int* sp_match;       // [B, sp_match_w]
  // required inter-pod affinity
  const int* af_nv;          // [K, N]
  int* aff_counts;           // [ra, V_aff] scratch
  const int* aff_key;        // [>= ra]
  const int* aff_rows;       // [B, C_aff]
  const uint8_t* self_match; // [B]
  const int* aff_bump;       // [B, aff_bump_w]
  int* anti_counts;          // [rt, V_anti] scratch
  const int* anti_key;       // [>= rt]
  const int* anti_rows;      // [B, C_anti]
  const int* anti_bump;      // [B, anti_bump_w]
  int* exist_counts;         // [re, V_exist] scratch
  const int* exist_key;      // [>= re]
  const uint8_t* exist_match;  // [B, exist_w]
  const int* exist_bump;     // [B, exist_w]
  // scoring
  const float* direct;       // [S, N]
  const int* nodeaff;        // [S, N]
  const int* taint;          // [S, N]
  const int* pod_sig;        // [B]
  int* sel_counts;           // [g_sel, N] scratch (node space)
  const int* zone_id;        // [N]
  const int* sel_group;      // [B]
  const int* sel_match;      // [B, sel_match_w]
  int* soft_counts;          // [gt, V_soft] scratch
  const int* soft_nv;        // [>= gt, N]
  const int* soft_groups;    // [B, C_soft]
  const int* soft_match;     // [B, soft_match_w]
  const int* ipa_nv;         // [>= rp, N]
  float* ipa_counts;         // [rp, V_ipa] scratch
  float* ipa_wcounts;        // [rp, V_ipa] scratch
  const float* ipa_weight;   // [B, ipa_w]
  const float* ipa_match;    // [B, ipa_w]
  const float* ipa_bump;     // [B, ipa_w]
  const float* weights;      // [5]: NodeAffinity, TaintToleration,
                             //      SelectorSpread, soft spread, IPA
  // outputs and per-node scratch
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

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int warp_max(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
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

__device__ __forceinline__ float warp_fmin(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_fmax(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// value of a row's topology key at node j: -1 where the row is padding
// (key < 0) or the node lacks the key (assignment.row_node_values)
__device__ __forceinline__ int row_value(
    const int* af_nv, int key, int n, int j) {
  return key < 0 ? -1 : af_nv[static_cast<size_t>(key) * n + j];
}

// per-step reductions, one slot per warp
struct Red {
  int any_feas, na_max, tt_max, sel_max, have_zones;
  int soft_total, soft_min, dom_any;
  float ipa_min, ipa_max;
};

__global__ void __launch_bounds__(kThreads) constrained_solve_kernel(
    Ptrs p, Dims d) {
  __shared__ float s_score[kWarps];
  __shared__ int s_index[kWarps];
  __shared__ Red s_red[kWarps];
  __shared__ int s_zsum[kMaxZones];
  __shared__ int s_aff_key[kMaxAffRows];
  __shared__ int s_anti_key[kMaxAffRows];
  __shared__ int s_exist_key[kMaxExistRows];
  __shared__ int s_aff_tot[kMaxAffRows];
  // per-pod parameters
  __shared__ int s_sp_g[kMaxSlots], s_sp_skew[kMaxSlots];
  __shared__ int s_sp_self[kMaxSlots], s_sp_min[kMaxSlots];
  __shared__ int s_aff_row[kMaxSlots], s_anti_row[kMaxSlots];
  __shared__ int s_soft_g[kMaxSlots];
  __shared__ int s_exist_rows[kMaxExistRows];
  __shared__ int s_n_exist;
  __shared__ float s_ipa_w[kMaxIpaRows], s_ipa_m[kMaxIpaRows];
  __shared__ int s_mask_row, s_all_zero, s_sig, s_sel_g, s_escape;
  __shared__ int s_has_soft, s_ipa_live;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = d.n;
  const int r = d.r;

  for (int j = tid; j < n; j += kThreads) {
    for (int q = 0; q < r; ++q) p.req_out[j * r + q] = p.req_in[j * r + q];
    p.nzr_out[j * 2] = p.nzr_in[j * 2];
    p.nzr_out[j * 2 + 1] = p.nzr_in[j * 2 + 1];
  }
  // row keys clamp into the key table, as JAX's gather does
  if (tid < d.ra) {
    const int key = p.aff_key[tid];
    s_aff_key[tid] = key < 0 ? -1 : min(key, d.k - 1);
    s_aff_tot[tid] = 0;
  }
  if (tid >= 32 && tid < 32 + d.rt) {
    const int key = p.anti_key[tid - 32];
    s_anti_key[tid - 32] = key < 0 ? -1 : min(key, d.k - 1);
  }
  if (tid >= 64 && tid < 64 + d.re) {
    const int key = p.exist_key[tid - 64];
    s_exist_key[tid - 64] = key < 0 ? -1 : min(key, d.k - 1);
  }
  // preferred inter-pod affinity scores only when some row has a value
  // anywhere (the reference's ipa_live)
  bool ipa_any = false;
  for (int i = tid; i < d.rp * n; i += kThreads) ipa_any |= p.ipa_nv[i] >= 0;
  const int ipa_live = __syncthreads_or(ipa_any);
  // the affinity rows' totals over values (the first-pod escape reads
  // them); kept exact in shared memory and bumped by the replay
  for (int row = 0; row < d.ra; ++row) {
    int part = 0;
    for (int v = tid; v < d.v_aff; v += kThreads)
      part = add_wrap(part, p.aff_counts[row * d.v_aff + v]);
    part = warp_sum(part);
    if (lane == 0) atomicAdd(&s_aff_tot[row], part);
  }
  if (tid == 0) s_ipa_live = ipa_live;
  __syncthreads();

  const int per_thread = (n + kThreads - 1) / kThreads;
  for (int t = 0; t < d.b; ++t) {
    if (!p.active[t]) {  // uniform across the block
      if (tid == 0) p.asg[t] = -1;
      continue;
    }
    const int* preq = p.pod_req + static_cast<size_t>(t) * r;

    // -- (a) per-pod parameters -----------------------------------------
    if (tid < kMaxSlots) {
      const int c = tid;
      int g = -1;
      if (c < d.c_sp) {
        g = p.sp_groups[t * d.c_sp + c];
        if (g >= d.g_sp) g = -1;  // a group beyond the live rows is absent
        s_sp_skew[c] = p.sp_skew[t * d.c_sp + c];
        s_sp_self[c] = p.sp_self[t * d.c_sp + c];
      }
      s_sp_g[c] = g < 0 ? -1 : g;
      s_sp_min[c] = kBig;
      int row = c < d.c_aff ? p.aff_rows[t * d.c_aff + c] : -1;
      s_aff_row[c] = (row < 0 || row >= d.ra) ? -1 : row;
      row = c < d.c_anti ? p.anti_rows[t * d.c_anti + c] : -1;
      s_anti_row[c] = (row < 0 || row >= d.rt) ? -1 : row;
      row = c < d.c_soft ? p.soft_groups[t * d.c_soft + c] : -1;
      s_soft_g[c] = (row < 0 || row >= d.gt) ? -1 : row;
    } else if (tid >= 32 && tid < 32 + kMaxIpaRows) {
      const int row = tid - 32;
      const bool live = row < d.rp;
      s_ipa_w[row] = live ? p.ipa_weight[t * d.ipa_w + row] : 0.0f;
      s_ipa_m[row] = live ? p.ipa_match[t * d.ipa_w + row] : 0.0f;
    } else if (tid == 64) {
      int m = p.midx[t];
      s_mask_row = clampi(m, 0, d.u - 1);  // gathers clamp, as in JAX
      s_all_zero = pod_all_zero(preq, r);
      s_sig = clampi(p.pod_sig[t], 0, d.s - 1);
      const int g = p.sel_group[t];
      s_sel_g = (g < 0 || g >= d.g_sel) ? -1 : g;
      s_n_exist = 0;
    } else if (tid >= 128 && tid < 128 + kMaxZones) {
      s_zsum[tid - 128] = 0;
    }
    __syncthreads();
    if (tid >= 256 && tid < 256 + d.re) {  // the pod's existing-pod rows
      const int row = tid - 256;
      if (p.exist_match[t * d.exist_w + row])
        s_exist_rows[atomicAdd(&s_n_exist, 1)] = row;  // order is free
    }
    if (tid == 0) {
      int total = 0;  // the pod's affinity rows' totals (escape test)
      for (int c = 0; c < kMaxSlots; ++c)
        if (s_aff_row[c] >= 0) total = add_wrap(total, s_aff_tot[s_aff_row[c]]);
      s_escape = total == 0 && p.self_match[t];
      bool has_soft = false;
      for (int c = 0; c < kMaxSlots; ++c) has_soft |= s_soft_g[c] >= 0;
      s_has_soft = has_soft;
    }
    // each live spread slot's minimum over the group's valid values
    for (int c = 0; c < kMaxSlots; ++c) {
      const int g = s_sp_g[c];  // uniform
      if (g < 0) continue;
      int lo = kBig;
      for (int v = tid; v < d.v_sp; v += kThreads)
        if (p.sp_vvalid[g * d.v_sp + v]) lo = min(lo, p.sp_counts[g * d.v_sp + v]);
      lo = warp_min(lo);
      if (lane == 0) atomicMin(&s_sp_min[c], lo);
    }
    __syncthreads();

    // -- (b) pass 1: feasibility, raw family values, normalisers --------
    const uint8_t* mrow = p.rows + static_cast<size_t>(s_mask_row) * n;
    const bool all_zero = s_all_zero;
    const int sig = s_sig;
    const int sel_g = s_sel_g;
    const bool has_soft = s_has_soft;
    const bool ipa_on = s_ipa_live && d.rp > 0;
    Red red = {0, INT_MIN, INT_MIN, INT_MIN, 0, 0, kBig, 0, INFINITY, -INFINITY};
    for (int it = 0; it < per_thread; ++it) {
      const int j = tid + it * kThreads;
      bool feas = j < n && p.valid[j] && mrow[j];
      if (feas) {
        feas = fits_node(p.alloc + static_cast<size_t>(j) * r,
                         p.req_out + static_cast<size_t>(j) * r, preq, r,
                         all_zero);
      }
      for (int c = 0; feas && c < kMaxSlots; ++c) {
        const int g = s_sp_g[c];
        if (g < 0) continue;
        const int v = p.sp_nv[static_cast<size_t>(g) * n + j];
        const int cnt = p.sp_counts[g * d.v_sp + clampi(v, 0, d.v_sp - 1)];
        feas = v >= 0 &&
               sub_wrap(add_wrap(cnt, s_sp_self[c]), s_sp_min[c]) <= s_sp_skew[c];
      }
      if (feas && d.ra > 0) {
        bool aff_all = true;
        for (int c = 0; aff_all && c < kMaxSlots; ++c) {
          const int row = s_aff_row[c];
          if (row < 0) continue;
          const int v = row_value(p.af_nv, s_aff_key[row], n, j);
          aff_all = v >= 0 &&
                    p.aff_counts[row * d.v_aff + clampi(v, 0, d.v_aff - 1)] > 0;
        }
        feas = aff_all || s_escape;
      }
      for (int c = 0; feas && c < kMaxSlots; ++c) {
        const int row = s_anti_row[c];
        if (row < 0) continue;
        const int v = row_value(p.af_nv, s_anti_key[row], n, j);
        feas = !(v >= 0 &&
                 p.anti_counts[row * d.v_anti + clampi(v, 0, d.v_anti - 1)] > 0);
      }
      for (int i = 0; feas && i < s_n_exist; ++i) {
        const int row = s_exist_rows[i];
        const int v = row_value(p.af_nv, s_exist_key[row], n, j);
        feas = !(v >= 0 &&
                 p.exist_counts[row * d.v_exist + clampi(v, 0, d.v_exist - 1)] > 0);
      }
      // the normalisers are maxima / minima over every node row, an
      // infeasible one counting 0 (the reference's where(feasible, x, 0))
      const size_t sj = static_cast<size_t>(sig) * n + j;
      red.any_feas |= feas;
      if (j < n) {
        red.na_max = max(red.na_max, feas ? p.nodeaff[sj] : 0);
        red.tt_max = max(red.tt_max, feas ? p.taint[sj] : 0);
      }
      if (sel_g >= 0) {  // uniform
        const int sel = feas ? p.sel_counts[static_cast<size_t>(sel_g) * n + j] : 0;
        if (j < n) red.sel_max = max(red.sel_max, sel);
        const int zone = j < n ? p.zone_id[j] : -1;
        const bool in_zone = feas && zone >= 0;
        red.have_zones |= in_zone;
        // warp-aggregated zone sums: lanes on one zone add once
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
          const int g = s_soft_g[c];
          if (g < 0) continue;
          const int v = p.soft_nv[static_cast<size_t>(g) * n + j];
          if (v < 0) {
            eligible = false;
          } else {
            raw = add_wrap(raw, p.soft_counts[g * d.v_soft + min(v, d.v_soft - 1)]);
          }
        }
        p.soft_raw[j] = raw;
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
            const float a = v >= 0 ? p.ipa_counts[row * d.v_ipa + vc] : 0.0f;
            const float w = v >= 0 ? p.ipa_wcounts[row * d.v_ipa + vc] : 0.0f;
            raw = __fadd_rn(raw, __fadd_rn(__fmul_rn(a, s_ipa_w[row]),
                                           __fmul_rn(w, s_ipa_m[row])));
          }
          p.ipa_raw[j] = raw;
        }
        if (j < n) {
          red.ipa_min = fminf(red.ipa_min, raw);
          red.ipa_max = fmaxf(red.ipa_max, raw);
        }
      }
      if (j < n) p.node_flags[j] = (feas ? 1 : 0) | (eligible ? 2 : 0);
    }

    // -- (c) block reductions -------------------------------------------
    red.any_feas = __any_sync(0xffffffffu, red.any_feas);
    red.na_max = warp_max(red.na_max);
    red.tt_max = warp_max(red.tt_max);
    red.sel_max = warp_max(red.sel_max);
    red.have_zones = __any_sync(0xffffffffu, red.have_zones);
    red.soft_total = warp_sum(red.soft_total);
    red.soft_min = warp_min(red.soft_min);
    red.dom_any = __any_sync(0xffffffffu, red.dom_any);
    red.ipa_min = warp_fmin(red.ipa_min);
    red.ipa_max = warp_fmax(red.ipa_max);
    if (lane == 0) s_red[warp] = red;
    __syncthreads();
    red = s_red[lane];  // kWarps == 32: each warp reduces all 32 again
    red.any_feas = __any_sync(0xffffffffu, red.any_feas);
    red.na_max = warp_max(red.na_max);
    red.tt_max = warp_max(red.tt_max);
    red.sel_max = warp_max(red.sel_max);
    red.have_zones = __any_sync(0xffffffffu, red.have_zones);
    red.soft_total = warp_sum(red.soft_total);
    red.soft_min = warp_min(red.soft_min);
    red.dom_any = __any_sync(0xffffffffu, red.dom_any);
    red.ipa_min = warp_fmin(red.ipa_min);
    red.ipa_max = warp_fmax(red.ipa_max);
    int sel_max_zone = 0;
    if (sel_g >= 0) {
      sel_max_zone = max(lane < d.z ? s_zsum[lane] : INT_MIN,
                         lane + 32 < d.z ? s_zsum[lane + 32] : INT_MIN);
      sel_max_zone = warp_max(sel_max_zone);
    }

    // -- (d) pass 2: compose the scores, argmax ------------------------
    const float w_na = p.weights[0];
    const float w_tt = p.weights[1];
    const float w_sel = p.weights[2];
    const float w_soft = p.weights[3];
    const float w_ipa = p.weights[4];
    const float na_den = static_cast<float>(max(red.na_max, 1));
    const float tt_den = static_cast<float>(max(red.tt_max, 1));
    const float sel_den = static_cast<float>(max(red.sel_max, 1));
    const float zone_den = static_cast<float>(max(sel_max_zone, 1));
    const int soft_min = red.dom_any ? red.soft_min : kBig;
    const float soft_diff = static_cast<float>(sub_wrap(red.soft_total, soft_min));
    const float ipa_mn = fminf(0.0f, red.ipa_min);
    const float ipa_mx = fmaxf(0.0f, red.ipa_max);
    const float ipa_diff = __fsub_rn(ipa_mx, ipa_mn);
    const int p0 = p.pod_nzr[t * 2];
    const int p1 = p.pod_nzr[t * 2 + 1];
    float best = -INFINITY;
    int best_i = kNoIndex;
    for (int j = tid; j < n; j += kThreads) {
      const uint8_t flags = p.node_flags[j];
      if (!(flags & 1)) continue;
      const int* a = p.alloc + static_cast<size_t>(j) * r;
      float score = combined_score(
          static_cast<float>(a[0]), static_cast<float>(a[1]),
          static_cast<float>(add_wrap(p.nzr_out[j * 2], p0)),
          static_cast<float>(add_wrap(p.nzr_out[j * 2 + 1], p1)),
          d.w_least, d.w_balanced, d.w_most);
      const size_t sj = static_cast<size_t>(sig) * n + j;
      score = __fadd_rn(score, p.direct[sj]);
      // preferred NodeAffinity: max-scaled over the feasible set
      const float na = floorf(__fdiv_rn(
          __fmul_rn(100.0f, static_cast<float>(p.nodeaff[sj])), na_den));
      score = __fadd_rn(score, red.na_max > 0 ? __fmul_rn(w_na, na) : 0.0f);
      // TaintToleration: reversed
      const float tt = floorf(__fdiv_rn(
          __fmul_rn(100.0f, static_cast<float>(p.taint[sj])), tt_den));
      score = __fadd_rn(score, __fmul_rn(
          w_tt, red.tt_max > 0 ? __fsub_rn(100.0f, tt) : 100.0f));
      // SelectorSpread: inverted counts, zone-blended 2/3
      if (sel_g >= 0) {
        const int sel = p.sel_counts[static_cast<size_t>(sel_g) * n + j];
        const float f_node = red.sel_max > 0
            ? __fdiv_rn(__fmul_rn(100.0f, static_cast<float>(sub_wrap(red.sel_max, sel))), sel_den)
            : 100.0f;
        const int zone = p.zone_id[j];
        const int zs = s_zsum[clampi(zone, 0, d.z - 1)];
        const float f_zone = sel_max_zone > 0
            ? __fdiv_rn(__fmul_rn(100.0f, static_cast<float>(sub_wrap(sel_max_zone, zs))), zone_den)
            : 100.0f;
        const float blended = (red.have_zones && zone >= 0)
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
              sub_wrap(red.soft_total, p.soft_raw[j]))), soft_diff));
        }
        score = __fadd_rn(score, __fmul_rn(w_soft, soft));
      }
      // preferred inter-pod affinity: [min, max] -> [0, 100]
      if (ipa_on) {
        const float ipa = ipa_diff > 0.0f
            ? floorf(__fadd_rn(__fdiv_rn(__fmul_rn(100.0f, __fsub_rn(p.ipa_raw[j], ipa_mn)),
                                         fmaxf(ipa_diff, 1e-9f)), 1e-4f))
            : 0.0f;
        score = __fadd_rn(score, __fmul_rn(w_ipa, ipa));
      }
      if (score > best) {  // nodes ascend, so the first max is kept
        best = score;
        best_i = j;
      }
    }
    const int choice = block_argmax(best, best_i, s_score, s_index);

    // -- (e) replay: one thread per live count row ---------------------
    if (choice == kNoIndex) {
      if (tid == 0) p.asg[t] = -1;
    } else {
      int k = tid;
      if (k == 0) {
        p.asg[t] = choice;
        int* q = p.req_out + static_cast<size_t>(choice) * r;
        for (int x = 0; x < r; ++x) q[x] = add_wrap(q[x], preq[x]);
        p.nzr_out[choice * 2] = add_wrap(p.nzr_out[choice * 2], p0);
        p.nzr_out[choice * 2 + 1] = add_wrap(p.nzr_out[choice * 2 + 1], p1);
      }
      k -= 1;
      if (k >= 0 && k < d.g_sp) {
        const int v = p.sp_nv[static_cast<size_t>(k) * n + choice];
        if (v >= 0 && p.sp_match[t * d.sp_match_w + k] > 0) {
          int* c = &p.sp_counts[k * d.v_sp + min(v, d.v_sp - 1)];
          *c = add_wrap(*c, 1);
        }
      }
      k -= d.g_sp;
      if (k >= 0 && k < d.ra) {
        const int v = row_value(p.af_nv, s_aff_key[k], n, choice);
        const int bump = p.aff_bump[t * d.aff_bump_w + k];
        if (v >= 0) {
          int* c = &p.aff_counts[k * d.v_aff + min(v, d.v_aff - 1)];
          *c = add_wrap(*c, bump);
          s_aff_tot[k] = add_wrap(s_aff_tot[k], bump);
        }
      }
      k -= d.ra;
      if (k >= 0 && k < d.rt) {
        const int v = row_value(p.af_nv, s_anti_key[k], n, choice);
        if (v >= 0) {
          int* c = &p.anti_counts[k * d.v_anti + min(v, d.v_anti - 1)];
          *c = add_wrap(*c, p.anti_bump[t * d.anti_bump_w + k]);
        }
      }
      k -= d.rt;
      if (k >= 0 && k < d.re) {
        const int v = row_value(p.af_nv, s_exist_key[k], n, choice);
        if (v >= 0) {
          int* c = &p.exist_counts[k * d.v_exist + min(v, d.v_exist - 1)];
          *c = add_wrap(*c, p.exist_bump[t * d.exist_w + k]);
        }
      }
      k -= d.re;
      if (k >= 0 && k < d.g_sel) {
        int* c = &p.sel_counts[static_cast<size_t>(k) * n + choice];
        *c = add_wrap(*c, p.sel_match[t * d.sel_match_w + k]);
      }
      k -= d.g_sel;
      if (k >= 0 && k < d.gt) {
        const int v = p.soft_nv[static_cast<size_t>(k) * n + choice];
        if (v >= 0) {
          int* c = &p.soft_counts[k * d.v_soft + min(v, d.v_soft - 1)];
          *c = add_wrap(*c, p.soft_match[t * d.soft_match_w + k]);
        }
      }
      k -= d.gt;
      if (k >= 0 && k < d.rp) {
        const int v = p.ipa_nv[static_cast<size_t>(k) * n + choice];
        if (v >= 0) {
          const int at = k * d.v_ipa + min(v, d.v_ipa - 1);
          p.ipa_counts[at] = __fadd_rn(p.ipa_counts[at], p.ipa_match[t * d.ipa_w + k]);
          p.ipa_wcounts[at] = __fadd_rn(p.ipa_wcounts[at], p.ipa_bump[t * d.ipa_w + k]);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// ptrs: kNumPtrs device pointers in Ptrs order; dims: kNumDims ints in Dims
// order. Returns the launch's cudaError_t, or cudaErrorInvalidValue when
// the operand counts or a row count exceed what the kernel holds.
extern "C" int constrained_solve_launch(
    const void* const* ptrs, int n_ptrs, const int* dims, int n_dims,
    void* stream) {
  if (n_ptrs != kNumPtrs || n_dims != kNumDims) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Ptrs p;
  Dims d;
  memcpy(&p, ptrs, sizeof(Ptrs));
  memcpy(&d, dims, sizeof(Dims));
  if (d.c_sp > kMaxSlots || d.c_aff > kMaxSlots || d.c_anti > kMaxSlots ||
      d.c_soft > kMaxSlots || d.ra > kMaxAffRows || d.rt > kMaxAffRows ||
      d.re > kMaxExistRows || d.rp > kMaxIpaRows || d.z > kMaxZones ||
      d.z < 1 || d.s < 1 || d.u < 1 ||
      (d.k < 1 && d.ra + d.rt + d.re > 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constrained_solve_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p, d);
  return static_cast<int>(cudaGetLastError());
}
