// Preemption victim search for Hopper (sm_90a): a whole wave in ONE launch
// of ONE thread-block cluster.
//
// Replaces: kubernetes_tpu/ops/pallas_preempt.py::_preempt_kernel (entry
// pallas_preempt_solve), and computes the function of the JAX package's
// XLA wave kernel kubernetes_tpu/ops/preemption.py::_preempt_batch_kernel
// with _device_pick -- PDB budgets and pre-existing nominations included,
// which the TPU kernel left to the XLA kernel. Its plain PyTorch version is
// kubernetes_tpu_torch/ops/preemption.py::preempt_batch_plain, and the
// wrapper is kubernetes_tpu_torch/ops/preempt_kernel.py.
//
// What it computes, for each pod t of the wave in order (priority desc):
//   removal   state0 = carry + every pre-existing nomination at the node
//             whose priority is >= the pod's (addNominatedPods) - every
//             active victim of lower priority;
//   fit       the _fits rule on alloc - state0 (the pods dim always; fixed
//             dims strictly; scalar dims only when requested; a pod whose
//             other requests are all zero checks only the pods dim), AND
//             the pod's candidate row;
//   PDBs      the sorted victims spend the node's budgets, fresh for every
//             pod (filterPodsWithPDBViolation): a victim whose matching
//             budget is spent is violating and spends no later budget;
//   reprieve  violating victims first, then the rest, in MoreImportantPod
//             order: each is re-added and kept while the pod still fits;
//   pick      pickOneNodeForPreemption as ONE cluster-wide argmin over a
//             composite key per feasible node: a node that needs no victim
//             has (0, index); every other node has
//             (1, violations, first victim's priority, sum of
//             (prio + 2^31) as uint64, victims, -earliest start, index),
//             where the first victim is the first violating one if any and
//             the earliest start is taken among the highest-priority
//             victims (f32). Taking the minimum of that tuple IS the
//             reference's lexicographic narrowing: each of the six rules
//             keeps the nodes that tie on every earlier rule, and the
//             lowest index wins the final tie. The priority sum is exact
//             (48 bits at most);
//   carry     the chosen node's state += the pod's request, so later pods
//             see the nomination. An inactive pod, or one with no feasible
//             node, gets -1 and changes nothing.
//
// Design. One cluster of C CTAs (C <= 16, ops/cluster_plan.plan_launch)
// of 512 threads, CTA k owning the contiguous nodes [k * N / C, (k + 1) *
// N / C), thread i of a CTA the nodes lo + i, lo + i + 512, ... Each CTA
// keeps its slice in one field-major layout, [field][slice] words: alloc,
// the carry, the class's nomination addend, the victims' priorities,
// starts, requests and active bits, the PDB match bits and budgets, the
// victim / violating / PDB-violating masks, the candidate bit and the
// pick key.
//   resident  (the shape gate, a template flag): the layout lives in
//             shared memory for the whole launch (~490 bytes a node at
//             V = 16, R = 4: 313 nodes in ~150 KB);
//   streaming (above it, e.g. V = 48, R = 6): the same layout in a
//             device-memory scratch region per CTA (L2), the same code.
//             Shared memory then holds only the fixed words, so a node
//             of any size streams: at V = 12,000, R = 4 one node's
//             layout (~294 KB) is larger than a CTA's shared memory.
// The pick key is packed into six words whose lexicographic unsigned
// order is the composite key's (tier, violations, first victim's
// priority, priority sum, victims, latest earliest start, index): taking
// its minimum is the reference's lexicographic narrowing in any slicing,
// and a warp's minimum is six redux.sync.
// A node's key is built by ONE warp (warp_build_key): lane i takes victim
// i of each chunk of 32 (eligibility as a ballot, the removal sum as warp
// sums, the statistics from the mask words and two warp reductions); lane
// d holds dims d and d + 32 of the node's alloc, working state and the
// pod's request in registers, so a fit test is one vote; the PDB spending
// (lanes over PDBs) and the two reprieve passes walk the eligible
// victims' set bits in MoreImportantPod order, one victim at a time.
// R <= 64, V < 2^16.
// Per (priority, request) group: the CTA folds the nominations at or
// above the priority into each node's addend in one pass over the M
// nominations (shared atomics), then its warps build its nodes' keys.
// Per candidate row: each thread's minimum over its nodes (a node off the
// row is infeasible), each warp's, each CTA's, and every CTA's minimum
// to every CTA (distributed shared memory) behind one cluster barrier;
// lane k of every warp keeps CTA k's minimum in registers. Per pod: every
// warp takes the minimum of its lanes' C minima -- the pick. The chosen
// node's owner CTA writes the outputs, adds the pod's request to the
// carry and rebuilds that node's key with the warp that holds the owner
// thread; only the owner thread rescans its nodes, and that warp folds
// the CTA's warp minima and stores the CTA's new minimum into every CTA;
// the next pod's one cluster barrier publishes it (slots alternate by
// parity). Only the chosen node's state changed, so this equals a full
// rebuild. The pods' priorities, candidate rows and flags are staged 32 at
// a time; an inactive pod is a skip that every CTA takes alike. N, V, R,
// P, M, U and B are all run-time arguments: one build serves every wave.
//
// What bounds it on this card: neither bytes nor operations. The inputs
// are read once in principle (~4 MB at 5,000 nodes x 16 victims x R=4)
// and a class build is ~V x R operations per node, but each pod depends
// on the previous pod's carry, so the wave is a chain of B dependent
// steps: the chosen node's rebuild, whose reprieve passes are sequential
// in the victims, one cluster barrier and two warp minima.

#include <limits.h>

#include "solve_common.cuh"

namespace {

using namespace solve;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kDimSlots = 2;  // dims per lane in a node build
constexpr int kMaxDims = 32 * kDimSlots;

// One node's pick key, packed into six words whose lexicographic unsigned
// order IS the composite order (tier, violations, first victim's
// priority, priority sum, victims, latest earliest start, index): tier 0
// = feasible with no victims, 1 = feasible with victims, 2 = infeasible,
// 3 = no node. V < 2^16 keeps the counts in 16 bits and the priority sum
// (V x (prio + 2^31)) in 48.
constexpr int kKeyWords = 6;
struct Key {
  unsigned w[kKeyWords];
};

__device__ __forceinline__ Key pack_key(int tier, int nviol, int fprio,
                                        unsigned long long psum, int vcount,
                                        float earliest, int index) {
  Key k;
  k.w[0] = static_cast<unsigned>(tier) << 30 | static_cast<unsigned>(nviol);
  k.w[1] = static_cast<unsigned>(fprio) ^ 0x80000000u;
  k.w[2] = static_cast<unsigned>(psum >> 16);
  k.w[3] = static_cast<unsigned>(psum & 0xffffull) << 16 |
           static_cast<unsigned>(vcount);
  k.w[4] = ~ordered_bits(earliest);  // the latest start sorts first
  k.w[5] = static_cast<unsigned>(index);
  return k;
}

__device__ __forceinline__ Key no_key() {  // after every node's key
  Key k;
#pragma unroll
  for (int e = 0; e < kKeyWords; ++e) k.w[e] = 0xffffffffu;
  return k;
}

__device__ __forceinline__ Key infeasible_key(int index) {
  return pack_key(2, 0, 0, 0ull, 0, 0.0f, index);
}

__device__ __forceinline__ bool key_less(const Key& a, const Key& b) {
#pragma unroll
  for (int e = 0; e < kKeyWords; ++e) {
    if (a.w[e] != b.w[e]) return a.w[e] < b.w[e];
  }
  return false;
}

__device__ __forceinline__ int key_index(const Key& k) {
  return static_cast<int>(k.w[kKeyWords - 1]);
}

__device__ __forceinline__ int key_tier(const Key& k) {
  return static_cast<int>(k.w[0] >> 30);
}

// the warp's minimum key, to every lane: one redux.sync per word among the
// lanes that still tie. Call from all 32 lanes.
__device__ __forceinline__ Key warp_min_key(const Key& k) {
  Key out;
  bool tied = true;
#pragma unroll
  for (int e = 0; e < kKeyWords; ++e) {
    out.w[e] = __reduce_min_sync(kFull, tied ? k.w[e] : 0xffffffffu);
    tied = tied && k.w[e] == out.w[e];
  }
  return out;
}

// int32 words of one node in a CTA's layout (ops/preempt_kernel.py
// node_words)
__host__ __device__ __forceinline__ int node_words(int r, int v, int p) {
  const int w = (v + 31) / 32;
  const int pw = (v * p + 31) / 32;
  return 3 * r + 2 * v + r * v + w + pw + p + 3 * w + 1 + kKeyWords;
}

// a CTA's layout: word e of field f of node l at base[(f + e) * s + l];
// s, the slice's capacity rounded up to odd, spreads a warp's reads of
// one node's consecutive words over the banks
struct Layout {
  int* base;
  int s;
  int r, v, p, w;
  int alloc, state, nom;  // [R] each
  int vprio, vstart;      // [V] each (vstart: float bits)
  int vreq;               // [R][V]
  int vact;               // [W] active bits
  int pdb;                // [ceil(V * P / 32)] match bits, i * P + k
  int bud;                // [P] scratch
  int vic, vio, pdbv;     // [W] each: victims, violating, PDB-violating
  int cand;               // the class's candidate bit
  int key;                // [8] the pick key

  __device__ __forceinline__ int& at(int f, int l) const {
    return base[static_cast<size_t>(f) * s + l];
  }
  __device__ __forceinline__ bool bit(int f, int i, int l) const {
    return (static_cast<unsigned>(at(f + (i >> 5), l)) >> (i & 31)) & 1u;
  }
};

__device__ __forceinline__ Layout make_layout(int* base, int s, int r, int v,
                                              int p) {
  Layout L;
  L.base = base;
  L.s = s;
  L.r = r;
  L.v = v;
  L.p = p;
  L.w = (v + 31) / 32;
  L.alloc = 0;
  L.state = r;
  L.nom = 2 * r;
  L.vprio = 3 * r;
  L.vstart = L.vprio + v;
  L.vreq = L.vstart + v;
  L.vact = L.vreq + r * v;
  L.pdb = L.vact + L.w;
  L.bud = L.pdb + (v * p + 31) / 32;
  L.vic = L.bud + p;
  L.vio = L.vic + L.w;
  L.pdbv = L.vio + L.w;
  L.cand = L.pdbv + L.w;
  L.key = L.cand + 1;
  return L;
}

__device__ __forceinline__ Key load_key(const Layout& L, int l) {
  Key k;
#pragma unroll
  for (int e = 0; e < kKeyWords; ++e) k.w[e] = static_cast<unsigned>(L.at(L.key + e, l));
  return k;
}

__device__ __forceinline__ void store_key(const Layout& L, int l, const Key& k) {
#pragma unroll
  for (int e = 0; e < kKeyWords; ++e) L.at(L.key + e, l) = static_cast<int>(k.w[e]);
}

// node l's key under the class's candidate row: a node off the row is
// infeasible
__device__ __forceinline__ Key gated_key(const Layout& L, int l) {
  const Key k = load_key(L, l);
  return L.at(L.cand, l) ? k : infeasible_key(key_index(k));
}

// the minimum of this thread's nodes' gated keys
__device__ __forceinline__ Key thread_min(const Layout& L, int len) {
  Key mine = no_key();
  for (int l = threadIdx.x; l < len; l += blockDim.x) {
    const Key k = gated_key(L, l);
    if (key_less(k, mine)) mine = k;
  }
  return mine;
}

// the victims of chunk c (32 victim slots) of node l that are active and
// of lower priority than the pod: one word, the same in every lane
__device__ __forceinline__ unsigned eligible_mask(const Layout& L, int l,
                                                  int c, int pprio) {
  const int i = c * 32 + (threadIdx.x & 31);
  const bool lower = i < L.v && L.at(L.vprio + i, l) < pprio;
  return static_cast<unsigned>(L.at(L.vact + c, l)) & __ballot_sync(kFull, lower);
}

// the _fits rule for the working state plus x (per dim slot): the pods dim
// always; fixed dims strictly; scalar dims only when requested; an
// all-zero pod checks only the pods dim. One vote of the warp.
__device__ __forceinline__ bool warp_fits(const int* a, const int* q,
                                          const int* need, int r,
                                          bool all_zero) {
  const int lane = threadIdx.x & 31;
  bool ok_lane = true;
#pragma unroll
  for (int k = 0; k < kDimSlots; ++k) {
    const int d = lane + 32 * k;
    if (d >= r || (all_zero && d != kPodsCol)) continue;
    bool ok = q[k] <= sub_wrap(a[k], need[k]);
    if (d >= kNumFixedDims && q[k] == 0) ok = true;
    ok_lane = ok_lane && ok;
  }
  return __all_sync(kFull, ok_lane) != 0;
}

// selectVictimsOnNode for node l (global index j) and the class (priority
// pprio, request preq), then node l's victim masks and pick key as if the
// node were a candidate (gated_key applies the candidate row). Reads the
// carry and the class's nomination addend; writes only node l's masks,
// budgets and key. Call from all 32 lanes of one warp.
__device__ void warp_build_key(const Layout& L, int l, int j, const int* preq,
                               const int* pdb_allowed, int pprio,
                               bool all_zero) {
  const int lane = threadIdx.x & 31;
  const int r = L.r;
  const int v = L.v;
  const int p = L.p;
  const int w = L.w;
  // lane d: dims d and d + 32 of alloc, the working state and the request
  int a[kDimSlots], work[kDimSlots], q[kDimSlots];
#pragma unroll
  for (int k = 0; k < kDimSlots; ++k) {
    const int d = lane + 32 * k;
    const bool on = d < r;
    a[k] = on ? L.at(L.alloc + d, l) : 0;
    work[k] = on ? add_wrap(L.at(L.state + d, l), L.at(L.nom + d, l)) : 0;
    q[k] = on ? preq[d] : 0;
  }
  // removal: every eligible victim leaves the working state
  for (int c = 0; c < w; ++c) {
    const int i = c * 32 + lane;
    const bool elig = (eligible_mask(L, l, c, pprio) >> lane) & 1u;
    for (int d = 0; d < r; ++d) {
      const int x = elig ? L.at(L.vreq + d * v + i, l) : 0;
      const int sum = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(x)));
#pragma unroll
      for (int k = 0; k < kDimSlots; ++k) {
        if (d == lane + 32 * k) work[k] = sub_wrap(work[k], sum);
      }
    }
  }
  const bool feasible = warp_fits(a, q, work, r, all_zero);

  // PDBs: the sorted victims spend fresh budgets; a victim that matches a
  // spent budget is violating and spends no later one
  if (p > 0) {
    for (int k = lane; k < p; k += 32) L.at(L.bud + k, l) = pdb_allowed[k];
    __syncwarp();
    for (int c = 0; c < w; ++c) {
      unsigned e = eligible_mask(L, l, c, pprio);
      unsigned viol = 0u;
      while (e) {
        const int b = __ffs(e) - 1;
        e &= e - 1;
        const int i = c * 32 + b;
        int first = p;  // the first matching PDB with no budget left
        for (int k0 = 0; k0 < p; k0 += 32) {
          const int k = k0 + lane;
          const bool spent =
              k < p && L.bit(L.pdb, i * p + k, l) && L.at(L.bud + k, l) <= 0;
          const unsigned sb = __ballot_sync(kFull, spent);
          if (sb) {
            first = k0 + __ffs(sb) - 1;
            break;
          }
        }
        for (int k = lane; k < first; k += 32) {
          if (L.bit(L.pdb, i * p + k, l)) L.at(L.bud + k, l) -= 1;
        }
        __syncwarp();
        if (first < p) viol |= 1u << b;
      }
      if (lane == 0) L.at(L.pdbv + c, l) = static_cast<int>(viol);
    }
    __syncwarp();
  }

  // reprieve: the PDB-violating victims first, then the rest, one at a
  // time in MoreImportantPod order; a victim is kept while the pod fits
  for (int pass = 0; pass < 2; ++pass) {
    for (int c = 0; c < w; ++c) {
      const unsigned pv = p > 0 ? static_cast<unsigned>(L.at(L.pdbv + c, l)) : 0u;
      unsigned sel = eligible_mask(L, l, c, pprio) & (pass == 0 ? pv : ~pv);
      unsigned vic = pass == 0 ? 0u : static_cast<unsigned>(L.at(L.vic + c, l));
      unsigned vio = 0u;
      while (sel) {
        const int b = __ffs(sel) - 1;
        sel &= sel - 1;
        const int i = c * 32 + b;
        int need[kDimSlots];
#pragma unroll
        for (int k = 0; k < kDimSlots; ++k) {
          const int d = lane + 32 * k;
          need[k] = add_wrap(work[k], d < r ? L.at(L.vreq + d * v + i, l) : 0);
        }
        if (warp_fits(a, q, need, r, all_zero)) {
#pragma unroll
          for (int k = 0; k < kDimSlots; ++k) work[k] = need[k];
        } else {
          vic |= 1u << b;
          vio |= 1u << b;
        }
      }
      __syncwarp();
      if (lane == 0) {
        L.at(L.vic + c, l) = static_cast<int>(vic);
        if (pass == 0) L.at(L.vio + c, l) = static_cast<int>(vio);
      }
    }
    __syncwarp();
  }

  Key key = infeasible_key(j);
  if (feasible) {
    int vcount = 0, nviol = 0;
    int first_any = kNoIndex, first_viol = kNoIndex;
    unsigned long long psum = 0ull;
    bool has = false;
    int maxp = INT_MIN;
    float earliest = INFINITY;
    for (int c = 0; c < w; ++c) {
      const unsigned vc = static_cast<unsigned>(L.at(L.vic + c, l));
      const unsigned oc = static_cast<unsigned>(L.at(L.vio + c, l));
      vcount += __popc(vc);
      nviol += __popc(oc);
      if (vc && first_any == kNoIndex) first_any = c * 32 + __ffs(vc) - 1;
      if (oc && first_viol == kNoIndex) first_viol = c * 32 + __ffs(oc) - 1;
      if ((vc >> lane) & 1u) {  // lane i: victim i of the chunk
        const int i = c * 32 + lane;
        const int vp = L.at(L.vprio + i, l);
        const float vs = __int_as_float(L.at(L.vstart + i, l));
        if (!has || vp > maxp) {
          maxp = vp;
          earliest = vs;
        } else if (vp == maxp && vs < earliest) {
          earliest = vs;
        }
        has = true;
        psum += static_cast<unsigned>(vp) ^ 0x80000000u;
      }
    }
    // the highest priority, then the earliest start among its victims
    const int top = __reduce_max_sync(kFull, has ? maxp : INT_MIN);
    earliest = has && maxp == top ? earliest : INFINITY;
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(kFull, earliest, off);
      if (o < earliest) earliest = o;
      psum += __shfl_xor_sync(kFull, psum, off);
    }
    key = vcount == 0
        ? pack_key(0, 0, 0, 0ull, 0, 0.0f, j)
        : pack_key(1, nviol,
                   L.at(L.vprio + (first_viol != kNoIndex ? first_viol : first_any), l),
                   psum, vcount, earliest, j);
  }
  if (lane == 0) store_key(L, l, key);
}

struct Wave {
  const int* alloc;          // [N, R]
  const int* state_in;       // [N, R]
  const int* vprio;          // [N, V] clipped below INT32_MAX
  const float* vstart;       // [N, V]
  const int* vreq;           // [N, V, R]
  const uint8_t* vactive;    // [N, V]
  const uint8_t* pdb_match;  // [N, V, P]
  const int* pdb_allowed;    // [P]
  const int* nom_req;        // [M, R]
  const int* nom_prio;       // [M]
  const int* nom_node;       // [M]
  const int* pod_req;        // [B, R]
  const int* pod_prio;       // [B]
  const uint8_t* cand_rows;  // [U, N]
  const int* cand_index;     // [B]
  const uint8_t* pod_active; // [B]
  int* chosen;               // [B]    out
  unsigned* vic_out;         // [B, W] out
  unsigned* viol_out;        // [B, W] out
  int* nviol_out;            // [B]    out
  int* state_out;            // [N, R] out
  int* scratch;              // streaming: C layouts in device memory
  int n, v, r, p, m, b, u;
};

__device__ __forceinline__ int clamp_row(int i, int u) {
  return i < 0 ? 0 : (i >= u ? u - 1 : i);  // gathers clamp, as in JAX
}

// dynamic shared memory: the class's request [R] and a chunk's pod flags,
// priorities and candidate rows [3][kChunk], then (resident) the CTA's
// layout (ops/preempt_kernel.py plan_for)
__host__ __device__ __forceinline__ int fixed_words(int r) {
  return r + 3 * kChunk;
}

size_t dynamic_smem_bytes(int n, int r, int v, int p, int cluster,
                          bool resident) {
  const size_t s = ((n + cluster - 1) / cluster) | 1;
  size_t ints = fixed_words(r);
  if (resident) ints += s * node_words(r, v, p);
  return ints * sizeof(int);
}

// the outputs of a pod that places nowhere (rank 0 writes them)
__device__ __forceinline__ void no_placement(const Wave& a, int t, int w) {
  for (int k = threadIdx.x; k < w; k += blockDim.x) {
    a.vic_out[static_cast<size_t>(t) * w + k] = 0u;
    a.viol_out[static_cast<size_t>(t) * w + k] = 0u;
  }
  if (threadIdx.x == 0) {
    a.chosen[t] = -1;
    a.nviol_out[t] = 0;
  }
}

template <bool kResident>
__global__ void __launch_bounds__(kClusterThreads, 1) preempt_cluster_kernel(Wave a) {
  extern __shared__ int s_dyn[];
  // every CTA's minimum after a full exchange, and the one CTA minimum
  // that changed since the last exchange, each alternating by parity
  __shared__ Key s_all[2][kMaxCluster];
  __shared__ Key s_upd[2];
  __shared__ Key s_wmin[kClusterWarps];  // each warp's minimum
  const int cluster =
      static_cast<int>(cooperative_groups::this_cluster().num_blocks());
  const int rank =
      static_cast<int>(cooperative_groups::this_cluster().block_rank());
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = nt >> 5;
  const int n = a.n;
  const int r = a.r;
  const int v = a.v;
  const int p = a.p;
  const int w = (v + 31) / 32;
  const int lo = slice_lo(rank, cluster, n);
  const int hi = slice_lo(rank + 1, cluster, n);
  const int len = hi - lo;
  const int s = ((n + cluster - 1) / cluster) | 1;
  int* s_preq = s_dyn;               // [R] the class's request
  int* s_pflags = s_preq + r;        // [kChunk] see kActive .. kNewRow
  int* s_pprio = s_pflags + kChunk;  // [kChunk]
  int* s_pci = s_pprio + kChunk;     // [kChunk] clamped candidate row
  constexpr int kActive = 1, kNewGroup = 2, kNewRow = 4;
  const Layout L = make_layout(
      kResident ? s_dyn + fixed_words(r)
                : a.scratch + static_cast<size_t>(rank) * s * node_words(r, v, p),
      s, r, v, p);

  for (int l = tid; l < len; l += nt) {
    const size_t j = static_cast<size_t>(lo + l);
    for (int d = 0; d < r; ++d) {
      L.at(L.alloc + d, l) = a.alloc[j * r + d];
      L.at(L.state + d, l) = a.state_in[j * r + d];
    }
    for (int i = 0; i < v; ++i) {
      L.at(L.vprio + i, l) = a.vprio[j * v + i];
      L.at(L.vstart + i, l) = __float_as_int(a.vstart[j * v + i]);
      for (int d = 0; d < r; ++d) {
        L.at(L.vreq + d * v + i, l) = a.vreq[(j * v + i) * r + d];
      }
    }
    for (int c = 0; c < w; ++c) {
      unsigned bits = 0u;
      for (int i = c * 32; i < min(v, c * 32 + 32); ++i) {
        if (a.vactive[j * v + i]) bits |= 1u << (i & 31);
      }
      L.at(L.vact + c, l) = static_cast<int>(bits);
    }
    for (int c = 0; c < (v * p + 31) / 32; ++c) {
      unsigned bits = 0u;
      for (int i = c * 32; i < min(v * p, c * 32 + 32); ++i) {
        if (a.pdb_match[j * v * p + i]) bits |= 1u << (i & 31);
      }
      L.at(L.pdb + c, l) = static_cast<int>(bits);
    }
  }
  // every CTA of the cluster is running before any store into its slots
  cluster_barrier();

  Key mine = no_key();  // the minimum of this thread's nodes' keys
  // lane k of every warp holds CTA k's minimum
  Key cmin = no_key();
  int pending = -1;  // the CTA whose minimum changed since the last exchange
  int group = -1;    // (priority, request) groups and candidate rows seen
  int row = -1;
  int built = -1;    // the group the keys hold
  int gated = -1;    // the row the minima hold
  int phase = 0;     // cluster barriers passed since the loads
  STEP_START();
  for (int t0 = 0; t0 < a.b; t0 += kChunk) {
    const int steps = min(kChunk, a.b - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < steps; i += nt) {
      const int t = t0 + i;
      const int ci = clamp_row(a.cand_index[t], a.u);
      bool new_group = t == 0;
      bool new_row = t == 0;
      if (t > 0) {
        new_group = a.pod_prio[t - 1] != a.pod_prio[t];
        const int* now = a.pod_req + static_cast<size_t>(t) * r;
        for (int d = 0; d < r && !new_group; ++d) new_group = now[d - r] != now[d];
        new_row = clamp_row(a.cand_index[t - 1], a.u) != ci;
      }
      s_pflags[i] = (a.pod_active[t] ? kActive : 0) |
                    (new_group ? kNewGroup : 0) | (new_row ? kNewRow : 0);
      s_pprio[i] = a.pod_prio[t];
      s_pci[i] = ci;
    }
    __syncthreads();

    for (int i = 0; i < steps; ++i) {
      const int t = t0 + i;
      const int flags = s_pflags[i];
      group += (flags & kNewGroup) ? 1 : 0;
      row += (flags & (kNewGroup | kNewRow)) ? 1 : 0;
      if (!(flags & kActive)) {  // inactive: every CTA skips alike
        if (rank == 0) no_placement(a, t, w);
        continue;
      }
      const int pprio = s_pprio[i];
      if (group != built) {
        // a new (priority, request): fold the nominations, then every
        // node's key, one warp per node
        __syncthreads();  // the last group's readers are done
        const int* preq = a.pod_req + static_cast<size_t>(t) * r;
        for (int d = tid; d < r; d += nt) s_preq[d] = preq[d];
        for (int l = tid; l < len; l += nt) {
          for (int d = 0; d < r; ++d) L.at(L.nom + d, l) = 0;
        }
        __syncthreads();
        for (int k = tid; k < a.m; k += nt) {
          const int node = a.nom_node[k];
          if (node < lo || node >= hi || a.nom_prio[k] < pprio) continue;
          for (int d = 0; d < r; ++d) {
            atomicAdd(&L.at(L.nom + d, node - lo),
                      a.nom_req[static_cast<size_t>(k) * r + d]);
          }
        }
        __syncthreads();
        const bool all_zero = pod_all_zero(s_preq, r);
        for (int l = warp; l < len; l += warps) {
          warp_build_key(L, l, lo + l, s_preq, a.pdb_allowed, pprio, all_zero);
        }
        built = group;
        gated = -1;
      }
      if (row != gated) {
        // a new candidate row: every thread's, warp's and CTA's minimum,
        // then every CTA's to every CTA
        __syncthreads();  // the keys are built, the last minima are read
        const uint8_t* cand = a.cand_rows + static_cast<size_t>(s_pci[i]) * n;
        for (int l = tid; l < len; l += nt) L.at(L.cand, l) = cand[lo + l] != 0;
        mine = thread_min(L, len);
        const Key wmin = warp_min_key(mine);
        if (lane == 0) s_wmin[warp] = wmin;
        __syncthreads();
        if (warp == 0) {
          const Key cta = warp_min_key(lane < warps ? s_wmin[lane] : no_key());
          if (lane < cluster) {
            cooperative_groups::this_cluster().map_shared_rank(
                s_all[phase & 1], lane)[rank] = cta;
          }
        }
        cluster_barrier();
        cmin = lane < cluster ? s_all[phase & 1][lane] : no_key();
        ++phase;
        pending = -1;
        gated = row;
      } else if (pending >= 0) {
        // the CTA that placed the last pod stored its new minimum
        cluster_barrier();
        if (lane == pending) cmin = s_upd[phase & 1];
        ++phase;
        pending = -1;
      }
      STEP_MARK(0);  // the pod's parameters, a class build, the exchange
      const Key best = warp_min_key(cmin);
      STEP_MARK(1);  // the pick

      if (key_tier(best) > 1) {  // nothing feasible: no placement, no carry
        if (rank == 0) no_placement(a, t, w);
        continue;
      }
      const int c = key_index(best);
      // the CTA that owns c: the largest k with slice_lo(k) <= c
      pending = static_cast<int>(
          ((static_cast<long long>(c) + 1) * cluster + n - 1) / n - 1);
      const int l = c - lo;
      const int owner = l % nt;
      if (rank == pending && warp == owner >> 5) {
        STEP_TIME(rebuild_t);
        // the owner's warp: the outputs from c's masks, the nomination into
        // the carry, then c's key -- the only one that changed -- and the
        // CTA's new minimum into every CTA
        int nv = 0;
        for (int k = lane; k < w; k += 32) {
          const int vk = L.at(L.vic + k, l);
          const int ok = L.at(L.vio + k, l);
          a.vic_out[static_cast<size_t>(t) * w + k] = static_cast<unsigned>(vk);
          a.viol_out[static_cast<size_t>(t) * w + k] = static_cast<unsigned>(ok);
          nv += __popc(static_cast<unsigned>(ok));
        }
        nv = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(nv)));
        if (lane == 0) {
          a.chosen[t] = c;
          a.nviol_out[t] = nv;
        }
        for (int d = lane; d < r; d += 32) {
          L.at(L.state + d, l) = add_wrap(L.at(L.state + d, l), s_preq[d]);
        }
        __syncwarp();
        warp_build_key(L, l, c, s_preq, a.pdb_allowed, pprio,
                       pod_all_zero(s_preq, r));
        __syncwarp();
        if (tid == owner) mine = thread_min(L, len);  // only the owner rescans
        const Key wmin = warp_min_key(mine);
        if (lane == 0) s_wmin[warp] = wmin;
        __syncwarp();
        const Key cta = warp_min_key(lane < warps ? s_wmin[lane] : no_key());
        if (lane < cluster) {
          cooperative_groups::this_cluster().map_shared_rank(
              &s_upd[phase & 1], lane)[0] = cta;
        }
        if (lane == 0) STEP_ADD(3, rebuild_t);  // the owner warp's rebuild
      }
      STEP_MARK(2);  // thread 0's share of a rebuild
    }
  }

  __syncthreads();  // the last rebuild's carry is written
  for (int l = tid; l < len; l += nt) {
    const size_t j = static_cast<size_t>(lo + l);
    for (int d = 0; d < r; ++d) a.state_out[j * r + d] = L.at(L.state + d, l);
  }
  // no CTA leaves while another may still store into its shared memory
  cluster_barrier();
}

}  // namespace

#ifdef SOLVE_STEP_PROFILE
extern "C" int preempt_solve_step_cycles(unsigned long long* out) {
  return solve::read_step_cycles(out);
}
#endif

// static shared memory of one CTA of the kernel (the slots), or -1
extern "C" int preempt_solve_static_smem(int resident) {
  return resident ? static_smem_bytes(preempt_cluster_kernel<true>)
                  : static_smem_bytes(preempt_cluster_kernel<false>);
}

// how many clusters of this shape the card can hold at once (0: none)
extern "C" int preempt_solve_max_clusters(int cluster, int threads, int smem,
                                          int resident) {
  if (!valid_cluster_shape(cluster, threads)) return 0;
  return resident
      ? cluster_occupancy(preempt_cluster_kernel<true>, cluster, threads, smem)
      : cluster_occupancy(preempt_cluster_kernel<false>, cluster, threads, smem);
}

// int32 words of one node in a CTA's layout and of a CTA's fixed part
// (the wrapper sizes the plan and the streaming scratch with them)
extern "C" int preempt_solve_node_words(int r, int v, int p) {
  return node_words(r, v, p);
}

extern "C" int preempt_solve_fixed_words(int r) { return fixed_words(r); }

// Launches one cluster of `cluster` CTAs of `threads` threads with `smem`
// bytes of dynamic shared memory each (ops/cluster_plan.plan_launch);
// `scratch` holds the streaming side's layouts (cluster x slice stride x
// node_words ints; unused when resident). Returns the launch's
// cudaError_t, or cudaErrorInvalidValue when the shapes or the plan do not
// match what the kernel needs (R <= 64).
extern "C" int preempt_solve_launch(
    const void* alloc, const void* state_in, const void* vprio,
    const void* vstart, const void* vreq, const void* vactive,
    const void* pdb_match, const void* pdb_allowed, const void* nom_req,
    const void* nom_prio, const void* nom_node, const void* pod_req,
    const void* pod_prio, const void* cand_rows, const void* cand_index,
    const void* pod_active,
    void* chosen, void* vic_out, void* viol_out, void* nviol_out,
    void* state_out, void* scratch,
    int n, int v, int r, int p, int m, int b, int u,
    int cluster, int threads, int resident, int smem, void* stream) {
  if (!valid_cluster_shape(cluster, threads) || n < 1 || cluster > n ||
      r < 1 || r > kMaxDims || v < 0 || v >= (1 << 16) || p < 0 || m < 0 ||
      u < 1 ||
      (!resident && scratch == nullptr) ||
      static_cast<size_t>(smem) < dynamic_smem_bytes(n, r, v, p, cluster, resident)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Wave a;
  a.alloc = static_cast<const int*>(alloc);
  a.state_in = static_cast<const int*>(state_in);
  a.vprio = static_cast<const int*>(vprio);
  a.vstart = static_cast<const float*>(vstart);
  a.vreq = static_cast<const int*>(vreq);
  a.vactive = static_cast<const uint8_t*>(vactive);
  a.pdb_match = static_cast<const uint8_t*>(pdb_match);
  a.pdb_allowed = static_cast<const int*>(pdb_allowed);
  a.nom_req = static_cast<const int*>(nom_req);
  a.nom_prio = static_cast<const int*>(nom_prio);
  a.nom_node = static_cast<const int*>(nom_node);
  a.pod_req = static_cast<const int*>(pod_req);
  a.pod_prio = static_cast<const int*>(pod_prio);
  a.cand_rows = static_cast<const uint8_t*>(cand_rows);
  a.cand_index = static_cast<const int*>(cand_index);
  a.pod_active = static_cast<const uint8_t*>(pod_active);
  a.chosen = static_cast<int*>(chosen);
  a.vic_out = static_cast<unsigned*>(vic_out);
  a.viol_out = static_cast<unsigned*>(viol_out);
  a.nviol_out = static_cast<int*>(nviol_out);
  a.state_out = static_cast<int*>(state_out);
  a.scratch = static_cast<int*>(scratch);
  a.n = n;
  a.v = v;
  a.r = r;
  a.p = p;
  a.m = m;
  a.b = b;
  a.u = u;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return resident
      ? launch_cluster(preempt_cluster_kernel<true>, cluster, threads, smem, st, a)
      : launch_cluster(preempt_cluster_kernel<false>, cluster, threads, smem, st, a);
}
