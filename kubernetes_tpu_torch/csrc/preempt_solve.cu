// Preemption victim search for Hopper (sm_90a): a whole wave in ONE launch.
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
//   pick      pickOneNodeForPreemption as ONE block-wide argmin over a
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
// Design, keeping the two ideas of the TPU kernel: per CLASS of pods (same
// priority, request row and candidate row as the previous pod) every node's
// key is built once -- node_keys(), thread k owning nodes k, k+1024, ...;
// after each placement only the CHOSEN node's state changed, so only its
// key is rebuilt (by thread 0, with the same node_keys()), which equals a
// full rebuild. Per pod: each thread takes the minimum of its nodes' keys,
// block_min (solve_common.cuh) reduces them, thread 0 writes the result and
// the carry. Each node's key, working state, budgets and masks live in
// device memory (L2-resident at 5,000 nodes), so N, V, R, P, M, U and B are
// all run-time arguments: one build serves every wave.
//
// What bounds it on this card: neither bytes nor operations. The inputs are
// read once in principle (~4 MB at 5,000 nodes x 16 victims x R=4) and a
// class rebuild is ~V x R operations per node, but each pod depends on the
// previous pod's carry, so the wave is a chain of B dependent block-wide
// steps on ONE SM, each a pass over N keys, a two-level reduction, and a
// single-thread key rebuild whose loads are serial. The simple design
// leaves on the table: the other 131 SMs, keeping each thread's best key
// in registers so that only the chosen node's owner rescans, and spreading
// the rebuild of the chosen node over a warp.

#include "solve_common.cuh"

namespace {

using namespace solve;

// One node's pick key; tier 0 = feasible with no victims, 1 = feasible
// with victims, 2 = infeasible, 3 = no node (an idle thread).
struct PickKey {
  int tier;
  int nviol;
  int fprio;
  int vcount;
  unsigned long long psum;
  float earliest;
  int index;
};
static_assert(sizeof(PickKey) == 32, "PickKey is 8 int32 words (wrapper)");

struct KeyLess {
  __device__ __forceinline__ bool operator()(const PickKey& a,
                                             const PickKey& b) const {
    if (a.tier != b.tier) return a.tier < b.tier;
    if (a.nviol != b.nviol) return a.nviol < b.nviol;
    if (a.fprio != b.fprio) return a.fprio < b.fprio;
    if (a.psum != b.psum) return a.psum < b.psum;
    if (a.vcount != b.vcount) return a.vcount < b.vcount;
    if (a.earliest != b.earliest) return a.earliest > b.earliest;  // latest
    return a.index < b.index;
  }
};

struct Wave {
  const int* alloc;          // [N, R]
  const int* vprio;          // [N, V] clipped below INT32_MAX
  const float* vstart;       // [N, V]
  const int* vreq;           // [N, V, R]
  const uint8_t* vactive;    // [N, V]
  const uint8_t* pdb_match;  // [N, V, P]
  const int* pdb_allowed;    // [P]
  const int* nom_req;        // [M, R]
  const int* nom_prio;       // [M]
  const int* nom_node;       // [M]
  int* state;                // [N, R] the carry (state' out)
  int* work;                 // [N, R] scratch: a node's working state
  int* budgets;              // [N, P] scratch
  unsigned* masks;           // [N, 3W] scratch: victims | violating | PDB
  PickKey* keys;             // [N]
  int n, v, r, p, m, w;
};

__device__ __forceinline__ bool bit(const unsigned* words, int i) {
  return (words[i >> 5] >> (i & 31)) & 1u;
}

__device__ __forceinline__ void set_bit(unsigned* words, int i) {
  words[i >> 5] |= 1u << (i & 31);
}

// the _fits rule for state q + add (add may be null) on one node
__device__ __forceinline__ bool fits_plus(
    const int* a, const int* q, const int* add, const int* preq, int r,
    bool all_zero) {
  bool fits_all = true;
  bool fits_pods = true;
  for (int d = 0; d < r; ++d) {
    const int s = preq[d];
    const int used = add ? add_wrap(q[d], add[d]) : q[d];
    bool ok = s <= sub_wrap(a[d], used);
    if (d >= kNumFixedDims && s == 0) ok = true;
    fits_all = fits_all && ok;
    if (d == kPodsCol) fits_pods = ok;
  }
  return all_zero ? fits_pods : fits_all;
}

// selectVictimsOnNode for node j and the current class, then j's pick key
// and victim masks; reads the carry, writes only j's scratch rows
__device__ void node_keys(const Wave& s, int j, const int* preq, int pprio,
                          bool all_zero, bool candidate) {
  const int r = s.r;
  const int v = s.v;
  const int w = s.w;
  const int* a = s.alloc + static_cast<size_t>(j) * r;
  const int* st = s.state + static_cast<size_t>(j) * r;
  int* q = s.work + static_cast<size_t>(j) * r;
  const int* vp = s.vprio + static_cast<size_t>(j) * v;
  const float* vs = s.vstart + static_cast<size_t>(j) * v;
  const int* vq = s.vreq + static_cast<size_t>(j) * v * r;
  const uint8_t* va = s.vactive + static_cast<size_t>(j) * v;
  unsigned* vic = s.masks + static_cast<size_t>(j) * 3 * w;
  unsigned* vio = vic + w;
  unsigned* pdbv = vio + w;

  for (int d = 0; d < r; ++d) q[d] = st[d];
  for (int k = 0; k < s.m; ++k) {
    if (s.nom_node[k] != j || s.nom_prio[k] < pprio) continue;
    const int* nq = s.nom_req + static_cast<size_t>(k) * r;
    for (int d = 0; d < r; ++d) q[d] = add_wrap(q[d], nq[d]);
  }
  for (int i = 0; i < v; ++i) {
    if (!va[i] || vp[i] >= pprio) continue;
    for (int d = 0; d < r; ++d) q[d] = sub_wrap(q[d], vq[i * r + d]);
  }
  const bool feasible = candidate && fits_plus(a, q, nullptr, preq, r, all_zero);

  for (int k = 0; k < 3 * w; ++k) vic[k] = 0u;
  if (s.p > 0) {
    int* bud = s.budgets + static_cast<size_t>(j) * s.p;
    const uint8_t* pm = s.pdb_match + static_cast<size_t>(j) * v * s.p;
    for (int k = 0; k < s.p; ++k) bud[k] = s.pdb_allowed[k];
    for (int i = 0; i < v; ++i) {
      if (!va[i] || vp[i] >= pprio) continue;
      for (int k = 0; k < s.p; ++k) {
        if (!pm[i * s.p + k]) continue;
        if (bud[k] <= 0) {
          set_bit(pdbv, i);
          break;
        }
        bud[k] -= 1;
      }
    }
  }
  // reprieve: the PDB-violating victims first, then the rest
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = 0; i < v; ++i) {
      if (!va[i] || vp[i] >= pprio) continue;
      if (bit(pdbv, i) != (pass == 0)) continue;
      const int* add = vq + i * r;
      if (fits_plus(a, q, add, preq, r, all_zero)) {
        for (int d = 0; d < r; ++d) q[d] = add_wrap(q[d], add[d]);
      } else {
        set_bit(vic, i);
        if (pass == 0) set_bit(vio, i);
      }
    }
  }

  PickKey key = {2, 0, 0, 0, 0ull, 0.0f, j};
  if (feasible) {
    int vcount = 0, nviol = 0, first_any = -1, first_viol = -1;
    unsigned long long psum = 0ull;
    int maxp = 0;
    float earliest = 0.0f;
    for (int i = 0; i < v; ++i) {
      if (!bit(vic, i)) continue;
      if (vcount == 0 || vp[i] > maxp) {
        maxp = vp[i];
        earliest = vs[i];
      } else if (vp[i] == maxp && vs[i] < earliest) {
        earliest = vs[i];
      }
      if (first_any < 0) first_any = i;
      ++vcount;
      psum += static_cast<unsigned>(vp[i]) ^ 0x80000000u;
      if (bit(vio, i)) {
        if (first_viol < 0) first_viol = i;
        ++nviol;
      }
    }
    if (vcount == 0) {
      key.tier = 0;
    } else {
      key.tier = 1;
      key.nviol = nviol;
      key.fprio = vp[first_viol >= 0 ? first_viol : first_any];
      key.psum = psum;
      key.vcount = vcount;
      key.earliest = earliest;
    }
  }
  s.keys[j] = key;
}

__global__ void __launch_bounds__(kThreads) preempt_solve_kernel(
    Wave s,
    const int* __restrict__ state_in,       // [N, R]
    const int* __restrict__ pod_req,        // [B, R]
    const int* __restrict__ pod_prio,       // [B]
    const uint8_t* __restrict__ cand_rows,  // [U, N]
    const int* __restrict__ cand_index,     // [B]
    const uint8_t* __restrict__ pod_active, // [B]
    int* chosen,                            // [B]    out
    unsigned* vic_out,                      // [B, W] out
    unsigned* viol_out,                     // [B, W] out
    int* nviol_out,                         // [B]    out
    int b, int u) {
  __shared__ PickKey s_warp[kWarps];
  const int tid = threadIdx.x;
  const int n = s.n;
  const int r = s.r;
  const int w = s.w;

  for (int j = tid; j < n * r; j += kThreads) s.state[j] = state_in[j];
  __syncthreads();

  for (int t = 0; t < b; ++t) {
    const int* preq = pod_req + static_cast<size_t>(t) * r;
    const int pprio = pod_prio[t];
    int ci = cand_index[t];
    ci = ci < 0 ? 0 : (ci >= u ? u - 1 : ci);  // gathers clamp, as in JAX
    const uint8_t* cand = cand_rows + static_cast<size_t>(ci) * n;
    const bool all_zero = pod_all_zero(preq, r);

    // a new class (uniform across the block): rebuild every node's key
    bool rebuild = t == 0;
    if (!rebuild) {
      int cp = cand_index[t - 1];
      cp = cp < 0 ? 0 : (cp >= u ? u - 1 : cp);
      rebuild = pod_prio[t - 1] != pprio || cp != ci;
      const int* prev = preq - r;
      for (int d = 0; d < r && !rebuild; ++d) rebuild = prev[d] != preq[d];
    }
    if (rebuild) {
      for (int j = tid; j < n; j += kThreads) {
        node_keys(s, j, preq, pprio, all_zero, cand[j] != 0);
      }
      __syncthreads();
    }

    PickKey best = {3, 0, 0, 0, 0ull, 0.0f, kNoIndex};
    for (int j = tid; j < n; j += kThreads) {
      const PickKey k = s.keys[j];
      if (KeyLess()(k, best)) best = k;
    }
    best = block_min(best, s_warp, KeyLess());

    if (tid == 0) {
      const bool placed = pod_active[t] && best.tier <= 1;
      const int c = placed ? best.index : -1;
      chosen[t] = c;
      const unsigned* vm = placed ? s.masks + static_cast<size_t>(c) * 3 * w
                                  : nullptr;
      int nv = 0;
      for (int k = 0; k < w; ++k) {
        const unsigned vk = placed ? vm[k] : 0u;
        const unsigned ok = placed ? vm[w + k] : 0u;
        vic_out[static_cast<size_t>(t) * w + k] = vk;
        viol_out[static_cast<size_t>(t) * w + k] = ok;
        nv += __popc(ok);
      }
      nviol_out[t] = nv;
      if (placed) {
        // the nomination rides the carry; only this node's key changes
        int* q = s.state + static_cast<size_t>(c) * r;
        for (int d = 0; d < r; ++d) q[d] = add_wrap(q[d], preq[d]);
        node_keys(s, c, preq, pprio, all_zero, cand[c] != 0);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int preempt_solve_launch(
    const void* alloc, const void* state_in, const void* vprio,
    const void* vstart, const void* vreq, const void* vactive,
    const void* pdb_match, const void* pdb_allowed, const void* nom_req,
    const void* nom_prio, const void* nom_node, const void* pod_req,
    const void* pod_prio, const void* cand_rows, const void* cand_index,
    const void* pod_active,
    void* chosen, void* vic_out, void* viol_out, void* nviol_out,
    void* state_out,
    void* work, void* budgets, void* masks, void* keys,
    int n, int v, int r, int p, int m, int b, int u, void* stream) {
  Wave s;
  s.alloc = static_cast<const int*>(alloc);
  s.vprio = static_cast<const int*>(vprio);
  s.vstart = static_cast<const float*>(vstart);
  s.vreq = static_cast<const int*>(vreq);
  s.vactive = static_cast<const uint8_t*>(vactive);
  s.pdb_match = static_cast<const uint8_t*>(pdb_match);
  s.pdb_allowed = static_cast<const int*>(pdb_allowed);
  s.nom_req = static_cast<const int*>(nom_req);
  s.nom_prio = static_cast<const int*>(nom_prio);
  s.nom_node = static_cast<const int*>(nom_node);
  s.state = static_cast<int*>(state_out);
  s.work = static_cast<int*>(work);
  s.budgets = static_cast<int*>(budgets);
  s.masks = static_cast<unsigned*>(masks);
  s.keys = static_cast<PickKey*>(keys);
  s.n = n;
  s.v = v;
  s.r = r;
  s.p = p;
  s.m = m;
  s.w = (v + 31) / 32;
  preempt_solve_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, static_cast<const int*>(state_in), static_cast<const int*>(pod_req),
      static_cast<const int*>(pod_prio),
      static_cast<const uint8_t*>(cand_rows),
      static_cast<const int*>(cand_index),
      static_cast<const uint8_t*>(pod_active),
      static_cast<int*>(chosen), static_cast<unsigned*>(vic_out),
      static_cast<unsigned*>(viol_out), static_cast<int*>(nviol_out), b, u);
  return static_cast<int>(cudaGetLastError());
}
