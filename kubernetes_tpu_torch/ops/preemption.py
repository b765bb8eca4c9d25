"""Device victim search: the preemption wave on the card.

Reference semantics replicated exactly from
the reference Kubernetes tree, pkg/scheduler/core/generic_scheduler.go:
- selectVictimsOnNode (:940): remove every lower-priority pod, check the
  preemptor fits, then "reprieve" victims in MoreImportantPod order --
  PDB-violating pods first -- re-adding each and keeping it unless the
  preemptor stops fitting.
- filterPodsWithPDBViolation (:884): greedy per-PDB DisruptionsAllowed
  budget spend over the sorted potential-victim list.
- addNominatedPods (:535): nominated pods with priority >= the preemptor
  are virtually added before the fit check.
- pickOneNodeForPreemption (:721): the six-rule choice of one node.

A whole wave of failed pods (priority-descending, the activeQ order) is
ONE call: each pod's nomination rides a node-state carry, so later pods
see earlier ones, exactly the view addNominatedPods gives each later
scheduling cycle. On the card the call is kernel K3
(``ops/preempt_kernel.py``, ``csrc/preempt_solve.cu``);
``preempt_batch_plain`` below is its plain PyTorch version (a loop over
pods, one node-parallel step each), taken only for tensors on the CPU.

Pod-side string work (MoreImportantPod sort, PDB label matching) happens
once per snapshot in ``pack_preemption_state`` and is cached by the
Preemptor, so a burst of failed pods shares one pack and one upload.

Only the resource-fit + static-mask filter family is modeled on device;
the Preemptor gates this path to pods/clusters where that set is exact
(plain pods, no required anti-affinity in the cluster, no interested
extenders) and takes the host oracle otherwise
(scheduler/preemption.py).
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.api.selectors import labels_match_mask
from kubernetes_tpu_torch.api.types import Pod, PodDisruptionBudget
from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.ops.assignment import _fits
from kubernetes_tpu_torch.tensors import pack_pod_batch
from kubernetes_tpu_torch.tensors.node_tensor import NodeTensor

_INT_MIN = -(1 << 31)
_INT_MAX = (1 << 31) - 1
#: victim priorities are clipped below INT32_MAX, so the pick's masked
#: minimum (INT32_MAX) never ties a real value
_PRIO_MAX = (1 << 31) - 2


class PreemptionPack:
    """Per-snapshot tensors for the device victim search (cached by the
    Preemptor keyed on snapshot generation + PDB resource version).
    ``dev`` caches the upload per device (``upload_pack``)."""

    __slots__ = (
        "node_names", "node_index", "pods_by_node", "alloc",
        "base_requested", "prio", "start_rel", "req", "active",
        "pdb_match", "pdb_allowed", "v_max", "generation", "dev",
    )


def pack_preemption_state(
    snapshot,
    nt: NodeTensor,
    pdbs: List[PodDisruptionBudget],
) -> PreemptionPack:
    """Sort every node's pods by MoreImportantPod (priority desc, start
    asc -- util/utils.go:76) and pack the per-victim tensors. The
    priority cutoff (which pods are eligible victims for a given
    preemptor) is applied ON DEVICE over this sorted order, so one pack
    serves preemptors of any priority. The victim axis is exactly the
    most pods any node holds (at least 1): K3 takes it at run time."""
    node_infos = [
        ni for ni in snapshot.list_node_infos() if ni.node is not None
    ]
    n = len(node_infos)
    now = time.time()
    # MoreImportantPod order per node via ONE np.lexsort over the whole
    # cluster
    all_pods: List[Pod] = []
    node_of: List[int] = []
    for i, ni in enumerate(node_infos):
        all_pods.extend(ni.pods)
        node_of.extend([i] * len(ni.pods))
    if all_pods:
        node_arr = np.asarray(node_of, dtype=np.int64)
        prio_arr = np.array(
            [p.spec.priority for p in all_pods], dtype=np.int64
        )
        # a pod with no start time counts as "now" (GetPodStartTime), so
        # a replay must reuse this pack, never rebuild it
        start_arr = np.array(
            [
                p.status.start_time
                if p.status.start_time is not None else now
                for p in all_pods
            ],
            dtype=np.float64,
        )
        order = np.lexsort((start_arr, -prio_arr, node_arr))
        counts_per_node = np.bincount(node_arr, minlength=n)
        sorted_pods = [[] for _ in range(n)]
        for j in order:
            sorted_pods[node_of[j]].append(all_pods[j])
    else:
        counts_per_node = np.zeros(n, dtype=np.int64)
        sorted_pods = [[] for _ in range(n)]
    v_max = max(1, int(counts_per_node.max()) if n else 0)
    r = nt.dims.num_dims
    p_count = len(pdbs)

    prio = np.full((n, v_max), _INT_MIN, dtype=np.int64)
    start_rel = np.zeros((n, v_max), dtype=np.float64)
    req = np.zeros((n, v_max, r), dtype=np.int32)
    active = np.zeros((n, v_max), dtype=bool)
    pdb_match = np.zeros((n, v_max, max(p_count, 1)), dtype=bool)

    # one vectorized pass over ALL victims: flatten (node, slot) -> one
    # pack_pod_batch call + scatters
    rows = np.array(
        [nt.row(ni.node_name) for ni in node_infos], dtype=np.int64
    )
    alloc = (
        nt.allocatable[rows].astype(np.int32)
        if n else np.zeros((0, r), dtype=np.int32)
    )
    base_requested = (
        nt.requested[rows].astype(np.int32)
        if n else np.zeros((0, r), dtype=np.int32)
    )
    if all_pods:
        flat_pods = [all_pods[j] for j in order]
        flat_node = node_arr[order]
        starts = np.zeros(n, dtype=np.int64)
        starts[1:] = np.cumsum(counts_per_node)[:-1]
        flat_slot = (
            np.arange(len(all_pods), dtype=np.int64) - starts[flat_node]
        )
        batch = pack_pod_batch(flat_pods, nt.dims)
        req[flat_node, flat_slot] = batch.requests
        prio[flat_node, flat_slot] = prio_arr[order]
        start_rel[flat_node, flat_slot] = start_arr[order]
        active[flat_node, flat_slot] = True
        if pdbs:
            labels_list = [p.metadata.labels for p in flat_pods]
            ns_arr = np.array(
                [p.metadata.namespace for p in flat_pods], dtype=object
            )
            has_labels = np.array(
                [bool(p.metadata.labels) for p in flat_pods], dtype=bool
            )
            for k, pdb in enumerate(pdbs):
                if pdb.selector is None:
                    continue
                mask = np.frombuffer(
                    labels_match_mask(labels_list, pdb.selector),
                    dtype=np.uint8,
                ).astype(bool)
                mask &= has_labels
                mask &= ns_arr == pdb.metadata.namespace
                pdb_match[flat_node, flat_slot, k] = mask

    # relative start times keep f32 exact for realistic spans (absolute
    # epoch seconds lose ~64s of precision in f32)
    if active.any():
        start_rel -= start_rel[active].min()

    pack = PreemptionPack()
    pack.node_names = [ni.node_name for ni in node_infos]
    pack.node_index = {
        name: i for i, name in enumerate(pack.node_names)
    }
    pack.pods_by_node = sorted_pods
    pack.alloc = alloc
    pack.base_requested = base_requested
    pack.prio = prio
    pack.start_rel = start_rel
    pack.req = req
    pack.active = active
    pack.pdb_match = pdb_match
    pack.pdb_allowed = np.array(
        [pdb.status.disruptions_allowed for pdb in pdbs] or [0],
        dtype=np.int32,
    )
    pack.v_max = v_max
    pack.generation = getattr(snapshot, "generation", 0)
    pack.dev = {}
    return pack


def pack_num_pdbs(pack: PreemptionPack) -> int:
    """The PDB count the wave models: zero when no victim matches any
    budget (the common case skips the budget walk)."""
    return int(pack.pdb_allowed.shape[0]) if pack.pdb_match.any() else 0


def to_device(arrays, device) -> List[torch.Tensor]:
    """Copy numpy arrays to ``device`` as ONE transfer: the arrays ride
    one host buffer (pinned, for the card), each at a 16-byte aligned
    offset, and come back as typed views of the one device buffer. bool
    arrays stay bool; every other dtype keeps its own."""
    device = torch.device(device)
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offsets = []
    total = 0
    for a in arrays:
        offsets.append(total)
        total += -(-a.nbytes // 16) * 16
    if device.type == "cuda":
        host = torch.empty(max(total, 16), dtype=torch.uint8, pin_memory=True)
    else:
        host = torch.empty(max(total, 16), dtype=torch.uint8)
    flat = host.numpy()
    for a, off in zip(arrays, offsets):
        flat[off:off + a.nbytes] = a.view(np.uint8).reshape(-1)
    buf = host.to(device, non_blocking=True) if device.type == "cuda" else host
    out = []
    for a, off in zip(arrays, offsets):
        dtype = torch.from_numpy(np.zeros(0, dtype=a.dtype)).dtype
        piece = buf[off:off + a.nbytes].view(dtype).view(a.shape)
        out.append(piece)
    return out


def upload_pack(pack: PreemptionPack, device) -> Tuple[torch.Tensor, ...]:
    """The pack's device tensors, cached on it per device: (alloc [N, R],
    base_requested [N, R], prio [N, V] int32 clipped below INT32_MAX,
    start_rel [N, V] f32, req [N, V, R], active [N, V] bool, pdb_match
    [N, V, P] bool, pdb_allowed [P]) with P = ``pack_num_pdbs``. One
    pinned host buffer and one host-to-device copy; the prewarm path
    makes it before the wave needs it. The kernel reads these and never
    writes them, so a cached pack serves every later wave."""
    key = str(torch.device(device))
    dev = pack.dev.get(key)
    if dev is None:
        p = pack_num_pdbs(pack)
        dev = tuple(to_device(
            (
                pack.alloc,
                pack.base_requested,
                np.clip(pack.prio, _INT_MIN, _PRIO_MAX).astype(np.int32),
                pack.start_rel.astype(np.float32),
                pack.req,
                pack.active,
                pack.pdb_match[:, :, :p],
                pack.pdb_allowed[:p],
            ),
            device,
        ))
        pack.dev[key] = dev
    return dev


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """[B, V] bool -> [B, ceil(V/32)] int32 words, victim slot v at bit
    v % 32 of word v // 32 (K3's output layout)."""
    b, v = mask.shape
    w = -(-v // 32)
    padded = torch.zeros((b, w * 32), dtype=torch.int64, device=mask.device)
    padded[:, :v] = mask.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    words = (padded.view(b, w, 32) << shifts).sum(dim=2)
    # the uint32 bit pattern as int32
    words = torch.where(words >= (1 << 31), words - (1 << 32), words)
    return words.to(torch.int32)


def unpack_bits(words: np.ndarray, v: int) -> np.ndarray:
    """[B, W] int32 words -> [B, v] bool (the inverse of pack_bits)."""
    bits = words.astype(np.uint32)[:, :, None] >> np.arange(
        32, dtype=np.uint32
    )
    return (bits & 1).astype(bool).reshape(words.shape[0], -1)[:, :v]


def _device_pick(feasible, victims, victims_viol, prio, start_rel):
    """pickOneNodeForPreemption (:721), node-parallel. Rules 1-4 are
    exact integer narrowing; rule 3's priority sum (each term is
    prio + MaxInt32 + 1, up to 2^32, summed over victims) is carried in
    two 16-bit limbs so the 48-bit compare stays exact in int32.
    Returns the chosen node index (a 0-d int32 tensor), or -1 when
    nothing is feasible."""
    i32 = torch.int32
    vcount = victims.sum(dim=1, dtype=i32)
    nviol = victims_viol.sum(dim=1, dtype=i32)

    def narrow(cand, vals):
        masked = torch.where(cand, vals, _INT_MAX)
        return cand & (masked == masked.min())

    cand = feasible
    # free lunch: a feasible node needing no victims wins immediately
    free = cand & (vcount == 0)
    any_free = free.any()

    cand = narrow(cand, nviol)  # 1. fewest PDB violations
    # 2. lowest first-victim priority (reference Victims.Pods[0]:
    # victims are appended violating-first)
    has_viol = victims_viol.any(dim=1)
    first_any = torch.argmax(victims.to(i32), dim=1)
    first_viol = torch.argmax(victims_viol.to(i32), dim=1)
    fi = torch.where(has_viol, first_viol, first_any)
    fprio = prio.gather(1, fi[:, None]).squeeze(1)
    cand = narrow(cand, fprio)
    # 3. smallest sum of (prio + MaxInt32 + 1) = prio ^ 0x80000000 as
    # uint32, in 16-bit limbs whose sums fit int32 exactly
    t = prio.to(torch.int64) + (1 << 31)
    lo = (t & 0xFFFF).to(i32)
    hi = (t >> 16).to(i32)
    vic_i = victims.to(i32)
    slo = (lo * vic_i).sum(dim=1, dtype=i32)
    shi = (hi * vic_i).sum(dim=1, dtype=i32)
    shi = shi + (slo >> 16)
    slo = slo & 0xFFFF
    cand = narrow(cand, shi)
    cand = narrow(cand, slo)
    cand = narrow(cand, vcount)  # 4. fewest victims
    # 5. latest earliest-start among each node's highest-priority victims
    vprio = torch.where(victims, prio, _INT_MIN)
    max_prio = vprio.max(dim=1).values
    at_max = victims & (vprio == max_prio[:, None])
    earliest = torch.where(at_max, start_rel, torch.inf).min(dim=1).values
    pick_r5 = torch.argmax(torch.where(cand, earliest, -torch.inf))
    pick = torch.where(any_free, torch.argmax(free.to(i32)), pick_r5)
    return torch.where(feasible.any(), pick, -1).to(i32)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap, as int32 adds wrap."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _reprieve(alloc, state, req, sel_mask, pod_req):
    """One reprieve pass in sorted order: re-add each selected victim and
    keep it while the pod still fits. Returns (state, victims [N, V]).

    Equal to the walk one victim at a time, taken a run at a time: from
    each node's first undecided victim, the selected victims whose prefix
    sums still fit are kept (the first that does not is the run's end);
    from there, each selected victim that does not fit alone on the new
    state is taken, up to the first that does. A node with k such
    alternations needs k steps of node-parallel prefix sums, not V; the
    sums are int64, wrapped to int32 as the walk's adds wrap."""
    n, v, r = req.shape
    dev = req.device
    taken = torch.zeros((n, v), dtype=torch.bool, device=dev)
    if v == 0 or n == 0:
        return state, taken
    idx = torch.arange(v, device=dev)[None, :]
    contrib = req.to(torch.int64) * sel_mask[:, :, None]
    base = (alloc.to(torch.int64) - state.to(torch.int64))[:, None, :]

    def fits(used):  # [N, V, R] int64 added to the state -> [N, V]
        return _fits(_wrap32(base - used).reshape(n * v, r),
                     pod_req).reshape(n, v)

    pos = torch.zeros((n, 1), dtype=torch.int64, device=dev)
    added = torch.zeros((n, 1, r), dtype=torch.int64, device=dev)
    while True:
        ahead = sel_mask & (idx >= pos)
        if not bool(ahead.any()):
            break
        # the keep run: prefix sums from pos
        prefix = torch.cumsum(contrib * (idx >= pos)[:, :, None], dim=1)
        fail = ahead & ~fits(added + prefix)
        end = torch.where(fail.any(dim=1, keepdim=True),
                          fail.to(torch.int8).argmax(dim=1, keepdim=True), v)
        kept = prefix.gather(
            1, (end - 1).clamp(min=0)[:, :, None].expand(n, 1, r)
        ) * (end > 0)[:, :, None]
        added = added + kept
        # the taken run: each victim alone on the new state
        back = sel_mask & (idx >= end) & fits(added + contrib)
        nxt = torch.where(back.any(dim=1, keepdim=True),
                          back.to(torch.int8).argmax(dim=1, keepdim=True), v)
        taken |= sel_mask & (idx >= end) & (idx < nxt)
        pos = nxt
    return _wrap32(state.to(torch.int64) + added[:, 0, :]), taken


def _pdb_violating(eligible, pdb_match, pdb_allowed):
    """filterPodsWithPDBViolation per node over the sorted victims, with
    fresh budgets: a victim whose first matching budget is spent is
    violating (and spends no later budget). Returns [N, V] bool."""
    n, v, p = pdb_match.shape
    budgets = pdb_allowed[None, :].expand(n, p).clone()
    out = []
    for vi in range(v):
        elig_v = eligible[:, vi]
        violated = torch.zeros_like(elig_v)
        for k in range(p):
            m = pdb_match[:, vi, k] & elig_v & ~violated
            viol_k = m & (budgets[:, k] <= 0)
            violated = violated | viol_k
            budgets[:, k] -= (m & ~viol_k).to(torch.int32)
        out.append(violated)
    return torch.stack(out, dim=1)


def preempt_batch_plain(
    alloc: torch.Tensor,  # [N, R] int32
    base_requested: torch.Tensor,  # [N, R] int32 (all pods incl. victims)
    prio: torch.Tensor,  # [N, V] int32
    start_rel: torch.Tensor,  # [N, V] float32
    req: torch.Tensor,  # [N, V, R] int32
    active: torch.Tensor,  # [N, V] bool
    pdb_match: torch.Tensor,  # [N, V, P] bool (P may be 0)
    pdb_allowed: torch.Tensor,  # [P] int32
    nom_req: torch.Tensor,  # [M, R] int32 pre-existing nominated pods
    nom_prio: torch.Tensor,  # [M] int32
    nom_node: torch.Tensor,  # [M] int32 node index (-1 inactive)
    pods_req: torch.Tensor,  # [B, R] int32, priority-desc order
    pods_prio: torch.Tensor,  # [B] int32
    cand_rows: torch.Tensor,  # [U, N] bool deduplicated candidate rows
    cand_index: torch.Tensor,  # [B] int32 row per pod
    pods_active: torch.Tensor,  # [B] bool
) -> Tuple[torch.Tensor, ...]:
    """The plain version of K3: the whole failed-pod group's preemption,
    one node-parallel step per pod. The carry is the node state WITH
    every earlier pod's nomination added. Victims stay in the state (the
    reference's stale-snapshot semantics: deletions land
    asynchronously) and each pod gets fresh PDB budgets (the disruption
    controller has not observed earlier evictions yet).

    Returns (chosen [B] int32 node index or -1, victims [B, W] int32
    words, victims_violating [B, W] words, num_violating [B] int32,
    state' [N, R] int32), W = ceil(V/32), bits as ``pack_bits``. The
    inputs are never written."""
    n, v = prio.shape
    dev = alloc.device
    i32 = torch.int32
    node_iota = torch.arange(n, dtype=i32, device=dev)
    u = cand_rows.shape[0]
    cidx = cand_index.long().clamp(0, max(u - 1, 0))
    nom_on = (nom_node >= 0) & (nom_node < n)
    nom_at = nom_node.long().clamp(0, max(n - 1, 0))
    has_pdbs = pdb_match.shape[2] > 0
    node_state = base_requested
    chosen, vic_rows, viol_rows = [], [], []
    for t in range(pods_req.shape[0]):
        pod_req = pods_req[t]
        pod_prio = pods_prio[t]
        eligible = active & (prio < pod_prio)  # [N, V]
        nom_sel = (nom_prio >= pod_prio) & nom_on
        nom_add = torch.zeros_like(node_state).index_add_(
            0, nom_at, nom_req * nom_sel[:, None].to(i32)
        )
        removed = (req * eligible[:, :, None].to(i32)).sum(dim=1, dtype=i32)
        state0 = node_state + nom_add - removed
        feasible = (
            _fits(alloc - state0, pod_req) & cand_rows[cidx[t]]
            & pods_active[t]
        )
        if has_pdbs:
            violating = _pdb_violating(eligible, pdb_match, pdb_allowed)
        else:
            violating = torch.zeros_like(eligible)
        st, victims_viol = _reprieve(
            alloc, state0, req, eligible & violating, pod_req
        )
        _, victims_rest = _reprieve(
            alloc, st, req, eligible & ~violating, pod_req
        )
        victims = victims_viol | victims_rest

        choice = _device_pick(feasible, victims, victims_viol, prio, start_rel)
        placed = choice >= 0
        safe = choice.clamp(min=0)
        # nominate: later (lower-priority) pods see this pod's request
        node_state = node_state + (
            (node_iota == safe) & placed
        )[:, None].to(i32) * pod_req[None, :]
        chosen.append(choice)
        vic_rows.append(victims[safe] & placed)
        viol_rows.append(victims_viol[safe] & placed)
    b = len(chosen)
    if b == 0:
        empty = torch.zeros((0, -(-v // 32)), dtype=i32, device=dev)
        return (
            torch.zeros(0, dtype=i32, device=dev), empty, empty.clone(),
            torch.zeros(0, dtype=i32, device=dev), node_state.clone(),
        )
    vic = torch.stack(vic_rows)
    viol = torch.stack(viol_rows)
    return (
        torch.stack(chosen), pack_bits(vic), pack_bits(viol),
        viol.sum(dim=1, dtype=i32), node_state,
    )


def preempt_batch_device(
    pack: PreemptionPack,
    pods_req: np.ndarray,  # [B, R]
    pods_prio: np.ndarray,  # [B]
    cand_rows: np.ndarray,  # [U, N] bool deduplicated candidate masks
    cand_index: np.ndarray,  # [B] row per pod
    nom_req: np.ndarray,  # [M, R]
    nom_prio: np.ndarray,  # [M]
    nom_node: np.ndarray,  # [M]
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One device call for a whole failed-pod group on ``device`` (the
    card unless the caller names the CPU; with no visible card the
    default raises): K3 on the card, its plain version on the CPU
    (``preempt_kernel`` decides). Returns host arrays (chosen [B],
    victims [B, V], victims_violating [B, V], num_violating [B]).

    The candidate masks arrive deduplicated: a wave shares a handful of
    static-mask rows x potential-node lists, so no [B, N] matrix is
    built or shipped."""
    from kubernetes_tpu_torch.ops import preempt_kernel

    device = resolve_device(device)
    b = pods_req.shape[0]
    v = pack.req.shape[1]
    if b > 1 and not (pods_prio[:-1] >= pods_prio[1:]).all():
        # the in-wave carry models addNominatedPods only when every
        # earlier pod has a priority >= the later ones (the callers sort)
        raise ValueError("preemption wave must be priority-descending")
    wave = to_device(
        (
            np.asarray(nom_req, dtype=np.int32).reshape(-1, pods_req.shape[1]),
            np.asarray(nom_prio, dtype=np.int32),
            np.asarray(nom_node, dtype=np.int32),
            np.asarray(pods_req, dtype=np.int32),
            np.asarray(pods_prio, dtype=np.int32),
            np.asarray(cand_rows, dtype=bool),
            np.asarray(cand_index, dtype=np.int32).reshape(-1),
            np.ones(b, dtype=bool),
        ),
        device,
    )
    chosen, vwords, violwords, nviol, _state = preempt_kernel.preempt_solve(
        *upload_pack(pack, device), *wave
    )
    # ONE download for the four results
    packed = torch.cat(
        [chosen[:, None], nviol[:, None], vwords, violwords], dim=1
    ).cpu().numpy()
    w = vwords.shape[1]
    return (
        packed[:, 0],
        unpack_bits(packed[:, 2:2 + w], v),
        unpack_bits(packed[:, 2 + w:2 + 2 * w], v),
        packed[:, 1],
    )


def victims_for_node(
    pack: PreemptionPack,
    idx: int,
    victims_row: np.ndarray,
    violating_row: np.ndarray,
) -> List[Pod]:
    """Materialize the chosen node's victims in reprieve order
    (PDB-violating first, then the rest -- the order the reference
    appends them)."""
    pods = pack.pods_by_node[idx]
    out = [
        pods[v] for v in range(len(pods))
        if victims_row[v] and violating_row[v]
    ]
    out += [
        pods[v] for v in range(len(pods))
        if victims_row[v] and not violating_row[v]
    ]
    return out
