"""K2: the constrained batch solve as ONE hand-written CUDA kernel for Hopper.

Replaces ``kubernetes_tpu/ops/pallas_constrained.py::_constrained_kernel``
(entry ``pallas_constrained_solve``). The source is
``csrc/constrained_solve.cu``; its header says what bounds the kernel on
the card and how its thread-block cluster works. Each launch is one
cluster planned by ``plan_for`` (``ops/cluster_plan``), and every CTA
replays into its own copy of the value-space counts. The
kernel's plain PyTorch version is ``ops/assignment.greedy_assign_constrained``
(the port of the reference's XLA scan): ``constrained_solve`` takes it only
for tensors that lie on the CPU. A tensor on the card launches the kernel
or raises.

The TPU kernel is a template per combination of per-family row caps
(``Caps``) under a VMEM gate. K2 takes each family's live row count
(``Rows``, from ``live_rows``) as a runtime argument instead: an absent
family costs no rows and no work, no combination of families needs a
build of its own, and no shape needs a gate or a lowering fallback.

Build: ``ops/kernel_build.build_library`` (nvcc for ``sm_90a`` into a
library with a plain C interface, loaded with ctypes, at first use).
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.ops.assignment import (
    _N_AFFINITY,
    _N_SCORING,
    _N_SPREAD,
    ConstPiece,
    GreedyConfig,
    greedy_assign_constrained,
)
from kubernetes_tpu_torch.ops.cluster_plan import (
    LaunchPlan,
    card_admits,
    choose_plan,
    plan_launch,
)
from kubernetes_tpu_torch.ops.kernel_build import (
    KernelError,
    build_library,
    check_tensor,
)
from kubernetes_tpu_torch.utils import flightrecorder

__all__ = [
    "KernelError", "Rows", "build", "constrained_rows",
    "constrained_solve", "constrained_solve_cuda", "live_rows", "plan_for",
]

# Packer maximums (ops/affinity.py, ops/scoring.py)
_RA = 16        # affinity.MAX_AFF_ROWS (and MAX_ANTI_ROWS)
_RE = 64        # affinity.MAX_EXIST_ROWS
_RP = 16        # scoring.MAX_IPA_ROWS

# what one launch holds (csrc/constrained_solve.cu kMax*)
_MAX_SLOTS = 4   # hard-spread / affinity / anti / soft slots per pod
_MAX_GROUPS = 16  # topology.MAX_GROUPS, scoring.MAX_SOFT_GROUPS
_MAX_SEL_GROUPS = 8  # scoring.MAX_SEL_GROUPS
_MAX_ZONES = 64  # scoring.MAX_ZONES


def plan_for(n: int, r: int, cluster: int, static_bytes: int = 0) -> LaunchPlan:
    """K2's launch plan for N rows of R dims on at most ``cluster`` CTAs.
    A resident row holds alloc, req, nzr, its soft and preferred-affinity
    raw values and its flags; every CTA holds two pod requests and one
    parameter warp (csrc/constrained_solve.cu dynamic_smem_bytes)."""
    return plan_launch(
        n, cluster, node_bytes=4 * (2 * r + 4) + 1, fixed_bytes=4 * 2 * r,
        static_bytes=static_bytes, extra_warps=1,
    )


class Rows(NamedTuple):
    """Each family's live row count: the rows K2 loops over and replays.
    A zero drops the family."""

    g_sp: int   # hard-spread groups
    ra: int     # incoming-affinity rows
    rt: int     # incoming-anti-affinity rows
    re: int     # existing-pod anti-affinity rows
    gt: int     # soft-spread groups
    rp: int     # preferred inter-pod affinity rows
    g_sel: int  # selector-spread groups


def live_rows(spread, affinity, scoring) -> Rows:
    """The rows the packed family tuples (host arrays; None for an
    absent family) use: the groups and rows some pod refers to, the
    affinity rows with a topology key, the preferred-affinity rows with a
    value on some node. The rows past them are padding that no step
    reads, so K2 gives the same answer at these counts as at every row
    (and as the plain version, which runs every row)."""

    def max_plus_one(a):
        a = np.asarray(a)
        return 0 if a.size == 0 else int(a.max()) + 1

    def key_rows(a):
        return int(np.count_nonzero(np.asarray(a) >= 0))

    g_sp = max_plus_one(spread[3]) if spread is not None else 0
    ra = rt = re = 0
    if affinity is not None:
        ra, rt, re = (key_rows(affinity[k]) for k in (2, 7, 11))
    gt = rp = g_sel = 0
    if scoring is not None:
        gt = max_plus_one(scoring[11])
        rp = max_plus_one(
            np.flatnonzero((np.asarray(scoring[13]) >= 0).any(axis=1))
        )
        g_sel = max_plus_one(scoring[7])
    return Rows(g_sp, ra, rt, re, gt, rp, g_sel)


def constrained_rows(pieces_by_name) -> Rows:
    """live_rows of a constrained dispatch's HOST-side pieces (a
    ConstPiece family piece marks that family absent)."""

    def fam(prefix, count):
        arrs = [pieces_by_name[f"{prefix}{i}"] for i in range(count)]
        return None if any(isinstance(a, ConstPiece) for a in arrs) else arrs

    return live_rows(
        fam("sp", _N_SPREAD), fam("af", _N_AFFINITY), fam("sc", _N_SCORING)
    )


#: times the kernel library was built (or loaded) in this process --
#: the cache watchdog's "compile" count
builds = 0
#: kernel launches: incremented where the kernel is launched, nowhere else
launches = 0
#: what the last build did: {"seconds", "command", "log", "library"}
last_build: dict = {}
#: the plan of the last launch
last_plan: Optional[LaunchPlan] = None

_lib = None
_lib_lock = threading.Lock()
_static_bytes = 0
#: clusters the card holds at once, per planned shape
_admitted: dict = {}


def build() -> ctypes.CDLL:
    """Compile (once per process and source hash) and load the kernel
    library. Raises KernelError when nvcc fails."""
    global _lib, builds, _static_bytes
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, info = build_library("constrained_solve")
        fn = lib.constrained_solve_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.constrained_solve_max_clusters.restype = ctypes.c_int
        lib.constrained_solve_max_clusters.argtypes = [ctypes.c_int] * 4
        lib.constrained_solve_static_smem.restype = ctypes.c_int
        lib.constrained_solve_static_smem.argtypes = [ctypes.c_int]
        static = [lib.constrained_solve_static_smem(k) for k in (0, 1)]
        if min(static) < 0:
            raise KernelError("cannot read constrained_solve's attributes")
        _static_bytes = max(static)
        last_build.update(info)
        builds += 1
        _lib = lib
        return lib


def constrained_solve_cuda(
    allocatable, requested, nzr, valid, pod_requests, pod_nzr,
    mask_rows, mask_index, active, spread, affinity, scoring,
    config: GreedyConfig = GreedyConfig(), rows: Optional[Rows] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K2 on the current stream (no synchronize). Every operand
    must already be on the card with the packers' dtypes: int32 state,
    counts and indices, bool masks, float32 score rows and
    preferred-affinity tensors. ``rows`` (None: every row) sets each
    family's live rows (live_rows). Returns fresh (assignment [B] int32,
    requested' [N, R], nzr' [N, 2]); the inputs are never written."""
    global launches, last_plan
    device = allocatable.device
    if device.type != "cuda":
        raise KernelError(
            f"constrained_solve_cuda needs CUDA tensors, got {device}"
        )
    if (len(spread), len(affinity), len(scoring)) != (
        _N_SPREAD, _N_AFFINITY, _N_SCORING
    ):
        raise KernelError("family tuples of the wrong length")
    n, r = allocatable.shape
    b = pod_requests.shape[0]
    u = mask_rows.shape[0]
    i32, f32, bl = torch.int32, torch.float32, torch.bool
    (sp_counts, sp_vvalid, sp_nv, sp_groups, sp_skew, sp_self,
     sp_match) = spread
    (af_nv, c_aff, key_aff, aff_rows, self_match, bump_aff,
     c_anti, key_anti, anti_rows, bump_anti,
     c_exist, key_exist, exist_match, bump_exist) = affinity
    (direct, nodeaff, taint, pod_sig, sel_counts, zone_onehot, zone_id,
     sel_group, sel_match, soft_counts, soft_nv, soft_groups, soft_match,
     ipa_nv, ipa_counts, ipa_wcounts, ipa_weight, ipa_match, ipa_bump,
     weights) = scoring
    g_sp_rows, v_sp = sp_counts.shape
    c_sp = sp_groups.shape[1]
    k = af_nv.shape[0]
    ra_rows, v_aff = c_aff.shape
    c_aff_slots = aff_rows.shape[1]
    rt_rows, v_anti = c_anti.shape
    c_anti_slots = anti_rows.shape[1]
    re_rows, v_exist = c_exist.shape
    s = direct.shape[0]
    z = zone_onehot.shape[1]
    gs_rows = sel_counts.shape[0]
    gt_rows, v_soft = soft_counts.shape
    c_soft = soft_groups.shape[1]
    rp_rows, v_ipa = ipa_counts.shape
    full = Rows(g_sp_rows, ra_rows, rt_rows, re_rows, gt_rows, rp_rows,
                gs_rows)
    live = full if rows is None else Rows(
        *(min(int(c), f) for c, f in zip(rows, full))
    )
    if max(c_sp, c_aff_slots, c_anti_slots, c_soft) > _MAX_SLOTS:
        raise KernelError(f"more than {_MAX_SLOTS} slots per pod")
    if max(live.g_sp, live.gt) > _MAX_GROUPS or live.g_sel > _MAX_SEL_GROUPS:
        raise KernelError(f"group counts beyond what K2 holds: {live}")
    if not 1 <= z <= _MAX_ZONES:
        raise KernelError(f"{z} zones: K2 holds 1 to {_MAX_ZONES}")
    if max(live.ra, live.rt) > _RA or live.re > _RE or live.rp > _RP:
        raise KernelError(f"row counts beyond the packer maxima: {live}")

    def chk(t, name, dtype, shape):
        return check_tensor(t, name, dtype, shape, device)

    empty = b == 0 or n == 0 or u == 0
    lib = plan = None
    if not empty:
        lib = build()
        with torch.cuda.device(device):
            plan = _plan(lib, n, r)
    copies = 1 if plan is None else plan.cluster

    # the value-space count tensors are replayed into fresh copies of the
    # live rows, one per CTA; SelectorSpread's node-space counts into one
    def scratch(t, name, dtype, shape, count, per_cta=True):
        head = chk(t, name, dtype, shape)[:count]
        if not per_cta:
            return head.clone()
        return head.unsqueeze(0).repeat(copies, 1, 1)

    operands = [
        chk(allocatable, "allocatable", i32, (n, r)),
        chk(requested, "requested", i32, (n, r)),
        chk(nzr, "nzr", i32, (n, 2)),
        chk(valid, "valid", bl, (n,)),
        chk(pod_requests, "pod_requests", i32, (b, r)),
        chk(pod_nzr, "pod_nzr", i32, (b, 2)),
        chk(mask_rows, "mask_rows", bl, (u, n)),
        chk(mask_index, "mask_index", i32, (b,)),
        chk(active, "active", bl, (b,)),
        scratch(sp_counts, "sp_counts", i32, (g_sp_rows, v_sp), live.g_sp),
        chk(sp_vvalid, "sp_value_valid", bl, (g_sp_rows, v_sp)),
        chk(sp_nv, "sp_node_value", i32, (g_sp_rows, n)),
        chk(sp_groups, "sp_pod_groups", i32, (b, c_sp)),
        chk(sp_skew, "sp_pod_max_skew", i32, (b, c_sp)),
        chk(sp_self, "sp_pod_self", i32, (b, c_sp)),
        chk(sp_match, "sp_pod_match", i32, (b, g_sp_rows)),
        chk(af_nv, "af_node_value", i32, (k, n)),
        scratch(c_aff, "af_counts_aff", i32, (ra_rows, v_aff), live.ra),
        chk(key_aff, "af_row_key_aff", i32, (ra_rows,)),
        chk(aff_rows, "af_pod_aff_rows", i32, (b, c_aff_slots)),
        chk(self_match, "af_pod_self_match", bl, (b,)),
        chk(bump_aff, "af_pod_bump_aff", i32, (b, ra_rows)),
        scratch(c_anti, "af_counts_anti", i32, (rt_rows, v_anti), live.rt),
        chk(key_anti, "af_row_key_anti", i32, (rt_rows,)),
        chk(anti_rows, "af_pod_anti_rows", i32, (b, c_anti_slots)),
        chk(bump_anti, "af_pod_bump_anti", i32, (b, rt_rows)),
        scratch(
            c_exist, "af_counts_exist", i32, (re_rows, v_exist), live.re
        ),
        chk(key_exist, "af_row_key_exist", i32, (re_rows,)),
        chk(exist_match, "af_pod_exist_match", bl, (b, re_rows)),
        chk(bump_exist, "af_pod_bump_exist", i32, (b, re_rows)),
        chk(direct, "sc_direct", f32, (s, n)),
        chk(nodeaff, "sc_nodeaff", i32, (s, n)),
        chk(taint, "sc_taint", i32, (s, n)),
        chk(pod_sig, "sc_pod_sig", i32, (b,)),
        scratch(
            sel_counts, "sc_sel_counts", i32, (gs_rows, n), live.g_sel,
            per_cta=False,
        ),
        chk(zone_id, "sc_zone_id", i32, (n,)),
        chk(sel_group, "sc_pod_sel_group", i32, (b,)),
        chk(sel_match, "sc_pod_sel_match", i32, (b, gs_rows)),
        scratch(
            soft_counts, "sc_soft_counts", i32, (gt_rows, v_soft), live.gt
        ),
        chk(soft_nv, "sc_soft_node_value", i32, (gt_rows, n)),
        chk(soft_groups, "sc_pod_soft_groups", i32, (b, c_soft)),
        chk(soft_match, "sc_pod_soft_match", i32, (b, gt_rows)),
        chk(ipa_nv, "sc_ipa_node_value", i32, (rp_rows, n)),
        scratch(ipa_counts, "sc_ipa_counts", f32, (rp_rows, v_ipa), live.rp),
        scratch(
            ipa_wcounts, "sc_ipa_wcounts", f32, (rp_rows, v_ipa), live.rp
        ),
        chk(ipa_weight, "sc_pod_ipa_weight", f32, (b, rp_rows)),
        chk(ipa_match, "sc_pod_ipa_match", f32, (b, rp_rows)),
        chk(ipa_bump, "sc_pod_ipa_bump", f32, (b, rp_rows)),
        chk(weights, "sc_weights", f32, (5,)),
    ]
    chk(zone_onehot, "sc_zone_onehot", bl, (n, z))
    asg = torch.empty(b, dtype=i32, device=device)
    req_out = torch.empty((n, r), dtype=i32, device=device)
    nzr_out = torch.empty((n, 2), dtype=i32, device=device)
    if empty:
        asg.fill_(-1)
        req_out.copy_(requested)
        nzr_out.copy_(nzr)
        return asg, req_out, nzr_out
    operands += [
        asg, req_out, nzr_out,
        # each row's pass-1 results on the streaming side
        torch.empty(n, dtype=torch.uint8, device=device),  # flags
        torch.empty(n, dtype=i32, device=device),  # soft raw
        torch.empty(n, dtype=f32, device=device),  # preferred-affinity raw
    ]
    dims = [
        n, r, b, u, s, z,
        int(config.least_allocated_weight),
        int(config.balanced_allocation_weight),
        int(config.most_allocated_weight),
        live.g_sp, v_sp, c_sp, g_sp_rows,
        k, live.ra, v_aff, c_aff_slots, ra_rows,
        live.rt, v_anti, c_anti_slots, rt_rows,
        live.re, v_exist, re_rows,
        live.g_sel, gs_rows,
        live.gt, v_soft, c_soft, gt_rows,
        live.rp, v_ipa, rp_rows,
    ]
    ptr_arr = (ctypes.c_void_p * len(operands))(
        *(t.data_ptr() for t in operands)
    )
    dim_arr = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        # the card's own time of this launch, while a traced dispatch
        # collects it: an event pair around the kernel alone
        timed = flightrecorder.launch_begin()
        err = lib.constrained_solve_launch(
            ptr_arr, len(operands), dim_arr, len(dims),
            plan.cluster, plan.threads, int(plan.resident), plan.smem_bytes,
            stream,
        )
        if timed is not None:
            flightrecorder.launch_end(timed, "K2")
    if err != 0:
        raise KernelError(
            f"constrained_solve_kernel launch failed: cudaError {err}"
        )
    launches += 1
    last_plan = plan
    return asg, req_out, nzr_out


def _plan(lib, n: int, r: int) -> LaunchPlan:
    """The plan at the largest cluster the current card admits."""
    return choose_plan(
        lambda c: plan_for(n, r, c, _static_bytes),
        card_admits(lib.constrained_solve_max_clusters, _admitted, torch.cuda.current_device()),
    )


def constrained_solve(
    allocatable, requested, nzr, valid, pod_requests, pod_nzr,
    mask_rows, mask_index, active, spread, affinity, scoring,
    config: GreedyConfig = GreedyConfig(), rows: Optional[Rows] = None,
):
    """The constrained solve: K2 (at ``rows``, the families' live_rows;
    None: every row) for tensors on the card, the plain version (on
    every row, which gives the same answer) for tensors on the CPU, an
    error otherwise."""
    kind = allocatable.device.type
    if kind == "cuda":
        return constrained_solve_cuda(
            allocatable, requested, nzr, valid, pod_requests, pod_nzr,
            mask_rows, mask_index, active, spread, affinity, scoring,
            config=config, rows=rows,
        )
    if kind == "cpu":
        return greedy_assign_constrained(
            allocatable, requested, nzr, valid, pod_requests, pod_nzr,
            mask_rows, mask_index, active, spread, affinity, scoring,
            config=config,
        )
    raise KernelError(f"no constrained solver for device type {kind!r}")
