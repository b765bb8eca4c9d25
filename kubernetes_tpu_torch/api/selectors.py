"""Label- and node-selector matching.

Reference semantics:
- labels.Selector  (staging/src/k8s.io/apimachinery/pkg/labels/selector.go)
- nodeaffinity matching (pkg/scheduler/framework/plugins/nodeaffinity/ and
  v1helper.MatchNodeSelectorTerms,
  pkg/apis/core/v1/helper/helpers.go)
"""

from __future__ import annotations

from typing import Dict, List, Optional

from kubernetes_tpu_torch.api.types import (
    LabelSelector,
    LabelSelectorRequirement,
    NodeSelector,
    NodeSelectorRequirement,
    NodeSelectorTerm,
)

try:  # native matcher (SURVEY section 2.4 host data plane)
    from kubernetes_tpu_torch.native import hotpath as _native
except Exception:  # noqa: BLE001 - pure-Python fallback
    _native = None

_OP_CODES = {"In": 0, "NotIn": 1, "Exists": 2, "DoesNotExist": 3}


def compile_selector(selector: LabelSelector):
    """Pre-compiled form for the native matcher, cached on the selector
    object (selectors are immutable once built, the same contract as
    every informer-cached object). Unknown operators compile to opcode
    -1 so the C path raises ValueError only when evaluation REACHES the
    bad requirement -- the exact short-circuit behavior of the Python
    path."""
    c = selector.__dict__.get("_compiled")
    if c is None:
        c = (
            selector.match_labels,
            tuple(
                (r.key, _OP_CODES.get(r.operator, -1), frozenset(r.values))
                for r in selector.match_expressions
            ),
        )
        selector.__dict__["_compiled"] = c
    return c


def _match_requirement(labels: Dict[str, str], req: LabelSelectorRequirement) -> bool:
    op = req.operator
    if op == "In":
        return req.key in labels and labels[req.key] in req.values
    if op == "NotIn":
        return req.key not in labels or labels[req.key] not in req.values
    if op == "Exists":
        return req.key in labels
    if op == "DoesNotExist":
        return req.key not in labels
    raise ValueError(f"unknown label selector operator {op!r}")


def labels_match_selector_py(
    labels: Dict[str, str], selector: Optional[LabelSelector]
) -> bool:
    """Pure-Python reference implementation (the native module's
    differential oracle)."""
    if selector is None:
        return False
    for k, v in selector.match_labels.items():
        if labels.get(k) != v:
            return False
    for req in selector.match_expressions:
        if not _match_requirement(labels, req):
            return False
    return True


def labels_match_selector(
    labels: Dict[str, str], selector: Optional[LabelSelector]
) -> bool:
    """True if ``labels`` match ``selector``. A nil selector matches nothing
    (reference metav1.LabelSelectorAsSelector returns labels.Nothing() for
    nil); an empty selector matches everything."""
    if selector is None:
        return False
    if _native is not None:
        return _native.match_compiled(labels, compile_selector(selector))
    return labels_match_selector_py(labels, selector)


def labels_match_mask(
    labels_list: List[Dict[str, str]], selector: LabelSelector
) -> bytes:
    """One byte (0/1) per labels dict -- the packers' inner loop over
    many pods against one selector, native when available."""
    if _native is not None:
        return _native.match_mask(labels_list, compile_selector(selector))
    return bytes(
        1 if labels_match_selector_py(labels, selector) else 0
        for labels in labels_list
    )


def label_selector_as_dict_matches(
    selector_labels: Dict[str, str], labels: Dict[str, str]
) -> bool:
    """Plain map-selector match (services/RCs): every selector kv present."""
    if _native is not None:
        return _native.dict_covers(labels, selector_labels)
    if not selector_labels:
        return False
    return all(labels.get(k) == v for k, v in selector_labels.items())


def _match_node_requirement(
    labels: Dict[str, str], req: NodeSelectorRequirement
) -> bool:
    op = req.operator
    if op == "In":
        return req.key in labels and labels[req.key] in req.values
    if op == "NotIn":
        return req.key not in labels or labels[req.key] not in req.values
    if op == "Exists":
        return req.key in labels
    if op == "DoesNotExist":
        return req.key not in labels
    if op in ("Gt", "Lt"):
        # Reference: helpers.go NodeSelectorRequirementsAsSelector converts
        # Gt/Lt with exactly one integer value; missing label => no match.
        if req.key not in labels or len(req.values) != 1:
            return False
        try:
            lhs = int(labels[req.key])
            rhs = int(req.values[0])
        except ValueError:
            return False
        return lhs > rhs if op == "Gt" else lhs < rhs
    raise ValueError(f"unknown node selector operator {op!r}")


def match_node_selector_term(
    node_labels: Dict[str, str],
    term: NodeSelectorTerm,
    node_fields: Optional[Dict[str, str]] = None,
) -> bool:
    """All matchExpressions (over labels) and matchFields (over e.g.
    metadata.name) in a single term must match. An empty term matches
    nothing (reference helpers.go MatchNodeSelectorTerms skips terms with
    no expressions and no fields)."""
    if not term.match_expressions and not term.match_fields:
        return False
    for req in term.match_expressions:
        if not _match_node_requirement(node_labels, req):
            return False
    if term.match_fields:
        fields = node_fields or {}
        for req in term.match_fields:
            if not _match_node_requirement(fields, req):
                return False
    return True


def node_matches_node_selector(
    node_labels: Dict[str, str],
    selector: Optional[NodeSelector],
    node_fields: Optional[Dict[str, str]] = None,
) -> bool:
    """Terms are ORed; requirements within a term are ANDed."""
    if selector is None:
        return True
    return any(
        match_node_selector_term(node_labels, term, node_fields)
        for term in selector.node_selector_terms
    )


def node_selector_dict_matches(
    node_selector: Dict[str, str], node_labels: Dict[str, str]
) -> bool:
    """pod.spec.nodeSelector: simple equality map, ANDed."""
    return all(node_labels.get(k) == v for k, v in node_selector.items())
