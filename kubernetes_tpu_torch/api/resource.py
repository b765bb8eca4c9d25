"""Kubernetes resource-quantity parsing.

Semantics follow apimachinery's ``resource.Quantity``
(/root/reference/staging/src/k8s.io/apimachinery/pkg/api/resource/quantity.go):
decimal SI suffixes (k, M, G, T, P, E, and m for milli), binary suffixes
(Ki, Mi, Gi, Ti, Pi, Ei), scientific notation, and plain decimals.

The scheduler never needs arbitrary-precision arithmetic; it works in two
fixed integer units (reference nodeinfo.Resource,
/root/reference/pkg/scheduler/nodeinfo/node_info.go:143):

- CPU     -> integer milliCPU  (``parse_cpu``)
- memory / ephemeral-storage / extended resources -> integer base units
  (``parse_memory`` / ``parse_quantity``)
"""

from __future__ import annotations

_BINARY_SUFFIXES = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}

_DECIMAL_SUFFIXES = {
    "n": 1e-9,
    "u": 1e-6,
    "m": 1e-3,
    "": 1.0,
    "k": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
    "P": 1e15,
    "E": 1e18,
}


def parse_quantity(value: "str | int | float") -> float:
    """Parse a quantity string into a float of base units.

    Accepts ints/floats unchanged (already base units).
    """
    if isinstance(value, (int, float)):
        return float(value)
    s = value.strip()
    if not s:
        raise ValueError("empty quantity")
    for suffix, mult in _BINARY_SUFFIXES.items():
        if s.endswith(suffix):
            return float(s[: -len(suffix)]) * mult
    # Decimal suffixes: longest-match not needed, all are single char; but be
    # careful with scientific notation ("1e3" -- trailing digit, no suffix).
    last = s[-1]
    if last in _DECIMAL_SUFFIXES and not last.isdigit() and last != ".":
        head = s[:-1]
        # "12E3" is scientific notation only if the remainder parses with it;
        # Kubernetes treats a trailing E as exa when head is a bare number and
        # "12E3"-style strings as scientific. Try scientific first.
        if last in ("E", "e"):
            try:
                return float(s)
            except ValueError:
                pass
        return float(head) * _DECIMAL_SUFFIXES[last]
    return float(s)


def parse_cpu(value: "str | int | float") -> int:
    """Parse a CPU quantity into integer milliCPU (``"1"`` -> 1000,
    ``"100m"`` -> 100, ``0.5`` -> 500)."""
    return int(round(parse_quantity(value) * 1000))


def parse_memory(value: "str | int | float") -> int:
    """Parse a memory/storage quantity into integer bytes."""
    return int(round(parse_quantity(value)))


def format_cpu(milli: int) -> str:
    if milli % 1000 == 0:
        return str(milli // 1000)
    return f"{milli}m"


def format_memory(b: int) -> str:
    for suffix in ("Ei", "Pi", "Ti", "Gi", "Mi", "Ki"):
        mult = _BINARY_SUFFIXES[suffix]
        if b >= mult and b % mult == 0:
            return f"{b // mult}{suffix}"
    return str(b)
