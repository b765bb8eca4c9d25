"""Host-side string -> int encodings for device-pure-numeric state.

The reference matches labels/selectors as strings inside its per-node hot
loops (e.g. interpodaffinity/filtering.go:256 over all nodes x all pods).
On TPU strings don't exist: every label key/value and topology value is
interned to a dense int id on the host, and the device only ever sees int
tensors (SURVEY.md section 7, "hardest parts (c)").
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class StringInterner:
    """Stable string -> dense-int interning. Id 0 is reserved for
    "absent" so zero-initialized tensors mean "no value"."""

    ABSENT = 0

    def __init__(self) -> None:
        self._ids: Dict[str, int] = {}
        self._strings: List[str] = ["\x00absent"]

    def intern(self, s: str) -> int:
        i = self._ids.get(s)
        if i is None:
            i = len(self._strings)
            self._ids[s] = i
            self._strings.append(s)
        return i

    def lookup(self, s: str) -> int:
        """Like intern but returns ABSENT for unknown strings."""
        return self._ids.get(s, self.ABSENT)

    def string(self, i: int) -> str:
        return self._strings[i]

    def __len__(self) -> int:
        return len(self._strings)


class TopologyEncoder:
    """Per-topology-key interning of node label values.

    Produces, for a set of registered topology keys (e.g. ``zone``,
    ``kubernetes.io/hostname``), a ``[N, K]`` int32 matrix of interned
    label values (ABSENT=0 when the node lacks the key). Keys are
    registered lazily as pod constraints reference them; adding a key
    invalidates packed columns, so the cache tracks a key-set version.
    """

    def __init__(self) -> None:
        self.keys: List[str] = []
        self._key_index: Dict[str, int] = {}
        self._value_interners: List[StringInterner] = []
        self.version = 0

    def register_key(self, key: str) -> int:
        idx = self._key_index.get(key)
        if idx is None:
            idx = len(self.keys)
            self._key_index[key] = idx
            self.keys.append(key)
            self._value_interners.append(StringInterner())
            self.version += 1
        return idx

    def key_index(self, key: str) -> Optional[int]:
        return self._key_index.get(key)

    def encode_value(self, key_idx: int, value: str) -> int:
        return self._value_interners[key_idx].intern(value)

    def num_values(self, key_idx: int) -> int:
        return len(self._value_interners[key_idx])

    def encode_node_labels(self, labels: Dict[str, str]) -> np.ndarray:
        """[K] int32 row of interned topology values for one node."""
        row = np.zeros(len(self.keys), dtype=np.int32)
        for i, key in enumerate(self.keys):
            v = labels.get(key)
            if v is not None:
                row[i] = self._value_interners[i].intern(v)
        return row
