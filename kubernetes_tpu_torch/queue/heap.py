"""Keyed min-heap (reference pkg/scheduler/internal/heap/heap.go).

Ordered by a user-supplied ``less(a, b)`` function or -- the fast path --
a ``sort_key(obj)`` function returning a comparable tuple, with O(1)
lookup and O(log n) amortized update/delete by key. Backs both activeQ
and podBackoffQ.

Implementation: ``heapq`` (C) with lazy deletion. The reference's Go heap
sifts with interface calls; a Python translation of that sift dominated
the 10k-burst profile (every compare and swap is interpreter work), so
entries are pushed as ``[sort_key, seq, entry]`` lists that heapq compares
natively. Deletes/overwrites tombstone the entry; dead entries are
skipped at pop/peek and the array is compacted when more than half is
dead. ``seq`` makes ties FIFO and guarantees the comparison never reaches
the entry payload.

With ``less`` (arbitrary comparator, e.g. a custom QueueSort plugin) each
object is wrapped in a tiny ``__lt__`` adapter -- still faster than the
hand-written sift because heapq drives the loop in C.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Any, Callable, List, Optional


class Heap:
    def __init__(
        self,
        key_func: Callable[[Any], str],
        less: Optional[Callable[[Any, Any], bool]] = None,
        sort_key: Optional[Callable[[Any], Any]] = None,
    ):
        if less is None and sort_key is None:
            raise ValueError("need less or sort_key")
        self._key = key_func
        # native sort keys (comparable tuples) make bulk drains a single
        # C-level sort; the less-adapter path keeps the per-pop loop
        self._native_keys = sort_key is not None
        if sort_key is not None:
            self._sort_key = sort_key
        else:
            class _LessAdapter:
                __slots__ = ("obj",)

                def __init__(self, obj: Any) -> None:
                    self.obj = obj

                def __lt__(self, other: "_LessAdapter") -> bool:
                    return less(self.obj, other.obj)

            self._sort_key = _LessAdapter
        self._heap: List[List[Any]] = []  # [sort_key, seq, entry]
        # key -> entry; entry = [obj, alive]
        self._entries = {}
        self._seq = itertools.count()
        self._dead = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def get_by_key(self, key: str) -> Optional[Any]:
        entry = self._entries.get(key)
        return entry[0] if entry is not None else None

    def add(self, obj: Any) -> None:
        """Insert or overwrite-and-reheapify (reference heap.go Add)."""
        key = self._key(obj)
        old = self._entries.get(key)
        if old is not None:
            old[1] = False
            self._dead += 1
        entry = [obj, True]
        self._entries[key] = entry
        heapq.heappush(
            self._heap, [self._sort_key(obj), next(self._seq), entry]
        )
        self._maybe_compact()

    def add_bulk(
        self,
        objs: List[Any],
        keys: Optional[List[str]] = None,
        sort_keys: Optional[List[Any]] = None,
    ) -> None:
        """Insert many objects under one structural pass -- the bulk
        apiserver->queue ingest path. Semantics per object are exactly
        ``add`` (later duplicates tombstone earlier ones), but the heap
        work batches: when the new items rival the live heap in size, one
        ``extend`` + C-level ``heapify`` replaces N pushes. ``keys`` /
        ``sort_keys``, when precomputed by the caller (the native
        queue_shape pass), skip the per-object key/sort-key calls."""
        if not objs:
            return
        if keys is None:
            key_f = self._key
            keys = [key_f(o) for o in objs]
        if sort_keys is None:
            sk = self._sort_key
            sort_keys = [sk(o) for o in objs]
        entries = self._entries
        heap = self._heap
        seq = self._seq
        new_items = []
        for obj, key, skey in zip(objs, keys, sort_keys):
            old = entries.get(key)
            if old is not None:
                old[1] = False
                self._dead += 1
            entry = [obj, True]
            entries[key] = entry
            new_items.append([skey, next(seq), entry])
        if len(new_items) * 4 >= len(heap):
            heap.extend(new_items)
            heapq.heapify(heap)
        else:
            push = heapq.heappush
            for item in new_items:
                push(heap, item)
        self._maybe_compact()

    def add_if_not_present(self, obj: Any) -> None:
        if self._key(obj) not in self._entries:
            self.add(obj)

    def update(self, obj: Any) -> None:
        self.add(obj)

    def delete(self, obj: Any) -> None:
        self.delete_by_key(self._key(obj))

    def delete_by_key(self, key: str) -> None:
        entry = self._entries.pop(key, None)
        if entry is None:
            return
        entry[1] = False
        self._dead += 1
        self._maybe_compact()

    def _drop_dead_top(self) -> None:
        heap = self._heap
        while heap and not heap[0][2][1]:
            heapq.heappop(heap)
            self._dead -= 1

    def peek(self) -> Optional[Any]:
        self._drop_dead_top()
        return self._heap[0][2][0] if self._heap else None

    def pop(self) -> Any:
        self._drop_dead_top()
        if not self._heap:
            raise IndexError("heap is empty")
        item = heapq.heappop(self._heap)
        obj = item[2][0]
        del self._entries[self._key(obj)]
        return obj

    def pop_bulk(self, max_n: int) -> List[Any]:
        """Remove and return up to ``max_n`` live objects in exact pop
        order -- the bulk drain behind ``PriorityQueue.pop_batch``.

        With native sort keys one C-level ``sorted`` over the
        ``[key, seq, entry]`` items replaces max_n heappops (each of
        which pays O(log n) plus interpreter-level dead-entry and dict
        bookkeeping per call); the unique ``seq`` makes the order total,
        so sorted order IS heappop order. The sorted remainder satisfies
        the heap invariant and becomes the new heap directly, and dead
        entries crossed on the way out are dropped -- compaction rides
        the drain for free. Small drains from a much larger heap keep
        the heappop loop (k log n beats a full n log n sort there), and
        the arbitrary-``less`` adapter path always uses it: comparator
        ties make sort-vs-heappop order implementation-defined, and the
        pop loop is the contract."""
        if max_n <= 0 or not self._entries:
            return []
        out: List[Any] = []
        entries = self._entries
        key = self._key
        if not self._native_keys or max_n * 8 < len(self._heap):
            heap = self._heap
            pop = heapq.heappop
            while heap and len(out) < max_n:
                entry = pop(heap)[2]
                if entry[1]:
                    obj = entry[0]
                    del entries[key(obj)]
                    out.append(obj)
                else:
                    self._dead -= 1
            return out
        items = sorted(self._heap)
        i = 0
        n = len(items)
        while i < n and len(out) < max_n:
            entry = items[i][2]
            i += 1
            if entry[1]:
                obj = entry[0]
                del entries[key(obj)]
                out.append(obj)
            else:
                self._dead -= 1
        self._heap = items[i:]
        return out

    def list(self) -> List[Any]:
        return [entry[0] for entry in self._entries.values()]

    def _maybe_compact(self) -> None:
        if self._dead > 64 and self._dead * 2 > len(self._heap):
            live = [item for item in self._heap if item[2][1]]
            heapq.heapify(live)
            self._heap = live
            self._dead = 0
