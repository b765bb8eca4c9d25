"""The node-sharded mesh: node rows split over an ordered list of devices.

The counterpart of the JAX package's ``jax.sharding.Mesh`` with a
"nodes" axis and the ``NamedSharding`` specs it shards the resident
node state with (``scheduler/batch.py:544-550``,
``ops/assignment.py:713-715``). As there, the mesh is ONE process
driving every shard: no ``torch.distributed``, no NCCL. A device may
repeat, so ``NodeMesh(["cuda:0"] * 4)`` runs four shards on one card --
the analogue of the JAX tests' virtual CPU devices -- and
``NodeMesh(["cpu"] * 2)`` is the tests' CPU mesh.

Shard k holds the node rows ``bounds[k] = (lo, hi)``: P contiguous
ranges in order, the first ``N % P`` one row longer (ragged splits are
allowed; global order is kept, so the best-of-shards combine stays
exact).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.device import resolve_device


def canonical_device(device=None) -> torch.device:
    """``resolve_device(device)`` with one name per device: ``"cuda"``
    becomes the current card's ``"cuda:<index>"`` and ``"cpu:0"``
    becomes ``"cpu"``, so two names of one device compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cpu":
        return torch.device("cpu")
    return dev


def solve_device(device, mesh) -> torch.device:
    """A scheduler's solve device: ``resolve_device(device)`` off a mesh;
    on a mesh its first device, where ``device`` must be None or name
    that same device."""
    if mesh is None:
        return resolve_device(device)
    if not isinstance(mesh, NodeMesh):
        raise TypeError(f"mesh must be a NodeMesh, got {type(mesh)!r}")
    if device is not None and canonical_device(device) != mesh.first:
        raise ValueError(
            f"device {device!r} is not the mesh's first device {mesh.first}"
        )
    return mesh.first


class NodeMesh:
    """An ordered list of torch devices, one per node shard, each named
    by ``canonical_device``. Devices on the card are checked at
    construction (a missing card raises)."""

    def __init__(self, devices: Sequence) -> None:
        devs = tuple(canonical_device(d) for d in devices)
        if not devs:
            raise ValueError("a NodeMesh needs at least one device")
        kinds = {d.type for d in devs}
        if len(kinds) != 1:
            raise ValueError(f"a NodeMesh spans one device type, got {kinds}")
        self.devices = devs
        self._row_maps: dict = {}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    def __eq__(self, other) -> bool:
        return isinstance(other, NodeMesh) and other.devices == self.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return f"NodeMesh({[str(d) for d in self.devices]})"

    def bounds(self, n: int) -> List[Tuple[int, int]]:
        """The P contiguous row ranges of an N-row tensor, in order."""
        p = self.size
        base, extra = divmod(n, p)
        out, lo = [], 0
        for k in range(p):
            hi = lo + base + (1 if k < extra else 0)
            out.append((lo, hi))
            lo = hi
        return out

    def groups(self) -> List[Tuple[torch.device, List[int]]]:
        """(device, its shard indices in order), devices in first-use
        order: the shards one launch and one upload per device serve."""
        out: dict = {}
        for k, d in enumerate(self.devices):
            out.setdefault(d, []).append(k)
        return list(out.items())

    def row_map(self, n: int, device, ks: Sequence[int]) -> torch.Tensor:
        """[N + 1] int64 on ``device``: global node row -> the row of the
        working buffer of shards ``ks`` (one device's, stacked in shard
        order), and ``n_dev`` -- the buffer's scratch row -- for a row
        that lives elsewhere and for the "no node" index N. Cached."""
        key = (n, tuple(ks))
        cached = self._row_maps.get(key)
        if cached is not None:
            return cached
        bounds = self.bounds(n)
        n_dev = sum(bounds[k][1] - bounds[k][0] for k in ks)
        host = np.full(n + 1, n_dev, dtype=np.int64)
        off = 0
        for k in ks:
            lo, hi = bounds[k]
            host[lo:hi] = np.arange(off, off + hi - lo)
            off += hi - lo
        out = torch.from_numpy(host).to(device)
        self._row_maps[key] = out
        return out


class ShardedRows:
    """A logical ``[N, ...]`` tensor held as one tensor per shard of a
    NodeMesh, shard k on ``mesh.devices[k]`` holding rows
    ``mesh.bounds(N)[k]``. Immutable by convention: every operation
    returns a new instance (the resident carry is never written)."""

    __slots__ = ("mesh", "shards", "n")

    def __init__(self, mesh: NodeMesh, shards: Sequence[torch.Tensor]) -> None:
        if len(shards) != mesh.size:
            raise ValueError(
                f"{len(shards)} shards for a {mesh.size}-device mesh"
            )
        self.mesh = mesh
        self.shards = list(shards)
        self.n = sum(int(s.shape[0]) for s in self.shards)
        if [hi - lo for lo, hi in mesh.bounds(self.n)] != [
            int(s.shape[0]) for s in self.shards
        ]:
            raise ValueError("shard row counts do not match the mesh split")

    @classmethod
    def split(cls, mesh: NodeMesh, full) -> "ShardedRows":
        """Shard a full tensor or array by rows: one host->device copy
        per device of the rows its shards hold."""
        if not isinstance(full, torch.Tensor):
            full = torch.from_numpy(np.ascontiguousarray(full))
        bounds = mesh.bounds(int(full.shape[0]))
        shards: List = [None] * mesh.size
        for dev, ks in mesh.groups():
            # cat copies, so no shard aliases the caller's array
            block = torch.cat(
                [full[bounds[k][0]:bounds[k][1]] for k in ks]
            ).to(dev)
            off = 0
            for k in ks:
                m = bounds[k][1] - bounds[k][0]
                shards[k] = block[off:off + m]
                off += m
        return cls(mesh, shards)

    @property
    def bounds(self) -> List[Tuple[int, int]]:
        return self.mesh.bounds(self.n)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.n,) + tuple(self.shards[0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def gather(self, device=None) -> torch.Tensor:
        """The full tensor on one device (the mesh's first by default)."""
        dev = self.mesh.first if device is None else torch.device(device)
        return torch.cat([s.to(dev) for s in self.shards])

    def numpy(self) -> np.ndarray:
        return self.gather("cpu").numpy()

    def map(self, fn: Callable) -> "ShardedRows":
        """fn(shard) per shard; fn must keep each shard's row count."""
        return ShardedRows(self.mesh, [fn(s) for s in self.shards])

    def locate(self, row: int) -> Tuple[int, int]:
        """(shard, local row) of a global row."""
        for k, (lo, hi) in enumerate(self.bounds):
            if lo <= row < hi:
                return k, row - lo
        raise IndexError(f"row {row} outside [0, {self.n})")


def shard_local_row_set(state, idx, rows, lo: int, hi: int):
    """``shard_local_row_set`` of the JAX package for ONE shard holding
    global rows [lo, hi): slot j sets row ``idx[j] - lo`` to ``rows[j]``
    when ``lo <= idx[j] < hi``; every other slot (padding at index >= N,
    rows of other shards, negative indices) drops. When two slots name
    one row the FIRST wins, as the JAX version's argmax over a one-hot
    picks. Returns a new tensor; ``state`` is never written."""
    n = hi - lo
    idx = idx.long().to(state.device)
    rows = rows.to(state.device)
    k = idx.shape[0]
    local = idx - lo
    keep = (local >= 0) & (local < n)
    if k:
        same = idx[:, None] == idx[None, :]
        earlier = torch.ones(
            (k, k), dtype=torch.bool, device=state.device
        ).tril(-1)
        keep = keep & ~(same & earlier).any(dim=1)
    local = torch.where(keep, local, n)
    ext = torch.cat([state, state.new_zeros((1,) + tuple(state.shape[1:]))])
    ext[local] = rows.to(state.dtype)
    return ext[:n]
