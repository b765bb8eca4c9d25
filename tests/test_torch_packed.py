"""The port's packed upload and resident carry against the JAX package's.

``solve_packed`` of both packages runs on identical piece lists -- the
cold, refresh and steady layouts the scheduler dispatches, row patches
with padding slots, and the int16 compressed carry -- and every output
(assignment, requested', nzr', allocatable, valid) is compared bit for
bit. So are the carry ops around the solve: the buffer unpack (int16
'h' pieces of odd length holding negative values, float bitcasts,
const pieces), ``apply_assignment_delta`` with NO_NODE slots,
compress/decompress, and the carry-audit checksum on values that wrap.
All of it is integer (or bit-exact float) state: the tolerance is zero.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubernetes_tpu.ops import assignment as jax_asg
from kubernetes_tpu.scheduler import batch as jax_batch
from kubernetes_tpu_torch.ops import assignment as torch_asg
from kubernetes_tpu_torch.scheduler import batch as torch_batch

N, R, B, U = 75, 5, 64, 8  # odd N * R: the int16 carry packs an odd count


def _state(seed):
    rng = np.random.default_rng(seed)
    alloc = np.zeros((N, R), np.int32)
    alloc[:, 0] = rng.choice([2000, 4000, 8000], N)
    alloc[:, 1] = rng.choice([4, 8, 16], N) * 1024
    alloc[:, 3] = rng.choice([3, 40, 110], N)
    alloc[:, 4] = rng.choice([0, 4], N)
    valid = rng.random(N) > 0.1
    req = np.zeros_like(alloc)
    req[:, 0] = rng.integers(0, 2000, N)
    req[:, 1] = rng.integers(0, 4096, N)
    req[:, 3] = rng.integers(0, 3, N)
    nzr = np.stack([req[:, 0], req[:, 1] + 100], axis=1).astype(np.int32)
    return alloc, valid, req, nzr


def _batch(seed):
    rng = np.random.default_rng(seed + 100)
    pod_req = np.zeros((B, R), np.int32)
    pod_req[:, 0] = rng.choice([0, 100, 250, 500], B)
    pod_req[:, 1] = rng.choice([0, 64, 128], B)
    pod_req[:, 3] = 1
    pod_req[:, 4] = rng.choice([0, 0, 1], B)
    pod_nzr = np.maximum(pod_req[:, :2], [100, 200]).astype(np.int32)
    midx = rng.integers(0, U, B).astype(np.int32)
    active = (rng.random(B) > 0.1).astype(np.int32)
    rows = (rng.random((U, N)) > 0.2).astype(np.int32)
    return [
        ("req", pod_req), ("nzr", pod_nzr), ("midx", midx),
        ("active", active), ("rows", rows),
    ]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _assert_outputs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def _solve_both(pieces, jax_in, torch_in, compress=False):
    want = jax_asg.solve_packed(
        pieces, *jax_in, config=jax_asg.GreedyConfig(), compress=compress
    )
    got = torch_asg.solve_packed(
        pieces, *torch_in, config=torch_asg.GreedyConfig(),
        compress=compress, device="cpu",
    )
    _assert_outputs_equal(got, want)
    return want, got


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_cold_refresh_steady_layouts(seed, compress):
    alloc, valid, req, nzr = _state(seed)
    dt = np.int16 if compress else np.int32
    static = [("alloc", alloc), ("valid", valid.astype(np.int32))]
    carry = [("req_state", req.astype(dt)), ("nzr_state", nzr.astype(dt))]
    # cold: static + carry ride the buffer
    w, g = _solve_both(
        _batch(seed) + static + carry, (None,) * 4, (None,) * 4, compress
    )
    j_alloc, j_valid, t_alloc, t_valid = w[3], w[4], g[3], g[4]
    # refresh: the resident alloc/valid, a fresh carry
    w, g = _solve_both(
        _batch(seed + 1) + carry,
        (j_alloc, j_valid, None, None), (t_alloc, t_valid, None, None),
        compress,
    )
    # steady: the resident carry plus the delta-scatter slots
    slots = torch_batch._delta_slot_pieces(N, R, compress=compress)
    w, g = _solve_both(
        _batch(seed + 2) + slots,
        (j_alloc, j_valid, w[1], w[2]), (t_alloc, t_valid, g[1], g[2]),
        compress,
    )
    assert (_np(w[0]) >= 0).any()


@pytest.mark.parametrize("compress", [False, True])
def test_steady_row_patches_with_padding_slots(compress):
    """didx/sidx patches (membership churn flips valid too) ride the
    buffer; unused slots carry index N and must drop, not wrap."""
    alloc, valid, req, nzr = _state(4)
    dt = np.int16 if compress else np.int32
    w, g = _solve_both(
        _batch(4) + [("alloc", alloc), ("valid", valid.astype(np.int32)),
                     ("req_state", req.astype(dt)),
                     ("nzr_state", nzr.astype(dt))],
        (None,) * 4, (None,) * 4, compress,
    )
    host_req = req.copy()
    host_req[[0, 7, N - 1]] += 11
    host_nzr = nzr.copy()
    host_nzr[[0, 7, N - 1]] += 3
    new_alloc = alloc.copy()
    new_alloc[[2, N - 1]] *= 2
    new_valid = valid.copy()
    new_valid[[2, N - 1]] = [False, True]
    slots = jax_batch._delta_slot_pieces(
        N, R, fix_rows=np.array([0, 7, N - 1]),
        alloc_rows=np.array([2, N - 1]),
        node_requested=host_req, node_nzr=host_nzr,
        allocatable=new_alloc, valid=new_valid, compress=compress,
    )
    assert (slots[0][1] == N).sum() > 0  # padding slots present
    w2, g2 = _solve_both(
        _batch(5) + slots, (w[3], w[4], w[1], w[2]),
        (g[3], g[4], g[1], g[2]), compress,
    )
    np.testing.assert_array_equal(_np(g2[3]), new_alloc)
    np.testing.assert_array_equal(_np(g2[4]), new_valid)


def test_unpack_buffer_kinds():
    """'h' pieces of odd length with negative values sign-extend both
    halves; 'f' bitcasts; 'b' and the const pieces restore dtypes."""
    rng = np.random.default_rng(3)
    h_odd = rng.integers(-32768, 32768, (3, 5)).astype(np.int16)
    h_odd.flat[[0, 1, 14]] = [-1, -32768, 32767]
    h_one = np.array([-2], np.int16)
    f = rng.standard_normal((4, 3)).astype(np.float32)
    b = rng.random(7) > 0.5
    i = rng.integers(-(1 << 31), (1 << 31) - 1, 9).astype(np.int32)
    pieces = [
        ("h_odd", h_odd), ("f", f), ("b", b), ("i", i), ("h_one", h_one),
        ("zi", torch_asg.ConstPiece((2, 3), np.int32, -1)),
        ("zf", torch_asg.ConstPiece((2,), np.float32, 0.5)),
        ("zb", torch_asg.ConstPiece((4,), np.bool_, True)),
    ]
    layout = tuple(
        (name, a.shape, torch_asg._piece_kind(a)) for name, a in pieces
    )
    buf = np.concatenate([
        torch_asg._as_i32(a).ravel() for _, a in pieces
        if not isinstance(a, torch_asg.ConstPiece)
    ])
    want = jax_asg._unpack_buffer(jnp.asarray(buf), layout)
    got = torch_asg._unpack_buffer(torch.from_numpy(buf), layout)
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(got["h_odd"].numpy(), h_odd.astype(np.int32))
    np.testing.assert_array_equal(got["f"].numpy(), f)


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
def test_apply_assignment_delta_drops_no_node(dtype):
    _alloc, _valid, req, nzr = _state(6)
    rng = np.random.default_rng(6)
    asg = rng.integers(-1, N, B).astype(np.int32)
    asg[:5] = -1
    asg[5] = N - 1
    pod = _batch(6)
    want = jax_asg.apply_assignment_delta(
        jnp.asarray(req.astype(dtype)), jnp.asarray(nzr.astype(dtype)),
        asg, pod[0][1], pod[1][1],
    )
    got = torch_asg.apply_assignment_delta(
        torch.from_numpy(req.astype(dtype)),
        torch.from_numpy(nzr.astype(dtype)), asg, pod[0][1], pod[1][1],
    )
    _assert_outputs_equal(got, want)


def test_compress_decompress_roundtrip():
    _alloc, _valid, req, nzr = _state(7)
    req[0, 0] = 24576
    want = jax_asg.compress_carry(jnp.asarray(req), jnp.asarray(nzr))
    got = torch_asg.compress_carry(torch.from_numpy(req), torch.from_numpy(nzr))
    _assert_outputs_equal(got, want)
    _assert_outputs_equal(
        torch_asg.decompress_carry(*got),
        jax_asg.decompress_carry(*want),
    )


@pytest.mark.parametrize("shape", [(300, 4), (257,), (64, 2)])
def test_audit_checksum_wraps_like_the_host(shape):
    """Sums and row-weighted sums far past 2^31 wrap exactly as numpy's
    int32 does, on the device twin of both packages."""
    rng = np.random.default_rng(len(shape))
    arr = rng.integers((1 << 31) - 5000, (1 << 31) - 1, shape).astype(np.int32)
    arr.flat[::7] = -(1 << 31)
    host = jax_batch._audit_checksum_host(arr)
    dev = torch_batch._audit_checksum_dev(torch.from_numpy(arr))
    assert (int(dev[0]), int(dev[1])) == host
    assert torch_batch._audit_checksum_host(arr) == host
    j = jax_batch._audit_checksum_dev(jnp.asarray(arr))
    assert (int(j[0]), int(j[1])) == host


def test_audit_checksum_bool_and_int16():
    valid = np.random.default_rng(1).random(130) > 0.3
    assert tuple(
        int(x) for x in torch_batch._audit_checksum_dev(torch.from_numpy(valid))
    ) == jax_batch._audit_checksum_host(valid)
    req16 = np.random.default_rng(2).integers(-300, 300, (50, 3)).astype(
        np.int16
    )
    assert tuple(
        int(x) for x in torch_batch._audit_checksum_dev(torch.from_numpy(req16))
    ) == jax_batch._audit_checksum_host(req16)


def test_carry_from_numpy_feeds_the_same_solve():
    """The JAX package's resident carry, handed over through
    carry_from_numpy, solves to the same outputs on the port."""
    alloc, valid, req, nzr = _state(8)
    jcfg = jax_asg.GreedyConfig(0, 0, 1)
    (t_alloc, t_valid, t_req, t_nzr), tcfg = torch_asg.carry_from_numpy(
        jnp.asarray(alloc), jnp.asarray(valid), jnp.asarray(req),
        jnp.asarray(nzr), jcfg, "cpu",
    )
    assert tcfg == torch_asg.GreedyConfig(0, 0, 1)
    assert t_req.dtype == torch.int32 and t_valid.dtype == torch.bool
    pieces = _batch(8)
    want = jax_asg.solve_packed(
        pieces, jnp.asarray(alloc), jnp.asarray(valid), jnp.asarray(req),
        jnp.asarray(nzr), config=jcfg,
    )
    got = torch_asg.solve_packed(
        pieces, t_alloc, t_valid, t_req, t_nzr, config=tcfg, device="cpu"
    )
    _assert_outputs_equal(got, want)


def test_solve_packed_rejects_unported_modes():
    with pytest.raises(ValueError, match="later slice"):
        torch_asg.solve_packed(
            _batch(0), None, None, None, None, mode="constrained",
            device="cpu",
        )
