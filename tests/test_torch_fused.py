"""Torch port: the fused serving evaluation (online/fused.py) against the
JAX package's fused arena kernel, on the CPU.

The port's plain version ``arena_eval_torch`` runs here; the JAX side
runs ``arena_eval_xla`` and the Pallas kernel ``arena_eval_fused`` in
interpret mode (how tests/test_pallas_fused.py runs it on the CPU), on
the same buffers: the port's arena layout is the JAX ``pack_columns``
layout with its TPU padding cut away (vertex rows and contraction
width to p+1, control lanes to n_u), so the port's buffers are slices
of the JAX ones.

Tolerances: leaf column, served and clamped flags exact (the queries
are tie-free: disjoint simplices, or random points whose best score
clears the runner-up); val/u/cost to 1e-5 absolute -- all three
evaluate the same float32 products, summed in different orders.
"""

import numpy as np
import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp
from explicit_hybrid_mpc_tpu.online import pallas_eval
from explicit_hybrid_mpc_tpu_torch.online import export, fused
from explicit_hybrid_mpc_tpu_torch.partition import geometry

torch.set_num_threads(1)

P, N_U = 2, 2
PP1 = P + 1
_BOX = (np.zeros(P), np.full(P, 8.0))


def _synthetic_table(rng, L=40, n_u=N_U):
    """Disjoint unit-grid simplices (tests/test_pallas_fused.py's
    construction): each simplex uniquely contains its own centroid."""
    base = np.vstack([np.zeros(P), np.eye(P)])
    side = int(np.ceil(np.sqrt(L)))
    bary, U, V = [], [], []
    for i in range(L):
        off = np.array([i % side, i // side], dtype=float)
        verts = 0.8 * base + off + 0.1 * rng.uniform(size=P)
        bary.append(geometry.barycentric_matrix(verts))
        U.append(rng.normal(size=(PP1, n_u)))
        V.append(np.abs(rng.normal(size=PP1)))
    return export.LeafTable(
        bary_M=np.stack(bary), U=np.stack(U), V=np.stack(V),
        delta=np.zeros(L, dtype=np.int64),
        node_id=np.arange(L, dtype=np.int64))


def _centroids(table):
    return np.stack([np.linalg.inv(table.bary_M[i])[:-1, :].mean(axis=1)
                     for i in range(table.n_leaves)])


@pytest.fixture(scope="module")
def buffers():
    """Two tenants packed at extents [0, 40) and [128, 165) of a
    256-column JAX-layout arena (PV = K = 8, NU = 128), as
    serve/arena.py lays them out."""
    rng = np.random.default_rng(77)
    ta, tb = _synthetic_table(rng, L=40), _synthetic_table(rng, L=37)
    C = 256
    bary = np.zeros((8, 8, C), dtype=np.float32)
    bary[:, P, :] = -pallas_eval._BIG
    U = np.zeros((8, C, 128), dtype=np.float32)
    V = np.zeros((8, C), dtype=np.float32)
    for t, s in ((ta, 0), (tb, 128)):
        b, u, v = pallas_eval.pack_columns(t, 128, 8, 8)
        bary[:, :, s:s + 128], U[:, s:s + 128], V[:, s:s + 128] = b, u, v
    return {"tables": {"a": ta, "b": tb}, "ext": {"a": (0, 40),
                                                   "b": (128, 165)},
            "bary": bary, "U": U, "V": V}


def _queries(buf, names, thetas, clamp=True):
    """JAX-layout (3, B, 8) query planes + (B, 2) extents, as
    DeviceArena.evaluate builds them."""
    B = len(names)
    q = np.zeros((3, B, 8), dtype=np.float32)
    q[0, :, :P] = thetas.astype(np.float32)
    lb, ub = (_BOX if clamp else (np.full(P, -pallas_eval._BIG),
                                  np.full(P, pallas_eval._BIG)))
    q[1, :, :P] = lb.astype(np.float32)
    q[2, :, :P] = ub.astype(np.float32)
    q[:, :, P] = 1.0
    ext = np.array([buf["ext"][n] for n in names], dtype=np.int32)
    return q, ext


def _port(buf, q, ext):
    """The port's plain version on the sliced buffers -> numpy tuple
    (val, col, u, cost, clamped)."""
    rec = fused.arena_eval_torch(
        torch.as_tensor(buf["bary"][:PP1, :PP1]),
        torch.as_tensor(np.ascontiguousarray(buf["U"][:PP1, :, :N_U])),
        torch.as_tensor(buf["V"][:PP1]),
        torch.as_tensor(np.ascontiguousarray(q[:, :, :PP1])),
        torch.as_tensor(ext))
    return tuple(a.numpy() for a in fused.unpack(rec))


def _xla(buf, q, ext):
    baryT = np.ascontiguousarray(buf["bary"][:PP1].transpose(1, 0, 2))
    out = pallas_eval.arena_eval_xla(
        jnp.asarray(baryT), jnp.asarray(buf["U"]), jnp.asarray(buf["V"]),
        jnp.asarray(q), jnp.asarray(ext))
    return tuple(np.asarray(a) for a in out)


def _assert_same(got, ref, tol=1e-5):
    val, col, u, cost, clamped = got
    rv, rc, ru, rcost, rcl = ref
    assert np.array_equal(col, rc)
    assert np.array_equal(clamped, rcl)
    assert np.array_equal(val >= -1e-4, rv >= -1e-4)        # served
    np.testing.assert_allclose(val, rv, atol=tol)
    np.testing.assert_allclose(u, ru[:, :u.shape[1]], atol=tol)
    np.testing.assert_allclose(cost, rcost, atol=tol)


def _mixed(buf, rng):
    """Interleaved tenant rows: centroids, random in-box points, and
    out-of-box points (clamped onto the box)."""
    ca = _centroids(buf["tables"]["a"])
    cb = _centroids(buf["tables"]["b"])
    names = ["a", "b"] * 20 + ["a"] * 8 + ["b"] * 8
    rows = [ca[i] if n == "a" else cb[i]
            for i, n in zip(np.repeat(np.arange(20), 2), names[:40])]
    rows += list(rng.uniform(0.0, 7.0, (8, P)))
    rows += list(rng.uniform(-3.0, 11.0, (8, P)))
    return names, np.stack(rows)


@pytest.mark.parametrize("n_cols,PV,K,nu", [
    (48, 8, 8, 128), (40, 8, 8, 2), (64, PP1, PP1, N_U), (40, PP1, PP1, 1)])
def test_pack_columns_is_bitwise_the_jax_pack(n_cols, PV, K, nu):
    table = _synthetic_table(np.random.default_rng(9), L=40,
                             n_u=min(nu, N_U))
    for a, b in zip(fused.pack_columns(table, n_cols, PV, K, nu),
                    pallas_eval.pack_columns(table, n_cols, PV, K, nu)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_pack_columns_rejects_what_the_jax_pack_rejects():
    table = _synthetic_table(np.random.default_rng(9), L=5)
    for pack in (fused.pack_columns, pallas_eval.pack_columns):
        with pytest.raises(ValueError):
            pack(table, 4, 8, 8)
        with pytest.raises(ValueError):
            pack(table, 8, 8, 8, nu=1)


def test_plain_matches_arena_eval_xla(buffers):
    names, thetas = _mixed(buffers, np.random.default_rng(3))
    q, ext = _queries(buffers, names, thetas)
    got, ref = _port(buffers, q, ext), _xla(buffers, q, ext)
    _assert_same(got, ref)
    assert got[4][:48].sum() == 0 and got[4][48:].sum() > 0
    # Rows route to their own tenant's extent.
    for (s, e), c in zip(ext, got[1]):
        assert s <= c < e


def test_plain_matches_the_pallas_kernel_in_interpret_mode(buffers):
    names, thetas = _mixed(buffers, np.random.default_rng(4))
    q, ext = _queries(buffers, names, thetas)
    B = len(names)
    pad = np.zeros((3, 128, 8), dtype=np.float32)
    pad[:, :B] = q
    ext_p = np.zeros((128, 2), dtype=np.int32)
    ext_p[:B] = ext
    out = pallas_eval.arena_eval_fused(
        jnp.asarray(buffers["bary"]), jnp.asarray(buffers["U"]),
        jnp.asarray(buffers["V"]), jnp.asarray(pad[0]), jnp.asarray(pad[1]),
        jnp.asarray(pad[2]), jnp.asarray(ext_p), interpret=True)
    ref = tuple(np.asarray(a)[:B] for a in out)
    _assert_same(_port(buffers, q, ext), ref)


def test_empty_extent_and_clamp_off(buffers):
    """A row with an empty extent scores -BIG at column 0 (the masked
    argmax); clamp off leaves far-out rows unclamped and unserved."""
    thetas = np.array([[3.3, 3.3], [40.0, -10.0], [1.0, 1.0]])
    q, ext = _queries(buffers, ["a", "a", "b"], thetas, clamp=False)
    ext[2] = (7, 7)
    got, ref = _port(buffers, q, ext), _xla(buffers, q, ext)
    _assert_same(got, ref)
    val, col, _u, _cost, clamped = got
    assert not clamped.any()
    assert val[0] >= -1e-4 and val[1] < -1e-4
    assert col[2] == 0 and val[2] == np.float32(-pallas_eval._BIG)


def test_nan_rows_are_unserved(buffers):
    """A query with a NaN coordinate is clamped and never served, as in
    the JAX package.  Against ``arena_eval_xla``: column, served and
    clamped exact, val/u/cost NaN where it has NaN (a NaN score is the
    argmax's largest, so the first column of the extent wins with val
    NaN).  Against the Pallas kernel: served and clamped exact (its
    running best never takes a NaN tile, so its column and val are
    those of the -inf start or a masked tile)."""
    nan = np.nan
    ca = _centroids(buffers["tables"]["a"])
    cb = _centroids(buffers["tables"]["b"])
    thetas = np.array([[nan, 3.3], [1.2, nan], [nan, nan], ca[5],
                       [nan, 0.5], cb[9]])
    names = ["a", "a", "b", "a", "b", "b"]
    for clamp in (True, False):
        q, ext = _queries(buffers, names, thetas, clamp=clamp)
        got, ref = _port(buffers, q, ext), _xla(buffers, q, ext)
        val, col, u, cost, clamped = got
        bad = np.isnan(thetas).any(axis=1)
        assert np.array_equal(col, ref[1])
        assert np.array_equal(clamped, ref[4]) and clamped[bad].all()
        assert np.array_equal(val >= -1e-4, ref[0] >= -1e-4)
        assert not (val >= -1e-4)[bad].any() and (val >= -1e-4)[~bad].all()
        for a, b in ((val, ref[0]), (u, ref[2][:, :N_U]), (cost, ref[3])):
            assert np.array_equal(np.isnan(a), np.isnan(b))
        assert np.isnan(val[bad]).all()
        assert np.array_equal(col[bad], ext[bad, 0])
        np.testing.assert_allclose(val[~bad], ref[0][~bad], atol=1e-5)
        B = len(names)
        pad = np.zeros((3, 128, 8), dtype=np.float32)
        pad[:, :B] = q
        ext_p = np.zeros((128, 2), dtype=np.int32)
        ext_p[:B] = ext
        out = pallas_eval.arena_eval_fused(
            jnp.asarray(buffers["bary"]), jnp.asarray(buffers["U"]),
            jnp.asarray(buffers["V"]), jnp.asarray(pad[0]),
            jnp.asarray(pad[1]), jnp.asarray(pad[2]), jnp.asarray(ext_p),
            interpret=True)
        pv, pcl = np.asarray(out[0])[:B], np.asarray(out[4])[:B]
        assert np.array_equal(clamped, pcl)
        assert np.array_equal(val >= -1e-4, pv >= -1e-4)


def test_clamped_rows_evaluate_the_clipped_query(buffers):
    """Bitwise: a clamped row's result is the plain version's result on
    the pre-clipped query (same arithmetic after the clip)."""
    rng = np.random.default_rng(5)
    lb, ub = _BOX
    thetas = np.concatenate([rng.uniform(1.0, 6.0, (4, P)),
                             [ub + [1.0, 2.5], lb - [0.5, 3.0],
                              [-1.0, 4.0], [3.0, 9.5]]])
    names = ["a"] * 8
    got = _port(buffers, *_queries(buffers, names, thetas))
    clip = _port(buffers, *_queries(buffers, names,
                                    np.clip(thetas, lb, ub)))
    assert not got[4][:4].any() and got[4][4:].all()
    assert not clip[4].any()
    for a, b in zip(got[:4], clip[:4]):
        assert a.tobytes() == b.tobytes()


def test_plain_is_deterministic_and_row_independent(buffers, monkeypatch):
    names, thetas = _mixed(buffers, np.random.default_rng(6))
    q, ext = _queries(buffers, names, thetas)
    a, b = _port(buffers, q, ext), _port(buffers, q, ext)
    for x, y in zip(a, b):
        assert x.tobytes() == y.tobytes()
    # Row chunks of 5 give the same discrete answers, values to 1e-6.
    monkeypatch.setattr(fused, "_CHUNK_ELEMS", 5 * PP1 * 256)
    c = _port(buffers, q, ext)
    assert np.array_equal(a[1], c[1]) and np.array_equal(a[4], c[4])
    for x, y in zip((a[0], a[2], a[3]), (c[0], c[2], c[3])):
        np.testing.assert_allclose(x, y, atol=1e-6)


def test_records_and_dispatch(buffers):
    names, thetas = _mixed(buffers, np.random.default_rng(7))
    q, ext = _queries(buffers, names, thetas)
    args = (torch.as_tensor(buffers["bary"][:PP1, :PP1]),
            torch.as_tensor(np.ascontiguousarray(
                buffers["U"][:PP1, :, :N_U])),
            torch.as_tensor(buffers["V"][:PP1]),
            torch.as_tensor(np.ascontiguousarray(q[:, :, :PP1])),
            torch.as_tensor(ext))
    before = fused.launches
    rec = fused.arena_eval(*args)
    assert fused.launches == before          # CPU tensors: plain version
    assert rec.dtype == torch.int32
    assert rec.shape == (len(names), fused.REC_HEAD + N_U)
    assert torch.equal(rec, fused.arena_eval_torch(*args))
    val, col, u, cost, clamped = fused.unpack(rec)
    assert val.dtype == u.dtype == cost.dtype == torch.float32
    assert clamped.dtype == torch.bool and u.shape == (len(names), N_U)
    with pytest.raises(ValueError, match="CUDA"):
        fused.arena_eval_cuda(*args, fused.make_plan(ext, "cpu"),
                              fused.Scratch("cpu"))
    with pytest.raises(TypeError):
        fused.arena_eval(args[0].double(), *args[1:])
    with pytest.raises(TypeError):
        fused.arena_eval(*args[:4], args[4].long())
    with pytest.raises(ValueError):
        fused.arena_eval(args[0][:, :, :100], *args[1:])
    with pytest.raises(ValueError):
        fused.arena_eval(*args[:3], args[3][:, :5], args[4])


def _check_plan(ext, chunks, tiles, C, n_sm=132):
    B = len(ext)
    assert tiles.dtype == np.int32 and tiles.shape[1] == fused.TILE_WORDS
    assert 1 <= chunks <= fused.MAX_CHUNKS
    seen = np.zeros(B, dtype=int)
    for n, s, e, _unused, *rows in tiles:
        assert 1 <= n <= fused.TILE_ROWS
        rows = np.array(rows[:n])
        seen[rows] += 1
        assert (ext[rows] == (s, e)).all()
        # The chunks cover the tile's extent (clipped to the arena) once.
        cov = np.zeros(C, dtype=int)
        for c0, c1 in fused.chunk_bounds(int(s), int(e), chunks, C):
            assert c0 <= c1
            cov[c0:c1] += 1
        want = np.zeros(C, dtype=int)
        want[max(s, 0):min(e, C)] = 1
        assert np.array_equal(cov, want)
    assert (seen == 1).all()
    widest = max(int(np.maximum(tiles[:, 2] - tiles[:, 1], 0).max()), 1)
    assert chunks == 1 or widest // chunks >= fused.MIN_CHUNK_COLS // 2
    assert len(tiles) * chunks <= max(len(tiles),
                                      2 * fused.BLOCKS_PER_SM * n_sm)


@pytest.mark.parametrize("B", [1, 3, 16, 17, 257, 4099])
def test_plan_batch_covers_every_row_and_column_once(B):
    """Tiles hold rows of one extent, every row in exactly one tile; the
    chunks of each tile cover its extent exactly once -- empty, one-
    column and arena-clipped extents included -- for B = 1 and batch
    sizes that are no multiple of the tile."""
    rng = np.random.default_rng(B)
    C = 12_000
    table = np.array([(0, 0), (5, 6), (128, 11_670), (11_776, 11_900),
                      (256, 256), (11_900, 12_500)])
    ext = table[rng.integers(0, len(table), B)]
    chunks, tiles = fused.plan_batch(ext)
    _check_plan(ext, chunks, tiles, C)


def test_plan_batch_fills_the_card_at_serving_batches():
    """The serving run's batch (16 rows round-robin over 4 tenants of
    11,670 columns) runs on 8 two-row tiles x 23 chunks of at least
    MIN_CHUNK_COLS columns, not on 16 blocks; 256 rows in 4-row tiles on
    no more than BLOCKS_PER_SM blocks per SM; 65,536 rows in full tiles
    need no chunks; and a 1-column extent is one chunk."""
    ext4 = np.array([(k * 11_776, k * 11_776 + 11_670) for k in range(4)])
    chunks, tiles = fused.plan_batch(ext4[np.arange(16) % 4], 132)
    assert len(tiles) == 8 and (tiles[:, 0] == 2).all()
    assert chunks == -(-11_670 // fused.MIN_CHUNK_COLS)
    chunks, tiles = fused.plan_batch(ext4[np.arange(256) % 4], 132)
    assert len(tiles) == 64 and (tiles[:, 0] == 4).all()
    assert 132 <= 64 * chunks <= fused.BLOCKS_PER_SM * 132
    chunks, tiles = fused.plan_batch(ext4[np.arange(65_536) % 4], 132)
    assert chunks == 1 and len(tiles) == 65_536 // fused.TILE_ROWS
    assert (tiles[:, 0] == fused.TILE_ROWS).all()
    assert fused.plan_batch(np.array([[7, 8]]))[0] == 1
    assert fused.plan_batch(np.zeros((0, 2)))[1].shape == (0,
                                                           fused.TILE_WORDS)


def test_make_plan_is_plan_batchs_plan_for_the_batch():
    """make_plan puts plan_batch's tiles on the device and names the
    batch size the wrapper holds the launch to."""
    ext = np.array([(0, 300), (300, 301), (0, 300)] * 5)
    plan = fused.make_plan(ext, "cpu")
    chunks, tiles = fused.plan_batch(ext)
    assert plan.rows == 15 and plan.chunks == chunks
    assert plan.tiles.dtype == torch.int32 and plan.tiles.is_contiguous()
    assert np.array_equal(plan.tiles.numpy(), tiles)
    assert fused.make_plan(ext[:1], "cpu").rows == 1


def test_chunk_bounds_match_the_kernels_arithmetic():
    assert fused.chunk_bounds(10, 10, 4, 100) == [(10, 10)] * 4
    assert fused.chunk_bounds(10, 11, 3, 100) == [(10, 10), (10, 10),
                                                  (10, 11)]
    assert fused.chunk_bounds(-5, 500, 2, 100) == [(0, 50), (50, 100)]
    assert fused.chunk_bounds(0, 11_670, 46, 12_000)[-1] == (11_416, 11_670)
