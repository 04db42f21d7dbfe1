"""PyTorch port of geo_topk against the JAX package.

The same numpy inputs (fixed seeds) go through the JAX op on the CPU
(``repro.kernels.geo_topk.ops.geo_topk``, which dispatches to its jitted
jnp oracle there) and through the port.  On the CPU the port's wrappers run their
plain PyTorch versions; the CUDA kernels are held against those on the
card by ``tests/test_torch_kernels_cuda.py`` (skipped without a card) and
by ``chip_smoke.py``.

Tolerance: scores within atol = rtol = 1e-5 — fp32 ``sin``/``cos``/
``asin`` may differ by an ulp between XLA and ATen.  Indices exactly
equal, including the ``NEG`` tail of rows with fewer than k hits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import geohash
from repro.kernels.geo_topk import ref as jref
from repro.kernels.geo_topk.ops import geo_topk as jax_geo_topk
from repro.kernels.geo_topk.ops import pack_inputs as jax_pack_inputs
from repro_torch.kernels.geo_topk import kernel, ops, ref

TOL = dict(atol=1e-5, rtol=1e-5)

# the JAX oracle's pieces, jitted (one compile per shape, not per op)
_jax_score_matrix = jax.jit(jref.score_matrix, static_argnames=("need",))
_jax_mask = jax.jit(jref.proximity_mask, static_argnums=(3,))
_jax_mask_restricted = jax.jit(jref.proximity_mask_restricted,
                               static_argnums=(3, 4))


def _geo_inputs(u, n, spread=0.5, seed=0, valid=None):
    """The JAX package's packed query (numpy arrays), as its kernel tests
    make it."""
    rng = np.random.default_rng(seed)
    base = (44.97, -93.22)
    ulat = base[0] + rng.uniform(-spread, spread, u)
    ulon = base[1] + rng.uniform(-spread, spread, u)
    nlat = base[0] + rng.uniform(-spread, spread, n)
    nlon = base[1] + rng.uniform(-spread, spread, n)
    return jax_pack_inputs(ulat, ulon, rng.integers(0, 3, u),
                           geohash.encode_batch(ulat, ulon, 9),
                           nlat, nlon, rng.uniform(0, 1, n),
                           rng.integers(0, 3, n),
                           geohash.encode_batch(nlat, nlon, 9), valid)


def _both(packed, k, need):
    """(JAX oracle, port) top-k of one numpy query on the CPU."""
    js, ji = jax_geo_topk(packed, k=k, need=need)
    ts, ti = ops.geo_topk(ops.inputs_from_numpy(packed, "cpu"), k=k,
                          need=need)
    return (np.asarray(js), np.asarray(ji)), (ts.numpy(), ti.numpy())


def _assert_same(j, t):
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_allclose(t[0], j[0], **TOL)


@pytest.fixture(autouse=True)
def _launch_counts():
    """CPU calls never launch a kernel."""
    kernel.reset_launches()
    yield
    assert all(v == 0 for v in kernel.LAUNCHES.values()), kernel.LAUNCHES


# ---------------------------------------------------------------------------
# (a) the plain version against the JAX oracle
# ---------------------------------------------------------------------------

GEO_CASES = [
    # U, N, k — the JAX package's untiled oracle cases
    (64, 128, 3),
    (50, 37, 5),          # ragged U and N
    (8, 3, 3),            # k == N: all selected
    (130, 257, 8),
    (40, 40, 40),         # k == N, wide
]


@pytest.mark.parametrize("case", GEO_CASES)
def test_geo_topk_reference_matches_jax(case):
    u, n, k = case
    packed = _geo_inputs(u, n, seed=u + n)
    _assert_same(*_both(packed, k, min(4, n)))


@pytest.mark.parametrize("spread", [0.02, 5.0])
def test_proximity_filter_spreads_match_jax(spread):
    """Tight clusters take the 4-char filter; global spreads fall through
    to coarser precisions or no filter."""
    packed = _geo_inputs(40, 64, spread=spread, seed=3)
    j, t = _both(packed, 4, 4)
    _assert_same(j, t)
    assert np.isfinite(t[0]).all()


@pytest.mark.parametrize("spread", [0.02, 0.5, 5.0])
def test_score_matrix_matches_jax(spread):
    packed = _geo_inputs(48, 96, spread=spread, seed=7)
    js = np.asarray(_jax_score_matrix(*packed, need=4))
    ts = ref.score_matrix(*ops.inputs_from_numpy(packed, "cpu"),
                          need=4).numpy()
    np.testing.assert_array_equal(ts == np.float32(ref.NEG),
                                  js == np.float32(jref.NEG))
    np.testing.assert_allclose(ts, js, **TOL)


@pytest.mark.parametrize("p_min", [1, 2, 3, 4])
@pytest.mark.parametrize("spread", [0.02, 5.0])
def test_proximity_mask_restricted_matches_jax(p_min, spread):
    packed = _geo_inputs(32, 80, spread=spread, seed=p_min)
    t = ops.inputs_from_numpy(packed, "cpu")
    jm, jsat = _jax_mask_restricted(packed.user_code20, packed.node_code20,
                                    packed.node_valid, 4, p_min)
    tm, tsat = ref.proximity_mask_restricted(t.user_code20, t.node_code20,
                                             t.node_valid, 4, p_min)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tsat.numpy(), np.asarray(jsat))
    full = ref.proximity_mask(t.user_code20, t.node_code20, t.node_valid, 4)
    jfull = _jax_mask(packed.user_code20, packed.node_code20,
                      packed.node_valid, 4)
    np.testing.assert_array_equal(full.numpy(), np.asarray(jfull))


TILED_CASES = [
    # U, N, k, node_tile — the JAX package's tiled cases, N over several
    # tiles, ragged too
    (48, 640, 3, 256),
    (20, 1000, 5, 128),
    (8, 257, 4, 128),     # ragged final tile
    (16, 128, 3, 128),    # single tile
    (6, 10, 8, 4),        # tiles narrower than k
]


@pytest.mark.parametrize("case", TILED_CASES)
def test_tiled_pair_matches_jax(case):
    u, n, k, nt = case
    packed = _geo_inputs(u, n, seed=u + n)
    need = min(4, n)
    j, _ = _both(packed, k, need)
    ts, ti = ops.geo_topk(ops.inputs_from_numpy(packed, "cpu"), k=k,
                          need=need, node_tile=nt)
    _assert_same(j, (ts.numpy(), ti.numpy()))


@pytest.mark.parametrize("spread", [0.02, 0.5, 5.0])
def test_prefix_counts_match_jax(spread):
    """Pass 1 of the tiled pair: the same integer counts the JAX tiled
    kernel accumulates (``(ucode >> s) == (ncode >> s)`` over valid
    nodes), summed here in jnp."""
    valid = np.ones(300, np.float32)
    valid[::7] = 0.0
    packed = _geo_inputs(24, 300, spread=spread, seed=11, valid=valid)
    uc = jnp.asarray(packed.user_code20)[:, None]
    nc = jnp.asarray(packed.node_code20)[None, :]
    nv = jnp.asarray(packed.node_valid)[None, :] > 0
    want = np.stack([np.asarray(jnp.sum(((uc >> s) == (nc >> s)) & nv,
                                        axis=1)) for s in (0, 5, 10, 15)], 1)
    t = ops.inputs_from_numpy(packed, "cpu")
    got = kernel.prefix_count(t.user_code20, t.node_code20, t.node_valid,
                              node_tile=64)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _clone_across_tile_edge(packed):
    """Clone node 126's full scoring identity across the 128-boundary."""
    for fld in ("node_lat", "node_lon", "node_free", "node_code20"):
        arr = getattr(packed, fld)
        arr[125:132] = arr[126]
    packed.node_aff[:, 125:132] = packed.node_aff[:, 126:127]
    return packed


def test_tile_boundary_ties_match_jax():
    """Equal-score nodes straddling a tile edge resolve to the lowest
    global index, exactly like ``lax.top_k`` over the full row."""
    packed = _clone_across_tile_edge(_geo_inputs(8, 384, seed=5))
    j, t = _both(packed, 6, 4)
    _assert_same(j, t)
    ts, ti = ops.geo_topk(ops.inputs_from_numpy(packed, "cpu"), k=6,
                          need=4, node_tile=128)
    _assert_same(j, (ts.numpy(), ti.numpy()))


def test_all_invalid_tiles_and_query_match_jax():
    """A dead tile, a dead tail and the fully invalid query (every row is
    the NEG tail, lowest indices first)."""
    n = 512
    valid = np.ones(n, np.float32)
    valid[128:256] = 0.0
    valid[500:] = 0.0
    packed = _geo_inputs(12, n, seed=9, valid=valid)
    j, t = _both(packed, 4, 4)
    _assert_same(j, t)
    dead = _geo_inputs(12, n, seed=10, valid=np.zeros(n, np.float32))
    j, t = _both(dead, 3, 4)
    _assert_same(j, t)
    assert (t[0] < -1e29).all()
    for nt in (128, 100):
        ts, ti = ops.geo_topk(ops.inputs_from_numpy(dead, "cpu"), k=3,
                              need=4, node_tile=nt)
        _assert_same(j, (ts.numpy(), ti.numpy()))


def test_default_dispatch_tiles_past_the_untiled_limit():
    """Above ``UNTILED_MAX_NODES`` the default layout is the tiled pair;
    on the CPU both layouts give the oracle's answer."""
    n = ops.UNTILED_MAX_NODES + 300
    packed = _geo_inputs(4, n, seed=1)
    j, t = _both(packed, 8, 4)
    _assert_same(j, t)


def test_merge_orders_by_score_then_index():
    """``topk_merge``'s plain version: (score desc, index asc) whatever
    order the partial lists arrive in."""
    s = torch.tensor([[[0.5, 0.1], [0.5, 0.3]]])
    i = torch.tensor([[[7, 2], [3, 9]]], dtype=torch.int32)
    ms, mi = kernel.topk_merge(s, i, k=3)
    assert mi.tolist() == [[3, 7, 9]]
    assert ms[0].tolist() == pytest.approx([0.5, 0.5, 0.3])


def test_k_range_is_checked():
    packed = ops.inputs_from_numpy(_geo_inputs(4, 80, seed=2), "cpu")
    with pytest.raises(ValueError):
        ops.geo_topk(packed, k=kernel.K_MAX + 1)
    with pytest.raises(ValueError):
        ops.geo_topk(packed, k=0)
    small = ops.inputs_from_numpy(_geo_inputs(4, 5, seed=2), "cpu")
    with pytest.raises(ValueError):
        ops.geo_topk(small, k=6)


# ---------------------------------------------------------------------------
# (b) the state crossing: numpy query -> tensors
# ---------------------------------------------------------------------------

def test_inputs_from_numpy_round_trips_jax_pack_inputs():
    rng = np.random.default_rng(4)
    lat = 44.97 + rng.uniform(-1, 1, 30)
    lon = -93.22 + rng.uniform(-1, 1, 30)
    codes = geohash.encode_batch(lat, lon, 9)
    args = (lat[:10], lon[:10], rng.integers(0, 4, 10), codes[:10],
            lat[10:], lon[10:], rng.uniform(0, 1, 20),
            rng.integers(0, 4, 20), codes[10:])
    jp = jax_pack_inputs(*args)
    tp = ops.inputs_from_numpy(jp, "cpu")
    assert tp._fields == jp._fields
    for name, a, t in zip(jp._fields, jp, tp):
        assert t.is_contiguous(), name
        assert t.dtype == torch.from_numpy(np.asarray(a)).dtype, name
        np.testing.assert_array_equal(t.numpy(), a, err_msg=name)
    # the port's own numpy packing is the same ten arrays
    for name, a, b in zip(jp._fields, jp, ops.pack_inputs(*args)):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
