"""The port's geo_topk CUDA kernels against their plain PyTorch versions,
on the card.

Imports torch, numpy and ``repro_torch`` only, so it runs where JAX is
not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py

Every test needs a CUDA device and skips without one.  Tolerance: scores
within atol = rtol = 1e-5 (the kernels keep the plain version's fp32
operation order, so in practice they agree exactly); counts and indices
exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import geohash
from repro_torch.kernels.geo_topk import kernel, ops, ref

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only "
                    "on the card")
    kernel.reset_launches()
    yield torch.device("cuda")
    kernel.reset_launches()


def _query(u, n, dev, spread=0.5, seed=0, valid=None):
    rng = np.random.default_rng(seed)
    base = (44.97, -93.22)
    ulat = base[0] + rng.uniform(-spread, spread, u)
    ulon = base[1] + rng.uniform(-spread, spread, u)
    nlat = base[0] + rng.uniform(-spread, spread, n)
    nlon = base[1] + rng.uniform(-spread, spread, n)
    return ops.inputs_from_numpy(ops.pack_inputs(
        ulat, ulon, rng.integers(0, 3, u), geohash.encode_batch(ulat, ulon, 9),
        nlat, nlon, rng.uniform(0, 1, n), rng.integers(0, 3, n),
        geohash.encode_batch(nlat, nlon, 9), valid), dev)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(64, 128, 3), (50, 37, 5), (8, 3, 3),
                                  (130, 257, 8), (1000, 1024, 64)])
def test_fused_kernel_matches_plain(case, cuda):
    u, n, k = case
    p = _query(u, n, cuda, seed=u + n)
    need = min(4, n)
    s, i = kernel.geo_topk_fused(p, k=k, need=need)
    rs, ri = ref.geo_topk_reference(*p, k=k, need=need)
    torch.testing.assert_close(s, rs, **TOL)
    assert torch.equal(i, ri)
    assert kernel.LAUNCHES["geo_topk_fused"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(48, 640, 3, 256), (20, 1000, 5, 128),
                                  (8, 257, 4, 128), (16, 128, 3, 128),
                                  (6, 10, 8, 4)])
def test_tiled_kernels_match_plain(case, cuda):
    u, n, k, nt = case
    p = _query(u, n, cuda, seed=u + n)
    need = min(4, n)
    counts = kernel.prefix_count(p.user_code20, p.node_code20,
                                 p.node_valid, node_tile=nt)
    assert torch.equal(counts, ref.prefix_counts_reference(
        p.user_code20, p.node_code20, p.node_valid))
    s, i = ops.geo_topk(p, k=k, need=need, node_tile=nt)
    rs, ri = ref.geo_topk_reference(*p, k=k, need=need)
    torch.testing.assert_close(s, rs, **TOL)
    assert torch.equal(i, ri)


@pytest.mark.gpu
def test_all_invalid_query_fills_the_neg_tail(cuda):
    p = _query(12, 512, cuda, seed=10, valid=np.zeros(512, np.float32))
    for nt in (None, 128):
        s, i = ops.geo_topk(p, k=3, need=4, node_tile=nt)
        rs, ri = ref.geo_topk_reference(*p, k=3, need=4)
        assert torch.equal(i, ri) and torch.equal(s, rs)
        assert (s < -1e29).all()


@pytest.mark.gpu
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    p = _query(8, 80, cuda)
    with pytest.raises(ValueError):
        kernel.geo_topk_fused(p, k=kernel.K_MAX + 1, need=4)
    with pytest.raises(ValueError):
        kernel.geo_topk_fused(p._replace(node_lat=p.node_lat.double()),
                              k=3, need=4)
    assert kernel.LAUNCHES["geo_topk_fused"] == 0
