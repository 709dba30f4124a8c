"""The Hopper kernels against their plain PyTorch versions, on the card.

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch and the CUDA toolkit are installed:

  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_hopper_cuda.py

Without a card every test skips. Indices, ``matched`` and match decisions
must be exact; squared distances agree to rtol 1e-5 (fp32 dot products
summed in another order; atol 1e-4 where a distance cancels to ~0) and
mean pixel differences to rtol 1e-6. ``dequant_topk``'s values and
indices must be exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.hopper import ops, ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on "
                    "the card")
    return torch.device("cuda")


def _t(x, device):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def _assert_assign_eq(got, want):
    torch.cuda.synchronize()
    d2, j, m = (x.cpu().numpy() for x in got)
    d2r, jr, mr = (x.cpu().numpy() for x in want)
    np.testing.assert_array_equal(j, jr)
    np.testing.assert_array_equal(m, mr)
    np.testing.assert_allclose(d2, d2r, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,D", [(512, 4096, 128), (37, 1000, 128),
                                   (1, 1, 8), (9, 300, 20)])
def test_centroid_assign_kernel_matches_plain(cuda, B, M, D):
    r = np.random.default_rng(B + M)
    f = r.normal(size=(B, D)).astype(np.float32)
    c = r.normal(size=(M, D)).astype(np.float32)
    c[M // 2:2 * (M // 2)] = c[:M // 2]          # planted ties
    T = float(np.sqrt(2 * D))
    before = ops.LAUNCHES["centroid_assign"]
    got = ops.centroid_assign(_t(f, cuda), _t(c, cuda), threshold=T)
    assert ops.LAUNCHES["centroid_assign"] == before + 1
    want = ref.centroid_assign_ref(_t(f, cuda), _t(c, cuda), T)
    _assert_assign_eq(got, want)


@pytest.mark.cuda
def test_centroid_assign_kernel_edges(cuda):
    D = 128
    f = np.zeros((3, D), np.float32)
    f[0, 0] = np.float32(0.8)                    # d2 == fp32(0.8)**2
    f[1, 0] = np.nextafter(np.float32(0.8), np.float32(1))
    f[2] = 1.0
    c = np.zeros((6, D), np.float32)
    c[3:] = 1e9                                  # dead slots
    got = ops.centroid_assign(_t(f, cuda), _t(c, cuda), threshold=0.8)
    _assert_assign_eq(got, ref.centroid_assign_ref(_t(f, cuda),
                                                   _t(c, cuda), 0.8))
    assert got[2].cpu().tolist() == [True, False, False]
    assert (got[1].cpu().numpy() == 0).all()     # ties go to slot 0
    none_live = np.full((6, D), 1e9, np.float32)
    _, j, m = ops.centroid_assign(_t(f, cuda), _t(none_live, cuda),
                                  threshold=0.8)
    assert (j.cpu().numpy() == 0).all() and not m.cpu().numpy().any()


@pytest.mark.cuda
@pytest.mark.parametrize("Na,Nb,D", [(3, 3, 3072), (4, 512, 3072),
                                     (130, 257, 96), (1, 9, 3072)])
def test_pixel_match_kernel_matches_plain(cuda, Na, Nb, D):
    r = np.random.default_rng(Na + Nb)
    a = r.random((Na, D), dtype=np.float32)
    b = r.random((Nb, D), dtype=np.float32)
    b[Nb // 2] = b[0]                            # planted tie
    a[0] = np.clip(b[0] + r.normal(0, 0.01, D), 0, 1)
    m, d = ops.pixel_match(_t(a, cuda), _t(b, cuda), 0.2)
    mr, dr = ref.pixel_match_ref(_t(a, cuda), _t(b, cuda), 0.2)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(m.cpu().numpy(), mr.cpu().numpy())
    np.testing.assert_allclose(d.cpu().numpy(), dr.cpu().numpy(), rtol=1e-6)
    assert int(m[0]) == 0


@pytest.mark.cuda
def test_pixel_match_kernel_strict_threshold_and_empty(cuda):
    z = torch.zeros(3, 3072, device=cuda)
    h = torch.full((3, 3072), 0.5, device=cuda)
    m, _ = ops.pixel_match(z, h, 0.5)
    assert (m.cpu().numpy() == -1).all()
    m, _ = ops.pixel_match(z, h, float(np.nextafter(np.float32(0.5),
                                                    np.float32(1))))
    assert (m.cpu().numpy() == 0).all()
    m, d = ops.pixel_match(z, torch.zeros(0, 3072, device=cuda), 0.5)
    assert (m.cpu().numpy() == -1).all() and torch.isinf(d).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,M,C,k,hi", [
    (np.uint8, 300, 1000, 1000, 255),    # the archive path's shape
    (np.uint8, 64, 1000, 1000, 3),       # quantization ties everywhere
    (np.int8, 33, 37, 5, 127),           # ragged C, k < C
    (np.int8, 7, 130, 130, 0),           # non-positive rows, ties
    (np.uint8, 5, 1, 1, 255),
])
def test_dequant_topk_kernel_matches_plain(cuda, dtype, M, C, k, hi):
    r = np.random.default_rng(M + C + k)
    lo = 0 if dtype == np.uint8 else -127
    q = r.integers(lo, hi + 1, (M, C)).astype(dtype)
    scales = (r.random(M) + 0.25).astype(np.float32)
    q[M // 2] = 0                                # all-zero row, scale 1
    scales[M // 2] = 1.0
    qt = torch.from_numpy(q).to(cuda)
    st = torch.from_numpy(scales).to(cuda)
    sg = np.float32(1.0 / 255.0)
    before = ops.LAUNCHES["dequant_topk"]
    v, i = ops.dequant_topk(qt, st, k, global_scale=sg)
    assert ops.LAUNCHES["dequant_topk"] == before + 1
    vr, ir = ref.dequant_topk_ref(qt, st, k, sg)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(i.cpu().numpy(), ir.cpu().numpy())
    np.testing.assert_array_equal(v.cpu().numpy(), vr.cpu().numpy())


@pytest.mark.cuda
def test_dequant_topk_kernel_empty_and_errors(cuda):
    before = ops.LAUNCHES["dequant_topk"]
    v, i = ops.dequant_topk(torch.zeros(0, 10, dtype=torch.uint8,
                                        device=cuda),
                            torch.zeros(0, device=cuda), 3)
    assert v.shape == (0, 3) and i.shape == (0, 3)
    assert ops.LAUNCHES["dequant_topk"] == before
    with pytest.raises(ValueError):
        ops.dequant_topk(torch.zeros(2, ops.DEQUANT_MAX_C + 1,
                                     dtype=torch.uint8, device=cuda),
                         torch.ones(2, device=cuda), 1)
    with pytest.raises(ValueError):
        ops.dequant_topk(torch.zeros(2, 8, dtype=torch.int32, device=cuda),
                         torch.ones(2, device=cuda), 1)
