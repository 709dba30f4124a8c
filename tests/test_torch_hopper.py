"""The port's kernels against the JAX package's, on the same numpy inputs.

On the CPU the wrappers in ``repro_torch.hopper.ops`` run the plain
versions (``hopper.ref``); they are held here against the Pallas kernels
(``repro.kernels.ops``, in interpret mode, as ``tests/test_kernels.py``
runs them) and the JAX package's numpy matcher. Indices, ``matched`` and
match decisions must be exact; squared distances agree to rtol 1e-5 (fp32
products summed in another order) and mean pixel differences to rtol 1e-6.
``dequant_topk``'s values and indices must be exact (two fp32 multiplies
in one order, then a ranking). The interpret-mode ``dequant_topk`` runs k
passes, so its cases keep k and C small.
The CUDA kernels themselves are held against the plain versions in
``test_torch_hopper_cuda.py``, which runs on the card.
"""
import numpy as np
import pytest
import torch

from repro.data.bgsub import match_flat as jax_match_flat
from repro.kernels import ops as jops
from repro_torch.hopper import ops, ref


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _assert_assign_eq(got, want):
    d2, j, m = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
                for x in got)
    d2r, jr, mr = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(j, jr)
    np.testing.assert_array_equal(m, mr)
    np.testing.assert_allclose(d2, d2r, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# centroid_assign
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,M,D,T", [
    (1, 1, 8, 3.0), (7, 13, 32, 7.0), (64, 64, 128, 14.0),
    (130, 257, 64, 10.0), (37, 1000, 128, 15.5),
])
def test_centroid_assign_matches_jax(B, M, D, T):
    f, c = _normal((B, D), B * M + D), _normal((M, D), B * M + D + 1)
    got = ops.centroid_assign(_t(f), _t(c), threshold=T)
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.bool
    _assert_assign_eq(got, jops.centroid_assign(f, c, threshold=T))
    # without a threshold: two outputs, the same distances and indices
    d2, j = ops.centroid_assign(_t(f), _t(c))
    np.testing.assert_array_equal(j.numpy(), got[1].numpy())


def _edge_inputs():
    """Exact-arithmetic edge cases: fp32 T^2, ties, dead slots."""
    t = np.float32(0.8)
    f = np.zeros((4, 8), np.float32)
    f[0, 0] = t                                 # d2 == fp32(0.8)**2 exactly
    f[1, 0] = np.nextafter(t, np.float32(1))    # just outside
    f[2] = 2.0                                  # equidistant from 2 slots
    f[3] = 1.0
    c = np.zeros((6, 8), np.float32)
    c[1] = c[4] = 4.0                           # planted tie: 1 wins
    c[2] = 2.0
    c[5] = 2.0                                  # duplicate of 2: 2 wins
    c[3, :4], c[3, 4:] = 1.0, 0.0
    return f, c


def test_centroid_assign_fp32_threshold_ties_and_dead_slots():
    f, c = _edge_inputs()
    got = ops.centroid_assign(_t(f), _t(c), threshold=0.8)
    want = jops.centroid_assign(f, c, threshold=0.8)
    _assert_assign_eq(got, want)
    d2, j, m = (x.numpy() for x in got)
    assert d2[0] == np.float32(0.8) ** 2 and m[0]   # 0.64000005 <= T^2
    assert not m[1]
    assert j[2] == 2                                # lowest of the tie
    # dead slots masked to 1e9 (what clustering's phase 1 does); with no
    # live slot at all (n = 0) every score ties and index 0 wins
    dead = np.where(np.arange(6)[:, None] < 3, c, np.float32(1e9))
    _assert_assign_eq(ops.centroid_assign(_t(f), _t(dead), threshold=0.8),
                      jops.centroid_assign(f, dead, threshold=0.8))
    none_live = np.full((6, 8), 1e9, np.float32)
    d2, j, m = ops.centroid_assign(_t(f), _t(none_live), threshold=0.8)
    assert (j.numpy() == 0).all() and not m.numpy().any()


def test_threshold_is_squared_in_fp32():
    assert float(ref.threshold_sq(0.8)) == float(np.float32(0.8) ** 2)
    assert float(ref.threshold_sq(0.8)) != 0.8 * 0.8


def test_centroid_assign_identical_rows():
    f = np.tile(np.arange(32, dtype=np.float32)[None], (4, 1))
    c = np.stack([np.arange(32, dtype=np.float32) + 5,
                  np.arange(32, dtype=np.float32)])
    d2, j = ops.centroid_assign(_t(f), _t(c))
    assert (j.numpy() == 1).all()
    np.testing.assert_allclose(d2.numpy(), 0.0, atol=1e-4)


def test_wrappers_validate_inputs():
    with pytest.raises(ValueError):
        ops.centroid_assign(torch.zeros(3, 4), torch.zeros(5, 6))
    with pytest.raises(ValueError):
        ops.pixel_match(torch.zeros(3), torch.zeros(5, 6), 0.1)


# ---------------------------------------------------------------------------
# pixel_match
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Na,Nb,D", [
    (1, 1, 8), (7, 13, 48), (37, 19, 300), (3, 3, 3072), (4, 40, 3072),
])
def test_pixel_match_matches_jax(Na, Nb, D):
    r = np.random.default_rng(Na * Nb + D)
    a = r.random((Na, D), dtype=np.float32)
    b = r.random((Nb, D), dtype=np.float32)
    # a threshold halfway between two rows' minima, so that it
    # discriminates with a margin far above fp32 rounding
    mins = np.sort(np.asarray(jops.pixel_match(a, b, 1.0)[1]))
    k = len(mins) // 2
    thr = float((mins[k - 1] + mins[k]) / 2) if Na > 1 else 1.0
    m, d = ops.pixel_match(_t(a), _t(b), thr)
    mj, dj = jops.pixel_match(a, b, thr)
    np.testing.assert_array_equal(m.numpy(), np.asarray(mj))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-6)
    np.testing.assert_array_equal(m.numpy(),
                                  jax_match_flat(a, b, thr, backend="numpy"))
    if Na > 2:
        assert (m.numpy() >= 0).any() and (m.numpy() == -1).any()


def test_pixel_match_threshold_is_strict():
    a = np.zeros((1, 16), np.float32)
    b = np.full((1, 16), 0.5, np.float32)       # mean abs diff exactly 0.5
    m, _ = ops.pixel_match(_t(a), _t(b), 0.5)
    assert int(m[0]) == -1
    m, _ = ops.pixel_match(_t(a), _t(b),
                           np.nextafter(np.float32(0.5), np.float32(1.0)))
    assert int(m[0]) == 0


def test_pixel_match_ties_and_exact_duplicates():
    a = np.full((3, 8), 0.25, np.float32)
    b = np.stack([np.full(8, 0.5, np.float32)] * 4)   # all equidistant
    m, _ = ops.pixel_match(_t(a), _t(b), 1.0)
    np.testing.assert_array_equal(m.numpy(), 0)
    np.testing.assert_array_equal(np.asarray(jops.pixel_match(a, b, 1.0)[0]),
                                  0)
    r = np.random.default_rng(0)
    a = r.random((9, 64), dtype=np.float32)
    b = r.random((5, 64), dtype=np.float32)
    b[3] = a[6]
    m, d = ops.pixel_match(_t(a), _t(b), 1e-6)
    assert int(m[6]) == 3 and float(d[6]) == 0.0


def test_pixel_match_empty_sides():
    m, d = ops.pixel_match(torch.zeros(0, 8), torch.ones(3, 8), 0.1)
    assert m.shape == (0,) and d.shape == (0,)
    m, d = ops.pixel_match(torch.ones(3, 8), torch.zeros(0, 8), 0.1)
    assert (m.numpy() == -1).all() and torch.isinf(d).all()


def test_cpu_tensors_take_the_plain_version():
    ops.reset_launches()
    ops.centroid_assign(torch.ones(4, 8), torch.zeros(3, 8), threshold=1.0)
    ops.pixel_match(torch.ones(4, 8), torch.zeros(3, 8), 0.1)
    ops.dequant_topk(torch.ones(4, 8, dtype=torch.uint8), torch.ones(4), 3)
    assert ops.LAUNCHES == {"centroid_assign": 0, "pixel_match": 0,
                            "dequant_topk": 0}


# ---------------------------------------------------------------------------
# dequant_topk
# ---------------------------------------------------------------------------

SG = np.float32(1.0 / 255.0)          # the v4 format's mean-prob multiplier


def _quantized(dtype, M, C, seed, levels=None):
    """Quantized rows as the v4 writer makes them, with optional planted
    ties (``levels`` distinct values per row) and an all-zero row whose
    sentinel scale is 1."""
    r = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    lo = 0 if dtype == np.uint8 else -127
    hi = levels if levels is not None else info.max
    q = r.integers(lo, hi + 1, (M, C)).astype(dtype)
    scales = (r.random(M) + 0.25).astype(np.float32)
    if M > 2:
        q[2] = 0
        scales[2] = 1.0
    return q, scales


def _assert_dequant_eq(q, scales, k):
    vals, idx = ops.dequant_topk(torch.from_numpy(q), torch.from_numpy(scales),
                                 k, global_scale=SG)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    jv, ji = jops.dequant_topk(q, scales, k, global_scale=SG)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    return vals.numpy(), idx.numpy()


@pytest.mark.parametrize("dtype", [np.uint8, np.int8])
@pytest.mark.parametrize("M,C,k,levels", [
    (9, 37, 1, None), (9, 37, 3, None), (9, 37, 37, None),
    (5, 16, 16, 3), (17, 8, 3, 1), (1, 130, 5, None),
])
def test_dequant_topk_matches_jax(dtype, M, C, k, levels):
    q, scales = _quantized(dtype, M, C, M * C + k, levels)
    vals, idx = _assert_dequant_eq(q, scales, k)
    # the eager v4 loader's dequant, ranked by a stable descending argsort
    x = q.astype(np.float32) * (SG * scales)[:, None]
    order = np.argsort(-x, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(idx, order)
    np.testing.assert_array_equal(vals, np.take_along_axis(x, order, 1))


def test_dequant_topk_ties_go_to_the_lowest_column():
    q = np.array([[3, 7, 7, 1, 7], [0, 0, 0, 0, 0]], np.uint8)
    scales = np.array([0.5, 1.0], np.float32)
    _, idx = _assert_dequant_eq(q, scales, 5)
    assert idx.tolist() == [[1, 2, 4, 0, 3], [0, 1, 2, 3, 4]]


def test_dequant_topk_empty_rows():
    for dtype in (torch.uint8, torch.int8):
        vals, idx = ops.dequant_topk(torch.zeros(0, 12, dtype=dtype),
                                     torch.zeros(0), 4, global_scale=SG)
        assert vals.shape == (0, 4) and idx.shape == (0, 4)
        assert vals.dtype == torch.float32 and idx.dtype == torch.int32


@pytest.mark.parametrize("q,scales,k", [
    (torch.zeros(3, 5, dtype=torch.uint8), torch.ones(3), 6),      # k > C
    (torch.zeros(3, 5, dtype=torch.uint8), torch.ones(3), 0),      # k < 1
    (torch.zeros(3, 5), torch.ones(3), 2),                         # float q
    (torch.zeros(3, 5, dtype=torch.int8), torch.ones(4), 2),       # scales
    (torch.zeros(3, 5, dtype=torch.int8), torch.ones(3, 1), 2),
])
def test_dequant_topk_rejects_bad_inputs(q, scales, k):
    with pytest.raises(ValueError):
        ops.dequant_topk(q, scales, k)
