"""The port's kernels against the JAX package's, on the same numpy inputs.

On the CPU the wrappers in ``repro_torch.hopper.ops`` run the plain
versions (``hopper.ref``); they are held here against the Pallas kernels
(``repro.kernels.ops``, in interpret mode, as ``tests/test_kernels.py``
runs them) and the JAX package's numpy matcher. Indices, ``matched`` and
match decisions must be exact; squared distances agree to rtol 1e-5 (fp32
products summed in another order) and mean pixel differences to rtol 1e-6.
``dequant_topk``'s values and indices must be exact (two fp32 multiplies
in one order, then a ranking), and so must ``topk``'s (a ranking of the
input bits). The interpret-mode ``dequant_topk`` and ``topk`` run k
passes, so their cases keep k and C small. ``flash_attention``'s plain
version agrees with the Pallas kernel and with the JAX package's plain
version at the JAX tests' own tolerances: atol = rtol = 2e-5 in fp32 (the
online softmax sums in another order), atol 3e-2 in bf16.
The CUDA kernels themselves are held against the plain versions in
``test_torch_hopper_cuda.py``, which runs on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.bgsub import match_flat as jax_match_flat
from repro.kernels import ops as jops
from repro.kernels import ref as jref
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


@pytest.mark.parametrize("S,B,M,D,T", [
    (1, 7, 13, 32, 7.0), (3, 64, 64, 128, 14.0), (4, 37, 300, 128, 15.5),
])
def test_centroid_assign_stacked_matches_jax_per_slot(S, B, M, D, T):
    """The stacked plain version against the Pallas kernel run once per
    slot, with a slot of dead rows (n = 0), an idle all-zero slot and
    planted ties across centroid tiles."""
    f, c = _normal((S, B, D), S * B + M), _normal((S, M, D), S * B + M + 1)
    c[:, M // 2:2 * (M // 2)] = c[:, :M // 2]         # planted ties
    c[0] = 1e9                                        # slot 0: n = 0
    f[-1] = 0.0                                       # an idle slot
    got = ops.centroid_assign_stacked(_t(f), _t(c), threshold=T)
    assert all(x.shape == (S, B) for x in got)
    for s in range(S):
        _assert_assign_eq(tuple(x[s] for x in got),
                          jops.centroid_assign(f[s], c[s], threshold=T))
    d2, j = ops.centroid_assign_stacked(_t(f), _t(c))
    np.testing.assert_array_equal(j.numpy(), got[1].numpy())


def test_centroid_assign_stacked_shapes_and_errors():
    got = ops.centroid_assign_stacked(torch.zeros(0, 5, 8),
                                      torch.zeros(0, 3, 8), threshold=1.0)
    assert [tuple(x.shape) for x in got] == [(0, 5)] * 3
    for f, c in ((torch.zeros(2, 5, 8), torch.zeros(3, 4, 8)),
                 (torch.zeros(2, 5, 8), torch.zeros(2, 4, 6)),
                 (torch.zeros(5, 8), torch.zeros(4, 8))):
        with pytest.raises(ValueError, match="\\(S, B, D\\)"):
            ops.centroid_assign_stacked(f, c)
    ops.reset_launches()
    ops.centroid_assign_stacked(torch.ones(2, 4, 8), torch.zeros(2, 3, 8))
    assert ops.LAUNCHES["centroid_assign"] == 0       # the CPU's plain path


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


def _i32(x):
    return torch.from_numpy(np.asarray(x, np.int32))


def _ranges_case(name):
    """(a, b, lo, hi, threshold) with a a view into b's rows where the case
    says so: the ranges the tracker builds, and every edge of a range."""
    r = np.random.default_rng(len(name))
    D = 48
    if name == "tracker":
        # three frames of 4 crops after a retained frame of 4 references,
        # all in one buffer; each frame's crops search the previous frame's
        # rows, and 2 of 3 crops are near duplicates of one there
        b = r.random((16, D), dtype=np.float32)
        for i in range(4, 16):
            if i % 3:
                b[i] = np.clip(b[i - 4] + r.normal(0, 0.003, D), 0, 1)
        lo = [0] * 4 + [4] * 4 + [8] * 4
        hi = [4] * 4 + [8] * 4 + [12] * 4
        return b[4:], b, lo, hi, 0.02
    if name == "empty_and_single":
        b = r.random((9, D), dtype=np.float32)
        a = r.random((6, D), dtype=np.float32)
        a[1] = b[3]
        return a, b, [0, 3, 5, 9, 2, 7], [0, 4, 6, 9, 1, 8], 0.5
    if name == "overlapping":
        b = r.random((20, D), dtype=np.float32)
        a = np.clip(b[[2, 5, 11, 17, 8]] + r.normal(0, 0.01, (5, D)), 0, 1
                    ).astype(np.float32)
        return a, b, [0, 2, 4, 0, 10], [9, 9, 12, 20, 20], 0.05
    if name == "same_buffer":
        # every row against all rows: itself included, so it matches
        # itself unless an identical row comes first
        b = r.random((10, D), dtype=np.float32)
        b[7] = b[2]
        return b, b, [0] * 10, [10] * 10, 1e-6
    if name == "ties":
        b = r.random((12, D), dtype=np.float32)
        b[[3, 6, 9]] = b[0]
        a = np.clip(b[[0, 0, 0]] + r.normal(0, 0.01, (3, D)), 0, 1
                    ).astype(np.float32)
        return a, b, [0, 1, 4], [12, 12, 10], 0.5
    # threshold exactly at a mean: |0 - 0.5| sums exactly in any order
    b = np.full((4, D), 0.5, np.float32)
    b[2] = 0.25
    a = np.zeros((3, D), np.float32)
    return a, b, [0, 0, 3], [2, 3, 4], 0.5


def _jax_ranges(a, b, lo, hi, thr):
    """The Pallas kernel (interpret mode) once per distinct range, its
    indices moved to absolute ones."""
    match = np.full(len(a), -1, np.int64)
    min_d = np.full(len(a), np.inf, np.float32)
    for l, h in sorted(set(zip(lo, hi))):
        rows = [i for i in range(len(a)) if (lo[i], hi[i]) == (l, h)]
        if h <= l:
            continue
        m, d = (np.asarray(x) for x in jops.pixel_match(a[rows], b[l:h], thr))
        match[rows] = np.where(m >= 0, m + l, -1)
        min_d[rows] = d
    return match, min_d


@pytest.mark.parametrize("case", ["tracker", "empty_and_single",
                                  "overlapping", "same_buffer", "ties",
                                  "threshold_at_mean"])
def test_pixel_match_ranges_matches_jax(case):
    a, b, lo, hi, thr = _ranges_case(case)
    m, d = ops.pixel_match_ranges(_t(a), _t(b), _i32(lo), _i32(hi), thr)
    assert m.dtype == torch.int32 and d.dtype == torch.float32
    mj, dj = _jax_ranges(a, b, lo, hi, thr)
    np.testing.assert_array_equal(m.numpy(), mj)
    np.testing.assert_allclose(d.numpy(), dj, rtol=1e-6)
    m, d = m.numpy(), d.numpy()
    if case == "tracker":
        assert (m >= 0).sum() == 8
        assert ((m == -1) | ((m >= np.array(lo)) & (m < np.array(hi)))).all()
    elif case == "empty_and_single":
        assert m[0] == m[3] == -1 and np.isinf(d[[0, 3, 4]]).all()
        assert m[1] == 3                    # a length-1 range, its own row
    elif case == "same_buffer":
        assert m.tolist() == [0, 1, 2, 3, 4, 5, 6, 2, 8, 9]
    elif case == "ties":
        assert m.tolist() == [0, 3, 6]      # the lowest of each range's ties
    elif case == "threshold_at_mean":
        assert m.tolist() == [-1, 2, -1]    # 0.5 does not match at 0.5


def test_pixel_match_ranges_clamps_and_validates():
    a, b, lo, hi, thr = _ranges_case("overlapping")
    m, _ = ops.pixel_match_ranges(_t(a), _t(b), _i32([-5, 2, 4, 0, 10]),
                                  _i32([9, 9, 12, 99, 20]), thr)
    want, _ = ops.pixel_match_ranges(_t(a), _t(b), _i32(lo), _i32(hi), thr)
    np.testing.assert_array_equal(m.numpy(), want.numpy())
    with pytest.raises(ValueError):
        ops.pixel_match_ranges(_t(a), _t(b), _i32(lo).long(), _i32(hi), thr)
    with pytest.raises(ValueError):
        ops.pixel_match_ranges(_t(a), _t(b), _i32(lo[:3]), _i32(hi), thr)
    # no rows to match, or nothing to match against
    m, d = ops.pixel_match_ranges(_t(a[:0]), _t(b), _i32([]), _i32([]), thr)
    assert m.shape == d.shape == (0,)
    m, d = ops.pixel_match_ranges(_t(a), _t(b[:0]), _i32(lo), _i32(hi), thr)
    assert (m.numpy() == -1).all() and torch.isinf(d).all()


def test_cpu_tensors_take_the_plain_version():
    ops.reset_launches()
    ops.centroid_assign(torch.ones(4, 8), torch.zeros(3, 8), threshold=1.0)
    ops.pixel_match(torch.ones(4, 8), torch.zeros(3, 8), 0.1)
    ops.pixel_match_ranges(torch.ones(4, 8), torch.zeros(3, 8),
                           _i32([0] * 4), _i32([3] * 4), 0.1)
    ops.dequant_topk(torch.ones(4, 8, dtype=torch.uint8), torch.ones(4), 3)
    ops.topk(torch.ones(4, 8), 3)
    ops.motion_gate(torch.ones(8, 8, 3), torch.zeros(8, 8, 3), 0.05, 0.08)
    ops.motion_gate_frames(torch.ones(3, 8, 8, 3), torch.zeros(8, 8, 3),
                           0.05, 0.08)
    ops.flash_attention(torch.ones(1, 4, 2, 16), torch.ones(1, 4, 2, 16),
                        torch.ones(1, 4, 2, 16))
    assert ops.LAUNCHES == {"centroid_assign": 0, "pixel_match": 0,
                            "dequant_topk": 0, "topk": 0, "motion_gate": 0,
                            "flash_attention": 0}


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


@pytest.mark.parametrize("dtype", [np.uint8, np.int8])
def test_dequant_topk_colliding_scales_match_jax(dtype):
    """Rows whose distinct q give equal values, which the reference ranks
    by column: a subnormal stored scale whose product with the format's
    1/255 underflows to 0 (every q collides; int8's negative q give -0.0,
    equal to +0.0), held exactly against the Pallas kernel and a stable
    argsort; and, at a global scale of 1, a scale so large that the top
    levels overflow to +-inf, held against the stable argsort (the Pallas
    kernel's -3e38 mask sorts above -inf, so it is no oracle there).
    XLA's CPU flushes subnormal products to zero, so a scale that stays
    subnormal is not compared with it."""
    r = np.random.default_rng(9)
    lo = 0 if dtype == np.uint8 else -127
    q = r.integers(lo, 128, (4, 41)).astype(dtype)
    q[:, :6] = np.array([0, 5, 0, 127, 5, 1], dtype)      # planted ties
    scales = np.array([1e-44, 0.5, 7e-45, 2.0], np.float32)
    assert (SG * scales)[[0, 2]].tolist() == [0.0, 0.0]
    vals, idx = _assert_dequant_eq(q, scales, 41)
    x = q.astype(np.float32) * (SG * scales)[:, None]
    order = np.argsort(-x, axis=1, kind="stable")
    np.testing.assert_array_equal(idx, order)
    np.testing.assert_array_equal(idx[[0, 2]], np.arange(41)[None].repeat(
        2, 0))                                    # every q tied: by column
    np.testing.assert_array_equal(
        vals.view(np.uint32), np.take_along_axis(x, order, 1).view(np.uint32))
    big = np.array([3e36, 1.0, 3e36, 1e-30], np.float32)
    with np.errstate(over="ignore"):
        x = q.astype(np.float32) * big[:, None]
    assert np.isinf(x[0]).sum() > 1
    vals, idx = ops.dequant_topk(torch.from_numpy(q), torch.from_numpy(big),
                                 41, global_scale=1.0)
    order = np.argsort(-x, axis=1, kind="stable")
    np.testing.assert_array_equal(idx.numpy(), order)
    np.testing.assert_array_equal(vals.numpy(),
                                  np.take_along_axis(x, order, 1))


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


# ---------------------------------------------------------------------------
# topk
# ---------------------------------------------------------------------------

def _assert_topk_eq(x, k):
    vals, idx = ops.topk(_t(x), k)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    assert vals.shape == idx.shape == (x.shape[0], k)
    jv, ji = jops.topk(x, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    return vals.numpy(), idx.numpy()


@pytest.mark.parametrize("B,C,k", [
    (9, 37, 1), (9, 37, 3), (9, 37, 37), (5, 130, 3), (3, 130, 130),
    (1, 8, 8), (7, 1000, 3),
])
def test_topk_matches_jax(B, C, k):
    """Random rows with planted ties (a column repeated, one row of equal
    values, softmax-like probabilities) give the JAX kernel's values and
    indices exactly."""
    r = np.random.default_rng(B * C + k)
    x = r.normal(size=(B, C)).astype(np.float32)
    x[:, C - 1] = x[:, 0]                     # every row holds a tie
    x[B // 2] = x[B // 2, 1]                  # a row of equal values
    if B > 2:
        e = np.exp(x[2] - x[2].max())
        x[2] = e / e.sum()                    # a probability row
    vals, idx = _assert_topk_eq(x, k)
    order = np.argsort(-x, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(idx, order)
    np.testing.assert_array_equal(vals, np.take_along_axis(x, order, 1))


def test_topk_ties_go_to_the_lowest_column():
    x = np.array([[1, 3, 3, 2, 3], [0, 0, 0, 0, 0]], np.float32)
    _, idx = _assert_topk_eq(x, 3)
    # torch.topk breaks this rule (it gave [2, 4, 1] on the first row)
    assert idx.tolist() == [[1, 2, 4], [0, 1, 2]]


def test_topk_signed_zeros_tie():
    """-0.0 and +0.0 compare equal, so they tie and go to the lowest
    column, in the JAX kernel and the plain version alike; the values
    written are the input bits, signs included."""
    x = np.array([[0.0, -0.0, 0.5, -0.0, 0.0],
                  [-0.0, -1.0, 0.0, -0.0, -2.0]], np.float32)
    vals, idx = _assert_topk_eq(x, 5)
    assert idx.tolist() == [[2, 0, 1, 3, 4], [0, 2, 3, 1, 4]]
    np.testing.assert_array_equal(
        vals.view(np.uint32), np.take_along_axis(x, idx, 1).view(np.uint32))


def test_topk_empty_batch():
    vals, idx = ops.topk(torch.zeros(0, 12), 4)
    assert vals.shape == (0, 4) and idx.shape == (0, 4)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    jv, ji = jops.topk(np.zeros((0, 12), np.float32), 4)
    assert np.asarray(jv).shape == np.asarray(ji).shape == (0, 4)


@pytest.mark.parametrize("x,k", [
    (torch.zeros(3, 5), 6),                          # k > C
    (torch.zeros(3, 5), 0),                          # k < 1
    (torch.zeros(15), 2),                            # not 2-D
    (torch.zeros(3, 5, 2), 2),
    (torch.zeros(3, 5, dtype=torch.float64), 2),     # not float32
])
def test_topk_rejects_bad_inputs(x, k):
    with pytest.raises(ValueError):
        ops.topk(x, k)


# ---------------------------------------------------------------------------
# motion_gate (the shape sweep against the Pallas kernel is in
# test_torch_bgsub.py)
# ---------------------------------------------------------------------------

def test_motion_gate_plain_version_on_the_cpu_matches_jax():
    """A CPU tensor takes the plain version, launches nothing, and gives
    the Pallas kernel's outputs (atol 1e-6, hot masks equal)."""
    r = np.random.default_rng(11)
    f = r.random((40, 56, 3), dtype=np.float32)
    bg = r.random((40, 56, 3), dtype=np.float32)
    before = dict(ops.LAUNCHES)
    nb, t, h = ops.motion_gate(_t(f), _t(bg), 0.1, 0.335, tile=8)
    assert ops.LAUNCHES == before
    assert np.abs(t.numpy() - 0.335).min() > 1e-5
    nbr, tr, hr = (np.asarray(x) for x in jops.motion_gate(f, bg, 0.1, 0.335,
                                                           tile=8))
    np.testing.assert_allclose(nb.numpy(), nbr, atol=1e-6)
    np.testing.assert_allclose(t.numpy(), tr, atol=1e-6)
    np.testing.assert_array_equal(h.numpy(), hr)
    assert 0 < int(h.sum()) < h.numel()


@pytest.mark.parametrize("f,bg,tile", [
    (torch.zeros(8, 8, 3), torch.zeros(8, 8, 3), 0),     # tile < 1
    (torch.zeros(8, 8), torch.zeros(8, 8), 4),            # not (H, W, 3)
    (torch.zeros(8, 8, 4), torch.zeros(8, 8, 4), 4),
    (torch.zeros(8, 8, 3), torch.zeros(8, 9, 3), 4),      # shapes differ
])
def test_motion_gate_rejects_bad_inputs(f, bg, tile):
    with pytest.raises(ValueError):
        ops.motion_gate(f, bg, 0.05, 0.08, tile=tile)


# ---------------------------------------------------------------------------
# flash_attention (tests/test_kernels.py's cases)
# ---------------------------------------------------------------------------



def _qkv(shape, seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    return [r.normal(size=shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("S,dh,causal", [
    (16, 16, True), (64, 32, True), (64, 32, False), (128, 64, True),
    (50, 16, True), (96, 128, False), (1, 32, True),
])
def test_flash_attention_plain_matches_jax(S, dh, causal):
    q, k, v = _qkv((2, S, 3, dh), S + dh)
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=causal)
    assert got.dtype == torch.float32 and got.shape == (2, S, 3, dh)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    for want in (jops.flash_attention(jq, jk, jv, causal=causal, bq=32,
                                      bk=32),
                 jref.flash_attention_ref(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)


def test_flash_attention_plain_bf16_matches_jax():
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16)
                  for x in _qkv((2, 32, 2, 32), 2))
    got = ops.flash_attention(
        *(torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
          for x in (jq, jk, jv)), causal=True)
    assert got.dtype == torch.bfloat16
    want = jops.flash_attention(jq, jk, jv, causal=True, bq=16, bk=16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2)


def test_flash_attention_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        ops.flash_attention(torch.ones(1, 4, 2, 16), torch.ones(1, 5, 2, 16),
                            torch.ones(1, 4, 2, 16))
    with pytest.raises(ValueError):
        ops.flash_attention(torch.ones(4, 2, 16), torch.ones(4, 2, 16),
                            torch.ones(4, 2, 16))
