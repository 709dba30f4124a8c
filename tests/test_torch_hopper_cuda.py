"""The Hopper kernels against their plain PyTorch versions, on the card.

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch and the CUDA toolkit are installed:

  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_hopper_cuda.py

Without a card every test skips. Indices, ``matched`` and match decisions
must be exact; squared distances agree to rtol 1e-5 (fp32 dot products
summed in another order; atol 1e-4 where a distance cancels to ~0) and
mean pixel differences to rtol 1e-6. ``dequant_topk``'s and ``topk``'s
values and indices must be exact, and so must the saved bytes of the
fused pipeline against the staged path on the card, and ``motion_gate``'s
and ``motion_gate_frames``' new background, tile means and hot masks
(bitwise: the EMA is rounded step by step and the tile sums are exact in
fp64). ``flash_attention``
agrees with its plain version to atol = rtol = 2e-5 in fp32 (the JAX
package's own tolerance: the online softmax sums in another order) and to
one bf16 ulp in bf16, rtol 2**-7 with atol 1e-4 (both round one fp32
result to bf16 once, and those fp32 results differ only by the order of
the sums and the kernel's split of p into two bf16 terms, about 2**-17
of p, so the outputs are equal or one ulp apart; one ulp is at most
2**-7 of the value, and atol covers values so small that the fp32
difference spans ulps).
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
                                   (1, 1, 8), (9, 300, 20),
                                   (130, 333, 128),     # ragged B and M
                                   (512, 2048, 128),    # the default serve
                                   (65, 129, 36)])      # D off the k-step
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
def test_centroid_assign_kernel_fills_the_card_and_ties_at_zero(cuda):
    """(512, 4096) runs at least a block per SM; zero features against
    centroids of +0.0 and -0.0 entries (partial scores +0.0, dot products
    of either sign) tie and go to the lowest of them; the duplicated
    halves of an all-dead table give index 0 and nothing matched."""
    from repro_torch.hopper import build
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert build.load().centroid_assign_blocks(512, 4096) >= sms
    D = 128
    f = np.zeros((3, D), np.float32)
    f[2, 0] = -1.0
    c = np.ones((5, D), np.float32)
    c[1] = -0.0
    c[2] = 0.0
    c[3] = -0.0
    c[3, ::2] = 0.0
    got = ops.centroid_assign(_t(f, cuda), _t(c, cuda), threshold=0.5)
    _assert_assign_eq(got, ref.centroid_assign_ref(_t(f, cuda),
                                                   _t(c, cuda), 0.5))
    assert got[1].cpu().tolist() == [1, 1, 1]
    assert got[2].cpu().tolist() == [True, True, False]
    dead = np.full((4096, D), 1e9, np.float32)
    dead[2048:] = dead[:2048]
    _, j, m = ops.centroid_assign(_t(f, cuda), _t(dead, cuda), threshold=0.8)
    assert (j.cpu().numpy() == 0).all() and not m.cpu().numpy().any()


@pytest.mark.cuda
@pytest.mark.parametrize("S,B,M,D", [(8, 512, 4096, 128),
                                     (8, 512, 2048, 128),
                                     (3, 130, 333, 128),    # ragged B, M
                                     (2, 9, 300, 20)])
def test_centroid_assign_stacked_kernel_equals_solo_launches(cuda, S, B, M,
                                                             D):
    """One stacked launch gives every slot the bits of its own solo
    launch, and the plain version's indices and matches; slot 0 has n = 0
    (all rows dead), the last slot is idle (all-zero features), and the
    tables hold ties across centroid tiles."""
    r = np.random.default_rng(S * B + M)
    f = r.normal(size=(S, B, D)).astype(np.float32)
    c = r.normal(size=(S, M, D)).astype(np.float32)
    c[:, M // 2:2 * (M // 2)] = c[:, :M // 2]
    c[0] = 1e9
    f[-1] = 0.0
    T = float(np.sqrt(2 * D))
    F, Cc = _t(f, cuda), _t(c, cuda)
    before = ops.LAUNCHES["centroid_assign"]
    got = ops.centroid_assign_stacked(F, Cc, threshold=T)
    assert ops.LAUNCHES["centroid_assign"] == before + 1
    for s in range(S):
        solo = ops.centroid_assign(F[s], Cc[s], threshold=T)
        for a, b in zip(got, solo):
            assert torch.equal(a[s], b)
        _assert_assign_eq(tuple(x[s] for x in got),
                          ref.centroid_assign_ref(F[s], Cc[s], T))
    assert (got[1][0] == 0).all() and not got[2][0].any()


@pytest.mark.cuda
def test_sharded_runner_on_the_card_equals_solo_pipelines(cuda):
    """Three streams through one stacked pipeline on the card, with the
    full cheap1 CNN and tables small enough to evict: each saves its solo
    pipeline's bytes, counters and sink, with one centroid_assign and one
    topk launch per stacked step (none per stream batch), so the stacked
    unmatched tail scans each slot as its solo scan does."""
    from repro_torch.common.config import CHEAP_CNNS
    from repro_torch.core.ingest import IngestConfig
    from repro_torch.core.pipeline import IngestPipeline
    from repro_torch.core.streaming import (StreamingIngestor,
                                            make_sharded_runner)
    from repro_torch.data.video import get_stream
    from repro_torch.launch.mesh import make_ingest_mesh
    from repro_torch.models import cnn

    names = ["jacksonh", "auburn_c", "cnn"]
    streams = {nm: get_stream(nm, duration_s=20, fps=30).objects_array()[:2]
               for nm in names}
    mcfg = CHEAP_CNNS["cheap1"]
    fwd = cnn.make_forward(cnn.build(mcfg, cnn.init_params(mcfg, 0), cuda))
    # 8 clusters a table, so every stream evicts within its 20 s
    cfg = IngestConfig(K=1000, threshold=0.4, batch_size=256,
                       max_clusters=8)
    got, want = {}, {}
    runner = make_sharded_runner(
        fwd, make_ingest_mesh(1), names, cfg=cfg,
        topk_sink=lambda nm, o, v, i: got.setdefault(nm, []).append(
            (o.copy(), i.copy())),
        n_local_classes=1000)
    before = dict(ops.LAUNCHES)
    for half in (0, 1):
        feeds = {}
        for nm, (crops, frames) in streams.items():
            cut = len(crops) // 2
            sl = slice(0, cut) if half == 0 else slice(cut, None)
            feeds[nm] = (crops[sl], frames[sl])
        runner.feed(feeds)
    out = runner.finish()
    st = runner.pipeline.stats
    assert ops.LAUNCHES["topk"] - before["topk"] == st.n_steps
    assert ops.LAUNCHES["centroid_assign"] - before["centroid_assign"] \
        == st.n_steps
    assert st.n_batches > st.n_steps and st.n_dispatches <= 2 * st.n_steps
    assert all(out[nm][1].n_evictions > 0 for nm in names)
    for nm, (crops, frames) in streams.items():
        sink = []
        ing = StreamingIngestor(
            None, 0.0, cfg, n_local_classes=1000,
            pipeline=IngestPipeline(fwd, cfg, topk_sink=lambda o, v, i:
                                    sink.append((o.copy(), i.copy()))))
        cut = len(crops) // 2
        ing.feed(crops[:cut], frames[:cut])
        ing.feed(crops[cut:], frames[cut:])
        index, stats = ing.finish()
        assert out[nm][0].save_bytes() == index.save_bytes(), nm
        assert vars(out[nm][1]) | {"wall_s": 0} == \
            vars(stats) | {"wall_s": 0}, nm
        for (go, gi), (wo, wi) in zip(got[nm], sink, strict=True):
            np.testing.assert_array_equal(go, wo)
            np.testing.assert_array_equal(gi, wi)


def _ranges_pair(a, b, lo, hi, thr):
    before = ops.LAUNCHES["pixel_match"]
    m, d = ops.pixel_match_ranges(a, b, lo, hi, thr)
    assert ops.LAUNCHES["pixel_match"] == before + 1
    mr, dr = ref.pixel_match_ranges_ref(a, b, lo, hi, thr)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(m.cpu().numpy(), mr.cpu().numpy())
    np.testing.assert_allclose(d.cpu().numpy(), dr.cpu().numpy(), rtol=1e-6)
    return m.cpu().numpy()


@pytest.mark.cuda
def test_pixel_match_ranges_kernel_tracker_ranges(cuda):
    """A tracker-like window in one buffer: 600 frames of 1-9 crops, each
    frame's crops against the previous frame's rows (empty across the
    planted gaps), a third of them near duplicates; one launch."""
    r = np.random.default_rng(17)
    D = 3072
    sizes = r.integers(1, 10, 600)
    frames = np.repeat(np.arange(600), sizes)
    frames[frames % 50 == 7] += 1           # gaps: frame 7 joins frame 8
    n = len(frames)
    rows = r.random((n, D), dtype=np.float32)
    prev = np.searchsorted(frames, frames - 1)
    for i in range(n):
        if frames[prev[i]] == frames[i] - 1 and r.random() < 0.33:
            rows[i] = np.clip(rows[prev[i]] + r.normal(0, 0.01, D), 0, 1)
    lo = np.searchsorted(frames, frames - 1, side="left")
    hi = np.searchsorted(frames, frames - 1, side="right")
    n_ref = int(sizes[0])
    b = _t(rows, cuda)
    bounds = torch.from_numpy(np.stack([lo, hi])[:, n_ref:].astype(
        np.int32)).to(cuda)
    m = _ranges_pair(b[n_ref:], b, bounds[0], bounds[1], 0.02)
    assert (m >= 0).sum() > n // 5 and (m == -1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("Na", [1, 4, 300])
def test_pixel_match_ranges_kernel_one_long_range(cuda, Na):
    """One 20000-row range split over the card and merged in the launch:
    a planted pair of equal nearest rows far apart (the lower wins)."""
    r = np.random.default_rng(Na)
    D, Nb = 3072, 20000
    b = r.random((Nb, D), dtype=np.float32)
    b[17000] = b[4321]
    a = r.random((Na, D), dtype=np.float32)
    a[0] = np.clip(b[4321] + r.normal(0, 0.01, D), 0, 1)
    lo = torch.zeros(Na, dtype=torch.int32, device=cuda)
    hi = torch.full((Na,), Nb, dtype=torch.int32, device=cuda)
    m = _ranges_pair(_t(a, cuda), _t(b, cuda), lo, hi, 0.2)
    assert m[0] == 4321 and (m[1:] == -1).all()
    # the same, as a range that starts past the planted pair's lower row
    lo += 5000
    m = _ranges_pair(_t(a, cuda), _t(b, cuda), lo, hi, 0.2)
    assert m[0] == 17000


@pytest.mark.cuda
def test_pixel_match_ranges_kernel_edges(cuda):
    """Empty, length-1, clamped and overlapping ranges, a view of one
    buffer, and one launch per call however the ranges split."""
    r = np.random.default_rng(3)
    b = _t(r.random((40, 3072), dtype=np.float32), cuda)
    b[30] = b[5]
    lo = torch.tensor([0, 31, 9, -3, 31, 0], dtype=torch.int32, device=cuda)
    hi = torch.tensor([40, 32, 8, 99, 40, 0], dtype=torch.int32, device=cuda)
    m = _ranges_pair(b[30:36], b, lo, hi, 1e-6)
    assert m.tolist() == [5, 31, -1, 33, 34, -1]


@pytest.mark.cuda
@pytest.mark.parametrize("Na,Nb,D", [(3, 3, 3072), (4, 512, 3072),
                                     (130, 257, 96), (1, 9, 3072)])
def test_pixel_match_kernel_matches_plain(cuda, Na, Nb, D):
    r = np.random.default_rng(Na + Nb)
    a = r.random((Na, D), dtype=np.float32)
    b = r.random((Nb, D), dtype=np.float32)
    b[Nb // 2] = b[0]                            # planted tie
    a[0] = np.clip(b[0] + r.normal(0, 0.01, D), 0, 1)
    before = ops.LAUNCHES["pixel_match"]
    m, d = ops.pixel_match(_t(a, cuda), _t(b, cuda), 0.2)
    assert ops.LAUNCHES["pixel_match"] == before + 1   # merged in-launch
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
@pytest.mark.parametrize("dtype", [np.uint8, np.int8])
def test_dequant_topk_kernel_colliding_values(cuda, dtype):
    """Distinct q with equal values rank by column, as in the plain
    version: a scale that underflows to 0 (every q, -0.0 with +0.0), one
    whose top levels overflow to inf, a subnormal scale (exact distinct
    products, not flushed), and a negative scale (values fall with q).
    The plain version runs on the CPU: the card's sort orders -0.0 below
    +0.0 by their bits, and the contract ties them."""
    r = np.random.default_rng(12)
    lo = 0 if dtype == np.uint8 else -127
    q = r.integers(lo, 128, (6, 1000)).astype(dtype)
    q[:, :6] = np.array([0, 5, 0, 127, 5, 1], dtype)
    for sg, scales in ((np.float32(1 / 255), [1e-44, 0.5, 7e-45, 2.0, 1.0,
                                              3e38]),
                       (np.float32(1.0), [3e36, 1e-44, -0.25, 1e-40, 0.0,
                                          1.0])):
        qt = torch.from_numpy(q).to(cuda)
        st = torch.tensor(scales, dtype=torch.float32, device=cuda)
        for k in (1000, 7):
            v, i = ops.dequant_topk(qt, st, k, global_scale=sg)
            vr, ir = ref.dequant_topk_ref(qt.cpu(), st.cpu(), k, sg)
            torch.cuda.synchronize()
            np.testing.assert_array_equal(i.cpu().numpy(), ir.numpy())
            np.testing.assert_array_equal(v.cpu().numpy().view(np.uint32),
                                          vr.numpy().view(np.uint32))


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


def _topk_pair(x, k):
    before = ops.LAUNCHES["topk"]
    v, i = ops.topk(x, k)
    assert ops.LAUNCHES["topk"] == before + (x.shape[0] > 0)
    vr, ir = ref.topk_ref(x, k)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(i.cpu().numpy(), ir.cpu().numpy())
    np.testing.assert_array_equal(v.cpu().numpy(), vr.cpu().numpy())
    return i.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,k,levels", [
    (512, 1000, 1000, None),             # the pipeline's shape
    (512, 1000, 1000, 4),                # ties everywhere
    (64, 1000, 10, None),                # k < C
    (33, 37, 5, None),                   # ragged C
    (7, 130, 130, 2),
    (5, 1, 1, None),
    (3, 12288, 1, None),                 # the widest row: 16384 keys
    (9, 1025, 1025, 3),                  # one past a power of two
])
def test_topk_kernel_matches_plain(cuda, B, C, k, levels):
    r = np.random.default_rng(B + C + k)
    x = r.random((B, C), dtype=np.float32)
    if levels is not None:
        x = np.floor(x * levels).astype(np.float32)
    x /= x.sum(1, keepdims=True) + 1
    x[B // 2] = 0.5                              # a row of equal values
    _topk_pair(_t(x, cuda), k)


@pytest.mark.cuda
def test_topk_kernel_ties_empty_and_errors(cuda):
    x = torch.tensor([[1, 3, 3, 2, 3]], dtype=torch.float32, device=cuda)
    assert _topk_pair(x, 5).tolist() == [[1, 2, 4, 3, 0]]
    _topk_pair(torch.zeros(0, 1000, device=cuda), 7)    # no launch
    with pytest.raises(ValueError):
        ops.topk(torch.zeros(2, ops.TOPK_MAX_C + 1, device=cuda), 1)
    with pytest.raises(ValueError):
        ops.topk(torch.zeros(2, 8, device=cuda).T, 1)   # not contiguous
    with pytest.raises(ValueError):
        ops.topk(torch.zeros(2, 8, dtype=torch.float16, device=cuda), 1)


@pytest.mark.cuda
def test_topk_kernel_signed_zeros_tie(cuda):
    """-0.0 and +0.0 tie and go to the lowest column, as in the JAX kernel
    and the plain version on the CPU; the values are the input bits."""
    x = torch.tensor([[0.0, -0.0, 0.5, -0.0, 0.0],
                      [-0.0, -1.0, 0.0, -0.0, -2.0]])
    before = ops.LAUNCHES["topk"]
    v, i = ops.topk(x.to(cuda), 5)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["topk"] == before + 1
    v, i = v.cpu(), i.cpu()
    assert i.tolist() == [[2, 0, 1, 3, 4], [0, 2, 3, 1, 4]]
    vr, ir = ref.topk_ref(x, 5)
    assert torch.equal(i, ir)
    bits = torch.take_along_dim(x, i.long(), 1).view(torch.int32)
    assert torch.equal(v.view(torch.int32), bits)


@pytest.mark.cuda
def test_pipeline_on_the_card_equals_staged(cuda):
    """The fused pipeline on the card, with the full cheap1 CNN, saves the
    staged path's bytes and launches topk once per megastep."""
    from repro_torch.common.config import CHEAP_CNNS
    from repro_torch.core.ingest import IngestConfig, ingest
    from repro_torch.core.pipeline import IngestPipeline, staged_cheap_apply
    from repro_torch.data.video import get_stream
    from repro_torch.models import cnn

    crops, frames = get_stream("jacksonh", duration_s=30,
                               fps=30).objects_array()[:2]
    mcfg = CHEAP_CNNS["cheap1"]
    fwd = cnn.make_forward(cnn.build(mcfg, cnn.init_params(mcfg, 0), cuda))
    cfg = IngestConfig(K=1000, threshold=0.4, batch_size=256)
    sunk = []
    pipe = IngestPipeline(fwd, cfg, topk_sink=lambda o, v, i: sunk.append(o))
    before = ops.LAUNCHES["topk"]
    piped, p_stats = ingest(crops, frames, None, 0.0, cfg,
                            n_local_classes=1000, pipeline=pipe)
    assert ops.LAUNCHES["topk"] - before == pipe.stats.n_batches > 1
    staged, s_stats = ingest(crops, frames, staged_cheap_apply(fwd, cfg), 0.0,
                             cfg, n_local_classes=1000)
    assert piped.save_bytes() == staged.save_bytes()
    assert p_stats.n_cnn_invocations == s_stats.n_cnn_invocations \
        == len(np.concatenate(sunk))


def _gate_pair(f, bg, alpha, thr, tile):
    """The kernel and its plain version on the same card-resident inputs:
    new_bg, tiles and hot must be bitwise equal."""
    before = ops.LAUNCHES["motion_gate"]
    got = ops.motion_gate(f, bg, alpha, thr, tile=tile)
    assert ops.LAUNCHES["motion_gate"] == before + 1
    want = ref.motion_gate_ref(f, bg, alpha, thr, tile)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
    return [x.cpu().numpy() for x in got]


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,tile", [
    (128, 128, 8),                       # the stream's frames
    (720, 1280, 8),                      # a 720p camera
    (70, 51, 8), (33, 95, 8), (16, 24, 4),
    (4, 20, 8),                          # smaller than one tile: EMA only
])
def test_motion_gate_kernel_matches_plain(cuda, H, W, tile):
    r = np.random.default_rng(H + W + tile)
    f = r.random((H, W, 3), dtype=np.float32)
    bg = f + r.normal(0, 0.1, (H, W, 3)).astype(np.float32)
    nb, t, h = _gate_pair(_t(f, cuda), _t(bg, cuda), 0.05, 0.08, tile)
    assert t.shape == h.shape == (H // tile, W // tile)
    if t.size:
        assert 0 < h.sum() < h.size


@pytest.mark.cuda
def test_motion_gate_kernel_edges(cuda):
    r = np.random.default_rng(7)
    f = _t(r.random((64, 64, 3), dtype=np.float32), cuda)
    bg = _t(r.random((64, 64, 3), dtype=np.float32), cuda)
    _, t, h = _gate_pair(f, f, 0.05, 0.0, 8)             # static: cold
    assert (t == 0).all() and not h.any()
    z = torch.zeros(16, 16, 3, device=cuda)
    half = torch.full((16, 16, 3), 0.5, device=cuda)
    _, t, h = _gate_pair(z, half, 0.05, 0.5, 8)           # strict >
    assert (t == 0.5).all() and not h.any()
    _, _, h = _gate_pair(z, half, 0.05, 0.4999, 8)
    assert h.all()
    nb, _, _ = _gate_pair(f, bg, 0.0, 0.1, 8)             # alpha = 0
    assert (nb == bg.cpu().numpy()).all()
    nb, _, _ = _gate_pair(f, bg, 1.0, 0.1, 8)             # alpha = 1
    assert (nb == f.cpu().numpy()).all()
    with pytest.raises(ValueError):
        ops.motion_gate(f.double(), bg.double(), 0.05, 0.08)
    with pytest.raises(ValueError):
        ops.motion_gate(f.transpose(0, 1), bg, 0.05, 0.08)


@pytest.mark.cuda
def test_background_subtractor_on_the_card_equals_the_cpu(cuda):
    """jacksonh's first 300 frames: the card (one kernel launch per frame
    after the first) and the CPU give the same boxes on every frame and
    the same background bit for bit."""
    from repro_torch.data.bgsub import BackgroundSubtractor
    from repro_torch.data.video import get_stream

    card = BackgroundSubtractor(device="cuda")
    cpu = BackgroundSubtractor(device="cpu")
    before = ops.LAUNCHES["motion_gate"]
    n_boxes = 0
    for frame in get_stream("jacksonh", duration_s=10, fps=30).frames():
        boxes = card(frame)
        assert boxes == cpu(frame)
        n_boxes += len(boxes)
    assert ops.LAUNCHES["motion_gate"] - before == 299
    assert n_boxes > 0
    assert (card.background == cpu.background).all()


def _gate_frames_pair(fr, bg, alpha, thr, tile):
    """The window kernel (one launch) and its plain version on the same
    card-resident inputs: new_bg, tiles and hot must be bitwise equal."""
    before = ops.LAUNCHES["motion_gate"]
    got = ops.motion_gate_frames(fr, bg, alpha, thr, tile=tile)
    assert ops.LAUNCHES["motion_gate"] == before + 1
    want = ref.motion_gate_frames_ref(fr, bg, alpha, thr, tile)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
    return [x.cpu().numpy() for x in got]


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W,tile", [
    (300, 128, 128, 8),                  # a window of the stream's frames
    (5, 720, 1280, 8),                   # a 720p window
    (1, 128, 128, 8),                    # a window of one
    (9, 70, 51, 8), (17, 33, 95, 8),     # ragged: remainder rows/columns
    (3, 16, 24, 4), (11, 130, 70, 3),    # other groups per tile
    (4, 128, 128, 16), (5, 64, 64, 1),
    (3, 90, 100, 30),                    # tiles too large for registers
    (4, 4, 20, 8),                       # smaller than one tile: EMA only
])
def test_motion_gate_frames_kernel_matches_plain(cuda, N, H, W, tile):
    r = np.random.default_rng(N + H + W + tile)
    fr = r.random((N, H, W, 3), dtype=np.float32)
    bg = fr[0] + r.normal(0, 0.1, (H, W, 3)).astype(np.float32)
    nb, t, h = _gate_frames_pair(_t(fr, cuda), _t(bg, cuda), 0.05, 0.08,
                                 tile)
    assert t.shape == h.shape == (N, H // tile, W // tile)
    if t.size:
        assert 0 < h.sum() < h.size


@pytest.mark.cuda
def test_motion_gate_frames_kernel_edges(cuda):
    r = np.random.default_rng(8)
    bg = _t(r.random((64, 64, 3), dtype=np.float32), cuda)
    fr = _t(r.random((6, 64, 64, 3), dtype=np.float32), cuda)
    static = bg[None].repeat(4, 1, 1, 1).contiguous()
    _, t, h = _gate_frames_pair(static, bg, 0.5, 0.0, 8)   # static: cold
    assert (t == 0).all() and not h.any()
    z = torch.zeros(3, 16, 16, 3, device=cuda)
    half = torch.full((16, 16, 3), 0.5, device=cuda)
    _, t, h = _gate_frames_pair(z, half, 0.0, 0.5, 8)       # strict >
    assert (t == 0.5).all() and not h.any()
    _, _, h = _gate_frames_pair(z, half, 0.0, 0.4999, 8)
    assert h.all()
    nb, _, _ = _gate_frames_pair(fr, bg, 0.0, 0.1, 8)       # alpha = 0
    assert (nb == bg.cpu().numpy()).all()
    nb, _, _ = _gate_frames_pair(fr, bg, 1.0, 0.1, 8)       # alpha = 1
    assert (nb == fr[-1].cpu().numpy()).all()
    before = ops.LAUNCHES["motion_gate"]
    nb, t, h = ops.motion_gate_frames(fr[:0], bg, 0.05, 0.08)
    assert ops.LAUNCHES["motion_gate"] == before
    assert torch.equal(nb, bg) and t.shape == h.shape == (0, 8, 8)
    with pytest.raises(ValueError):
        ops.motion_gate_frames(fr.double(), bg.double(), 0.05, 0.08)
    with pytest.raises(ValueError):
        ops.motion_gate_frames(fr.transpose(1, 2), bg, 0.05, 0.08)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 7])
def test_background_subtractor_process_on_the_card_equals_the_cpu(cuda,
                                                                   window):
    """jacksonh's first 300 frames through ``process`` on the card (one
    ``motion_gate`` launch per window after the first frame, in one
    64 MB window or in windows of 7) against per-frame calls on the CPU:
    the same boxes on every frame and the same background bit for bit."""
    from repro_torch.data.bgsub import BackgroundSubtractor
    from repro_torch.data.video import get_stream

    frames = list(get_stream("jacksonh", duration_s=10, fps=30).frames())
    card = BackgroundSubtractor(device="cuda")
    if window is not None:
        card.WINDOW_BYTES = window * frames[0].nbytes
    cpu = BackgroundSubtractor(device="cpu")
    before = ops.LAUNCHES["motion_gate"]
    got = card.process(frames)
    n_windows = -(-299 // (window or 299))
    assert ops.LAUNCHES["motion_gate"] - before == n_windows
    assert got == [cpu(f) for f in frames]
    assert sum(len(b) for b in got) > 0
    assert (card.background == cpu.background).all()


def _flash_pair(q, k, v, causal):
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    return got.float().cpu().numpy(), want.float().cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,dh,causal", [
    (4, 2048, 16, 128, True),            # the olmo-1b prefill's shape
    (2, 1, 3, 64, True), (2, 50, 3, 16, True), (1, 1000, 2, 32, True),
    (2, 96, 3, 128, False), (2, 64, 3, 32, False), (2, 130, 2, 16, False),
])
def test_flash_attention_kernel_matches_plain_fp32(cuda, B, S, H, dh,
                                                    causal):
    r = np.random.default_rng(S + dh)
    q, k, v = (_t(r.normal(size=(B, S, H, dh)), cuda) for _ in range(3))
    got, want = _flash_pair(q, k, v, causal)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 129, 2048])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_flash_attention_kernel_matches_plain_bf16(cuda, S, causal, dh):
    """Every ragged edge of the 64-row tiles, every head width; B*H = 64
    (the LM prefill's 4 x 16) at S = 2048."""
    B, H = (4, 16) if S == 2048 else (2, 3)
    r = np.random.default_rng(S + dh)
    q, k, v = (_t(r.normal(size=(B, S, H, dh)), cuda).bfloat16()
               for _ in range(3))
    got, want = _flash_pair(q, k, v, causal)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=2 ** -7)


@pytest.mark.cuda
def test_flash_attention_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 2, 48, device=cuda)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q)                 # dh not built
    q = torch.zeros(1, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError):
        ops.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError):
        ops.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                            q.transpose(1, 2))
    off = torch.zeros(q.numel() + 1, dtype=torch.bfloat16,
                      device=cuda)[1:].view(q.shape)  # 2 bytes off
    with pytest.raises(ValueError):
        ops.flash_attention(off, off, off)
