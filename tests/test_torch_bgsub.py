"""The port's background subtraction (§6.1) against the JAX package's, on the
same numpy inputs.

``VideoStream.frames()`` must be byte-identical. ``motion_gate_ref`` (the
plain version the port's ``hopper.ops.motion_gate`` runs for CPU tensors)
is held against the Pallas ``frame_gate`` kernel in interpret mode and the
JAX package's own reference: the EMA background to atol 1e-6 and the tile
means to atol 1e-6 (the JAX package rounds the channel mean to fp32 before
the tile mean; the port sums each tile in fp64 and rounds once), with the
hot masks equal and every threshold kept more than 1e-5 away from the
tile values. ``motion_gate_frames_ref`` (the plain version of the port's
one-launch window) is held to N sequential steps of the Pallas kernel at
the same tolerances. ``BackgroundSubtractor(device="cpu")`` must give the
JAX package's boxes and crops on every frame, per frame and through
``process``, and ``process`` must equal the per-frame calls bit for bit
however the frames are cut into windows.
"""
import numpy as np
import pytest
import torch

from repro.data import get_stream as jax_get_stream
from repro.data.bgsub import BackgroundSubtractor as JBackgroundSubtractor
from repro.data.bgsub import extract_crops as jax_extract_crops
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.data.bgsub import (BackgroundSubtractor, MotionBox,
                                    extract_crops)
from repro_torch.data.video import get_stream
from repro_torch.hopper import ops, ref


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _off_tiles(tiles: np.ndarray, thr: float) -> float:
    """``thr`` moved until no tile mean lies within 1e-5 of it."""
    while tiles.size and np.abs(tiles - thr).min() < 1e-5:
        thr += 3.7e-5
    return thr


@pytest.mark.parametrize("name", ["lausanne", "jacksonh"])
def test_frames_are_byte_identical(name):
    got = list(get_stream(name, duration_s=4, fps=10).frames(max_frames=30))
    want = list(jax_get_stream(name, duration_s=4, fps=10).frames(
        max_frames=30))
    assert len(got) == len(want) == 30
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("H,W,tile", [
    (8, 8, 8), (64, 64, 8), (70, 51, 8), (128, 128, 16), (33, 95, 8),
    (16, 24, 4),
])
@pytest.mark.parametrize("alpha,thr", [(0.05, 0.08), (0.3, 0.33), (1.0, 0.2)])
def test_motion_gate_ref_matches_jax(H, W, tile, alpha, thr):
    r = np.random.default_rng(H * W + tile)
    f = r.random((H, W, 3), dtype=np.float32)
    bg = r.random((H, W, 3), dtype=np.float32)
    bg[: H // 2] = f[: H // 2] + r.normal(0, 0.05, (H // 2, W, 3)
                                         ).astype(np.float32)
    tiles0 = ref.motion_gate_ref(_t(f), _t(bg), alpha, 0.0, tile)[1]
    thr = _off_tiles(tiles0.numpy(), thr)
    nb, t, h = ops.motion_gate(_t(f), _t(bg), alpha, thr, tile=tile)
    assert nb.shape == (H, W, 3) and t.shape == (H // tile, W // tile)
    assert h.dtype == torch.bool and t.dtype == torch.float32
    assert 0 < int(h.sum()) < h.numel() or h.numel() == 1
    for want in (jops.motion_gate(f, bg, alpha, thr, tile=tile),
                 jref.motion_gate_ref(f, bg, alpha, thr, tile)):
        nbr, tr, hr = (np.asarray(x) for x in want)
        np.testing.assert_allclose(nb.numpy(), nbr, atol=1e-6, rtol=0)
        np.testing.assert_allclose(t.numpy(), tr, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(h.numpy(), hr)


def test_motion_gate_ref_edges():
    r = np.random.default_rng(5)
    # smaller than one tile: the EMA over every pixel, an empty grid
    f = r.random((4, 20, 3), dtype=np.float32)
    bg = r.random((4, 20, 3), dtype=np.float32)
    nb, t, h = ops.motion_gate(_t(f), _t(bg), 0.05, 0.08, tile=8)
    assert t.shape == h.shape == (0, 2)
    nbr, _, _ = jops.motion_gate(f, bg, 0.05, 0.08, tile=8)
    np.testing.assert_allclose(nb.numpy(), np.asarray(nbr), atol=1e-6)
    # a static frame is cold everywhere, even at threshold 0 (strict >)
    _, t, h = ops.motion_gate(_t(f), _t(f), 0.05, 0.0, tile=2)
    assert (t.numpy() == 0).all() and not h.any()
    # strict threshold on exactly-summable tiles: mean |0 - 0.5| == 0.5
    z, half = np.zeros((16, 16, 3), np.float32), np.full((16, 16, 3), 0.5,
                                                         np.float32)
    for thr, hot in ((0.5, False),
                     (float(np.nextafter(np.float32(0.5), np.float32(0))),
                      True)):
        _, t, h = ops.motion_gate(_t(z), _t(half), 0.05, thr, tile=8)
        assert (t.numpy() == 0.5).all() and bool(h.all()) is hot
        _, _, hj = jops.motion_gate(z, half, 0.05, thr, tile=8)
        np.testing.assert_array_equal(h.numpy(), np.asarray(hj))
    # alpha = 0 keeps the background, alpha = 1 takes the frame, bit for bit
    assert torch.equal(ops.motion_gate(_t(f), _t(bg), 0.0, 0.1)[0], _t(bg))
    assert torch.equal(ops.motion_gate(_t(f), _t(bg), 1.0, 0.1)[0], _t(f))


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_bgsub_matches_jax_on_planted_objects(backend):
    """lausanne's first 60 frames (the analogue of the JAX package's
    ``test_bgsub_detects_planted_objects``): the same boxes and crops on
    every frame, and the same background model."""
    vs = get_stream("lausanne", duration_s=20, fps=5)
    port = BackgroundSubtractor(threshold=0.05, device="cpu")
    jax_bs = JBackgroundSubtractor(threshold=0.05, backend=backend)
    n_boxes = 0
    for frame in vs.frames(max_frames=60):
        boxes = port(frame)
        assert boxes == jax_bs(frame)
        assert all(isinstance(b, MotionBox) for b in boxes)
        crops = extract_crops(frame, boxes, vs.cfg.obj_res)
        assert crops.shape == (len(boxes), 32, 32, 3)
        np.testing.assert_array_equal(
            crops, jax_extract_crops(frame, boxes, vs.cfg.obj_res))
        n_boxes += len(boxes)
    assert n_boxes > 0
    if backend == "numpy":                 # the same fp32 ops in one order
        np.testing.assert_array_equal(port.background, jax_bs._bg)
    else:
        np.testing.assert_allclose(port.background, np.asarray(jax_bs._bg),
                                   atol=1e-6)


def test_bgsub_edge_cases():
    r = np.random.default_rng(0)
    # smaller than one tile: [] on every frame, the background still tracks
    for shape in ((4, 40, 3), (40, 5, 3)):
        bs = BackgroundSubtractor(tile=8, device="cpu")
        f0 = r.random(shape, dtype=np.float32)
        assert bs(f0) == [] and bs(np.ones_like(f0)) == []
        assert bs._bg.shape == f0.shape
        np.testing.assert_array_equal(
            bs.background, ((1 - np.float32(0.05)) * f0
                            + np.float32(0.05) * np.ones_like(f0)))
    # non-multiple resolution: boxes stay inside the complete tiles
    bs = BackgroundSubtractor(tile=8, min_tiles=1, threshold=0.05,
                              device="cpu")
    base = np.zeros((70, 51, 3), np.float32)
    bs(base)
    hot = base.copy()
    hot[8:32, 8:32] = 1.0
    boxes = bs(hot)
    assert boxes == [MotionBox(8, 8, 32, 32)]
    # a constant stream stays silent; the first frame seeds, yields []
    bs = BackgroundSubtractor(tile=8, min_tiles=1, device="cpu")
    f = np.full((64, 64, 3), 0.3, np.float32)
    assert all(bs(f.copy()) == [] for _ in range(5))
    with pytest.raises(ValueError):
        BackgroundSubtractor(tile=0, device="cpu")


def test_components_equal_bfs_and_jax():
    bs = BackgroundSubtractor(tile=8, device="cpu")
    jbs = JBackgroundSubtractor(tile=8, backend="numpy")
    rng = np.random.default_rng(0)
    for density in (0.1, 0.3, 0.5, 0.8):
        for _ in range(10):
            hot = rng.random((9, 13)) < density
            boxes = bs._components(hot)
            assert boxes == bs._components_bfs(hot) == jbs._components(hot)
    assert bs._components(np.zeros((5, 5), bool)) == []
    assert bs._components(np.ones((1, 1), bool)) == \
        bs._components_bfs(np.ones((1, 1), bool))


def test_bgsub_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BackgroundSubtractor()


def _moving_frames(H, W, n, seed):
    """n frames: a noisy static scene with a bright square moving across
    it, so each frame has hot and cold tiles."""
    r = np.random.default_rng(seed)
    base = r.random((H, W, 3), dtype=np.float32)
    out = []
    for i in range(n):
        f = np.clip(base + r.normal(0, 0.02, base.shape), 0, 1
                    ).astype(np.float32)
        y, x = (3 * i) % max(1, H - 8), (5 * i) % max(1, W - 8)
        f[y:y + 12, x:x + 12] = 1.0
        out.append(f)
    return np.stack(out)


@pytest.mark.parametrize("H,W,tile", [(64, 64, 8), (70, 51, 8), (33, 95, 8),
                                      (16, 24, 4), (4, 20, 8)])
@pytest.mark.parametrize("alpha,thr", [(0.05, 0.08), (0.3, 0.2)])
def test_motion_gate_frames_ref_matches_jax_steps(H, W, tile, alpha, thr):
    """The window's plain version (and the CPU wrapper) against N steps of
    the Pallas kernel, each from the background the last one left: the
    background to atol 1e-6 after every step, tile means to atol 1e-6,
    hot masks equal, the threshold kept 1e-5 off every tile mean."""
    fr = _moving_frames(H, W, 6, H * W + tile)
    bg = fr[0] + np.float32(0.03)
    t0 = ref.motion_gate_frames_ref(_t(fr), _t(bg), alpha, 0.0, tile)[1]
    thr = _off_tiles(t0.numpy(), thr)
    nb, t, h = ops.motion_gate_frames(_t(fr), _t(bg), alpha, thr, tile=tile)
    assert t.shape == h.shape == (6, H // tile, W // tile)
    assert h.dtype == torch.bool and t.dtype == torch.float32
    if h.numel():
        assert 0 < int(h.sum()) < h.numel()
    jbg = bg
    for n in range(6):
        jbg, jt, jh = (np.asarray(x) for x in jops.motion_gate(
            fr[n], jbg, alpha, thr, tile=tile))
        np.testing.assert_allclose(t[n].numpy(), jt, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(h[n].numpy(), jh)
    np.testing.assert_allclose(nb.numpy(), jbg, atol=1e-6, rtol=0)
    # the window is its steps, bit for bit
    b = _t(bg)
    for n in range(6):
        b, tn, hn = ref.motion_gate_ref(_t(fr[n]), b, alpha, thr, tile)
        assert torch.equal(tn, t[n]) and torch.equal(hn, h[n])
    assert torch.equal(b, nb)


def test_motion_gate_frames_edges():
    bg = np.random.default_rng(1).random((16, 16, 3), dtype=np.float32)
    before = dict(ops.LAUNCHES)
    nb, t, h = ops.motion_gate_frames(torch.zeros(0, 16, 16, 3), _t(bg),
                                      0.05, 0.08)
    assert ops.LAUNCHES == before
    assert torch.equal(nb, _t(bg)) and t.shape == h.shape == (0, 2, 2)
    # static frames stay cold (alpha 0.5 keeps a static background exact);
    # a mean exactly at the threshold is cold
    fr = np.stack([bg] * 3)
    _, t, h = ops.motion_gate_frames(_t(fr), _t(bg), 0.5, 0.0)
    assert (t.numpy() == 0).all() and not h.any()
    z = np.zeros((3, 16, 16, 3), np.float32)
    half = np.full((16, 16, 3), 0.5, np.float32)
    _, t, h = ops.motion_gate_frames(_t(z), _t(half), 0.0, 0.5)
    assert (t.numpy() == 0.5).all() and not h.any()
    # alpha = 0 keeps the background, alpha = 1 takes the last frame
    fr = _moving_frames(16, 16, 3, 2)
    assert torch.equal(ops.motion_gate_frames(_t(fr), _t(bg), 0.0, 0.1)[0],
                       _t(bg))
    assert torch.equal(ops.motion_gate_frames(_t(fr), _t(bg), 1.0, 0.1)[0],
                       _t(fr[-1]))


@pytest.mark.parametrize("frames,bg,tile", [
    (torch.zeros(2, 8, 8, 3), torch.zeros(8, 8, 3), 0),    # tile < 1
    (torch.zeros(8, 8, 3), torch.zeros(8, 8, 3), 4),       # not (N, H, W, 3)
    (torch.zeros(2, 8, 8, 4), torch.zeros(8, 8, 4), 4),
    (torch.zeros(2, 8, 8, 3), torch.zeros(8, 9, 3), 4),    # shapes differ
])
def test_motion_gate_frames_rejects_bad_inputs(frames, bg, tile):
    with pytest.raises(ValueError):
        ops.motion_gate_frames(frames, bg, 0.05, 0.08, tile=tile)


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_process_matches_jax_on_jacksonh(backend):
    """jacksonh's first 300 frames through ``process`` in windows of 64
    frames: the JAX package's per-frame boxes on every frame."""
    frames = list(get_stream("jacksonh", duration_s=10, fps=30).frames())
    port = BackgroundSubtractor(device="cpu")
    port.WINDOW_BYTES = 64 * frames[0].nbytes
    got = port.process(frames)
    jax_bs = JBackgroundSubtractor(backend=backend)
    want = [jax_bs(f) for f in frames]
    assert got == want
    assert sum(len(b) for b in got) > 0
    if backend == "numpy":
        np.testing.assert_array_equal(port.background, jax_bs._bg)


@pytest.mark.parametrize("window", [1, 7, 64, "mixed"])
def test_process_is_split_invariant(window):
    """``process`` in windows of 1, 7 and 64 frames, and mixed with
    per-frame calls, equals ``[bs(f) for f in frames]``: the same boxes on
    every frame and the same background bit for bit."""
    frames = list(get_stream("jacksonh", duration_s=5, fps=30).frames())
    ref_bs = BackgroundSubtractor(device="cpu")
    want = [ref_bs(f) for f in frames]
    bs = BackgroundSubtractor(device="cpu")
    if window == "mixed":
        bs.WINDOW_BYTES = 5 * frames[0].nbytes
        got = [bs(f) for f in frames[:10]] + bs.process(frames[10:40])
        got += [bs(f) for f in frames[40:47]] + bs.process(iter(frames[47:]))
    else:
        bs.WINDOW_BYTES = window * frames[0].nbytes
        got = bs.process(frames)
    assert got == want
    assert sum(len(b) for b in want) > 0
    np.testing.assert_array_equal(bs.background, ref_bs.background)


def test_process_edges():
    r = np.random.default_rng(3)
    bs = BackgroundSubtractor(device="cpu")
    assert bs.process([]) == [] and bs._bg is None
    f = r.random((40, 40, 3), dtype=np.float32)
    assert bs.process([f]) == [[]]                    # the first frame seeds
    np.testing.assert_array_equal(bs.background, f)
    # frames smaller than one tile: [] per frame, the background tracks
    small = r.random((3, 4, 40, 3), dtype=np.float32)
    bs, per = (BackgroundSubtractor(tile=8, device="cpu") for _ in range(2))
    assert bs.process(small) == [[], [], []] == [per(x) for x in small]
    np.testing.assert_array_equal(bs.background, per.background)
    # a frame of another shape than the background raises
    with pytest.raises(ValueError):
        BackgroundSubtractor(device="cpu").process([f, f[:32]])
