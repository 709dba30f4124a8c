"""The port's ingest against the JAX package's: the same stream and the
same probs/feats into ``repro.core.ingest.ingest`` and
``repro_torch.core.ingest.ingest`` save byte-identical indexes; an index
saved by either package loads in the other and answers identically; and
the port's own chunked ingest saves the same bytes as one-shot."""
import importlib

import numpy as np
import pytest

from conftest import make_stream
from repro.core.engine import QueryEngine as JQueryEngine
from repro.core.index import TopKIndex as JTopKIndex
from repro.data import get_stream as jax_get_stream
from repro_torch.common.config import CHEAP_CNNS
from repro_torch.core.engine import QueryEngine
from repro_torch.core.index import TopKIndex
from repro_torch.core.streaming import StreamingIngestor
from repro_torch.data.video import STREAM_ZOO, get_stream, gt_oracle
from repro_torch.hopper import ops
from repro_torch.models import cnn

# ``repro.core`` re-exports the function ``ingest`` under the module's name
J = importlib.import_module("repro.core.ingest")
P = importlib.import_module("repro_torch.core.ingest")
Streaming = importlib.import_module("repro_torch.core.streaming")

FEAT_DIM = 12
N_CLASSES = 5


def _cheap(batch):
    flat = batch.reshape(len(batch), -1)
    feats = (flat[:, :FEAT_DIM] * 10.0).astype(np.float32)
    probs = np.abs(flat[:, FEAT_DIM:FEAT_DIM + N_CLASSES]) + 1e-3
    return (probs / probs.sum(1, keepdims=True)).astype(np.float32), feats


def _gt_apply(batch):
    return np.rint(batch[:, 0, 0, 2] * 8).astype(np.int64) % N_CLASSES


def _both(crops, frames, cheap, n_classes, **cfg):
    ij, sj = J.ingest(crops, frames, cheap, 1.0, J.IngestConfig(**cfg),
                      n_local_classes=n_classes)
    ip, sp = P.ingest(crops, frames, cheap, 1.0, P.IngestConfig(**cfg),
                      n_local_classes=n_classes, device="cpu")
    assert vars(sj) | {"wall_s": 0} == vars(sp) | {"wall_s": 0}
    return ij, ip


def _answers(engine, classes, Kx=None):
    results, _ = engine.query_many(classes, Kx)
    return [(r.matched_clusters, r.frames.tolist()) for r in results]


@pytest.mark.parametrize("seed,cfg", [
    (0, dict(K=2, threshold=1.5, max_clusters=24, batch_size=32,
             high_water=0.8, evict_frac=0.5)),
    (1, dict(K=3, threshold=1.5, max_clusters=64, batch_size=64)),
    (2, dict(K=2, threshold=1.5, max_clusters=24, batch_size=100,
             gate=True, high_water=0.8, evict_frac=0.5)),
    (3, dict(K=2, threshold=1.5, max_clusters=32, batch_size=32,
             frame_stride=2)),
    (4, dict(K=2, threshold=0.8, max_clusters=48, batch_size=50,
             clustering="scan")),
    (5, dict(K=2, threshold=1.5, max_clusters=48, batch_size=50,
             clustering="batched", pixel_diff=False)),
])
def test_ingest_bytes_identical_to_jax(seed, cfg):
    crops, frames = make_stream(seed, n=400)
    ij, ip = _both(crops, frames, _cheap, N_CLASSES, **cfg)
    assert ij.save_bytes() == ip.save_bytes()
    assert ij.save_bytes(format=3) == ip.save_bytes(format=3)


def test_video_streams_and_oracle_match_jax():
    assert [s.name for s in STREAM_ZOO][5] == "jacksonh"
    a = get_stream("jacksonh", duration_s=4, fps=30).objects_array()
    b = jax_get_stream("jacksonh", duration_s=4, fps=30).objects_array()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    from benchmarks.common import gt_oracle as jax_gt_oracle
    crops, labels = a[0], a[3]
    np.testing.assert_array_equal(gt_oracle(labels)(crops[:50]),
                                  jax_gt_oracle(labels)(crops[:50]))


@pytest.fixture(scope="module")
def jacksonh_cheap1():
    """jacksonh crops with the seeded cheap1's probs/feats, computed once
    and served to both packages by crop content."""
    crops, frames, _, labels = get_stream(
        "jacksonh", duration_s=20, fps=30).objects_array()
    mcfg = CHEAP_CNNS["cheap1"]
    apply = cnn.make_apply(cnn.build(mcfg, cnn.init_params(mcfg, 0),
                                     device="cpu"))
    probs, feats = apply(crops)
    row = {c.tobytes(): i for i, c in enumerate(crops)}

    def cheap(batch):
        ix = np.array([row[c.tobytes()] for c in batch], np.int64)
        return probs[ix], feats[ix]

    return crops, frames, labels, cheap


@pytest.mark.parametrize("T", [0.8, 0.4])
def test_real_stream_cheap1_bytes_and_answers_identical(jacksonh_cheap1, T,
                                                        tmp_path):
    crops, frames, labels, cheap = jacksonh_cheap1
    ij, ip = _both(crops, frames, cheap, 1000, K=1000, threshold=T,
                   max_clusters=64, batch_size=128)
    assert ij.save_bytes() == ip.save_bytes()
    # cross-load both ways; every engine answers the same
    ij.save(str(tmp_path / "jax"))
    ip.save(str(tmp_path / "port"))
    gt = gt_oracle(labels)
    classes = sorted(set(labels.tolist()))[:6]
    want = _answers(JQueryEngine(ij, gt_apply=gt), classes)
    assert any(frames for _, frames in want)
    assert _answers(QueryEngine(ip, gt_apply=gt), classes) == want
    assert _answers(QueryEngine(TopKIndex.load(str(tmp_path / "jax")),
                                gt_apply=gt), classes) == want
    assert _answers(JQueryEngine(JTopKIndex.load(str(tmp_path / "port")),
                                 gt_apply=gt), classes) == want


@pytest.mark.parametrize("fmt", [3, 4])
def test_cross_load_answers_identical(fmt, tmp_path):
    crops, frames = make_stream(7, n=300)
    ij, ip = _both(crops, frames, _cheap, N_CLASSES, K=3, threshold=1.5,
                   max_clusters=64, batch_size=32)
    ij.save(str(tmp_path / "jax"), format=fmt)
    ip.save(str(tmp_path / "port"), format=fmt)
    from_jax = TopKIndex.load(str(tmp_path / "jax"))
    from_port = JTopKIndex.load(str(tmp_path / "port"))
    # either package loads either file to the same state (v4 is lossy, so
    # a re-save is compared with the other package's load, not the source)
    for path in ("jax", "port"):
        assert (TopKIndex.load(str(tmp_path / path)).save_bytes(format=fmt)
                == JTopKIndex.load(str(tmp_path / path)).save_bytes(
                    format=fmt))
    for Kx in (None, 1, 2):
        want = _answers(JQueryEngine(JTopKIndex.load(str(tmp_path / "jax")),
                                     gt_apply=_gt_apply), range(N_CLASSES), Kx)
        assert _answers(QueryEngine(from_jax, gt_apply=_gt_apply),
                        range(N_CLASSES), Kx) == want
        assert _answers(JQueryEngine(from_port, gt_apply=_gt_apply),
                        range(N_CLASSES), Kx) == want


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_port_chunked_equals_oneshot(seed):
    """Random chunk splits with interleaved flushes save byte-identically
    to the port's one-shot ingest, across eviction boundaries."""
    r = np.random.default_rng(seed)
    crops, frames = make_stream(seed, n=400)
    cfg = P.IngestConfig(K=2, threshold=1.5, max_clusters=24,
                         batch_size=int(r.choice([32, 64, 100])),
                         high_water=0.8, evict_frac=0.5, gate=bool(seed % 2))
    ref, _ = P.ingest(crops, frames, _cheap, 1.0, cfg,
                      n_local_classes=N_CLASSES, device="cpu")
    cuts = np.sort(r.choice(np.arange(1, len(crops)), size=int(
        r.integers(1, 12)), replace=False))
    bounds = [0, *cuts.tolist(), len(crops)]
    ing = StreamingIngestor(_cheap, 1.0, cfg, n_local_classes=N_CLASSES,
                            device="cpu")
    for lo, hi in zip(bounds, bounds[1:]):
        ing.feed(crops[lo:hi], frames[lo:hi])
        ing.flush()
    index, stats = ing.finish()
    assert stats.n_evictions > 0
    assert index.save_bytes() == ref.save_bytes()


@pytest.mark.parametrize("window", [8192, 7, 1])
def test_pixel_tracks_match_jax(window, monkeypatch):
    """One window, and windows whose edges cut frame groups (and every
    group, at 1 row): the roots stay JAX's."""
    monkeypatch.setattr(Streaming._PixelTracker, "WINDOW_ROWS", window)
    crops, frames = make_stream(11, n=300, dup_rate=0.6)
    got = P.pixel_tracks(crops, frames, 0.02, device="cpu")
    np.testing.assert_array_equal(got, J.pixel_tracks(crops, frames, 0.02))
    assert (got != np.arange(len(crops))).any()


def _cuts(frames, kind):
    """Up to three cut positions of one kind in a frame-sorted stream:
    inside a frame group f whose f-1 is present (the chunk after the cut
    continues f, its references split between prev and open), inside a
    group whose f+1 is present (the next frame's reference f-1 is split
    across the chunks), on a boundary between consecutive frames, and
    across a frame gap (f-2 -> f: nothing to match)."""
    f = frames
    i = np.arange(1, len(f))
    if kind == "inside_f":
        ok = (f[i] == f[i - 1]) & np.isin(f[i] - 1, f)
    elif kind == "inside_f_minus_1":
        ok = (f[i] == f[i - 1]) & np.isin(f[i] + 1, f)
    elif kind == "boundary":
        ok = f[i] == f[i - 1] + 1
    else:
        ok = f[i] > f[i - 1] + 1
    pos = i[ok]
    assert len(pos), kind
    return pos[np.linspace(0, len(pos) - 1, 3).astype(int)].tolist()


@pytest.fixture(scope="module")
def gappy_stream():
    """A duplicate-heavy stream with frame gaps: every fifth frame
    dropped."""
    crops, frames = make_stream(5, n=360, dup_rate=0.7)
    keep = frames % 5 != 3
    return crops[keep], frames[keep]


@pytest.fixture(scope="module")
def jax_split_refs(gappy_stream):
    """JAX's one-shot bytes per (gate, frame_stride), computed once."""
    crops, frames = gappy_stream
    out = {}
    for gate in (False, True):
        for stride in (1, 2):
            cfg = dict(K=2, threshold=1.5, max_clusters=32, batch_size=32,
                       gate=gate, frame_stride=stride)
            ij, _ = J.ingest(crops, frames, _cheap, 1.0, J.IngestConfig(**cfg),
                             n_local_classes=N_CLASSES)
            out[gate, stride] = (cfg, ij.save_bytes())
    return out


@pytest.mark.parametrize("window", [8192, 5])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("kind", ["inside_f", "inside_f_minus_1", "boundary",
                                  "gap"])
def test_split_feeds_match_jax(kind, gate, stride, window, gappy_stream,
                               jax_split_refs, monkeypatch):
    """The port fed in chunks cut at one kind of position (and, at window
    5, with tracker windows cutting groups too) saves JAX's one-shot
    bytes, with the gate on and off and every or every other frame."""
    monkeypatch.setattr(Streaming._PixelTracker, "WINDOW_ROWS", window)
    crops, frames = gappy_stream
    cfg, want = jax_split_refs[gate, stride]
    ing = StreamingIngestor(_cheap, 1.0, P.IngestConfig(**cfg),
                            n_local_classes=N_CLASSES, device="cpu")
    bounds = [0, *_cuts(frames, kind), len(crops)]
    for lo, hi in zip(bounds, bounds[1:]):
        ing.feed(crops[lo:hi], frames[lo:hi])
        ing.flush()
    index, stats = ing.finish()
    assert index.save_bytes() == want
    assert (stats.n_pixel_dedup > 0) == (stride == 1)


def test_tracker_launches_once_per_window(monkeypatch):
    """``pixel_match_ranges`` runs once per tracker window, never once per
    frame: a one-shot ingest and ``pixel_tracks`` of 400 objects in ~80
    frames call it once, 64-row windows once per window, one call per fed
    chunk, and none when no kept frame has its previous frame."""
    calls = []
    real = ops.pixel_match_ranges

    def counted(a, *args, **kw):
        calls.append(a.shape[0])
        return real(a, *args, **kw)

    monkeypatch.setattr(ops, "pixel_match_ranges", counted)
    crops, frames = make_stream(2, n=400, dup_rate=0.6)
    assert len(np.unique(frames)) > 50
    cfg = P.IngestConfig(K=2, threshold=1.5, max_clusters=48, batch_size=50)
    _, stats = P.ingest(crops, frames, _cheap, 1.0, cfg,
                        n_local_classes=N_CLASSES, device="cpu")
    assert calls == [400] and stats.n_pixel_dedup > 0
    calls.clear()
    P.pixel_tracks(crops, frames, 0.02, device="cpu")
    assert calls == [400]
    calls.clear()
    ing = StreamingIngestor(_cheap, 1.0, cfg, n_local_classes=N_CLASSES,
                            device="cpu")
    for lo, hi in ((0, 150), (150, 151), (151, 400)):
        ing.feed(crops[lo:hi], frames[lo:hi])
    assert calls == [150, 1, 249]
    calls.clear()
    monkeypatch.setattr(Streaming._PixelTracker, "WINDOW_ROWS", 64)
    P.ingest(crops, frames, _cheap, 1.0, cfg, n_local_classes=N_CLASSES,
             device="cpu")
    assert calls == [64] * 6 + [16]
    calls.clear()
    P.ingest(crops, frames, _cheap, 1.0,
             P.IngestConfig(K=2, threshold=1.5, frame_stride=2),
             n_local_classes=N_CLASSES, device="cpu")
    assert calls == []


def test_empty_stream_keeps_class_width():
    crops = np.zeros((0, 6, 6, 3), np.float32)
    index, stats = P.ingest(crops, np.zeros((0,), np.int64), _cheap, 1.0,
                            P.IngestConfig(), n_local_classes=N_CLASSES,
                            device="cpu")
    assert index.n_clusters == 0 and index.n_local_classes == N_CLASSES
    assert stats.n_objects == 0


def test_feed_rejects_decreasing_frames_and_feed_after_finish():
    crops, frames = make_stream(3, n=50)
    ing = StreamingIngestor(_cheap, 1.0, P.IngestConfig(batch_size=16),
                            device="cpu")
    ing.feed(crops[25:], frames[25:])
    with pytest.raises(ValueError):
        ing.feed(crops[:25], frames[:25])
    ing.finish()
    with pytest.raises(RuntimeError):
        ing.feed(crops[:1], frames[:1])
