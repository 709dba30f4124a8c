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
from repro_torch.models import cnn

# ``repro.core`` re-exports the function ``ingest`` under the module's name
J = importlib.import_module("repro.core.ingest")
P = importlib.import_module("repro_torch.core.ingest")

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


def test_pixel_tracks_match_jax():
    crops, frames = make_stream(11, n=300, dup_rate=0.6)
    np.testing.assert_array_equal(
        P.pixel_tracks(crops, frames, 0.02, device="cpu"),
        J.pixel_tracks(crops, frames, 0.02))
    assert (P.pixel_tracks(crops, frames, 0.02, device="cpu")
            != np.arange(len(crops))).any()


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
