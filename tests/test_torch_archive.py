"""The port's time-sharded archive against the JAX package's.

* **Cross-package rollover** — one stream and one set of CNN outputs fed
  in the same random chunks to both packages' ``StreamingIngestor`` with
  a catalog, rolling over by ``shard_objects`` or by ``shard_frames``:
  every sealed shard is byte-identical across packages and the manifests
  agree byte for byte.
* **Answers** — the port's lazy v4 shards (ranked by
  ``hopper.ops.dequant_topk``, its plain version on the CPU) answer like
  eagerly loaded shards, and shards sealed by either package answer
  identically in the other package's ``ArchiveQueryEngine``.
* **Contracts** — mirrors of ``tests/test_archive.py``'s catalog, loader
  and engine contract tests, run against the port.

All comparisons are exact. Everything runs on the CPU (``device="cpu"``).
"""
import importlib
import json
import os

import numpy as np
import pytest
import torch

from conftest import make_stream
from repro.core import index as jindex
from repro.core.archive import ArchiveQueryEngine as JArchiveQueryEngine
from repro.core.archive import ShardCatalog as JShardCatalog
from repro.core.streaming import StreamingIngestor as JStreamingIngestor
from repro_torch.core import archive as archive_mod
from repro_torch.core import index as pindex
from repro_torch.core.archive import (ArchiveQueryEngine, LazyShardIndex,
                                      ShardCatalog, ShardLoader)
from repro_torch.core.engine import QueryEngine
from repro_torch.core.streaming import StreamingIngestor
from repro_torch.hopper import ops as hops

# ``repro.core`` re-exports the function ``ingest`` under the module's name
J = importlib.import_module("repro.core.ingest")
P = importlib.import_module("repro_torch.core.ingest")

FEAT_DIM = 12
N_CLASSES = 5
CFG = dict(K=2, threshold=1.5, max_clusters=24, batch_size=32,
           high_water=0.8, evict_frac=0.5)
CLASSES = list(range(N_CLASSES))


def _cheap(batch):
    flat = batch.reshape(len(batch), -1)
    feats = (flat[:, :FEAT_DIM] * 10.0).astype(np.float32)
    probs = np.abs(flat[:, FEAT_DIM:FEAT_DIM + N_CLASSES]) + 1e-3
    return (probs / probs.sum(1, keepdims=True)).astype(np.float32), feats


def _gt_apply(batch):
    return np.rint(batch[:, 0, 0, 2] * 8).astype(np.int64) % N_CLASSES


def _answers(engine, classes=CLASSES, Kx=None):
    results, _ = engine.query_many(classes, Kx)
    return [(r.frames.tolist(), [tuple(map(int, m)) for m in r.matched])
            for r in results]


def _union_answers(catalog, load, classes=CLASSES):
    """Per-shard ``QueryEngine`` answers over eagerly loaded shards,
    unioned: what the archive fan-out must equal."""
    out = []
    for cls in classes:
        parts, matched = [], []
        for m in catalog:
            r = QueryEngine(load(m.shard_id), gt_apply=_gt_apply).query(cls)
            parts.append(r.frames)
            matched.extend((m.shard_id, int(c)) for c in r.matched_clusters)
        frames = (np.unique(np.concatenate(parts)) if parts
                  else np.array([], np.int64))
        out.append((frames.tolist(), matched))
    return out


def _roll(ingestor, crops, frames, bounds):
    """Feed the chunks with a flush after each; returns every delta."""
    deltas = []
    for lo, hi in zip(bounds, bounds[1:]):
        ingestor.feed(crops[lo:hi], frames[lo:hi])
        deltas.append(vars(ingestor.flush()))
    ingestor.finish()
    return deltas + [vars(ingestor.flush())]


def _random_bounds(r, n):
    cuts = np.sort(r.choice(np.arange(1, n), size=int(r.integers(1, 9)),
                            replace=False))
    return [0, *cuts.tolist(), n]


# ---------------------------------------------------------------------------
# cross-package rollover and answers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,roll,extra", [
    (0, {"shard_objects": 60}, {}),
    (1, {"shard_objects": 110}, {"gate": True}),
    (2, {"shard_objects": 70}, {"frame_stride": 2}),
    (3, {"shard_frames": 15}, {}),
    (4, {"shard_frames": 40}, {"gate": True}),
    (5, {"shard_objects": 80, "shard_frames": 30}, {}),
    (6, {"shard_objects": 90, "shard_format": 3}, {}),
])
def test_rollover_shards_byte_identical_to_jax(seed, roll, extra, tmp_path):
    r = np.random.default_rng(seed)
    n = int(r.integers(150, 330))
    crops, frames = make_stream(seed, n=n)
    bounds = _random_bounds(r, n)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jcat, pcat = JShardCatalog.open(jdir), ShardCatalog.open(pdir)
    want_deltas = _roll(
        JStreamingIngestor(_cheap, 1e9, J.IngestConfig(**CFG, **extra),
                           catalog=jcat, **roll), crops, frames, bounds)
    ping = StreamingIngestor(_cheap, 1e9, P.IngestConfig(**CFG, **extra),
                             catalog=pcat, device="cpu", **roll)
    assert _roll(ping, crops, frames, bounds) == want_deltas

    assert len(pcat) >= 2
    with open(os.path.join(jdir, "catalog.json"), "rb") as f:
        jmanifest = f.read()
    with open(os.path.join(pdir, "catalog.json"), "rb") as f:
        assert f.read() == jmanifest
    for m in pcat:
        assert pindex.saved_file_bytes(pcat.path_of(m.shard_id)) \
            == jindex.saved_file_bytes(jcat.path_of(m.shard_id)), \
            f"shard {m.shard_id} differs"
    assert ping.stats.n_objects == sum(m.n_objects for m in pcat)

    # lazy (dequant_topk) fan-out == eager per-shard union, and both
    # packages answer alike over either package's shards (capacity 1
    # forces a reload per shard per round)
    want = _union_answers(pcat, pcat.load_shard)
    assert any(frames for frames, _ in want)
    for cat in (pcat, ShardCatalog.open(jdir)):
        assert _answers(ArchiveQueryEngine(cat, gt_apply=_gt_apply,
                                           capacity=1, device="cpu")) == want
    for d in (jdir, pdir):
        assert _answers(JArchiveQueryEngine(JShardCatalog.open(d),
                                            gt_apply=_gt_apply)) == want


@pytest.mark.parametrize("Kx", [None, 1])
def test_lazy_shards_rank_with_the_kernel_wrapper(Kx, tmp_path):
    """The lazy rank path goes through ``hopper.ops.dequant_topk`` (its
    plain version on CPU tensors: no launch) once per residency, and its
    rank ids equal the eager index's top-K order."""
    crops, frames = make_stream(41, n=150)
    idx, _ = P.ingest(crops, frames, _cheap, 1e9, P.IngestConfig(**CFG),
                      device="cpu")
    path = str(tmp_path / "shard")
    idx.save(path)
    with open(path + ".json") as f:
        lazy = LazyShardIndex(path, json.load(f), device="cpu")
    calls = []
    real = hops.dequant_topk

    def spy(*a, **k):
        calls.append(a[0].device.type)
        return real(*a, **k)

    hops.reset_launches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hops, "dequant_topk", spy)
        for cls in CLASSES:
            lazy.lookup(cls, Kx=Kx)
    assert calls == ["cpu"] and hops.LAUNCHES["dequant_topk"] == 0
    eager = pindex.TopKIndex.load(path)
    for cls in CLASSES:
        assert lazy.lookup(cls, Kx=Kx) == eager.lookup(cls, Kx=Kx)


def test_lazy_v4_shard_answers_match_eager_dequant(tmp_path):
    crops, frames = make_stream(41, n=150)
    idx, _ = P.ingest(crops, frames, _cheap, 1e9, P.IngestConfig(**CFG),
                      device="cpu")
    path = str(tmp_path / "shard")
    idx.save(path)                                       # v4 default
    with open(path + ".json") as f:
        lazy = LazyShardIndex(path, json.load(f), device="cpu")
    eager = pindex.TopKIndex.load(path)
    assert (lazy.n_clusters, lazy.n_objects) \
        == (eager.n_clusters, eager.n_objects)
    for cls in CLASSES:
        for kx in range(1, CFG["K"] + 1):
            a, b = lazy.lookup(cls, Kx=kx), eager.lookup(cls, Kx=kx)
            assert a == b
            np.testing.assert_array_equal(lazy.frames_of(a),
                                          eager.frames_of(b))
    cids = sorted(eager.clusters)
    np.testing.assert_array_equal(lazy.rep_crops(cids),
                                  eager.rep_crops(cids))
    with pytest.raises(KeyError):
        lazy.frames_of([10**9])
    with pytest.raises(ValueError):
        lazy.lookup(0, Kx=CFG["K"] + 1)


# ---------------------------------------------------------------------------
# rollover and query-while-ingest in the port
# ---------------------------------------------------------------------------

def _windows(catalog, n_total):
    bases = [m.obj_base for m in catalog] + [n_total]
    return [(m, bases[i], bases[i + 1]) for i, m in enumerate(catalog)]


def test_rollover_unsorted_chunk_keeps_arrival_order_ids(tmp_path):
    r = np.random.default_rng(31)
    crops, frames = make_stream(31, n=100)
    perm = r.permutation(100)
    crops, frames = crops[perm], frames[perm]     # internally unsorted
    order = np.argsort(frames, kind="stable")
    catalog = ShardCatalog.open(str(tmp_path))
    ing = StreamingIngestor(_cheap, 1e9, P.IngestConfig(**CFG),
                            catalog=catalog, shard_objects=60, device="cpu")
    ing.feed(crops, frames)
    ing.finish()
    assert len(catalog) == 2
    for m, lo, hi in _windows(catalog, 100):
        sel = np.sort(order[lo:hi])               # window in arrival order
        one, _ = P.ingest(crops[sel], frames[sel], _cheap, 1e9,
                          P.IngestConfig(**CFG), device="cpu")
        assert pindex.saved_file_bytes(catalog.path_of(m.shard_id)) \
            == one.save_bytes()
    sel_all = np.concatenate([np.sort(order[lo:hi])
                              for _, lo, hi in _windows(catalog, 100)])
    oracle = ArchiveQueryEngine(catalog, oracle_labels=_gt_apply(
        crops[sel_all]), device="cpu")
    via_gt = ArchiveQueryEngine(catalog, gt_apply=_gt_apply, device="cpu")
    assert _answers(oracle) == _answers(via_gt)


def test_query_while_ingest_warm_across_rollovers(tmp_path):
    """A long-lived archive engine prefetching each flush delta answers
    like a cold engine on the same state, with zero query-path GT."""
    crops, frames = make_stream(3, n=500)
    cfg = P.IngestConfig(K=3, threshold=1.5, max_clusters=48, batch_size=48,
                         high_water=0.85, evict_frac=0.4)
    catalog = ShardCatalog.open(str(tmp_path))
    ing = StreamingIngestor(_cheap, 1e9, cfg, n_local_classes=N_CLASSES,
                            catalog=catalog, shard_objects=160, device="cpu")
    warm = ArchiveQueryEngine(catalog, gt_apply=_gt_apply, capacity=2,
                              ingestor=ing, device="cpu")
    sealed_seen = 0
    for start in range(0, len(crops), 130):
        ing.feed(crops[start:start + 130], frames[start:start + 130])
        delta = ing.flush()
        sealed_seen += len(delta.sealed_shards)
        assert all(sid in delta.sealed_shards
                   for sid, _ in delta.touched_sealed)
        warm.prefetch(delta)
        results, batch = warm.query_many(CLASSES)
        assert batch.n_gt_invocations == 0       # prefetch took the cost
        cold = ArchiveQueryEngine(catalog, gt_apply=_gt_apply, capacity=2,
                                  ingestor=ing, device="cpu")
        assert _answers(cold) == [
            (r.frames.tolist(), [tuple(map(int, m)) for m in r.matched])
            for r in results]
    ing.finish()
    warm.prefetch(ing.flush())
    _, fb = warm.query_many(CLASSES)
    assert fb.n_gt_invocations == 0
    assert sealed_seen + len(ing.flush().sealed_shards) <= len(catalog) == 4


def test_frame_window_rollover_seals_on_absolute_boundaries(tmp_path):
    crops, frames = make_stream(11, n=300)
    W = 20
    catalog = ShardCatalog.open(str(tmp_path))
    ing = StreamingIngestor(_cheap, 1e9, P.IngestConfig(**CFG),
                            catalog=catalog, shard_frames=W, device="cpu")
    for lo in range(0, len(crops), 77):
        ing.feed(crops[lo:lo + 77], frames[lo:lo + 77])
    ing.finish()
    assert len(catalog) >= 2
    for m, lo, hi in _windows(catalog, len(crops)):
        assert m.frame_lo // W == m.frame_hi // W       # one window
        np.testing.assert_array_equal(frames[lo:hi] // W, m.frame_lo // W)


# ---------------------------------------------------------------------------
# catalog / loader / engine contracts
# ---------------------------------------------------------------------------

def _tiny_archive(d, n=180, shard_objects=70, seed=17):
    crops, frames = make_stream(seed, n=n)
    catalog = ShardCatalog.open(d)
    ing = StreamingIngestor(_cheap, 1e9, P.IngestConfig(**CFG),
                            catalog=catalog, shard_objects=shard_objects,
                            device="cpu")
    ing.feed(crops, frames)
    ing.finish()
    return catalog


def test_resumed_catalog_continues_obj_base_and_frame_line(tmp_path):
    crops, frames = make_stream(29, n=160)
    catalog = _tiny_archive(str(tmp_path), n=160, shard_objects=70)
    n_first = sum(m.n_objects for m in catalog)
    resumed = ShardCatalog.open(str(tmp_path))
    ing = StreamingIngestor(_cheap, 1e9, P.IngestConfig(**CFG),
                            catalog=resumed, shard_objects=70, device="cpu")
    assert ing.shard_obj_base == n_first
    with pytest.raises(ValueError):        # frames behind the archive end
        ing.feed(crops[:4], np.zeros(4, np.int64))
    ing.feed(crops, frames + catalog.shards[-1].frame_hi)
    ing.finish()
    bases = [m.obj_base for m in resumed]
    assert bases == sorted(set(bases))     # strictly increasing, no alias
    assert bases[len(catalog.shards) - 1] + \
        catalog.shards[-1].n_objects == bases[len(catalog.shards)]


def test_catalog_roundtrips_through_json(tmp_path):
    catalog = _tiny_archive(str(tmp_path))
    reopened = ShardCatalog.open(str(tmp_path))
    assert reopened.shards == catalog.shards
    assert reopened.next_shard_id() == len(catalog)
    assert reopened.load_shard(0).n_clusters == catalog.shards[0].n_clusters
    # the JAX package reads the port's manifest to the same shard list
    assert [vars(m) for m in JShardCatalog.open(str(tmp_path))] \
        == [vars(m) for m in catalog]


def test_catalog_seal_survives_manifest_write_failure(tmp_path,
                                                      monkeypatch):
    """Failure injected between shard write and manifest rename: the old
    manifest stays intact and loadable, the in-memory shard list rolls
    back, and a retry reseals under the same shard id."""
    catalog = _tiny_archive(str(tmp_path))               # 3 shards
    before = [m.shard_id for m in catalog]
    crops, frames = make_stream(5, n=40)
    idx, _ = P.ingest(crops, frames, _cheap, 1e9, P.IngestConfig(**CFG),
                      device="cpu")

    def boom(src, dst):
        raise OSError("injected: crash before manifest rename")

    monkeypatch.setattr(archive_mod.os, "replace", boom)
    with pytest.raises(OSError, match="injected"):
        catalog.seal(idx, int(frames[0]), int(frames[-1]), obj_base=10**6)
    monkeypatch.undo()
    assert [m.shard_id for m in catalog] == before
    assert catalog.next_shard_id() == len(before)
    reopened = ShardCatalog.open(str(tmp_path))
    assert [m.shard_id for m in reopened] == before
    for m in reopened:
        assert reopened.load_shard(m.shard_id).n_clusters == m.n_clusters
    meta = catalog.seal(idx, int(frames[0]), int(frames[-1]),
                        obj_base=10**6)
    assert meta.shard_id == len(before)
    assert meta.n_bytes == pindex.saved_nbytes(catalog.path_of(meta.shard_id))
    again = ShardCatalog.open(str(tmp_path))
    assert [m.shard_id for m in again] == before + [meta.shard_id]


def test_shard_loader_lru_counts_hits_loads_evictions(tmp_path):
    catalog = _tiny_archive(str(tmp_path))               # 3 shards
    loader = ShardLoader(catalog, capacity=1, device="cpu")
    loader.get(0)
    loader.get(0)
    assert (loader.n_loads, loader.n_hits, loader.n_evictions) == (1, 1, 0)
    loader.get(1)
    assert loader.n_evictions == 1 and len(loader) == 1
    loader.get(0)                                        # reload
    assert loader.n_loads == 3
    with pytest.raises(ValueError):
        ShardLoader(catalog, capacity=0, device="cpu")
    with pytest.raises(KeyError):
        loader.get(99)


def test_shard_loader_bytes_bound_evicts_and_tracks_residency(tmp_path):
    catalog = _tiny_archive(str(tmp_path))               # 3 shards
    loader = ShardLoader(catalog, capacity_bytes=1, device="cpu")
    a = loader.get(0)
    a.lookup(0)                                          # grow rank cache
    assert len(loader) == 1 and loader.resident_bytes > 1
    loader.get(1)
    assert len(loader) == 1 and loader.n_evictions == 1
    loader.get(1)
    assert loader.n_hits == 1
    roomy = ShardLoader(catalog, capacity_bytes=1 << 30, device="cpu")
    for m in catalog:
        roomy.get(m.shard_id).lookup(0)
    assert roomy.n_evictions == 0 and len(roomy) == 3
    assert roomy.resident_bytes == sum(
        int(roomy.get(m.shard_id).nbytes) for m in catalog)


def test_shard_loader_capacity_kwargs(tmp_path):
    catalog = _tiny_archive(str(tmp_path))               # 3 shards
    for loader in (ShardLoader(catalog, capacity=1, device="cpu"),
                   ShardLoader(catalog, capacity_shards=1, device="cpu")):
        loader.get(0)
        loader.get(1)
        assert loader.n_evictions == 1 and len(loader) == 1
    for kw in ({"capacity_bytes": 10, "capacity_shards": 2},
               {"capacity_shards": 2, "capacity": 2},
               {"capacity_bytes": 0}, {"capacity_shards": 0}):
        with pytest.raises(ValueError):
            ShardLoader(catalog, device="cpu", **kw)
    default = ShardLoader(catalog, device="cpu")
    assert default.capacity_bytes == archive_mod.DEFAULT_CAPACITY_BYTES
    for m in catalog:
        default.get(m.shard_id)
    assert default.n_evictions == 0


def test_archive_stats_surface_loader_residency(tmp_path):
    catalog = _tiny_archive(str(tmp_path))               # 3 shards
    engine = ArchiveQueryEngine(catalog, gt_apply=_gt_apply, capacity=2,
                                device="cpu")
    assert engine.stats.resident_bytes == 0
    engine.query_many(CLASSES)
    assert engine.stats.n_shard_loads == 3
    assert engine.stats.n_shard_evictions >= 1
    assert engine.stats.resident_bytes == engine.loader.resident_bytes > 0
    roomy = ArchiveQueryEngine(catalog, gt_apply=_gt_apply, device="cpu")
    roomy.query_many(CLASSES)
    roomy.query_many(CLASSES)
    assert roomy.stats.n_shard_hits == 3
    assert roomy.stats.shard_hit_rate == 0.5


def test_rollover_requires_catalog_and_cheap_apply():
    cfg = P.IngestConfig(**CFG)
    for kw in ({"shard_objects": 10}, {"shard_frames": 10},
               {"catalog": ShardCatalog("unused"), "shard_objects": 0},
               {"catalog": ShardCatalog("unused"), "shard_frames": 0},
               {"shard_format": 3}):
        with pytest.raises(ValueError):
            StreamingIngestor(_cheap, 1e9, cfg, device="cpu", **kw)
    with pytest.raises(ValueError):
        StreamingIngestor(None, 1e9, cfg, catalog=ShardCatalog("unused"),
                          shard_objects=10, device="cpu")


def test_archive_engine_requires_exactly_one_labeler(tmp_path):
    catalog = _tiny_archive(str(tmp_path))
    with pytest.raises(ValueError):
        ArchiveQueryEngine(catalog, device="cpu")
    with pytest.raises(ValueError):
        ArchiveQueryEngine(catalog, gt_apply=_gt_apply,
                           oracle_labels=np.zeros(10, np.int64),
                           device="cpu")


def test_archive_cached_label_is_read_only_probe(tmp_path):
    """cached_label validates against the live index or a resident shard
    and returns None otherwise — never pulling a cold shard through the
    LRU."""
    catalog = _tiny_archive(str(tmp_path))               # 3 shards
    engine = ArchiveQueryEngine(catalog, gt_apply=_gt_apply, capacity=1,
                                device="cpu")
    for m in catalog:
        assert engine.cached_label(m.shard_id, 0) is None
    results, _ = engine.query_many(CLASSES)
    assert engine.loader.n_loads == 3
    resident = next(iter(engine.loader._lru))
    sid, cid = next((s, c) for r in results for s, c in r.matched
                    if s == resident)
    assert engine.cached_label(sid, cid) == _gt_apply(
        catalog.load_shard(sid).rep_crops([cid]))[0]
    loads = engine.loader.n_loads
    for m in catalog:
        if m.shard_id != resident:
            engine.cached_label(m.shard_id, 0)
    assert engine.loader.n_loads == loads
    assert engine.cached_label(resident, 10**9) is None


def test_oracle_mode_uses_obj_base_offsets(tmp_path):
    crops, frames = make_stream(23, n=220)
    catalog = ShardCatalog.open(str(tmp_path))
    ing = StreamingIngestor(_cheap, 1e9, P.IngestConfig(**CFG),
                            catalog=catalog, shard_objects=90, device="cpu")
    ing.feed(crops, frames)
    ing.finish()
    oracle = ArchiveQueryEngine(catalog, oracle_labels=_gt_apply(crops),
                                capacity=2, device="cpu")
    via_gt = ArchiveQueryEngine(catalog, gt_apply=_gt_apply, capacity=2,
                                device="cpu")
    a, batch_a = oracle.query_many(CLASSES)
    b, batch_b = via_gt.query_many(CLASSES)
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(ra.frames, rb.frames)
        assert ra.matched == rb.matched
    for results, batch in ((a, batch_a), (b, batch_b)):
        assert batch.n_gt_invocations > 0
        assert sum(r.n_gt_invocations for r in results) \
            == batch.n_gt_invocations


def test_cuda_archive_engine_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    catalog = _tiny_archive(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ArchiveQueryEngine(catalog, gt_apply=_gt_apply)
