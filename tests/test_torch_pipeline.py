"""The port's fused ingest megastep (``repro_torch.core.pipeline``).

Core property, as ``tests/test_pipeline.py`` pins it for the JAX package:
a ``StreamingIngestor`` driven by the port's ``IngestPipeline`` (forward
→ top-K → phase 1 → matched fold, double-buffered) saves a byte-identical
index on disk — and identical ``IngestStats`` counters — to the port's
host-staged path (``staged_cheap_apply``) over the same stream, across
random chunk splits, eviction boundaries and shard rollovers. Plus the
≤ 2 dispatches-per-batch budget, the (bucket, resolution) key counters,
the sink's top-K and the contract errors.

Then the port's pipeline against the JAX package's ``IngestPipeline``:
each package gets a lookup forward that gathers precomputed numpy
``(probs, feats)`` rows by the row number planted in the crop's first
pixel, so both see bit-equal CNN outputs; the saved indexes and the
sinks' top-K (the JAX package's Pallas ``topk`` in interpret mode, the
port's ``topk_ref``) must be identical. All comparisons are exact; the
interpret-mode ``topk`` makes k passes, so K and C stay small there.
Everything runs on the CPU (``device="cpu"``).
"""
import importlib
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import make_chunks as _chunks
from conftest import make_stream as _stream
from repro.core import index as jindex
from repro.core.archive import ShardCatalog as JShardCatalog
from repro.core.pipeline import IngestPipeline as JIngestPipeline
from repro.core.streaming import StreamingIngestor as JStreamingIngestor
from repro_torch.core.archive import ShardCatalog
from repro_torch.core.index import saved_file_bytes
from repro_torch.core.ingest import IngestConfig, ingest
from repro_torch.core.pipeline import (IngestPipeline, batch_bucket,
                                       staged_cheap_apply)
from repro_torch.core.streaming import StreamingIngestor

# ``repro.core`` re-exports the function ``ingest`` under the module's name
J = importlib.import_module("repro.core.ingest")

FEAT_DIM = 12
N_CLASSES = 5
EVICTING = dict(K=2, threshold=1.5, max_clusters=24, high_water=0.8,
                evict_frac=0.5)


def _forward(crops: torch.Tensor):
    """Per-example-pure cheap-CNN stand-in: feats/probs are functions of
    the crop's pixels alone, so bucket padding cannot leak across rows."""
    flat = crops.reshape(crops.shape[0], -1)
    feats = flat[:, :FEAT_DIM] * 10.0
    probs = torch.softmax(flat[:, FEAT_DIM:FEAT_DIM + N_CLASSES] * 5.0,
                          dim=-1)
    return probs, feats


def _pipe(cfg, **kw):
    return IngestPipeline(_forward, cfg, device="cpu", **kw)


def _staged(cfg):
    return staged_cheap_apply(_forward, cfg, device="cpu")


def _counters(stats):
    return (stats.n_objects, stats.n_cnn_invocations, stats.n_pixel_dedup,
            stats.n_evictions, stats.cheap_flops)


# ---------------------------------------------------------------------------
# the equivalence property (pipeline == staged == one-shot, byte for byte)
# ---------------------------------------------------------------------------

@settings(max_examples=8, deadline=None)
@given(st.data())
def test_pipeline_equals_staged_byte_identical(data):
    """Random stream, random chunk split, eviction-heavy config: the
    pipeline-driven ingestor saves byte-identically to the host-staged
    ingestor fed the same chunks — and to one-shot ``ingest()`` with and
    without the pipeline — with identical stats counters."""
    seed = data.draw(st.integers(0, 10_000), label="seed")
    n = data.draw(st.integers(0, 400), label="n")
    batch_size = data.draw(st.sampled_from([32, 64, 100]), label="batch")
    crops, frames = _stream(seed, n)
    cfg = IngestConfig(batch_size=batch_size, **EVICTING)

    one_index, one_stats = ingest(crops, frames, _staged(cfg), 1e9, cfg,
                                  device="cpu")
    one_pipe, one_pipe_stats = ingest(crops, frames, None, 1e9, cfg,
                                      device="cpu", pipeline=_pipe(cfg))
    staged = StreamingIngestor(_staged(cfg), 1e9, cfg, device="cpu")
    piped = StreamingIngestor(None, 1e9, cfg, device="cpu",
                              pipeline=_pipe(cfg))
    for size in _chunks(data.draw, n):
        taken, crops = crops[:size], crops[size:]
        tf, frames = frames[:size], frames[size:]
        staged.feed(taken, tf)
        staged.flush()
        piped.feed(taken, tf)
        piped.flush()                 # publication barrier mid-stream
    staged_index, staged_stats = staged.finish()
    pipe_index, pipe_stats = piped.finish()

    want = staged_index.save_bytes()
    assert pipe_index.save_bytes() == want
    assert one_index.save_bytes() == want
    assert one_pipe.save_bytes() == want
    for stats in (staged_stats, one_stats, one_pipe_stats):
        assert _counters(pipe_stats) == _counters(stats)


@settings(max_examples=4, deadline=None)
@given(st.integers(0, 10_000), st.sampled_from([60, 110]))
def test_pipeline_rollover_shards_byte_identical(seed, shard_objects):
    """Shard rollover through the pipeline: every sealed shard file and
    the catalog manifest are byte-identical to the staged rollover run."""
    crops, frames = _stream(seed, 300)
    cfg = IngestConfig(batch_size=48, **EVICTING)
    with tempfile.TemporaryDirectory() as d:
        cats = {}
        for name, kw in (("staged", {"cheap_apply": _staged(cfg)}),
                         ("piped", {"cheap_apply": None,
                                    "pipeline": _pipe(cfg)})):
            cats[name] = ShardCatalog.open(os.path.join(d, name))
            ing = StreamingIngestor(cheap_flops_per_image=1e9, cfg=cfg,
                                    catalog=cats[name],
                                    shard_objects=shard_objects,
                                    device="cpu", **kw)
            for s in range(0, len(crops), 77):
                ing.feed(crops[s:s + 77], frames[s:s + 77])
                ing.flush()
            ing.finish()
        cs, cp = cats["staged"], cats["piped"]
        assert len(cs) == len(cp) > 1
        assert [vars(m) for m in cs] == [vars(m) for m in cp]
        for m in cs:
            assert saved_file_bytes(cs.path_of(m.shard_id)) \
                == saved_file_bytes(cp.path_of(m.shard_id)), m.shard_id


@pytest.mark.parametrize("cfg,evicts", [
    (dict(batch_size=32, pixel_diff=False, **EVICTING), True),
    (dict(K=2, threshold=1.5, batch_size=32, pixel_diff=False), False),
])
def test_pipeline_eviction_syncs_only_when_the_bound_crosses(cfg, evicts):
    """Evictions land on the staged path's batches while ``state.n`` is
    read only when the live-cluster bound crosses the high-water mark:
    never under a table of M = 4096 that the stream cannot fill."""
    crops, frames = _stream(11, 600)
    cfg = IngestConfig(**cfg)
    staged, s_stats = ingest(crops, frames, _staged(cfg), 1e9, cfg,
                             device="cpu")
    pipe = _pipe(cfg)
    piped, p_stats = ingest(crops, frames, None, 1e9, cfg, device="cpu",
                            pipeline=pipe)
    assert piped.save_bytes() == staged.save_bytes()
    assert p_stats.n_evictions == s_stats.n_evictions
    assert (p_stats.n_evictions > 0) == evicts
    assert (pipe.stats.n_eviction_syncs > 0) == evicts
    assert pipe.stats.n_eviction_syncs <= pipe.stats.n_batches


# ---------------------------------------------------------------------------
# dispatch budget, key counters, fused top-K outputs
# ---------------------------------------------------------------------------

def test_pipeline_dispatch_budget_and_key_counters():
    """At most 2 dispatches per batch (megastep + optional unmatched
    tail); ragged tail batches land in bucketed keys — full batches all
    hit one key."""
    crops, frames = _stream(7, 500)
    cfg = IngestConfig(K=2, threshold=1.5, max_clusters=64, batch_size=60,
                       pixel_diff=False)
    pipe = _pipe(cfg)
    ing = StreamingIngestor(None, 1e9, cfg, device="cpu", pipeline=pipe)
    ing.feed(crops, frames)
    ing.finish()
    assert pipe.stats.n_batches == 9          # 8 full + 1 tail (20 rows)
    assert pipe.stats.n_dispatches == pipe.stats.n_batches \
        + pipe.stats.n_tail_scans
    assert pipe.stats.dispatches_per_batch <= 2.0
    assert pipe.stats.n_objects == 500
    # one key for the 8 full batches, one tail bucket (32)
    assert pipe.stats.compile_misses == 2
    assert pipe.stats.compile_hits == 7
    assert pipe.stats.tail_compile_hits + pipe.stats.tail_compile_misses \
        == pipe.stats.n_tail_scans > 0


def test_batch_bucket_shapes():
    assert batch_bucket(512, 512) == 512      # full batch: exact
    assert batch_bucket(700, 512) == 700      # oversize external batch
    for n, want in [(1, 8), (8, 8), (9, 16), (52, 64), (300, 512)]:
        assert batch_bucket(n, 512) == want
    assert batch_bucket(70, 100) == 100       # tail bucket capped at batch


def test_pipeline_topk_sink_matches_probs():
    """The sink's top-K agree with the batch's probabilities: descending
    values that index into each row's probs, every object once, and the
    index still folds byte-identically to the staged path."""
    got = []
    crops, frames = _stream(3, 200)
    cfg = IngestConfig(K=3, threshold=1.5, max_clusters=64, batch_size=64,
                       pixel_diff=False)
    pipe = _pipe(cfg, topk_sink=lambda o, v, i: got.append((o, v, i)))
    index, _ = ingest(crops, frames, None, 1e9, cfg, device="cpu",
                      pipeline=pipe)
    probs = _forward(torch.from_numpy(crops))[0].numpy()
    for objs, vals, idxs in got:
        assert vals.shape == idxs.shape == (len(objs), cfg.K)
        assert vals.dtype == np.float32 and idxs.dtype == np.int32
        assert (np.diff(vals, axis=1) <= 0).all()
        np.testing.assert_array_equal(
            np.take_along_axis(probs[objs], idxs, 1), vals)
    assert sorted(np.concatenate([o for o, _, _ in got]).tolist()) \
        == list(range(200))
    staged, _ = ingest(crops, frames, _staged(cfg), 1e9, cfg, device="cpu")
    assert index.save_bytes() == staged.save_bytes()


def test_staged_cheap_apply_pads_to_the_bucket():
    """The staged wrapper runs the forward at ``batch_bucket`` rows and
    returns the real rows as numpy."""
    seen = []

    def forward(x):
        seen.append(x.shape[0])
        return _forward(x)

    cfg = IngestConfig(batch_size=64)
    crops, _ = _stream(5, 64)
    apply = staged_cheap_apply(forward, cfg, device="cpu")
    for n in (64, 40, 3, 0):
        probs, feats = apply(crops[:n])
        assert probs.shape == (n, N_CLASSES) and feats.shape == (n, FEAT_DIM)
        assert isinstance(probs, np.ndarray)
    assert seen == [64, 64, 8, 8]             # the n == 0 call is a probe


# ---------------------------------------------------------------------------
# contract errors
# ---------------------------------------------------------------------------

def test_ingestor_rejects_both_cheap_apply_and_pipeline():
    cfg = IngestConfig(batch_size=8)
    with pytest.raises(ValueError):
        StreamingIngestor(_staged(cfg), 1e9, cfg, device="cpu",
                          pipeline=_pipe(cfg))


def test_rejected_constructor_does_not_consume_pipeline():
    """A constructor that raises (shard args without a catalog) leaves the
    pipeline unbound: the retry with the same pipeline works."""
    cfg = IngestConfig(batch_size=8)
    pipe = _pipe(cfg)
    with pytest.raises(ValueError):
        StreamingIngestor(None, 1e9, cfg, shard_objects=100, device="cpu",
                          pipeline=pipe)
    StreamingIngestor(None, 1e9, cfg, device="cpu", pipeline=pipe)


def test_pipeline_rejects_second_ingestor():
    cfg = IngestConfig(batch_size=8)
    pipe = _pipe(cfg)
    StreamingIngestor(None, 1e9, cfg, device="cpu", pipeline=pipe)
    with pytest.raises(ValueError):
        StreamingIngestor(None, 1e9, cfg, device="cpu", pipeline=pipe)


def test_pipeline_rejects_another_device_than_its_ingestor():
    cfg = IngestConfig(batch_size=8)
    pipe = _pipe(cfg)
    pipe.device = torch.device("cuda")     # as built with device="cuda"
    with pytest.raises(ValueError, match="device|runs on"):
        StreamingIngestor(None, 1e9, cfg, device="cpu", pipeline=pipe)


def test_pipeline_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        IngestPipeline(_forward, IngestConfig())


def test_pipeline_explicit_topk_wider_than_classes_raises():
    """cfg.K wider than the class width is clamped (TopKIndex semantics),
    an explicit topk_k beyond it raises, as ``hops.topk`` does."""
    crops, frames = _stream(2, 50)
    cfg = IngestConfig(K=2, threshold=1.5, batch_size=16, pixel_diff=False)
    ing = StreamingIngestor(
        None, 1e9, cfg, device="cpu",
        pipeline=_pipe(cfg, topk_k=N_CLASSES + 1, topk_sink=print))
    with pytest.raises(ValueError):
        ing.feed(crops, frames)
    wide = IngestConfig(K=N_CLASSES + 3, threshold=1.5, batch_size=16,
                        pixel_diff=False)
    got = []
    index, _ = ingest(crops, frames, None, 1e9, wide, device="cpu",
                      pipeline=_pipe(wide, topk_sink=lambda o, v, i:
                                     got.append(v.shape[1])))
    assert index.n_objects == 50 and set(got) == {N_CLASSES}


def test_pipeline_rejects_mismatched_cfg():
    pipe = _pipe(IngestConfig(batch_size=8, threshold=0.5))
    with pytest.raises(ValueError):
        StreamingIngestor(None, 1e9, IngestConfig(batch_size=8,
                                                  threshold=0.9),
                          device="cpu", pipeline=pipe)


def test_pipeline_rejects_non_fused_clustering():
    for variant in ("scan", "batched"):
        cfg = IngestConfig(batch_size=8, clustering=variant)
        with pytest.raises(ValueError):
            _pipe(cfg)
        with pytest.raises(ValueError):
            StreamingIngestor(None, 1e9, cfg, device="cpu",
                              pipeline=_pipe(None))


def test_unbound_pipeline_submit_raises():
    pipe = _pipe(IngestConfig(batch_size=8))
    with pytest.raises(RuntimeError):
        pipe.submit(np.zeros((4, 6, 6, 3), np.float32),
                    np.arange(4), np.zeros(4, np.int64))


def test_pipeline_reset_with_a_pending_batch_raises():
    crops, frames = _stream(4, 40)
    cfg = IngestConfig(K=2, threshold=1.5, batch_size=16, pixel_diff=False)
    pipe = _pipe(cfg)
    ing = StreamingIngestor(None, 1e9, cfg, device="cpu", pipeline=pipe)
    ing.feed(crops, frames)                   # two batches, one pending
    with pytest.raises(RuntimeError):
        pipe.reset()
    pipe.flush_pending()
    pipe.reset()


# ---------------------------------------------------------------------------
# the port's pipeline against the JAX package's
# ---------------------------------------------------------------------------

ROW_SCALE = 2.0 ** 16        # crop[:, 0, 0, 0] = row / ROW_SCALE, exact


def _lookup_stream(seed, n):
    """A stream whose crops carry their row number, with (probs, feats)
    tables computed from the crops: probs from 1..4 integer levels, so
    every row holds exact ties."""
    crops, frames = _stream(seed, n)
    flat = crops.reshape(n, -1)
    feats = (flat[:, 1:FEAT_DIM + 1] * 10.0).astype(np.float32)
    raw = np.floor(flat[:, FEAT_DIM:FEAT_DIM + N_CLASSES] * 4) + 1
    probs = (raw / raw.sum(1, keepdims=True)).astype(np.float32)
    crops[:, 0, 0, 0] = np.arange(n, dtype=np.float32) / ROW_SCALE
    return crops, frames, probs, feats


def _jax_lookup(probs, feats):
    tp, tf = jnp.asarray(probs), jnp.asarray(feats)

    def cheap_fn(crops):
        ix = jnp.round(crops[:, 0, 0, 0] * ROW_SCALE).astype(jnp.int32)
        return tp[ix], tf[ix]
    return cheap_fn


def _torch_lookup(probs, feats):
    tp, tf = torch.from_numpy(probs), torch.from_numpy(feats)

    def forward(crops):
        ix = torch.round(crops[:, 0, 0, 0] * ROW_SCALE).long()
        return tp[ix], tf[ix]
    return forward


def _sunk(got):
    return tuple(np.concatenate([g[i] for g in got]) for i in range(3))


@pytest.mark.parametrize("seed,n,chunks,cfg", [
    (0, 300, 1, dict(batch_size=32, **EVICTING)),
    (1, 260, 4, dict(K=N_CLASSES, threshold=1.5, max_clusters=64,
                     batch_size=64)),
    (2, 240, 3, dict(K=3, threshold=1.5, max_clusters=24, batch_size=50,
                     gate=True, high_water=0.8, evict_frac=0.5)),
])
def test_pipeline_matches_jax_pipeline(seed, n, chunks, cfg):
    crops, frames, probs, feats = _lookup_stream(seed, n)
    got_j, got_p = [], []
    jing = JStreamingIngestor(
        None, 1e9, J.IngestConfig(**cfg),
        pipeline=JIngestPipeline(_jax_lookup(probs, feats),
                                 topk_sink=lambda *a: got_j.append(a)))
    ping = StreamingIngestor(
        None, 1e9, IngestConfig(**cfg), device="cpu",
        pipeline=IngestPipeline(_torch_lookup(probs, feats), device="cpu",
                                topk_sink=lambda *a: got_p.append(a)))
    bounds = np.linspace(0, n, chunks + 1).astype(int)
    for lo, hi in zip(bounds, bounds[1:]):
        jing.feed(crops[lo:hi], frames[lo:hi])
        ping.feed(crops[lo:hi], frames[lo:hi])
        jd, pd = jing.flush(), ping.flush()
        assert vars(jd) == vars(pd)
    jindex, jstats = jing.finish()
    pindex, pstats = ping.finish()
    assert pindex.save_bytes() == jindex.save_bytes()
    assert vars(pstats) | {"wall_s": 0} == vars(jstats) | {"wall_s": 0}
    jo, jv, ji = _sunk(got_j)
    po, pv, pi = _sunk(got_p)
    np.testing.assert_array_equal(po, jo)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pv, jv)
    assert pv.shape == (pstats.n_cnn_invocations, min(cfg["K"], N_CLASSES))


def test_pipeline_rollover_matches_jax_pipeline(tmp_path):
    """Sealed shards and manifests agree across packages when both are
    driven by their pipelines."""
    crops, frames, probs, feats = _lookup_stream(5, 280)
    cfg = dict(batch_size=32, **EVICTING)
    jcat = JShardCatalog.open(str(tmp_path / "jax"))
    pcat = ShardCatalog.open(str(tmp_path / "port"))
    jing = JStreamingIngestor(None, 1e9, J.IngestConfig(**cfg), catalog=jcat,
                              shard_objects=90,
                              pipeline=JIngestPipeline(
                                  _jax_lookup(probs, feats)))
    ping = StreamingIngestor(None, 1e9, IngestConfig(**cfg), catalog=pcat,
                             shard_objects=90, device="cpu",
                             pipeline=IngestPipeline(
                                 _torch_lookup(probs, feats), device="cpu"))
    for s in range(0, len(crops), 70):
        jing.feed(crops[s:s + 70], frames[s:s + 70])
        ping.feed(crops[s:s + 70], frames[s:s + 70])
    jing.finish()
    ping.finish()
    assert len(pcat) == len(jcat) > 1
    with open(os.path.join(jcat.root, "catalog.json"), "rb") as fj, \
            open(os.path.join(pcat.root, "catalog.json"), "rb") as fp:
        assert fp.read() == fj.read()
    for m in pcat:
        assert saved_file_bytes(pcat.path_of(m.shard_id)) == \
            jindex.saved_file_bytes(jcat.path_of(m.shard_id))
