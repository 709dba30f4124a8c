"""The port's multi-stream ingest (``ShardedIngestPipeline``,
``MultiStreamRunner``, ``StreamPlacement``, ``make_ingest_mesh`` and
serve ``--mesh-devices``) against the JAX package's and against the
port's own solo runs.

Core property, as ``tests/test_sharded_ingest.py`` pins it for the JAX
package: every stream driven through a sharded pipeline (stacked steps,
the cluster tables stacked per stream slot) saves a byte-identical index
— and identical stats counters and sinks — to that stream's solo run,
across random chunk splits, evictions and shard rollovers. Against the
JAX package each side gets a lookup forward that gathers precomputed
numpy ``(probs, feats)`` rows by the global row number planted in the
crop's first pixel, so both see bit-equal CNN outputs (the technique of
``tests/test_torch_pipeline.py``). The port's CPU meshes of 2 and 4
blocks (the counterpart of XLA's forced host devices) are held against
the port's solo ``IngestPipeline``, with the lookup forward shared by the
blocks and with a real cheap CNN (the JAX package's initial weights)
replicated onto every block past the first. All comparisons are exact;
everything runs on the CPU.
"""
import ast
import importlib
import inspect
import os

import jax
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
from repro.core.streaming import MultiStreamRunner as JMultiStreamRunner
from repro.core.streaming import StreamingIngestor as JStreamingIngestor
from repro.core.streaming import make_sharded_runner as j_make_sharded_runner
from repro.common.config import CheapCNNConfig as JCheapCNNConfig
from repro.launch.mesh import make_ingest_mesh as j_make_ingest_mesh
from repro.models import cnn as jcnn
from repro_torch.common.config import CheapCNNConfig
from repro_torch.core.archive import ShardCatalog
from repro_torch.core.index import saved_file_bytes
from repro_torch.core.ingest import IngestConfig
from repro_torch.core.pipeline import (IngestPipeline, ShardedIngestPipeline,
                                       staged_cheap_apply)
from repro_torch.core.streaming import (MultiStreamRunner, StreamPlacement,
                                        StreamingIngestor,
                                        make_sharded_runner)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import IngestMesh, make_ingest_mesh
from repro_torch.models import cnn

# ``repro.core`` re-exports the function ``ingest`` under the module's name
J = importlib.import_module("repro.core.ingest")

FEAT_DIM = 12
N_CLASSES = 5
EVICTING = dict(K=2, threshold=1.5, max_clusters=24, high_water=0.8,
                evict_frac=0.5)
ROW_SCALE = 2.0 ** 16        # crop[:, 0, 0, 0] = row / ROW_SCALE, exact


def _forward(crops: torch.Tensor):
    """Per-example-pure cheap-CNN stand-in (``test_torch_pipeline``'s)."""
    flat = crops.reshape(crops.shape[0], -1)
    feats = flat[:, :FEAT_DIM] * 10.0
    probs = torch.softmax(flat[:, FEAT_DIM:FEAT_DIM + N_CLASSES] * 5.0,
                          dim=-1)
    return probs, feats


def _counters(stats):
    return vars(stats) | {"wall_s": 0}


def _cpu_mesh(n):
    return make_ingest_mesh(n, device="cpu")


# ---------------------------------------------------------------------------
# streams whose crops carry a global row number
# ---------------------------------------------------------------------------

def _lookup_streams(names, seed, lengths):
    """One stream per name, each crop's first pixel its row in one global
    (probs, feats) table computed from the crops (probs from integer
    levels, so rows hold exact ties)."""
    streams, probs, feats = {}, [], []
    base = 0
    for i, nm in enumerate(names):
        crops, frames = _stream(seed + 97 * i, lengths[i])
        flat = crops.reshape(len(crops), int(np.prod(crops.shape[1:])))
        feats.append((flat[:, 1:FEAT_DIM + 1] * 10.0).astype(np.float32))
        raw = np.floor(flat[:, FEAT_DIM:FEAT_DIM + N_CLASSES] * 4) + 1
        probs.append((raw / raw.sum(1, keepdims=True)).astype(np.float32))
        crops[:, 0, 0, 0] = (base + np.arange(len(crops))) / ROW_SCALE
        base += len(crops)
        streams[nm] = (crops, frames)
    return streams, np.concatenate(probs), np.concatenate(feats)


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


def _np_lookup(probs, feats):
    def apply(crops):
        ix = np.round(np.asarray(crops)[:, 0, 0, 0] * ROW_SCALE).astype(int)
        return probs[ix], feats[ix]
    return apply


def _feed(runner, streams, chunkings, interleave=True):
    """Feed every stream its chunks, a round at a time (or one stream per
    ``feed`` call); returns ``runner.finish()``."""
    offs = {nm: 0 for nm in streams}
    for rnd in range(max(len(c) for c in chunkings.values())):
        feeds = {}
        for nm, (crops, frames) in streams.items():
            if rnd < len(chunkings[nm]):
                k, o = chunkings[nm][rnd], offs[nm]
                feeds[nm] = (crops[o:o + k], frames[o:o + k])
                offs[nm] = o + k
        if interleave:
            runner.feed(feeds)
            runner.flush()
        else:
            for nm, fd in feeds.items():
                runner.feed({nm: fd})
    return runner.finish()


def _sink(store):
    def sink(name, objs, vals, idxs):
        store.setdefault(name, []).append(
            (np.array(objs), np.array(vals), np.array(idxs)))
    return sink


def _sunk(store):
    return {nm: tuple(np.concatenate([b[i] for b in batches])
                      for i in range(3))
            for nm, batches in store.items()}


def _solo_runs(streams, cfg, chunkings, forward=_forward):
    """Each stream through its own port ``IngestPipeline`` over the same
    chunk splits, with a sink: the byte-identity baseline. Returns the
    ``finish()`` results and the sinks' store."""
    out, store = {}, {}
    for nm, (crops, frames) in streams.items():
        sink = _sink(store)
        ing = StreamingIngestor(
            None, 1e9, cfg, device="cpu",
            pipeline=IngestPipeline(forward, device="cpu",
                                    topk_sink=lambda *a, nm=nm: sink(nm, *a)))
        o = 0
        for k in chunkings[nm]:
            ing.feed(crops[o:o + k], frames[o:o + k])
            ing.flush()
            o += k
        out[nm] = ing.finish()
    return out, store


def _assert_same(got, want, got_store=None, want_store=None):
    """Per stream: identical saved bytes and counters and, given the
    sinks' stores, identical sunk objects, values and classes."""
    assert list(got) == list(want)
    for nm in want:
        assert got[nm][0].save_bytes() == want[nm][0].save_bytes(), nm
        assert _counters(got[nm][1]) == _counters(want[nm][1]), nm
    if want_store is not None:
        got_sunk, want_sunk = _sunk(got_store), _sunk(want_store)
        assert sorted(got_sunk) == sorted(want_sunk)
        for nm in want_sunk:
            for g, w in zip(got_sunk[nm], want_sunk[nm]):
                np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the port's sharded runner against the JAX package's (1-device mesh)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("names", [["cam0", "cam1"],
                                   ["cam0", "cam1", "cam2"]])
@settings(max_examples=3, deadline=None)
@given(data=st.data())
def test_sharded_runner_matches_jax(names, data):
    cfg = dict(batch_size=data.draw(st.sampled_from([32, 64])), **EVICTING)
    lengths = [data.draw(st.integers(0, 260)) for _ in names]
    seed = data.draw(st.integers(0, 10_000))
    streams, probs, feats = _lookup_streams(names, seed, lengths)
    chunkings = {nm: _chunks(data.draw, n) for nm, n in zip(names, lengths)}
    js, ps = {}, {}
    jrun = j_make_sharded_runner(
        _jax_lookup(probs, feats), j_make_ingest_mesh(1), names,
        cfg=J.IngestConfig(**cfg), topk_sink=_sink(js),
        cheap_flops_per_image=1e9)
    prun = make_sharded_runner(
        _torch_lookup(probs, feats), _cpu_mesh(1), names,
        cfg=IngestConfig(**cfg), topk_sink=_sink(ps),
        cheap_flops_per_image=1e9)
    want = _feed(jrun, streams, chunkings)
    got = _feed(prun, streams, chunkings)
    _assert_same(got, want, ps, js)
    st_p, st_j = prun.pipeline.stats, jrun.pipeline.stats
    assert (st_p.n_steps, st_p.n_batches, st_p.n_objects) == \
        (st_j.n_steps, st_j.n_batches, st_j.n_objects)


# ---------------------------------------------------------------------------
# the port's CPU meshes of 2 and 4 blocks against its solo pipelines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_blocks,n_streams", [(2, 3), (2, 4), (4, 4),
                                                (4, 5)])
@settings(max_examples=2, deadline=None)
@given(data=st.data())
def test_cpu_blocks_match_solo_pipelines(n_blocks, n_streams, data):
    """Streams placed round-robin over 2 or 4 CPU blocks, idle padding
    slots where the count does not divide: every stream saves its solo
    ``IngestPipeline``'s bytes, counters and sink."""
    cfg = IngestConfig(batch_size=32, **EVICTING)
    names = [f"cam{i}" for i in range(n_streams)]
    streams, chunkings = {}, {}
    for i, nm in enumerate(names):
        n = data.draw(st.integers(0, 220))
        streams[nm] = _stream(data.draw(st.integers(0, 10_000)) + i, n)
        chunkings[nm] = _chunks(data.draw, n, max_chunks=5)
    got_sink = {}
    runner = make_sharded_runner(_forward, _cpu_mesh(n_blocks), names,
                                 cfg=cfg, topk_sink=_sink(got_sink),
                                 cheap_flops_per_image=1e9)
    assert runner.placement.slots.count(None) == \
        n_blocks * -(-n_streams // n_blocks) - n_streams
    got = _feed(runner, streams, chunkings)
    want, want_sink = _solo_runs(streams, cfg, chunkings)
    _assert_same(got, want, got_sink, want_sink)
    for nm in names:
        block = runner.pipeline.handle(nm).block
        assert block.index == runner.placement.device_of(nm)
        assert runner.ingestors[nm].device == block.device


# ---------------------------------------------------------------------------
# a real cheap CNN: the caller's forward on block 0, a replica on each other
# ---------------------------------------------------------------------------

# a cheap CNN at the test streams' 6 px crops, the lookup's widths
TINY_CNN = dict(name="tiny", input_res=6, n_blocks=2, width=8,
                n_classes=N_CLASSES, feature_dim=FEAT_DIM)


@pytest.fixture(scope="module")
def cheap_forward():
    """``cnn.make_forward`` of a CheapCNN holding the JAX package's
    initial weights (``cnn.init``, seed 0), carried by
    ``params_from_jax``."""
    tree = jax.tree.map(np.asarray, jax.jit(jcnn.init, static_argnums=1)(
        jax.random.PRNGKey(0), JCheapCNNConfig(**TINY_CNN)))
    return cnn.make_forward(cnn.build(CheapCNNConfig(**TINY_CNN), tree,
                                      device="cpu"))


def _storages(module):
    return {p.untyped_storage().data_ptr() for p in module.parameters()}


@pytest.mark.parametrize("n_blocks,n_streams", [(2, 3), (4, 5), (4, 2)])
def test_cnn_replicas_on_cpu_blocks_match_solo_pipelines(
        cheap_forward, n_blocks, n_streams):
    """Streams over 2 or 4 CPU blocks with a real cheap CNN: block 0 runs
    the caller's forward, every other block with a stream its own
    replica (a distinct module sharing no storage with block 0's, the
    same weights), an idle block none; every stream saves its solo
    ``IngestPipeline``'s bytes, counters and sink. The CNN's features lie
    ~0.25 apart, so the threshold is 0.1 for its tables to evict."""
    cfg = IngestConfig(batch_size=32, **dict(EVICTING, threshold=0.1))
    names = [f"cam{i}" for i in range(n_streams)]
    streams = {nm: _stream(41 + i, 150 + 30 * i)
               for i, nm in enumerate(names)}
    chunkings = {nm: [50] * -(-len(c) // 50)
                 for nm, (c, _) in streams.items()}
    got_sink = {}
    runner = make_sharded_runner(cheap_forward, _cpu_mesh(n_blocks), names,
                                 cfg=cfg, topk_sink=_sink(got_sink),
                                 cheap_flops_per_image=1e9)
    got = _feed(runner, streams, chunkings)
    want, want_sink = _solo_runs(streams, cfg, chunkings, cheap_forward)
    _assert_same(got, want, got_sink, want_sink)
    assert sum(c.n_evictions for _, c in got.values()) > 0
    forwards = runner.pipeline.forwards
    assert forwards[0] is cheap_forward
    active = set(runner.placement.assignment().values())
    for i, f in enumerate(forwards[1:], 1):
        if i not in active:
            assert f is None, i           # an idle block holds no weights
            continue
        assert isinstance(f, cnn.CheapForward) and not f.training
        assert all(f is not g for g in forwards[:i])
        assert not _storages(f) & _storages(cheap_forward)
        for a, b in zip(f.parameters(), cheap_forward.parameters(),
                        strict=True):
            assert torch.equal(a, b)


@pytest.mark.parametrize("input_res", [None, 4])
def test_replica_outputs_equal_the_original(cheap_forward, input_res):
    """The replica protocol alone: a block's replica (with the zoo's
    resize to the model's input inside the forward, or without) gives
    the original's outputs bit for bit."""
    fwd = (cheap_forward if input_res is None
           else cnn.make_forward(cheap_forward.model, input_res))
    pipe = ShardedIngestPipeline(fwd, _cpu_mesh(2), ["a", "b"])
    rep = pipe._forward_of(pipe.blocks[1])
    assert rep is not fwd and pipe._forward_of(pipe.blocks[1]) is rep
    assert rep.input_res == input_res
    crops = torch.from_numpy(_stream(5, 40)[0])
    for a, b in zip(rep(crops), fwd(crops), strict=True):
        assert torch.equal(a, b)
    # a forward that is no module is shared where the mesh is one device
    shared = ShardedIngestPipeline(_forward, _cpu_mesh(2), ["a", "b"])
    assert shared._forward_of(shared.blocks[1]) is _forward


def test_stacked_step_dispatch_budget():
    """A stacked step over S streams is one megastep dispatch plus at most
    one shared tail, however many streams it carries."""
    cfg = IngestConfig(batch_size=32, **EVICTING)
    names = ["cam0", "cam1", "cam2"]
    runner = make_sharded_runner(_forward, _cpu_mesh(1), names, cfg=cfg,
                                 cheap_flops_per_image=1e9)
    runner.feed({nm: _stream(21 + i, 96) for i, nm in enumerate(names)})
    runner.finish()
    st_ = runner.pipeline.stats
    assert st_.n_steps * 2 >= st_.n_dispatches   # <= 2 dispatches a step
    assert st_.n_batches > st_.n_steps           # steps carried streams
    assert st_.n_tail_scans <= st_.n_steps


# ---------------------------------------------------------------------------
# rollover: sealed shards and manifests match the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_blocks", [1, 2])
def test_sharded_rollover_matches_jax(tmp_path, n_blocks):
    names = ["cam0", "cam1", "cam2"]
    streams, probs, feats = _lookup_streams(names, 7, [300, 260, 280])
    cfg = dict(batch_size=32, **EVICTING)
    jcats = {nm: JShardCatalog.open(str(tmp_path / f"jax_{nm}"))
             for nm in names}
    pcats = {nm: ShardCatalog.open(str(tmp_path / f"port_{nm}"))
             for nm in names}
    jrun = j_make_sharded_runner(
        _jax_lookup(probs, feats), j_make_ingest_mesh(1), names,
        cfg=J.IngestConfig(**cfg), cheap_flops_per_image=1e9,
        ingestor_kwargs={nm: dict(catalog=jcats[nm], shard_objects=110)
                         for nm in names})
    prun = make_sharded_runner(
        _torch_lookup(probs, feats), _cpu_mesh(n_blocks), names,
        cfg=IngestConfig(**cfg), cheap_flops_per_image=1e9,
        ingestor_kwargs={nm: dict(catalog=pcats[nm], shard_objects=110)
                         for nm in names})
    chunkings = {nm: [77] * 4 for nm in names}
    _feed(jrun, streams, chunkings, interleave=False)
    _feed(prun, streams, chunkings, interleave=False)
    for nm in names:
        jcat, pcat = jcats[nm], pcats[nm]
        assert len(pcat) == len(jcat) > 1, nm
        with open(os.path.join(jcat.root, "catalog.json"), "rb") as fj, \
                open(os.path.join(pcat.root, "catalog.json"), "rb") as fp:
            assert fp.read() == fj.read(), nm
        for m in pcat:
            assert saved_file_bytes(pcat.path_of(m.shard_id)) == \
                jindex.saved_file_bytes(jcat.path_of(m.shard_id)), \
                (nm, m.shard_id)


# ---------------------------------------------------------------------------
# the staged MultiStreamRunner against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,batch", [(0, 32), (1, 64)])
def test_staged_runner_matches_jax(seed, batch):
    """One shared cheap_apply, stream batches folded in rotation: each
    stream's bytes equal the JAX staged runner's and the port's solo
    staged run's."""
    names = ["cam0", "cam1", "cam2"]
    streams, probs, feats = _lookup_streams(names, seed, [250, 140, 0])
    cfg = dict(batch_size=batch, **EVICTING)
    apply = _np_lookup(probs, feats)
    jrun = JMultiStreamRunner(
        {nm: JStreamingIngestor(None, 1e9, J.IngestConfig(**cfg))
         for nm in names}, cheap_apply=apply)
    prun = MultiStreamRunner(
        {nm: StreamingIngestor(None, 1e9, IngestConfig(**cfg), device="cpu")
         for nm in names}, cheap_apply=apply)
    chunkings = {nm: [50] * 6 for nm in names}
    want = _feed(jrun, streams, chunkings)
    got = _feed(prun, streams, chunkings)
    _assert_same(got, want)
    staged = staged_cheap_apply(_torch_lookup(probs, feats),
                                IngestConfig(**cfg), device="cpu")
    for nm, (crops, frames) in streams.items():
        solo = StreamingIngestor(staged, 1e9, IngestConfig(**cfg),
                                 device="cpu")
        solo.feed(crops, frames)
        assert solo.finish()[0].save_bytes() == got[nm][0].save_bytes()


def test_staged_runner_driven_ingestor_must_finish_through_the_runner():
    cfg = IngestConfig(batch_size=32, **EVICTING)
    ing = StreamingIngestor(None, 1e9, cfg, device="cpu")
    crops, frames = _stream(3, 40)
    ing.feed(crops, frames)             # one ready batch stays buffered
    assert ing.n_ready_batches == 1
    with pytest.raises(RuntimeError, match="MultiStreamRunner.finish"):
        ing.finish()


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def test_placement_round_robin_layout():
    pl = StreamPlacement(["a", "b", "c", "d", "e"], 2)
    assert pl.assignment() == {"a": 0, "b": 1, "c": 0, "d": 1, "e": 0}
    assert pl.slots == ["a", "c", "e", "b", "d", None]
    assert pl.n_slots == 6 and pl.width == 3
    assert pl.slot_of("b") == 3 and pl.device_of("b") == 1
    assert StreamPlacement(["a", "b", "c", "d", "e"], 2).slots == pl.slots


@pytest.mark.parametrize("names,n,match", [([], 2, "at least one"),
                                           (["a", "a"], 2, "duplicate"),
                                           (["a"], 0, "n_devices")])
def test_placement_validation(names, n, match):
    with pytest.raises(ValueError, match=match):
        StreamPlacement(names, n)


@settings(max_examples=4, deadline=None)
@given(st.data())
def test_assignment_stable_across_feed_chunkings(data):
    """The stream -> block assignment, and every stream's bytes, are a
    function of the stream set alone, not of how ``feed()`` calls were
    chunked or interleaved."""
    cfg = IngestConfig(batch_size=32, **EVICTING)
    names = ["cam0", "cam1", "cam2"]
    streams = {nm: _stream(11 + i, 180) for i, nm in enumerate(names)}
    outs = []
    for interleave in (True, False):
        chunkings = {nm: _chunks(data.draw, 180, max_chunks=5)
                     for nm in names}
        runner = make_sharded_runner(_forward, _cpu_mesh(2), names,
                                     cfg=cfg)
        outs.append((runner.placement, _feed(runner, streams, chunkings,
                                             interleave=interleave)))
    (pa, a), (pb, b) = outs
    assert pa.assignment() == pb.assignment() == {"cam0": 0, "cam1": 1,
                                                  "cam2": 0}
    assert pa.slots == pb.slots == ["cam0", "cam2", "cam1", None]
    for nm in names:
        assert a[nm][0].save_bytes() == b[nm][0].save_bytes(), nm


# ---------------------------------------------------------------------------
# the mesh factory
# ---------------------------------------------------------------------------

def test_make_ingest_mesh_validates():
    with pytest.raises(ValueError, match="n_devices must be >= 1"):
        make_ingest_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        make_ingest_mesh(1, device="mps")
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="device='cpu'"):
        make_ingest_mesh(avail + 1)
    mesh = _cpu_mesh(4)
    assert mesh.axis_names == ("data",) and mesh.size == 4
    assert mesh.devices == (torch.device("cpu"),) * 4


def test_make_ingest_mesh_import_has_no_device_side_effects():
    """Importing ``launch.mesh`` calls nothing at module scope (device
    state is touched only when ``make_ingest_mesh`` is called)."""
    tree = ast.parse(inspect.getsource(mesh_mod))
    for node in tree.body:
        assert not isinstance(node, (ast.Expr, ast.Assign)) or \
            not any(isinstance(n, ast.Call)
                    for n in ast.walk(node)), ast.dump(node)


# ---------------------------------------------------------------------------
# the pipeline's contract errors
# ---------------------------------------------------------------------------

def _shared(slots, mesh=None, **kw):
    return ShardedIngestPipeline(_forward, mesh or _cpu_mesh(1), slots, **kw)


def test_sharded_pipeline_rejects_mismatched_cfg():
    cfg_a = IngestConfig(batch_size=32, **EVICTING)
    cfg_b = IngestConfig(batch_size=64, **EVICTING)
    shared = _shared(["a", "b"], cfg=cfg_a)
    StreamingIngestor(None, 1e9, cfg_a, device="cpu",
                      pipeline=shared.handle("a"))
    with pytest.raises(ValueError, match="one\\s+IngestConfig"):
        StreamingIngestor(None, 1e9, cfg_b, device="cpu",
                          pipeline=shared.handle("b"))
    with pytest.raises(ValueError, match="fused"):
        _shared(["a"], cfg=IngestConfig(clustering="scan"))


@pytest.mark.parametrize("slots,mesh,err,match", [
    ([], None, ValueError, "multiple"),
    (["a", "b", "c"], IngestMesh((torch.device("cpu"),) * 2), ValueError,
     "multiple"),
    (["a", "a"], None, ValueError, "duplicate"),
    # a forward that is no module cannot be replicated onto a second device
    (["a", "b"], IngestMesh((torch.device("cuda", 0),
                             torch.device("cuda", 1))),
     ValueError, "cannot be\\s+replicated"),
    (["a", "b"], IngestMesh((torch.device("cpu"), torch.device("meta"))),
     ValueError, "cannot be\\s+replicated"),
])
def test_sharded_pipeline_slot_layout_validation(slots, mesh, err, match):
    with pytest.raises(err, match=match):
        _shared(slots, mesh)


def test_sharded_pipeline_needs_a_mesh():
    with pytest.raises(ValueError, match="make_ingest_mesh"):
        ShardedIngestPipeline(_forward, None, ["a"])


def test_sharded_pipeline_binding_errors():
    cfg = IngestConfig(batch_size=32, **EVICTING)
    shared = _shared(["a", "b"], cfg=cfg)
    ing = StreamingIngestor(None, 1e9, cfg, device="cpu",
                            pipeline=shared.handle("a"))
    with pytest.raises(ValueError, match="already bound"):
        StreamingIngestor(None, 1e9, cfg, device="cpu",
                          pipeline=shared.handle("a"))
    other = _shared(["a"], cfg=cfg)
    with pytest.raises(ValueError, match="not bound to this"):
        MultiStreamRunner({"a": ing}, pipeline=other)
    with pytest.raises(ValueError, match="exactly one"):
        MultiStreamRunner({"a": ing})
    with pytest.raises(ValueError, match="owns a cheap_apply/pipeline"):
        MultiStreamRunner({"a": ing}, cheap_apply=lambda c: c)


def test_sharded_slot_reset_with_queued_batches_raises():
    cfg = IngestConfig(batch_size=16, K=2, threshold=1.5, pixel_diff=False)
    shared = _shared(["a"], cfg=cfg, auto_pump=False)
    StreamingIngestor(None, 1e9, cfg, device="cpu",
                      pipeline=shared.handle("a"))
    crops, frames = _stream(4, 40)
    h = shared.handle("a")
    h.submit(crops[:16], np.arange(16), frames[:16])
    with pytest.raises(RuntimeError, match="queued batches"):
        h.reset()
    h.flush_pending()
    h.reset()
    assert int(shared._states[0].n[0]) == 0


# ---------------------------------------------------------------------------
# serve --mesh-devices against the JAX package's serve with the same flags
# ---------------------------------------------------------------------------

def test_serve_mesh_devices_needs_a_streaming_path():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.parse_args(["--device", "cpu", "--mesh-devices", "1"])
    args = serve.parse_args(["--device", "cpu", "--mesh-devices", "1",
                             "--stream-chunks", "4"])
    assert args.mesh_devices == 1


def test_serve_mesh_devices_matches_jax_serve(tmp_path, monkeypatch, capsys):
    """``--mesh-devices 1 --stream-chunks 4`` on the default path: the
    port trains spec1-spec3, selects, ingests through its sharded
    pipeline and answers; the JAX serve, given the port's weights through
    its model cache, does the same through its own sharded pipeline. Both
    print the same choice line and the same answers."""
    import dataclasses
    import pickle
    import sys

    import benchmarks.common as bc
    from repro.common.config import CheapCNNConfig as JCheapCNNConfig
    from repro.launch import serve as jserve
    from repro_torch.data.video import get_stream
    from repro_torch.launch import serve, zoo

    def lines(out, prefix):
        return [ln for ln in out.splitlines() if ln.startswith(prefix)]

    monkeypatch.setattr(zoo, "CACHE_DIR", tmp_path / "port")
    argv = ["--stream", "jacksonh", "--duration", "10", "--fps", "30",
            "--steps", "20", "--rounds", "1", "--mesh-devices", "1",
            "--stream-chunks", "4"]
    threads = torch.get_num_threads()
    # one intra-op thread: beside the other test workers, a thread per
    # core each leaves the serve's training many times slower
    torch.set_num_threads(1)
    try:
        report = serve.main(argv + ["--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    port_out = capsys.readouterr().out
    assert report["ingest_chunks"] == 4

    monkeypatch.setattr(bc, "CACHE_DIR", str(tmp_path / "jax"))
    crops = get_stream("jacksonh", duration_s=10, fps=30).objects_array()[0]
    for mid in zoo.SPECIALIZED_FAMILY:
        sm = zoo.load_model(zoo.cache_prefix("jacksonh", mid, 10, 20, 6,
                                             len(crops), tmp_path / "port"))
        with open(bc._cache_path("jacksonh", mid, 10), "wb") as f:
            pickle.dump((sm.params,
                         JCheapCNNConfig(**dataclasses.asdict(sm.cfg)),
                         sm.class_map.global_ids.tolist()), f)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    assert jserve.main() == 0
    jax_out = capsys.readouterr().out
    choice = lines(port_out, "[serve] policy=")
    assert len(choice) == 1 and choice == lines(jax_out, "[serve] policy=")
    answers = lines(port_out, "  query class=")
    assert answers and answers == lines(jax_out, "  query class=")


def test_serve_mesh_devices_2_answers_as_1(capsys):
    """The override path (seeded cheap1, K=1000, T=0.4) over a 2-block CPU
    ingest mesh prints the answers and the ingest line of a 1-block one:
    the one stream lives on block 0, and block 1 stays idle."""
    from repro_torch.launch import serve

    argv = ["--stream", "jacksonh", "--duration", "10", "--fps", "30",
            "--device", "cpu", "--stream-chunks", "4", "--rounds", "1",
            "--K", "1000", "--T", "0.4", "--model", "cheap1", "--seed", "0"]
    outs = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # beside the other test workers
    try:
        for n in ("1", "2"):
            report = serve.main(argv + ["--mesh-devices", n])
            assert report["objects"] > 0 and report["clusters"] > 1
            out = capsys.readouterr().out.splitlines()
            # the answers, and the ingest line up to its wall time
            outs.append([ln for ln in out if ln.startswith("  query class=")]
                        + [ln.split(" in ")[0] for ln in out
                           if ln.startswith("[serve] ingest:")])
    finally:
        torch.set_num_threads(threads)
    assert len(outs[0]) > 1 and outs[1] == outs[0]
