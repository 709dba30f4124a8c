"""The port's serving layer against the JAX package's: ``QueryService``
responses are identical on the same index, and the port's
``launch.serve`` entry point answers the same frames as the JAX
``QueryService`` over the JAX ingest of the same stream and the same CNN
outputs — one-shot, and in archive mode over the shards it sealed."""
import importlib

import numpy as np
import pytest
import torch

from conftest import make_stream
from repro.core.archive import ArchiveQueryEngine as JArchiveQueryEngine
from repro.core.archive import ShardCatalog as JShardCatalog
from repro.core.engine import QueryEngine as JQueryEngine
from repro.core.query import dominant_classes
from repro.serve import QueryService as JQueryService
from repro.serve import ServiceConfig as JServiceConfig
from repro_torch.common.config import CHEAP_CNNS
from repro_torch.core.engine import QueryEngine
from repro_torch.data.video import get_stream, gt_oracle
from repro_torch.launch import serve
from repro_torch.models import cnn
from repro_torch.serve import QueryService, ServiceConfig

J = importlib.import_module("repro.core.ingest")
P = importlib.import_module("repro_torch.core.ingest")
N_CLASSES = 5


def _cheap(batch):
    flat = batch.reshape(len(batch), -1)
    feats = (flat[:, :12] * 10.0).astype(np.float32)
    probs = np.abs(flat[:, 12:12 + N_CLASSES]) + 1e-3
    return (probs / probs.sum(1, keepdims=True)).astype(np.float32), feats


def _gt_apply(batch):
    return np.rint(batch[:, 0, 0, 2] * 8).astype(np.int64) % N_CLASSES


def _responses(service, plans):
    for tenant, classes, Kx in plans:
        assert service.submit(tenant, classes, Kx=Kx) is not None
    return [(r.request.tenant, r.request.classes, r.cycle,
             [(res.queried_class, res.matched_clusters, res.frames.tolist(),
               res.n_gt_invocations) for res in r.results])
            for r in service.run_until_idle()]


@pytest.mark.parametrize("seed,max_batch", [(0, 1), (1, 2), (2, 32)])
def test_service_responses_match_jax(seed, max_batch):
    crops, frames = make_stream(seed, n=300)
    cfg = dict(K=3, threshold=1.5, max_clusters=64, batch_size=32)
    ij, _ = J.ingest(crops, frames, _cheap, 1.0, J.IngestConfig(**cfg),
                     n_local_classes=N_CLASSES)
    ip, _ = P.ingest(crops, frames, _cheap, 1.0, P.IngestConfig(**cfg),
                     n_local_classes=N_CLASSES, device="cpu")
    r = np.random.default_rng(seed)
    plans = [(f"tenant{t}", r.integers(0, N_CLASSES, r.integers(1, 5)
                                       ).tolist(), [None, 1, 2][t % 3])
             for t in range(4) for _ in range(2)]
    port = QueryService(QueryEngine(ip, gt_apply=_gt_apply),
                        ServiceConfig(max_batch_requests=max_batch))
    ref = JQueryService(JQueryEngine(ij, gt_apply=_gt_apply),
                        JServiceConfig(max_batch_requests=max_batch))
    got, want = _responses(port, plans), _responses(ref, plans)
    assert got == want
    assert vars(port.stats) == vars(ref.stats)


def test_service_rejects_over_queue_depth():
    crops, frames = make_stream(3, n=100)
    ip, _ = P.ingest(crops, frames, _cheap, 1.0,
                     P.IngestConfig(K=2, max_clusters=32, batch_size=32),
                     n_local_classes=N_CLASSES, device="cpu")
    service = QueryService(QueryEngine(ip, gt_apply=_gt_apply),
                           ServiceConfig(max_queue_depth=2))
    assert service.submit("a", [0]) is not None
    assert service.submit("b", [1]) is not None
    assert service.submit("c", [2]) is None
    assert service.stats.n_rejected == 1
    with pytest.raises(ValueError):
        ServiceConfig(policy="nope")


def test_serve_entry_point_end_to_end_on_cpu_matches_jax_service():
    """``python -m repro_torch.launch.serve`` on a short stream: the round-0
    answers equal the JAX ``QueryService``'s over ``repro`` ingest of the
    same crops and the same cheap1 outputs."""
    argv = ["--stream", "jacksonh", "--duration", "6", "--fps", "30",
            "--device", "cpu", "--K", "1000", "--T", "0.4", "--rounds", "2"]
    report = serve.main(argv)
    assert report["objects"] > 0 and report["clusters"] > 1
    assert set(report["tenants"]) == {f"tenant{t}" for t in range(4)}
    assert all(t["completed"] == 2 for t in report["tenants"].values())
    assert any(len(f) for f in report["answers"].values())

    crops, frames, _, labels = get_stream(
        "jacksonh", duration_s=6, fps=30).objects_array()
    mcfg = CHEAP_CNNS["cheap1"]
    apply = cnn.make_apply(cnn.build(mcfg, cnn.init_params(mcfg, 0),
                                     device="cpu"))
    index, _ = J.ingest(crops, frames, apply, 1.0,
                        J.IngestConfig(K=1000, threshold=0.4),
                        n_local_classes=1000)
    workload = [int(x) for x in dominant_classes(labels)]
    service = JQueryService(JQueryEngine(index, gt_apply=gt_oracle(labels)))
    service.submit("tenant0", workload)
    (resp,) = service.run_until_idle()
    assert list(report["answers"]) == workload
    for x, res in zip(workload, resp.results):
        np.testing.assert_array_equal(report["answers"][x], res.frames)


def test_serve_streaming_mode_on_cpu_matches_jax_service():
    """``--stream-chunks 3``: tenants query the live index between chunks,
    and the final answers equal the JAX ``QueryService``'s over a one-shot
    JAX ingest at the same (chunk-clamped) CNN batch size — chunking never
    changes the index."""
    argv = ["--stream", "jacksonh", "--duration", "6", "--fps", "30",
            "--device", "cpu", "--K", "1000", "--T", "0.4", "--rounds", "1",
            "--stream-chunks", "3"]
    report = serve.main(argv)
    assert report["ingest_chunks"] == 3
    assert all(t["completed"] == 4 for t in report["tenants"].values())

    crops, frames, _, labels = get_stream(
        "jacksonh", duration_s=6, fps=30).objects_array()
    mcfg = CHEAP_CNNS["cheap1"]
    apply = cnn.make_apply(cnn.build(mcfg, cnn.init_params(mcfg, 0),
                                     device="cpu"))
    batch = max(16, min(512, -(-len(crops) // 3)))
    index, _ = J.ingest(crops, frames, apply, 1.0,
                        J.IngestConfig(K=1000, threshold=0.4,
                                       batch_size=batch),
                        n_local_classes=1000)
    assert report["clusters"] == index.n_clusters
    workload = [int(x) for x in dominant_classes(labels)]
    results, _ = JQueryEngine(index, gt_apply=gt_oracle(labels)
                              ).query_many(workload)
    assert any(len(f) for f in report["answers"].values())
    for x, res in zip(workload, results):
        np.testing.assert_array_equal(report["answers"][x], res.frames)


def test_serve_archive_mode_on_cpu_matches_jax_archive_engine(tmp_path):
    """``launch.serve --archive DIR --stream-chunks 4`` on the CPU: tenants
    query between chunks across shard rollovers, and the final round-0
    answers equal the JAX ``ArchiveQueryEngine``'s over the shards the
    port sealed. ``--K 1000`` because seeded random weights rank the same
    classes first for every crop; the shards hold a few dozen clusters, so
    the JAX package's interpret-mode ``dequant_topk`` stays cheap."""
    arch = str(tmp_path / "arch")
    argv = ["--stream", "jacksonh", "--duration", "20", "--fps", "30",
            "--device", "cpu", "--K", "1000", "--T", "0.4", "--rounds", "2",
            "--archive", arch, "--stream-chunks", "4",
            "--shard-objects", "512"]
    report = serve.main(argv)
    catalog = JShardCatalog.open(arch)
    assert report["shards"] == len(catalog) >= 2
    assert report["ingest_chunks"] == 4
    assert report["objects"] == sum(m.n_objects for m in catalog)
    assert report["clusters"] == sum(m.n_clusters for m in catalog)
    assert report["shard_loads"] >= len(catalog)
    # 4 chunk rounds + 2 final rounds, one request per tenant each
    assert all(t["completed"] == 6 for t in report["tenants"].values())
    assert any(len(f) for f in report["answers"].values())

    _, frames, _, labels = get_stream(
        "jacksonh", duration_s=20, fps=30).objects_array()
    workload = [int(x) for x in dominant_classes(labels)]
    results, _ = JArchiveQueryEngine(
        catalog, gt_apply=gt_oracle(labels)).query_many(workload)
    assert list(report["answers"]) == workload
    for x, res in zip(workload, results):
        np.testing.assert_array_equal(report["answers"][x], res.frames)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--stream", "jacksonh", "--duration", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.ingest(np.zeros((1, 6, 6, 3), np.float32), np.zeros(1, np.int64),
                 _cheap, 1.0, P.IngestConfig())
