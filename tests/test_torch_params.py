"""The port's §4.4 parameter selection against the JAX package's:
``pareto_boundary``, ``select`` and ``AdaptiveSampler`` on random inputs,
and ``sweep`` over the same stream with the same cheap-model outputs,
which must give identical ``ConfigEval``s (every field, floats
included) and the same choice under each policy. Also the zoo's
accounted GT-CNN cost against the JAX package's."""
import numpy as np
import pytest
import torch

from benchmarks.common import GT_FLOPS as JAX_GT_FLOPS
from repro.core import params as jparams
from repro.core.index import ClassMap as JClassMap
from repro.data import get_stream as jax_get_stream
from repro_torch.core import params
from repro_torch.core.index import ClassMap
from repro_torch.launch import zoo
from repro_torch.models import cnn


def _fields(e):
    c = e.candidate
    return (c.model_id, c.K, c.T, e.precision, e.recall, e.ingest_flops,
            e.query_flops, e.n_clusters, e.viable)


def _random_evals(seed, n=40):
    r = np.random.default_rng(seed)
    out = {"port": [], "jax": []}
    for i in range(n):
        # few distinct costs, so ties and dominated duplicates occur
        args = (f"m{i % 3}", int(r.choice([1, 2, 4])),
                float(r.choice([0.5, 0.8])))
        kw = dict(precision=float(r.choice([0.9, 0.96, 1.0])),
                  recall=float(r.choice([0.9, 0.97, 1.0])),
                  ingest_flops=float(r.integers(1, 8)),
                  query_flops=float(r.integers(1, 8)),
                  n_clusters=int(r.integers(1, 50)))
        viable = kw["precision"] >= 0.95 and kw["recall"] >= 0.95
        for mod, key in ((params, "port"), (jparams, "jax")):
            out[key].append(mod.ConfigEval(mod.Candidate(*args), viable=viable,
                                           **kw))
    return out["port"], out["jax"]


@pytest.mark.parametrize("seed", range(4))
def test_pareto_and_select_match_jax(seed):
    port, ref = _random_evals(seed)
    assert [_fields(e) for e in params.pareto_boundary(port)] == \
        [_fields(e) for e in jparams.pareto_boundary(ref)]
    for policy in ("balance", "opt_ingest", "opt_query"):
        got, want = params.select(port, policy), jparams.select(ref, policy)
        assert (got is None) == (want is None)
        if got is not None:
            assert _fields(got) == _fields(want)
    with pytest.raises(ValueError):
        params.select(port, "nope")
    assert params.select([e for e in port if not e.viable]) is None


@pytest.mark.parametrize("seed", range(3))
def test_adaptive_sampler_matches_jax(seed):
    r = np.random.default_rng(seed)
    cfg = dict(min_stride=1, max_stride=9, dup_high=0.7, dup_low=0.4,
               recall_floor=0.97)
    port = params.AdaptiveSampler(params.SamplerConfig(**cfg))
    ref = jparams.AdaptiveSampler(jparams.SamplerConfig(**cfg))
    for _ in range(200):
        n_in, n_skip = (int(x) for x in r.integers(0, 100, 2))
        recall = float(r.random()) if r.random() < 0.1 else None
        out = (n_in, n_skip, recall, int(r.integers(0, 50)))
        assert port.observe(*out) == ref.observe(*out)
    with pytest.raises(ValueError):
        params.AdaptiveSampler(params.SamplerConfig(min_stride=0))


def test_sweep_matches_jax_with_the_same_cheap_outputs():
    """Two stand-in cheap models (one with a class map), K in {1, 2, 4},
    T in {0.5, 0.8}: the port's sweep on the CPU and the JAX package's
    give the same ConfigEvals and the same selection."""
    vs = jax_get_stream("bend", duration_s=40, fps=10)
    crops, frames, _, labels = vs.objects_array()
    classes = np.unique(labels)
    r = np.random.default_rng(0)
    outputs = {}
    for mid, n_local in (("wide", len(classes)), ("spec", 4)):
        local = np.searchsorted(classes, labels) % n_local
        probs = r.random((len(crops), n_local)).astype(np.float32)
        probs[np.arange(len(crops)), local] += 0.8
        probs /= probs.sum(1, keepdims=True)
        feats = (crops.reshape(len(crops), -1)[:, ::97][:, :32]
                 + r.normal(0, 0.01, (len(crops), 32))).astype(np.float32)
        outputs[mid] = (probs, feats)
    row = {c.tobytes(): i for i, c in enumerate(crops)}

    def lookup(mid):
        def apply(batch):
            ix = np.array([row[c.tobytes()] for c in batch], np.int64)
            return outputs[mid][0][ix], outputs[mid][1][ix]
        return apply

    models = {mid: (lookup(mid), 1e6 * (i + 1))
              for i, mid in enumerate(outputs)}
    spec_ids = classes[:3]
    kw = dict(Ks=[1, 2, 4], Ts=[0.5, 0.8], gt_flops=1e9,
              precision_target=0.9, recall_target=0.9, max_clusters=64,
              batch_size=64)
    got = params.sweep(crops, frames, labels, models,
                       class_maps={"spec": ClassMap(spec_ids)},
                       device="cpu", **kw)
    want = jparams.sweep(crops, frames, labels, models,
                         class_maps={"spec": JClassMap(spec_ids)}, **kw)
    assert len(got) == 12
    assert [_fields(e) for e in got] == [_fields(e) for e in want]
    assert any(e.viable for e in got)
    for policy in ("balance", "opt_ingest", "opt_query"):
        assert _fields(params.select(got, policy)) == \
            _fields(jparams.select(want, policy))


def test_gt_flops_and_families_match_the_jax_zoo():
    from benchmarks.common import (DEFAULT_LS, GENERIC_FAMILY,
                                   SPECIALIZED_FAMILY)
    assert zoo.GT_FLOPS == JAX_GT_FLOPS
    assert zoo.DEFAULT_LS == DEFAULT_LS
    for port_fam, jax_fam in ((zoo.GENERIC_FAMILY, GENERIC_FAMILY),
                              (zoo.SPECIALIZED_FAMILY, SPECIALIZED_FAMILY)):
        assert set(port_fam) == set(jax_fam)
        for mid, (cfg, div) in port_fam.items():
            jcfg, jdiv = jax_fam[mid]
            assert div == jdiv and vars(cfg) == vars(jcfg)


def test_zoo_generic_model_resizes_and_caches(tmp_path):
    """``get_model`` on a generic member: the crops are resized to its
    16 px input as the JAX zoo resizes them, the tensor ``forward`` (a
    replicable module that resizes inside) equals the numpy ``apply``,
    and a second call loads the cached model."""
    from benchmarks.common import _resize as jax_resize
    r = np.random.default_rng(0)
    crops = r.random((40, 32, 32, 3), dtype=np.float32)
    labels = r.integers(0, 1000, 40)
    np.testing.assert_array_equal(cnn.resize_nearest(crops, 16),
                                  jax_resize(crops, 16))
    np.testing.assert_array_equal(
        cnn.resize_nearest(torch.from_numpy(crops), 16).numpy(),
        jax_resize(crops, 16))
    apply_fn, flops, cmap = zoo.get_model("s", "cheap3", crops, labels, 4,
                                          steps=2, device="cpu",
                                          cache_dir=tmp_path)
    assert cmap is None and flops == zoo.GT_FLOPS / 98.0
    assert apply_fn.input_res == 16 and len(apply_fn.history) == 2
    probs, feats = apply_fn(crops)
    assert probs.shape == (40, 1000) and feats.shape == (40, 128)
    assert isinstance(apply_fn.forward, cnn.CheapForward)
    tp, tf = apply_fn.forward(torch.from_numpy(crops))
    np.testing.assert_allclose(tp.numpy(), probs, atol=1e-6)
    again, _, _ = zoo.get_model("s", "cheap3", crops, labels, 4, steps=2,
                                device="cpu", cache_dir=tmp_path)
    assert again.train_s is None and again.history == []
    np.testing.assert_array_equal(again(crops)[0], probs)
