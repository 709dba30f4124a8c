"""The port's clustering against the JAX package's, mirroring
``tests/test_clustering.py``: the same numpy features through both give
identical cluster ids, counts and live counts; centroids agree within
atol 1e-5 (fp32 sums in another order)."""
import numpy as np
import pytest
import torch

from repro.core import clustering as JC
from repro_torch.core import clustering as C


def _feats(n, d, seed=0, spread=5.0, n_modes=3):
    r = np.random.default_rng(seed)
    modes = r.normal(0, spread, (n_modes, d))
    pick = r.integers(0, n_modes, n)
    return (modes[pick] + r.normal(0, 0.1, (n, d))).astype(np.float32)


def _state(M, D):
    return C.init_state(M, D, device="cpu"), JC.init_state(M, D)


def _assert_same(port, jax_out, atol=1e-5):
    (ps, pids), (js, jids) = port, jax_out
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
    assert int(ps.n) == int(js.n)
    np.testing.assert_array_equal(ps.counts.numpy(), np.asarray(js.counts))
    n = int(js.n)
    np.testing.assert_allclose(ps.centroids.numpy()[:n],
                               np.asarray(js.centroids)[:n], atol=atol)


def _run(name, state_pair, f, T):
    ps, js = state_pair
    out = (C.CLUSTER_FNS[name](ps, f, T), JC.CLUSTER_FNS[name](js, f, T))
    _assert_same(*out)
    return out[0][0], out[1][0]


def _warm(M, D, f, T):
    """Both packages' states after the same sequential warm-up."""
    ps, js = _state(M, D)
    return _run("scan", (ps, js), f, T)


def test_first_object_creates_cluster():
    ps, _ = _run("scan", _state(8, 4), np.ones((1, 4), np.float32), 1.0)
    assert int(ps.n) == 1


def test_centroid_is_running_mean():
    f = np.array([[0, 0], [1, 0], [2, 0]], np.float32)
    ps, _ = _run("scan", _state(4, 2), f, 10.0)
    np.testing.assert_allclose(ps.centroids[0].numpy(), [1.0, 0.0], atol=1e-6)


@pytest.mark.parametrize("name", ["scan", "batched", "fused"])
@pytest.mark.parametrize("case", [
    "all_match", "none_match", "mixed", "crossing_high_water", "single",
])
def test_variants_match_jax(name, case):
    if case == "all_match":       # warm table, tight modes: every row folds
        f = _feats(96, 16, seed=7, spread=8.0)
        state, T, f = _warm(64, 16, f[:32], 2.0), 2.0, f[32:]
    elif case == "none_match":    # empty table, tiny threshold
        f = np.random.default_rng(11).normal(0, 10, (40, 8)).astype(
            np.float32)
        state, T = _state(64, 8), 1e-3
    elif case == "mixed":         # some fold, some open clusters in-batch
        f = _feats(150, 16, seed=5, spread=10.0, n_modes=8)
        state, T, f = _warm(128, 16, f[:30], 1.5), 1.5, f[30:]
    elif case == "crossing_high_water":   # fills all 16 slots mid-batch
        r = np.random.default_rng(13)
        f = (r.normal(0, 1, (24, 8)) + np.arange(24)[:, None] * 50.0
             ).astype(np.float32)
        state, T = _state(16, 8), 1.0
    else:
        f, state, T = np.ones((1, 4), np.float32), _state(16, 4), 1.0
    ps, _ = _run(name, state, f, T)
    if case == "crossing_high_water":
        assert int(ps.n) == 16


def test_fused_threshold_edge_is_squared_in_fp32():
    """d2 == fp32(0.8)**2 exactly: matched (folds into cluster 0) in both
    packages; one ulp further opens a new cluster."""
    f = np.zeros((3, 4), np.float32)
    f[1, 0] = np.float32(0.8)
    f[2, 0] = np.nextafter(np.float32(0.8), np.float32(1))
    state = _warm(8, 4, f[:1], 0.8)
    ps, _ = _run("fused", state, f[1:2], 0.8)
    assert int(ps.n) == 1
    ps, _ = _run("fused", state, f[2:3], 0.8)
    assert int(ps.n) == 2


def test_fused_video_stream_multi_batch():
    """Batch after batch over a video-style stream, as the ingestor
    calls it: ids, counts and centroids stay equal to the JAX package's."""
    f = _feats(400, 16, seed=21, spread=12.0, n_modes=6)
    state = _warm(64, 16, f[:64], 1.5)
    for start in range(64, 400, 64):
        state = _run("fused", state, f[start:start + 64], 1.5)


def test_fused_empty_batch_and_input_state_untouched():
    ps, _ = _state(16, 4)
    s, ids = C.cluster_fused(ps, np.zeros((0, 4), np.float32), 1.0)
    assert ids.shape == (0,) and int(s.n) == 0
    f = _feats(20, 4, seed=2)
    before = (ps.centroids.clone(), ps.counts.clone())
    C.cluster_fused(ps, f, 1.0)
    assert torch.equal(ps.centroids, before[0])
    assert torch.equal(ps.counts, before[1]) and int(ps.n) == 0


def test_fold_is_order_fixed_segment_sum():
    """Many rows into few clusters: the fixed-order fold equals the JAX
    segment sum, and repeated runs give identical bits."""
    f = _feats(256, 32, seed=4, spread=6.0, n_modes=4)
    state = _warm(32, 32, f[:16], 3.0)
    a, _ = C.cluster_fused(state[0], f[16:], 3.0)
    b, _ = C.cluster_fused(state[0], f[16:], 3.0)
    assert torch.equal(a.centroids, b.centroids)
    _run("fused", state, f[16:], 3.0)


def test_eviction_matches_jax():
    f = _feats(40, 8, seed=3, n_modes=6)
    ps, js = _warm(16, 8, f, 1.0)
    p_new, p_ev, p_remap = C.evict_smallest(ps, frac=0.5)
    j_new, j_ev, j_remap = JC.evict_smallest(js, frac=0.5)
    np.testing.assert_array_equal(p_ev, j_ev)
    np.testing.assert_array_equal(p_remap, j_remap)
    assert int(p_new.n) == int(j_new.n)
    np.testing.assert_array_equal(p_new.counts.numpy(),
                                  np.asarray(j_new.counts))
    np.testing.assert_allclose(p_new.centroids.numpy(),
                               np.asarray(j_new.centroids), atol=1e-5)


def test_buffer_full_joins_nearest():
    f = np.array([[0, 0], [10, 10], [5, 5]], np.float32)
    ps, _ = _run("scan", _state(2, 2), f, 0.1)
    assert int(ps.n) == 2
