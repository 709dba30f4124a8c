"""The port's threefry PRNG (``repro_torch.common.prng``) against
``jax.random`` with JAX's default settings (threefry2x32, partitionable):
keys, splits and random bits must be exact, and the normals too (the port
computes XLA's own ``erf_inv`` and ``log1p``, fused multiply-adds
included). Then the weights drawn from it: ``cnn.init_params(cfg, seed)``
equals ``repro.models.cnn.init(PRNGKey(seed), cfg)`` bit for bit, so the
default serve path trains the JAX package's models and, with no weights
shared, prints the JAX serve's choice line. The same run of the port's
default serve, handed to the JAX serve through its model cache, gives
its choice line and answers too."""
import contextlib
import dataclasses
import io
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import CheapCNNConfig as JCheapCNNConfig
from repro.models import cnn as jcnn
from repro_torch.common import prng
from repro_torch.data.video import get_stream
from repro_torch.launch import serve, zoo
from repro_torch.models import cnn


def _np(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2 ** 31 - 1, -3])
def test_key_and_split_are_exact(seed):
    k = jax.random.PRNGKey(seed)
    tk = prng.key(seed)
    np.testing.assert_array_equal(tk.numpy(), _np(k))
    for n in (2, 3, 16):
        np.testing.assert_array_equal(prng.split(tk, n).numpy(),
                                      _np(jax.random.split(k, n)))
    # a split of a split: keys travel as tensors
    np.testing.assert_array_equal(
        prng.split(prng.split(tk, 4)[3], 5).numpy(),
        _np(jax.random.split(jax.random.split(k, 4)[3], 5)))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 4, 5), (0, 4)])
def test_random_bits_are_exact(shape):
    k = jax.random.split(jax.random.PRNGKey(11), 3)[2]
    want = np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64)
    got = prng._bits(torch.from_numpy(_np(k)), 0,
                     int(np.prod(shape))).reshape(shape)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,shape", [(0, (1,)), (1, (3, 3, 3, 16)),
                                        (2, (257, 129)), (3, (4, 5, 6)),
                                        (4, (1 << 18,))])
def test_normal_is_exact(seed, shape):
    k = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.normal(k, shape, jnp.float32))
    got = prng.normal(prng.key(seed), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_normal_in_chunks_equals_one_draw(monkeypatch):
    k = prng.key(5)
    whole = prng.normal(k, (1000, 3))
    monkeypatch.setattr(prng, "_CHUNK", 97)
    np.testing.assert_array_equal(prng.normal(k, (1000, 3)).numpy(),
                                  whole.numpy())


def test_erf_inv_and_log1p_follow_xla():
    """``erf_inv`` and ``log1p`` on the uniform range the normals use,
    tails included: exact but for the rare float64-then-float32 rounding
    of an emulated fused multiply-add, at most 1 ulp."""
    r = np.random.default_rng(0)
    u = (r.random(1 << 16) * 2 - 1).astype(np.float32)
    u = np.concatenate([u, np.float32(1) - r.random(1024).astype(
        np.float32) * np.float32(1e-3)])
    t = torch.from_numpy(u)
    want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(u)))
    got = prng.erf_inv(t).numpy()
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    assert ulp.max() <= 1 and (ulp > 0).mean() < 1e-3
    a = -(u * u)
    want = np.asarray(jax.jit(jnp.log1p)(jnp.asarray(a)))
    np.testing.assert_array_equal(prng.log1p(torch.from_numpy(a)).numpy(),
                                  want)


@pytest.mark.parametrize("seed", [2 ** 31, -2 ** 31 - 1, 2 ** 32, 2 ** 40])
def test_seed_outside_32_bits_raises(seed):
    with pytest.raises(ValueError):
        prng.key(seed)


def _cheap_cfgs():
    cfgs = {"cheap1": zoo.GENERIC_FAMILY["cheap1"][0]}
    for mid, (cfg, _) in zoo.SPECIALIZED_FAMILY.items():
        cfgs[mid] = dataclasses.replace(cfg, name=f"{mid}-spec6",
                                        n_classes=7)
    return cfgs


@pytest.mark.parametrize("model_id", ["cheap1", "spec1", "spec2", "spec3"])
@pytest.mark.parametrize("seed", [0, 3])
def test_cnn_init_params_equal_jax_init(model_id, seed):
    cfg = _cheap_cfgs()[model_id]
    got = cnn.init_params(cfg, seed)
    want = jcnn.init(jax.random.PRNGKey(seed),
                     JCheapCNNConfig(**dataclasses.asdict(cfg)))
    a, b = jax.tree.leaves(got), jax.tree.leaves(want)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, want))
    for x, y in zip(a, b):
        assert x.dtype == np.float32
        np.testing.assert_array_equal(x, np.asarray(y))


def test_zoo_cache_key_names_the_init_version(tmp_path):
    prefix = zoo.cache_prefix("jacksonh", "spec1", 10, 20, 6, 100, tmp_path)
    assert prefix.name.endswith(f"_init{zoo.INIT_VERSION}")
    assert zoo.INIT_VERSION == 2


def _lines(out: str, prefix: str):
    return [line for line in out.splitlines() if line.startswith(prefix)]


DEFAULT_ARGV = ["--stream", "jacksonh", "--duration", "10", "--fps", "30",
                "--steps", "20", "--rounds", "1"]


@pytest.fixture(scope="module")
def default_serve(tmp_path_factory):
    """The port's default serve with ``DEFAULT_ARGV`` on the CPU (spec1-spec3
    trained from its own threefry draw, the sweep, the choice, ingest and
    one round), run once for the module's two comparisons with the JAX
    serve: (its report, what it printed, its model cache)."""
    cache = tmp_path_factory.mktemp("port")
    printed = io.StringIO()
    threads = torch.get_num_threads()
    # one intra-op thread: beside the other test workers, a thread per
    # core each leaves the serve's training many times slower
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp, \
                contextlib.redirect_stdout(printed):
            mp.setattr(zoo, "CACHE_DIR", cache)
            report = serve.main(DEFAULT_ARGV + ["--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    return report, printed.getvalue(), cache


def test_serve_default_path_choice_equals_jax_serve_from_one_seed(
        default_serve, tmp_path, monkeypatch, capsys):
    """ROADMAP C7's closure: from one seed and NO shared weights, the port
    (training spec1-spec3 from its own threefry draw) and the JAX package
    (training from ``jax.random``) print the same choice line."""
    port_out = default_serve[1]
    import benchmarks.common as bc
    from repro.launch import serve as jserve
    monkeypatch.setattr(bc, "CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(sys, "argv", ["serve"] + DEFAULT_ARGV)
    assert jserve.main() == 0
    jax_out = capsys.readouterr().out
    choice = _lines(port_out, "[serve] policy=")
    assert len(choice) == 1 and choice == _lines(jax_out, "[serve] policy=")
    answers = _lines(port_out, "  query class=")
    assert answers and answers == _lines(jax_out, "  query class=")


def test_serve_default_path_matches_jax_serve(default_serve, tmp_path,
                                              monkeypatch, capsys):
    """With no ``--K/--T`` the port trains spec1-spec3, sweeps (model, K,
    T), selects by policy and ingests with the chosen model's class map,
    as ``repro.launch.serve`` does. Given the same trained weights (the
    port's, handed to the JAX package through its model cache), both
    print the same choice line and the same answers."""
    report, port_out, cache = default_serve
    sel = report["selection"]
    assert set(sel["models"]) == set(zoo.SPECIALIZED_FAMILY)
    for m in sel["models"].values():
        assert m["train_s"] > 0 and [h["step"] for h in m["history"]] == \
            [1, 5, 10, 15, 20]
        assert m["history"][-1]["loss"] < m["history"][0]["loss"]
    assert (report["K"], report["T"]) == (sel["choice"]["K"],
                                          sel["choice"]["T"])
    assert sel["choice"]["K"] in (1, 2, 4) and sel["choice"]["T"] in (0.5,
                                                                     0.8)

    import benchmarks.common as bc
    from repro.launch import serve as jserve
    monkeypatch.setattr(bc, "CACHE_DIR", str(tmp_path / "jax"))
    crops = get_stream("jacksonh", duration_s=10, fps=30).objects_array()[0]
    for mid in zoo.SPECIALIZED_FAMILY:
        sm = zoo.load_model(zoo.cache_prefix("jacksonh", mid, 10, 20, 6,
                                             len(crops), cache))
        with open(bc._cache_path("jacksonh", mid, 10), "wb") as f:
            pickle.dump((sm.params,
                         JCheapCNNConfig(**dataclasses.asdict(sm.cfg)),
                         sm.class_map.global_ids.tolist()), f)
    monkeypatch.setattr(sys, "argv", ["serve"] + DEFAULT_ARGV)
    assert jserve.main() == 0
    jax_out = capsys.readouterr().out
    choice = _lines(port_out, "[serve] policy=")
    assert len(choice) == 1 and choice == _lines(jax_out, "[serve] policy=")
    answers = _lines(port_out, "  query class=")
    assert answers and answers == _lines(jax_out, "  query class=")
