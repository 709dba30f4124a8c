"""The port's hillclimb harness (``repro_torch.launch.hillclimb``) against
the JAX package's ``repro.launch.hillclimb``.

- ``gate_tune(device="cpu")``: the redundancy gate and the
  ``AdaptiveSampler`` over JAX's synthetic static-camera stream, window
  by window; its record equals JAX's ``gate_tune()`` key for key (strides,
  per-window counts, recall to 4 places, the final stride). JAX's runs in
  a subprocess (importing ``repro.launch.hillclimb`` sets ``XLA_FLAGS``).
- ``parse_override`` casts as JAX's does.
- Cell mode re-traces one cell with overrides, in a subprocess of its own
  (a fake process group is global state of a process).
"""
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")

_JAX = r"""
import json
from repro.launch.hillclimb import gate_tune, parse_override
print(json.dumps({"gate": gate_tune(), "overrides": [
    parse_override(kv) for kv in ("a=3", "b=0.5", "c=true", "d=false",
                                  "e=dp", "f=1e-3", "g=x=y")]}))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's gate tune and the port's cell mode, both in subprocesses
    started together; the port's gate tune in this process meanwhile."""
    from repro_torch.launch.hillclimb import gate_tune
    out = str(tmp_path_factory.mktemp("hillclimb"))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _JAX],
                              env=dict(env, JAX_PLATFORMS="cpu"),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True),
             subprocess.Popen([sys.executable, "-m",
                               "repro_torch.launch.hillclimb", "--cell",
                               "olmo-1b:decode_32k", "--set",
                               "act_sharding=dp", "--tag", "t", "--out",
                               out], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)]
    try:
        port = gate_tune(device="cpu")
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e[-4000:]
    with open(os.path.join(out, "olmo-1b_decode_32k_t.json")) as f:
        cell = json.load(f)
    return port, json.loads(outs[0][0].strip().splitlines()[-1]), cell, \
        outs[1][0]


def test_gate_tune_record_equals_jax(runs):
    port, jax_out = runs[0], runs[1]
    assert json.loads(json.dumps(port)) == jax_out["gate"]
    # the tune did something: the gate skipped, a window was sampled out
    assert port["n_gate_skipped"] > 0 and port["n_sampled_out"] > 0
    assert len(port["steps"]) == 8


def test_parse_override_casts_as_jax(runs):
    from repro_torch.launch.hillclimb import parse_override
    kvs = ("a=3", "b=0.5", "c=true", "d=false", "e=dp", "f=1e-3", "g=x=y")
    got = [list(parse_override(kv)) for kv in kvs]
    assert got == runs[1]["overrides"]
    assert parse_override("train_microbatches=2") == ("train_microbatches",
                                                      2)
    assert isinstance(parse_override("x=2")[1], int)
    assert parse_override("x=true")[1] is True


def test_cell_mode_retraces_with_overrides(runs):
    cell, stdout = runs[2], runs[3]
    assert cell["ok"] and cell["overrides"] == {"act_sharding": "dp"}
    assert cell["mesh"] == {"data": 16, "model": 16}
    assert cell["roofline"]["bound_step_s"] > 0
    assert "cell=olmo-1b:decode_32k" in stdout and "dom=" in stdout
