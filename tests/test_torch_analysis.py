"""The port's focuslint (``repro_torch.analysis``): a positive and a
negative fixture per rule, asserted through the JSON report as
``tests/test_analysis.py`` does for the JAX package's linter; the
suppression cases; the CLI's exit codes; the rules both linters share
(``cache-version``, ``bare-suppression``, ``parse-error``) held to the
JAX linter's JSON findings on the same fixtures; and the tree itself:
no active finding over the default paths, and the suppressed syncs and
exemptions of ``src/repro_torch`` pinned."""
import collections
import contextlib
import io
import json
import os

import pytest

from repro.analysis.runner import run_analysis as jax_run_analysis
from repro_torch.analysis import cli
from repro_torch.analysis.rules import RULES
from repro_torch.analysis.runner import run_analysis

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(tmp_path, files):
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)


def lint(tmp_path, files, run=run_analysis, **kw):
    """Write {relpath: source} under tmp_path, lint, return parsed JSON."""
    _write(tmp_path, files)
    report = run([str(tmp_path)], **kw)
    return json.loads(report.to_json(show_suppressed=True))


def rules_of(doc):
    return sorted({f["rule"] for f in doc["findings"]})


def lines_of(doc, rule):
    return sorted(f["line"] for f in doc["findings"] if f["rule"] == rule)


# -- host-sync: built steps ----------------------------------------------------

_STEPS = (
    "import torch\n"
    "from dataclasses import dataclass\n"
    "@dataclass\n"
    "class StepSpec:\n"
    "    name: str\n"
    "    fn: object\n"
    "def _layer(x: torch.Tensor, n):\n"
    "    h = x * n\n"
    "    return h, {body}\n"
    "def _factory(loss_fn):\n"
    "    def run(p, b):\n"
    "        return loss_fn(p, b)\n"
    "    return run\n"
    "def build(cfg):\n"
    "    step = _factory(lambda p, b: _layer(p, cfg.n))\n"
    "    return StepSpec(name='s', fn=step)\n")


@pytest.mark.parametrize("body,line", [
    ("h.sum().item()", 9), ("h.cpu()", 9), ("h.tolist()", 9),
    ("int(h.sum())", 9), ("float(x)", 9), ("torch.cuda.synchronize()", 9)])
def test_host_sync_in_a_built_step(tmp_path, body, line):
    """The step is the factory's ``run``; the function the lambda handed
    to the factory calls (``_layer``) runs in it."""
    doc = lint(tmp_path, {"steps.py": _STEPS.format(body=body)})
    assert rules_of(doc) == ["host-sync"]
    assert lines_of(doc, "host-sync") == [line]
    assert "built-step function '_layer'" in doc["findings"][0]["message"]


def test_static_values_in_a_built_step_are_clean(tmp_path):
    doc = lint(tmp_path, {"steps.py": _STEPS.format(
        body="int(x.shape[0]) + float(n) + bool(x.dtype == torch.int8) + "
             "len(h)")})
    assert doc["findings"] == []


def test_a_function_outside_every_step_is_not_checked(tmp_path):
    doc = lint(tmp_path, {"steps.py": _STEPS.format(body="h") + (
        "def report(x: torch.Tensor):\n"
        "    return x.sum().item()\n")})
    assert doc["findings"] == []


# -- host-sync: dispatchers ----------------------------------------------------

_LIB = {
    "src/repro_torch/hopper/build.py": (
        "_SIGNATURES = {'scale_launch': (1, 2, 3)}\n"
        "def load():\n"
        "    return None\n"),
    "src/repro_torch/hopper/csrc/scale.cu": (
        'extern "C" int scale_launch(const float* x, float* out, int n) {\n'
        "  return 0;\n"
        "}\n"),
    "src/repro_torch/hopper/ref.py": (
        "def scale_ref(x):\n"
        "    return x * 2\n"),
    "src/repro_torch/hopper/ops.py": (
        "import torch\n"
        "from repro_torch.hopper import build, ref\n"
        "LAUNCHES = {'scale': 0}\n"
        "def _on(dev):\n"
        "    return torch.cuda.device(dev)\n"
        "def _launch(x, out):\n"
        "    with _on(x.device):\n"
        "        err = build.load().scale_launch(x.data_ptr(),\n"
        "                                        out.data_ptr(), x.numel())\n"
        "    LAUNCHES['scale'] += 1\n"
        "    return err\n"
        "def scale(x):\n"
        "    if x.device.type == 'cpu':\n"
        "        return ref.scale_ref(x)\n"
        "    out = torch.empty(x.shape, device=x.device)\n"
        "    if x.device.type == 'meta':\n"
        "        return out\n"
        "    _launch(x, out)\n"
        "    return out\n"),
    "tests/test_torch_hopper.py": (
        "from repro.kernels import ops as jops\n"
        "from repro_torch.hopper import ops\n"
        "def _pair(x):\n"
        "    return ops.scale(x), jops.scale(x)\n"
        "def test_scale_matches_jax():\n"
        "    a, b = _pair(1.0)\n"
        "    assert a == b\n"),
    "tests/test_torch_hopper_cuda.py": (
        "import pytest\n"
        "import torch\n"
        "from repro_torch.hopper import ops, ref\n"
        "@pytest.mark.cuda\n"
        "def test_scale_kernel_matches_plain():\n"
        "    x = torch.ones(4, device='cuda')\n"
        "    assert torch.equal(ops.scale(x), ref.scale_ref(x))\n"),
}


def _hot(body):
    return dict(_LIB, **{"src/repro_torch/core/hot.py": (
        "import numpy as np\n"
        "import torch\n"
        "from repro_torch.hopper import ops\n"
        "def upload(a, dev):\n"
        "    return torch.from_numpy(a).to(dev)\n"
        "def hot(a, dev, meta, ev):\n"
        "    x = upload(a, dev)\n"
        "    y = ops.scale(x)\n"
        "    host = torch.from_numpy(a)\n" + body)})


@pytest.mark.parametrize("body", [
    "    return y.cpu()\n", "    return int(y.sum())\n",
    "    return np.asarray(y)\n", "    return y.numpy()\n",
    "    return host.sum().item()\n", "    return meta.tolist()\n",
    "    return ev.synchronize()\n", "    torch.cuda.synchronize()\n"])
def test_host_sync_in_a_dispatcher(tmp_path, body):
    """``hot`` reaches the kernel launch through ``ops.scale``: syncs on
    its device tensors, and every fetch or wait, are flagged."""
    doc = lint(tmp_path, _hot(body))
    assert rules_of(doc) == ["host-sync"]
    assert lines_of(doc, "host-sync") == [10]
    assert "hot-path function 'hot'" in doc["findings"][0]["message"]


@pytest.mark.parametrize("body", [
    "    return host.cpu(), int(meta['n']), np.asarray(a), y\n",
    "    return len(y), int(y.shape[0]), y.dtype, y.numel()\n",
    "    y = host\n    return y.cpu()\n"])
def test_host_values_in_a_dispatcher_are_clean(tmp_path, body):
    doc = lint(tmp_path, _hot(body))
    assert doc["findings"] == []


def test_reads_after_the_wait_are_landed(tmp_path):
    """What ``<owner>.<event>.synchronize()`` waited for is no further
    sync: only the wait is flagged."""
    doc = lint(tmp_path, _hot("    y.ready.synchronize()\n"
                              "    return y.host.cpu(), int(y.n)\n"))
    assert lines_of(doc, "host-sync") == [10]


def test_a_handed_forward_on_a_device_tensor_is_hot(tmp_path):
    """A function that applies a callable it was handed (a model's
    forward) to a device tensor runs device work the call graph cannot
    follow: its fetch is flagged, with no kernel in sight."""
    src = ("import torch\n"
           "def staged(forward, dev):\n"
           "    def apply(a):\n"
           "        x = torch.from_numpy(a).to(dev)\n"
           "        return forward(x).cpu()\n"
           "    return apply\n"
           "def host_only(forward, a):\n"
           "    return forward(torch.from_numpy(a)).cpu()\n")
    doc = lint(tmp_path, {"mod.py": src})
    assert lines_of(doc, "host-sync") == [5]


def test_tests_are_exempt(tmp_path):
    files = _hot("    return y.cpu()\n")
    files["tests/test_hot.py"] = files.pop("src/repro_torch/core/hot.py")
    doc = lint(tmp_path, files)
    assert doc["findings"] == []


# -- donated-read ---------------------------------------------------------------

_DONATE = (
    "from repro_torch.launch.steps import StepSpec\n"
    "def step(p, o, b):\n"
    "    return p, o\n"
    "def run(p, o, batches):\n"
    "    spec = StepSpec(name='t', fn=step, args=(), donate_argnums=(0, 1))\n"
    "{body}")


@pytest.mark.parametrize("body,line", [
    ("    new_p, new_o = spec.fn(p, o, batches[0])\n"
     "    return p.sum()\n", 7),
    ("    for b in batches:\n"
     "        total = p.sum()\n"
     "        new = spec.fn(p, o, b)\n", 7)])
def test_donated_read(tmp_path, body, line):
    doc = lint(tmp_path, {"mod.py": _DONATE.format(body=body)})
    assert rules_of(doc) == ["donated-read"]
    assert lines_of(doc, "donated-read") == [line]


@pytest.mark.parametrize("body", [
    "    p, o = spec.fn(p, o, batches[0])\n    return p.sum()\n",
    "    for b in batches:\n        p, o = spec.fn(p, o, b)\n    return p\n",
    "    new = spec.fn(p, o, batches[0])\n    return batches, new\n"])
def test_reassigned_or_undonated_reads_are_clean(tmp_path, body):
    doc = lint(tmp_path, {"mod.py": _DONATE.format(body=body)})
    assert doc["findings"] == []


# -- the kernel contract ----------------------------------------------------------

def test_the_contract_fixture_is_clean(tmp_path):
    doc = lint(tmp_path, _LIB)
    assert doc["findings"] == []


def _without(rel, old, new=""):
    files = dict(_LIB)
    assert old in files[rel]
    files[rel] = files[rel].replace(old, new)
    return files


@pytest.mark.parametrize("files,want", [
    # no plain version: the cuda test cannot call it either
    (_without("src/repro_torch/hopper/ref.py", "scale_ref", "other_ref"),
     [("kernel-exact", "ops.py"), ("kernel-oracle", "ops.py")]),
    (_without("src/repro_torch/hopper/ops.py",
              "    LAUNCHES['scale'] += 1\n"), [("kernel-wrapper", "ops.py")]),
    (_without("src/repro_torch/hopper/ops.py",
              "    if x.device.type == 'meta':\n        return out\n"),
     [("kernel-wrapper", "ops.py")]),
    # bound under another name: the extern unbound, the row undefined
    # and launched by nothing
    (_without("src/repro_torch/hopper/build.py", "scale_launch",
              "scale2_launch"),
     [("kernel-wrapper", "build.py"), ("kernel-wrapper", "build.py"),
      ("kernel-wrapper", "scale.cu")]),
    # the wrapper launches a name the library does not have
    (_without("src/repro_torch/hopper/ops.py", "scale_launch",
              "scale2_launch"),
     [("kernel-wrapper", "build.py"), ("kernel-wrapper", "ops.py")]),
    (_without("tests/test_torch_hopper.py", "jops.scale(x)", "x"),
     [("kernel-test", "ops.py")]),
    (_without("tests/test_torch_hopper_cuda.py", "@pytest.mark.cuda\n"),
     [("kernel-exact", "ops.py")]),
    (_without("tests/test_torch_hopper_cuda.py", "torch.equal",
              "torch.allclose"), [("kernel-exact", "ops.py")]),
    (dict(_LIB, **{"src/repro_torch/core/raw.py": (
        "from repro_torch.hopper import build\n"
        "def raw(x):\n"
        "    lib = build.load()\n"
        "    return lib.scale_launch(x, x, 1)\n")}),
     [("kernel-outside-ops", "raw.py")]),
])
def test_kernel_contract_findings(tmp_path, files, want):
    doc = lint(tmp_path, files)
    got = sorted((f["rule"], os.path.basename(f["path"]))
                 for f in doc["findings"])
    assert got == want, doc


_GUARDED = "    with _on(x.device):\n        err = build.load()"


@pytest.mark.parametrize("guard,want", [
    # no guard at all, or a with of something else: the launch would run
    # on the current device
    (None, [("kernel-device", 8)]),
    ("    with torch.no_grad():\n        err = build.load()",
     [("kernel-device", 8)]),
    # the guard's own call, in place of the module's helper
    ("    with torch.cuda.device(x.device):\n        err = build.load()",
     []),
])
def test_kernel_device_guard(tmp_path, guard, want):
    """A launch in hopper/ops.py must lie inside a ``with`` of the
    module's device guard (the fixture's ``_on``) or of
    ``torch.cuda.device`` itself."""
    files = _without("src/repro_torch/hopper/ops.py", _GUARDED,
                     guard or "    if True:\n        err = build.load()")
    doc = lint(tmp_path, files)
    assert [(f["rule"], f["line"]) for f in doc["findings"]] == want, doc
    assert all(os.path.basename(f["path"]) == "ops.py"
               for f in doc["findings"])


def test_an_unreached_entry_is_a_kernel_wrapper_finding(tmp_path):
    """An extern bound in _SIGNATURES that no wrapper launches, reported
    at its _SIGNATURES row (where a suppression could go)."""
    files = dict(_LIB)
    files["src/repro_torch/hopper/build.py"] = (
        "_SIGNATURES = {'scale_launch': (1, 2, 3),\n"
        "               'old_launch': (1,)}\n"
        "def load():\n"
        "    return None\n")
    files["src/repro_torch/hopper/csrc/old.cu"] = (
        'extern "C" int old_launch(int n) { return 0; }\n')
    doc = lint(tmp_path, files)
    assert [(f["rule"], f["line"]) for f in doc["findings"]] == [
        ("kernel-wrapper", 2)]
    assert "old_launch" in doc["findings"][0]["message"]


# -- cache-version, parse-error --------------------------------------------------

_STORE = (
    "class Store:\n"
    "    def bad(self, rows, vals):\n"
    "        self.centroids[rows] = vals\n"
    "    def good(self, rows, vals):\n"
    "        self.centroids[rows] = vals\n"
    "        self.versions[rows] += 1\n")


def test_cache_version(tmp_path):
    doc = lint(tmp_path, {"store.py": _STORE})
    assert rules_of(doc) == ["cache-version"]
    assert lines_of(doc, "cache-version") == [3]


def test_cache_version_bumped_is_clean(tmp_path):
    doc = lint(tmp_path, {"store.py": _STORE.replace(
        "        self.centroids[rows] = vals\n    def good",
        "        self.versions[rows] += 1\n    def good")})
    assert doc["findings"] == []


def test_parse_error(tmp_path):
    doc = lint(tmp_path, {"bad.py": "def f(:\n", "ok.py": "x = 1\n"})
    assert [(f["rule"], f["path"][-6:]) for f in doc["findings"]] == [
        ("parse-error", "bad.py")]


# -- suppressions -------------------------------------------------------------------

@pytest.mark.parametrize("body,n_sup", [
    ("    return y.cpu()  # focuslint: disable=host-sync -- fixture\n", 1),
    ("    # focuslint: disable=host-sync -- fixture\n    return y.cpu()\n",
     1),
    ("    # focuslint: disable=host-sync -- fixture, and its\n"
     "    # wrapped justification\n    return y.cpu()\n", 1),
])
def test_suppressed_finding(tmp_path, body, n_sup):
    doc = lint(tmp_path, _hot(body))
    assert doc["findings"] == []
    assert doc["n_suppressed"] == n_sup
    assert doc["suppressed"][0]["justification"].startswith("fixture")


def test_def_line_and_file_suppressions(tmp_path):
    files = _hot("    return y.cpu(), int(y.sum())\n")
    src = files["src/repro_torch/core/hot.py"]
    on_def = src.replace("def hot(a, dev, meta, ev):",
                         "def hot(a, dev, meta, ev):  "
                         "# focuslint: disable=host-sync -- whole fn")
    doc = lint(tmp_path, dict(files, **{"src/repro_torch/core/hot.py":
                                        on_def}))
    assert doc["findings"] == [] and doc["n_suppressed"] == 2
    whole = "# focuslint: disable-file=host-sync -- fixture file\n" + src
    doc = lint(tmp_path, dict(files, **{"src/repro_torch/core/hot.py":
                                        whole}))
    assert doc["findings"] == [] and doc["n_suppressed"] == 2


def test_bare_suppression_is_itself_a_finding(tmp_path):
    doc = lint(tmp_path, _hot(
        "    return y.cpu()  # focuslint: disable=host-sync\n"))
    assert rules_of(doc) == ["bare-suppression"]
    assert doc["n_suppressed"] == 1


def test_select_filters_rules(tmp_path):
    doc = lint(tmp_path, dict(_hot("    return y.cpu()\n"),
                              **{"store.py": _STORE}),
               select=["cache-version"])
    assert rules_of(doc) == ["cache-version"]


# -- the CLI -------------------------------------------------------------------------

def _cli(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(list(argv))
    return rc, out.getvalue()


def test_cli_exit_codes(tmp_path):
    _write(tmp_path / "clean", {"ok.py": "x = 1\n"})
    _write(tmp_path / "dirty", {"store.py": _STORE})
    rc, text = _cli(str(tmp_path / "clean"))
    assert rc == 0 and "0 finding(s)" in text
    rc, text = _cli("--format", "json", str(tmp_path / "dirty"))
    assert rc == 1 and json.loads(text)["n_findings"] == 1
    rc, _ = _cli("--select", "cache-version", str(tmp_path / "clean"))
    assert rc == 0
    assert _cli("--select", "no-such-rule", str(tmp_path / "clean"))[0] == 2
    assert _cli("--select", "retrace-hazard", str(tmp_path / "clean"))[0] \
        == 2
    with pytest.raises(SystemExit) as e:
        _cli("--format", "xml")
    assert e.value.code == 2
    out = tmp_path / "report.txt"
    rc, text = _cli("-o", str(out), "--show-suppressed",
                    str(tmp_path / "dirty"))
    assert rc == 1 and text == "" and "[cache-version]" in out.read_text()


def test_list_rules_has_no_retrace_hazard():
    rc, text = _cli("--list-rules")
    listed = [line.split()[0] for line in text.splitlines()]
    assert rc == 0 and listed == sorted(RULES)
    assert "retrace-hazard" not in listed
    assert cli.build_parser().parse_args([]).paths == [
        "src/repro_torch", "chip_smoke.py", "tests"]


# -- against the JAX package's linter on the shared rules -------------------------

_SHARED = ["cache-version", "bare-suppression", "parse-error"]


@pytest.mark.parametrize("files", [
    {"store.py": _STORE},
    {"store.py": _STORE.replace(
        "    def bad(self, rows, vals):",
        "    def bad(self, rows, vals):  # focuslint: disable=cache-version\n"
        "        pass\n    def worse(self, rows, vals):")},
    {"store.py": "# focuslint: disable-file=cache-version -- fixture\n"
                 + _STORE},
    {"bad.py": "def f(:\n", "store.py": _STORE},
])
def test_shared_rules_match_the_jax_linter(tmp_path, files):
    def key(doc):
        return sorted((f["rule"], os.path.relpath(f["path"], tmp_path),
                       f["line"], f["message"]) for f in doc["findings"])

    got = lint(tmp_path, files, select=_SHARED)
    want = lint(tmp_path, files, run=jax_run_analysis, select=_SHARED)
    assert key(got) == key(want)
    assert got["n_suppressed"] == want["n_suppressed"]
    assert key(got) or got["n_suppressed"]


# -- the tree ----------------------------------------------------------------------

# every suppressed finding of src/repro_torch: (path, rule, message); a new
# deliberate sync or exemption is added here with its suppression, a
# vanished one taken out
PINNED = collections.Counter([
    ("src/repro_torch/core/archive.py", "host-sync",
     ".cpu() of a device tensor in hot-path function '_rank_ids' -- a "
     "blocking copy to the host"),
    ("src/repro_torch/core/archive.py", "host-sync",
     ".tolist() in hot-path function 'lookup' -- blocks until the card's "
     "result lands"),
    ("src/repro_torch/core/clustering.py", "host-sync",
     ".cpu() of a device tensor in hot-path function 'cluster_batched' -- a "
     "blocking copy to the host"),
] + [("src/repro_torch/core/clustering.py", "host-sync",
      ".cpu() of a device tensor in hot-path function 'cluster_fused' -- a "
      "blocking copy to the host")] * 2 + [
    ("src/repro_torch/core/index.py", "cache-version",
     "'attach' mutates self.{counts} in place without bumping "
     "self.versions — the (cid, version) GT-label cache will serve stale "
     "labels"),
] + [("src/repro_torch/core/pipeline.py", "host-sync",
      ".cpu() of a device tensor in hot-path function 'apply' -- a "
      "blocking copy to the host")] * 2 + [
    ("src/repro_torch/core/pipeline.py", "host-sync",
     "rec.ready.synchronize() in hot-path function '_resolve' -- waits for "
     "the card"),
    ("src/repro_torch/core/pipeline.py", "host-sync",
     "int() of a device tensor in hot-path function '_resolve' -- an "
     "implicit blocking transfer"),
    ("src/repro_torch/core/pipeline.py", "host-sync",
     "rec.ready.synchronize() in hot-path function '_fold' -- waits for the "
     "card"),
] + [("src/repro_torch/core/pipeline.py", "host-sync",
      "st.ready.synchronize() in hot-path function 'pump_one' -- waits for "
      "the card")] * 2 + [
    ("src/repro_torch/data/bgsub.py", "host-sync",
     ".cpu() of a device tensor in hot-path function 'match_flat' -- a "
     "blocking copy to the host"),
    ("src/repro_torch/data/bgsub.py", "host-sync",
     ".cpu() of a device tensor in hot-path function 'match_ranges' -- a "
     "blocking copy to the host"),
    ("src/repro_torch/data/bgsub.py", "host-sync",
     ".cpu() of a device tensor in hot-path function '_step' -- a blocking "
     "copy to the host"),
    ("src/repro_torch/data/bgsub.py", "host-sync",
     ".cpu() of a device tensor in hot-path function '_steps' -- a blocking "
     "copy to the host"),
    ("src/repro_torch/hopper/ops.py", "kernel-exact",
     "no cuda test in tests/test_torch_hopper_cuda.py compares "
     "ops.flash_attention with ref.flash_attention_ref exactly "
     "(assert_array_equal or torch.equal)"),
])


@pytest.fixture(scope="module")
def tree():
    """One run over the default paths, from the repository's root."""
    cwd = os.getcwd()
    os.chdir(REPO_ROOT)
    try:
        report = run_analysis(cli.DEFAULT_PATHS)
    finally:
        os.chdir(cwd)
    return json.loads(report.to_json(show_suppressed=True))


def test_port_is_clean(tree):
    assert tree["findings"] == [], json.dumps(tree["findings"], indent=1)
    port = collections.Counter(
        (f["path"].replace(os.sep, "/"), f["rule"], f["message"])
        for f in tree["suppressed"] if f["path"].startswith("src"))
    assert port == PINNED, (sorted(port - PINNED), sorted(PINNED - port))
    assert all(f["justification"] for f in tree["suppressed"])
    # the measurement script's syncs are one file-wide suppression
    smoke = {f["justification"] for f in tree["suppressed"]
             if f["path"] == "chip_smoke.py"}
    assert len(smoke) == 1 and "measurement script" in smoke.pop()


def test_the_tree_covers_the_port(tree):
    assert tree["n_files"] > 100 and tree["n_functions"] > 1500
