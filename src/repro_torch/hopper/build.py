"""Build and load the Hopper kernels: ``nvcc`` into one shared library with
a plain C interface, bound with ``ctypes``.

The library is built at first use into ``build/hopper/`` at the root of
the checkout and named by a hash of the sources and the flags, so an edit
to any ``csrc/*.cu`` or ``csrc/*.cuh`` file rebuilds it and a stale
library is never loaded. Each source compiles to an object in its own
``nvcc`` process, all started together, and one more ``nvcc`` links them
(the ``.cuh`` headers are included, not compiled). Nothing here runs
at import time: the CPU tests import this module without a toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "hopper"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: every pointer and the stream as void*, ints as int
_SIGNATURES = {
    "centroid_assign_launch": (_vp, _vp, _vp, _vp, _vp, _vp, _int, _int,
                               _int, _float, _vp),
    "centroid_assign_stacked_launch": (_vp, _vp, _vp, _vp, _vp, _vp, _int,
                                       _int, _int, _int, _float, _vp),
    "centroid_assign_blocks": (_int, _int),
    "pixel_match_launch": (_vp, _vp, _vp, _vp, _vp, _vp, _vp, _int, _int,
                           _int, _int, _float, _vp),
    "dequant_topk_launch": (_vp, _int, _vp, _float, _vp, _vp, _int, _int,
                            _int, _vp),
    "topk_launch": (_vp, _vp, _vp, _int, _int, _int, _vp),
    "motion_gate_launch": (_vp, _vp, _vp, _vp, _vp, _int, _int, _int,
                           _int, _float, _float, _vp),
    "flash_attention_launch": (_vp, _vp, _vp, _vp, _int, _int, _int, _int,
                               _int, _int, _float, _vp),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None     # wall time of this process's build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the Hopper kernels are built with the "
                       "CUDA toolkit on the machine that has the card")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def _compile(target: Path):
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in _sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                  for src, obj in zip(_sources(), objs)])
        tmp_lib = Path(tmp) / target.name
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                   "-o", str(tmp_lib)]])
        os.replace(tmp_lib, target)         # atomic: never a half-written .so


def load() -> ctypes.CDLL:
    """The kernel library, built on first use (or when a source changed)."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        target = BUILD_DIR / f"libhopper_{_digest()}.so"
        if not target.exists():
            t0 = time.perf_counter()
            _compile(target)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib
