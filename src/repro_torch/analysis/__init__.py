"""focuslint for the PyTorch/CUDA port: static invariant checks of its
hot paths, the counterpart of the JAX package's ``repro.analysis``.

The port's cost and correctness claims rest on the same discipline as
the JAX package's, in the port's own forms: no stray host syncs inside a
built step or the kernel dispatch loop, no reads of a step argument
after the step updated it in place, every Hopper kernel held to a plain
version, every centroid/prob mutation bumping the ``(cid, version)``
cache key. A lightweight AST pass enforces them at review time (nothing
of the checked code is imported or run; the package imports only the
standard library):

* ``host-sync`` -- syncs in functions reachable from a built step's
  ``fn`` (``launch/steps.py``), and on device tensors in functions that
  reach a kernel launch (``rules/host_sync.py``);
* ``donated-read`` -- reads of an argument a built step updated in place
  (its ``donate_argnums``);
* ``kernel-*`` / ``kernel-outside-ops`` -- the kernel contract: each
  ``extern "C"`` launch in ``hopper/csrc`` bound in ``hopper/build.py``
  and reached by a ``hopper/ops.py`` wrapper that counts its launches
  and takes meta tensors, a plain version in ``hopper/ref.py``, a CPU
  test against ``repro.kernels`` and an exact ``cuda`` test;
* ``cache-version`` -- ClusterStore mutations must bump ``versions``.

The JAX package's ``retrace-hazard`` has no counterpart: the port has no
JIT and no trace cache, and no path uses ``torch.compile`` or a CUDA
graph, so a data-dependent Python value costs no recompile.

CLI: ``python -m repro_torch.analysis [paths...]`` (default
``src/repro_torch chip_smoke.py tests``) -- see ``--help``. Suppress a
finding inline with
``# focuslint: disable=<rule>[,<rule>] -- <justification>``, the JAX
package's syntax, so that one comment serves both linters.
"""
from repro_torch.analysis.report import Finding
from repro_torch.analysis.runner import run_analysis

__all__ = ["Finding", "run_analysis"]
