"""Rule registry: rule id -> one-line description (``--list-rules``).

The ids are the JAX package's where the rule has a counterpart there
(``kernel-outside-ops`` is the counterpart of ``pallas-outside-kernels``).
``retrace-hazard`` has none: the port has no JIT and no trace cache."""

RULES = {
    "host-sync": (
        "host/device sync (.item(), .tolist(), .cpu(), .numpy(), "
        "int()/float()/bool() of a tensor, torch.cuda.synchronize(), an "
        "event's or stream's .synchronize()) in a function reachable from "
        "a built step's fn, or on a device tensor in a function that "
        "reaches a Hopper kernel launch"),
    "donated-read": (
        "read of an argument after a built step (StepSpec(..., "
        "donate_argnums=...)) updated it in place, in the same scope"),
    "kernel-oracle": (
        "hopper/ops.py kernel wrapper without a plain version *_ref in "
        "hopper/ref.py"),
    "kernel-wrapper": (
        "kernel entry not bound, or reached by no hopper/ops.py wrapper; "
        "or a wrapper that does not count LAUNCHES or tell meta tensors "
        "from the card's"),
    "kernel-test": (
        "kernel wrapper never called beside a repro.kernels function in "
        "tests/test_torch_hopper.py"),
    "kernel-exact": (
        "kernel wrapper without a cuda test comparing it exactly "
        "(assert_array_equal / torch.equal) with its plain version"),
    "kernel-outside-ops": (
        "kernel launch on the loaded library outside hopper/ops.py"),
    "kernel-device": (
        "kernel launch in hopper/ops.py outside a 'with' of the module's "
        "device guard (a function returning torch.cuda.device(...))"),
    "cache-version": (
        "ClusterStore-style method mutates a centroid/prob/count column "
        "without bumping .versions — rots the (cid, version) GT-label "
        "cache key"),
    "bare-suppression": (
        "focuslint suppression without a '-- justification'"),
    "parse-error": "file failed to parse",
}
