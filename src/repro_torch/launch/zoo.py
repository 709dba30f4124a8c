"""The cheap-CNN model zoo of the serve path (paper §4.1, §4.3, §4.4).

The JAX package keeps its zoo in ``benchmarks/common.py``, outside the
package; the port keeps its own copy here.

Cost model:
  * GT-CNN = vit-l16 classifying an object crop at its native 224 px,
    ``2 * n_params * n_tokens`` FLOPs per object (``GT_FLOPS``).
  * The cheap ingest CNNs are physically small convnets (the streams'
    objects are 32 px synthetic crops), but their ACCOUNTED cost is that of
    the compression family the paper used (ResNet18 with layers removed /
    inputs rescaled): GT/8, GT/30, GT/98 for the generic family and GT/20,
    GT/50, GT/98 for the specialized one (§6.3: specialized models are
    7x-71x cheaper than GT-CNN).

``get_model`` trains a family member on a stream's crops, or loads it from
its cache: ``experiments/torch_cache/`` at the root of the checkout, one
``.npz`` of JAX-layout parameters (``cnn.save_npz_params``) and one
``.json`` with the config and the class map per (stream, model, duration,
Ls, steps, objects, ``INIT_VERSION``). The JAX package's pickled cache is
never read: its pickles name classes of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np

from repro_torch.common.config import CheapCNNConfig
from repro_torch.common.device import DeviceLike
from repro_torch.core.index import ClassMap
from repro_torch.core.specialize import (SpecializedModel, specialize,
                                         train_generic)
from repro_torch.models import cnn

CACHE_DIR = Path(__file__).resolve().parents[3] / "experiments" / "torch_cache"
# How the initial weights were drawn, part of every cache key: 2 is JAX's
# threefry draw (``common.prng``); 1, numpy's ``default_rng``, trained other
# models from the same seed, and its entries are never served again.
INIT_VERSION = 2

# GT-CNN: vit-l16 @ 224, 2 * n_params * n_tokens forward FLOPs per object
# crop (the JAX package derives it from its vit-l16 config; the tests hold
# the two equal)
GT_FLOPS = 119817143056.0

# (config, accounted-cost divisor vs GT) — paper's compression family
GENERIC_FAMILY = {
    "cheap1": (CheapCNNConfig("cheap1", input_res=32, n_blocks=6, width=48,
                              n_classes=1000, feature_dim=128), 8.0),
    "cheap2": (CheapCNNConfig("cheap2", input_res=32, n_blocks=4, width=32,
                              n_classes=1000, feature_dim=128), 30.0),
    "cheap3": (CheapCNNConfig("cheap3", input_res=16, n_blocks=3, width=24,
                              n_classes=1000, feature_dim=128), 98.0),
}
SPECIALIZED_FAMILY = {
    "spec1": (CheapCNNConfig("spec1", input_res=32, n_blocks=4, width=32,
                             feature_dim=128), 20.0),
    "spec2": (CheapCNNConfig("spec2", input_res=16, n_blocks=3, width=24,
                             feature_dim=128), 50.0),
    "spec3": (CheapCNNConfig("spec3", input_res=16, n_blocks=2, width=16,
                             feature_dim=128), 98.0),
}
DEFAULT_LS = 8


def cache_prefix(stream: str, model_id: str, duration_s: int, steps: int,
                 Ls: int, n_objects: int,
                 cache_dir: Optional[Path] = None) -> Path:
    """Where ``get_model`` keeps one trained model (without suffix)."""
    root = Path(cache_dir if cache_dir is not None else CACHE_DIR)
    return root / (f"{stream}_{model_id}_{duration_s}s_ls{Ls}_"
                   f"steps{steps}_n{n_objects}_init{INIT_VERSION}")


def save_model(sm: SpecializedModel, prefix: Path):
    """Write ``sm`` as ``prefix.npz`` + ``prefix.json``, each atomically."""
    prefix.parent.mkdir(parents=True, exist_ok=True)
    tmp = prefix.with_name(f"{prefix.name}.tmp{os.getpid()}")
    cnn.save_npz_params(sm.params, f"{tmp}.npz")
    meta = {"config": dataclasses.asdict(sm.cfg),
            "class_map": (sm.class_map.global_ids.tolist()
                          if sm.class_map is not None else None)}
    with open(f"{tmp}.json", "w") as f:
        json.dump(meta, f)
    os.replace(f"{tmp}.npz", f"{prefix}.npz")
    os.replace(f"{tmp}.json", f"{prefix}.json")


def load_model(prefix: Path) -> SpecializedModel:
    with open(f"{prefix}.json") as f:
        meta = json.load(f)
    ids = meta["class_map"]
    return SpecializedModel(cnn.load_npz_params(f"{prefix}.npz"),
                            CheapCNNConfig(**meta["config"]),
                            ClassMap(np.array(ids)) if ids is not None
                            else None, [])


def get_model(stream_name: str, model_id: str, crops: np.ndarray,
              labels: np.ndarray, duration_s: int = 90, steps: int = 200,
              Ls: int = DEFAULT_LS, device: DeviceLike = "cuda",
              cache_dir: Optional[Path] = None,
              ) -> Tuple[Callable, float, Optional[ClassMap]]:
    """Returns ``(apply_fn, accounted_flops_per_image, class_map or None)``.

    ``apply_fn(crops numpy) -> (probs, feats)`` numpy runs on ``device``
    and resizes the crops to the model's input first. It also carries
    ``forward`` (the same on tensors, a replicable ``cnn.CheapForward``
    for an ``IngestPipeline`` or a ``ShardedIngestPipeline``),
    ``input_res``, ``history`` (the training log; empty when loaded from
    the cache) and ``train_s`` (training wall time, None when loaded)."""
    specialized = model_id in SPECIALIZED_FAMILY
    cfg, divisor = (SPECIALIZED_FAMILY if specialized
                    else GENERIC_FAMILY)[model_id]
    prefix = cache_prefix(stream_name, model_id, duration_s, steps, Ls,
                          len(crops), cache_dir)
    train_s = None
    if os.path.exists(f"{prefix}.json") and os.path.exists(f"{prefix}.npz"):
        sm = load_model(prefix)
    else:
        crops_r = cnn.resize_nearest(crops, cfg.input_res)
        t0 = time.perf_counter()
        if specialized:
            sm = specialize(crops_r, labels, Ls=Ls, base_cfg=cfg,
                            steps=steps, device=device)
        else:
            sm = train_generic(crops_r, labels, base_cfg=cfg, steps=steps,
                               device=device)
        # params_to_jax read the weights back: the card has finished
        train_s = time.perf_counter() - t0
        save_model(sm, prefix)

    model = sm.build(device)
    inner = cnn.make_apply(model)

    def apply_fn(batch):
        return inner(cnn.resize_nearest(batch, cfg.input_res))

    apply_fn.forward = cnn.make_forward(model, cfg.input_res)
    apply_fn.input_res = cfg.input_res
    apply_fn.history = sm.history
    apply_fn.train_s = train_s
    return apply_fn, GT_FLOPS / divisor, sm.class_map
