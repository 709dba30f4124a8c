"""Video-specific CNN specialization (paper §4.3).

Periodically sample the stream, classify the sample with GT-CNN to estimate
the class distribution, pick the Ls most frequent classes, and retrain a
cheap CNN on (Ls + OTHER) with the training data re-weighted so OTHER does
not dominate (paper footnote 2). Specialized models are smaller and more
accurate on their stream, which lets Focus use a much smaller K.

A port of ``repro.core.specialize``: the class map, the equal-class weights,
the batch indices (``numpy.random.default_rng(seed)``) and the initial
weights (``cnn.init_params(cfg, seed)``, JAX's threefry draw through
``common.prng``) are the reference's, so both packages train the same
model from one seed; ``init=`` still hands in any JAX-layout tree.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.config import CheapCNNConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core.index import ClassMap
from repro_torch.models import cnn
from repro_torch.train import OptConfig, TrainConfig, train


@dataclass
class SpecializedModel:
    params: dict                    # JAX-layout tree of numpy arrays
    cfg: CheapCNNConfig
    class_map: Optional[ClassMap]
    history: list

    def build(self, device: DeviceLike = "cuda") -> cnn.CheapCNN:
        return cnn.build(self.cfg, self.params, device)

    def make_apply(self, batch_pad: int = 64, device: DeviceLike = "cuda"):
        """``apply(crops numpy) -> (probs (B, Ls+1), feats (B, D))`` as
        numpy on ``device``, with ragged batches padded to a multiple of
        ``batch_pad`` (``cnn.make_apply``): the staged ingest path."""
        return cnn.make_apply(self.build(device), batch_pad)

    def make_forward(self, device: DeviceLike = "cuda") -> Callable:
        """The tensor-level forward ``crops -> (probs, feats)`` that a fused
        ``IngestPipeline`` runs in its megastep (the reference's
        ``make_traceable``)."""
        return cnn.make_forward(self.build(device))


def estimate_distribution(gt_labels: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """(classes, counts) sorted by decreasing frequency."""
    vals, counts = np.unique(gt_labels, return_counts=True)
    order = np.argsort(-counts)
    return vals[order], counts[order]


def _fit(sample_crops: np.ndarray, labels: np.ndarray, cfg: CheapCNNConfig,
         steps: int, batch_size: int, lr: float, seed: int,
         init: Optional[dict], device: DeviceLike,
         label_weights: Optional[np.ndarray] = None):
    """Train ``cfg`` on (crops, int labels); returns (JAX-layout tree,
    history)."""
    dev = resolve_device(device)
    tree = init if init is not None else cnn.init_params(cfg, seed)
    model = cnn.build(cfg, tree, dev)
    weights = (torch.tensor(label_weights, dtype=torch.float32, device=dev)
               if label_weights is not None else None)

    def loss_fn(model, batch):
        return cnn.loss_fn(model, batch["x"], batch["y"],
                           label_weights=weights)

    def data_iter():
        r = np.random.default_rng(seed)
        n = len(sample_crops)
        while True:
            idx = r.integers(0, n, size=batch_size)
            yield {"x": torch.from_numpy(
                       np.ascontiguousarray(sample_crops[idx], np.float32)
                   ).to(dev),
                   "y": torch.from_numpy(labels[idx]).to(dev)}

    opt_cfg = OptConfig(lr=lr, warmup_steps=min(50, steps // 5),
                        total_steps=steps, weight_decay=1e-4)
    model, history = train(loss_fn, model, data_iter(), opt_cfg,
                           TrainConfig(steps=steps,
                                       log_every=max(steps // 4, 1)))
    return cnn.params_to_jax(model), history


def specialize(sample_crops: np.ndarray, sample_gt_labels: np.ndarray,
               Ls: int, base_cfg: CheapCNNConfig, steps: int = 300,
               batch_size: int = 128, lr: float = 3e-3, seed: int = 0,
               init: Optional[dict] = None, device: DeviceLike = "cuda",
               ) -> SpecializedModel:
    """Retrain ``base_cfg`` on the stream's top-Ls classes + OTHER, on
    ``device``. ``init`` (a JAX-layout tree for the specialized config)
    replaces the seeded initial weights."""
    classes, _ = estimate_distribution(sample_gt_labels)
    keep = np.sort(classes[:Ls])
    cmap = ClassMap(global_ids=keep)

    local = np.full(len(sample_gt_labels), cmap.other_local, np.int32)
    for li, g in enumerate(keep):
        local[sample_gt_labels == g] = li

    # equal-class re-weighting (paper footnote 2). ``Ls`` may exceed the
    # number of observed classes (keep is then just the observed set) and a
    # sample may contain a single class — the normalizer below must stay
    # finite in both cases, so guard the empty-positive edge.
    counts = np.bincount(local, minlength=cmap.n_local).astype(np.float64)
    w = np.where(counts > 0, counts.sum() / np.maximum(counts, 1), 0.0)
    pos = counts > 0
    w = w / w[pos].mean() if pos.any() else np.ones_like(w)

    cfg = dataclasses.replace(base_cfg,
                              name=f"{base_cfg.name}-spec{Ls}",
                              n_classes=cmap.n_local)
    params, history = _fit(sample_crops, local, cfg, steps, batch_size, lr,
                           seed, init, device, label_weights=w)
    return SpecializedModel(params, cfg, cmap, history)


def train_generic(sample_crops: np.ndarray, sample_gt_labels: np.ndarray,
                  base_cfg: CheapCNNConfig, steps: int = 300,
                  batch_size: int = 128, lr: float = 3e-3, seed: int = 0,
                  device: DeviceLike = "cuda") -> SpecializedModel:
    """Train a *generic* (non-specialized) cheap CNN over the full global
    class space — the "Compressed model" rung of Fig. 8."""
    params, history = _fit(sample_crops,
                           np.asarray(sample_gt_labels).astype(np.int32),
                           base_cfg, steps, batch_size, lr, seed, None,
                           device)
    return SpecializedModel(params, base_cfg, None, history)
