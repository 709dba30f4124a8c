"""Focus cheap ingest-CNN family (compressed classifiers, §4.1 of the paper).

A small conv classifier parameterized by (n_blocks, width, input_res,
n_classes) — the paper's two compression axes are "remove conv layers"
(n_blocks) and "rescale input" (input_res); specialization shrinks
n_classes to Ls+1 (§4.3). The penultimate ``feature_dim`` vector is the
clustering feature (§2.2.3).

The public layout is the JAX package's: images are NHWC and parameters
travel as the JAX tree (conv weights HWIO) through ``params_from_jax`` /
``params_to_jax``. Inside, the module works in NCHW with OIHW weights.
Convolutions and dense products stay ``F.conv2d`` / ``F.linear``: the JAX
package leaves them to XLA too, outside any kernel of its own.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common import prng
from repro_torch.common.config import CheapCNNConfig
from repro_torch.common.device import DeviceLike, resolve_device


def _plan(cfg: CheapCNNConfig) -> List[Tuple[int, int, int]]:
    """(c_in, c_out, stride) per conv block."""
    plan = []
    c_in = cfg.in_channels
    res = cfg.input_res
    for i in range(cfg.n_blocks):
        stride = 2 if (i % 2 == 0 and res > 4) else 1
        res = res // stride
        c_out = min(cfg.width * (2 ** (i // 2)), 4 * cfg.width)
        plan.append((c_in, c_out, stride))
        c_in = c_out
    return plan


def _same_pads(size: int, stride: int, k: int = 3) -> Tuple[int, int]:
    """XLA's SAME padding for one spatial axis: the output has
    ceil(size / stride) positions and the extra row goes at the END — with
    stride 2 on an even size that is (0, 1), not the symmetric (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class CheapCNN(nn.Module):
    """``forward(images (B, R, R, C) NHWC) -> (logits (B, n_classes),
    feats (B, feature_dim))``, both fp32."""

    def __init__(self, cfg: CheapCNNConfig):
        super().__init__()
        if cfg.dtype != "float32":
            raise ValueError(f"only float32 cheap CNNs are ported, got "
                             f"{cfg.dtype!r}")
        self.cfg = cfg
        self.plan = _plan(cfg)
        self.conv_w = nn.ParameterList(
            nn.Parameter(torch.empty(co, ci, 3, 3)) for ci, co, _ in self.plan)
        self.scale = nn.ParameterList(
            nn.Parameter(torch.ones(co)) for _, co, _ in self.plan)
        self.bias = nn.ParameterList(
            nn.Parameter(torch.zeros(co)) for _, co, _ in self.plan)
        c_last = self.plan[-1][1]
        self.feat = nn.Linear(c_last, cfg.feature_dim)
        self.head = nn.Linear(cfg.feature_dim, cfg.n_classes)

    def forward(self, images: torch.Tensor):
        x = images.float().permute(0, 3, 1, 2)              # NHWC -> NCHW
        for w, scale, bias, (_, _, s) in zip(self.conv_w, self.scale,
                                             self.bias, self.plan):
            ph = _same_pads(x.shape[2], s)
            pw = _same_pads(x.shape[3], s)
            x = F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w,
                         stride=s, padding=0)
            # cheap norm: per-channel RMS over the spatial axes + affine
            nu2 = (x * x).mean(dim=(2, 3), keepdim=True)
            x = x * torch.rsqrt(nu2 + 1e-6)
            x = torch.relu(x * scale[None, :, None, None]
                           + bias[None, :, None, None])
        x = x.mean(dim=(2, 3))                               # (B, C)
        feats = torch.tanh(self.feat(x))
        logits = self.head(feats)
        return logits, feats


def init_params(cfg: CheapCNNConfig, seed: int = 0,
                device: DeviceLike = "cpu") -> dict:
    """Random parameters as a JAX-layout tree of numpy arrays: the JAX
    package's ``cnn.init(jax.random.PRNGKey(seed), cfg)``, drawn through
    ``common.prng`` on ``device`` with its key splits, leaves and op order
    (conv: ``normal / sqrt(fan_in)``; dense: ``normal * (1 / sqrt(d_in))``;
    both in fp32). The card and the CPU draw the same bits."""
    dev = resolve_device(device)
    plan = _plan(cfg)
    ks = prng.split(prng.key(seed, dev), len(plan) + 2)

    def dense(k, d_in, d_out):
        return prng.normal(k, (d_in, d_out)) * (1.0 / math.sqrt(d_in))

    def host(t):
        return t.cpu().numpy()

    blocks = []
    for k, (ci, co, _) in zip(ks[:len(plan)], plan):
        fan_in = torch.tensor(math.sqrt(9 * ci), dtype=torch.float32,
                              device=dev)
        blocks.append({"conv": {"w": host(prng.normal(k, (3, 3, ci, co))
                                          / fan_in)},
                       "scale": np.ones((co,), np.float32),
                       "bias": np.zeros((co,), np.float32)})
    c_last = plan[-1][1]
    d = cfg.feature_dim
    return {
        "blocks": blocks,
        "feat": {"w": host(dense(ks[-2], c_last, d)),
                 "b": np.zeros((d,), np.float32)},
        "head": {"w": host(dense(ks[-1], d, cfg.n_classes)),
                 "b": np.zeros((cfg.n_classes,), np.float32)},
    }


def params_from_jax(model: CheapCNN, tree: dict) -> CheapCNN:
    """Load a JAX parameter tree (numpy arrays, as ``cnn.init`` lays it out
    and the benchmarks pickle it) into ``model``: conv weights HWIO ->
    OIHW, dense weights (in, out) -> ``nn.Linear``'s (out, in)."""
    blocks = tree["blocks"]
    if len(blocks) != len(model.plan):
        raise ValueError(f"tree has {len(blocks)} blocks, model has "
                         f"{len(model.plan)}")

    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    with torch.no_grad():
        for i, p in enumerate(blocks):
            model.conv_w[i].copy_(t(p["conv"]["w"]).permute(3, 2, 0, 1))
            model.scale[i].copy_(t(p["scale"]))
            model.bias[i].copy_(t(p["bias"]))
        model.feat.weight.copy_(t(tree["feat"]["w"]).T)
        model.feat.bias.copy_(t(tree["feat"]["b"]))
        model.head.weight.copy_(t(tree["head"]["w"]).T)
        model.head.bias.copy_(t(tree["head"]["b"]))
    return model


def params_to_jax(model: CheapCNN) -> dict:
    """Inverse of ``params_from_jax``: the JAX-layout tree of numpy arrays."""
    def n(x):
        return x.detach().cpu().numpy().astype(np.float32)

    return {
        "blocks": [{"conv": {"w": np.ascontiguousarray(
                        n(w).transpose(2, 3, 1, 0))},
                    "scale": n(s), "bias": n(b)}
                   for w, s, b in zip(model.conv_w, model.scale, model.bias)],
        "feat": {"w": np.ascontiguousarray(n(model.feat.weight).T),
                 "b": n(model.feat.bias)},
        "head": {"w": np.ascontiguousarray(n(model.head.weight).T),
                 "b": n(model.head.bias)},
    }


def load_npz_params(path: str) -> dict:
    """A JAX-layout parameter tree saved as numpy in one ``.npz`` whose
    keys are the tree paths joined by '/' (``blocks/0/conv/w``,
    ``feat/b``, ...), as ``save_npz_params`` writes it."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    n_blocks = 1 + max(int(k.split("/")[1]) for k in flat
                       if k.startswith("blocks/"))
    return {
        "blocks": [{"conv": {"w": flat[f"blocks/{i}/conv/w"]},
                    "scale": flat[f"blocks/{i}/scale"],
                    "bias": flat[f"blocks/{i}/bias"]}
                   for i in range(n_blocks)],
        "feat": {"w": flat["feat/w"], "b": flat["feat/b"]},
        "head": {"w": flat["head/w"], "b": flat["head/b"]},
    }


def save_npz_params(tree: dict, path: str):
    """Inverse of ``load_npz_params``."""
    flat = {}
    for i, p in enumerate(tree["blocks"]):
        flat[f"blocks/{i}/conv/w"] = np.asarray(p["conv"]["w"], np.float32)
        flat[f"blocks/{i}/scale"] = np.asarray(p["scale"], np.float32)
        flat[f"blocks/{i}/bias"] = np.asarray(p["bias"], np.float32)
    for name in ("feat", "head"):
        for leaf in ("w", "b"):
            flat[f"{name}/{leaf}"] = np.asarray(tree[name][leaf], np.float32)
    np.savez(path, **flat)


def build(cfg: CheapCNNConfig, tree: dict,
          device: DeviceLike = "cuda") -> CheapCNN:
    """An eval-mode ``CheapCNN`` on ``device`` holding the parameters of
    ``tree`` (JAX layout)."""
    dev = resolve_device(device)
    return params_from_jax(CheapCNN(cfg), tree).to(dev).eval()


def resize_nearest(crops, res: int):
    """Nearest-neighbour resize of (N, R, R, 3) crops to (N, res, res, 3);
    numpy arrays and tensors alike."""
    if crops.shape[1] == res:
        return crops
    idx = np.arange(res) * crops.shape[1] // res
    if isinstance(crops, torch.Tensor):
        idx = torch.from_numpy(idx).to(crops.device)
    return crops[:, idx][:, :, idx]


class CheapForward(nn.Module):
    """``forward(crops (B, R, R, 3) f32 tensor on the model's device) ->
    (softmax probs (B, n_classes), feats (B, feature_dim))``, both on that
    device and without a host copy: the tensor-level forward the fused
    ingest pipelines run (the JAX package's traceable ``cheap_fn``). With
    ``input_res`` the crops are first resized to it (``resize_nearest``).

    A module, so that it can be replicated: ``copy.deepcopy(f).to(device)
    .eval()`` is the same forward on another device, holding the same
    weight bytes in storage of its own (``ShardedIngestPipeline`` places
    one on each mesh block past the first)."""

    def __init__(self, model: CheapCNN, input_res: Optional[int] = None):
        super().__init__()
        self.model = model
        self.input_res = input_res

    def forward(self, crops: torch.Tensor):
        if self.input_res is not None:
            crops = resize_nearest(crops, self.input_res)
        with torch.no_grad():
            logits, feats = self.model(crops)
            return torch.softmax(logits, dim=-1), feats


def make_forward(model: CheapCNN,
                 input_res: Optional[int] = None) -> CheapForward:
    """The tensor-level forward of ``model`` (``CheapForward``), resizing
    its crops to ``input_res`` first when given."""
    return CheapForward(model, input_res)


def make_apply(model: CheapCNN, batch_pad: int = 64
               ) -> Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]:
    """``apply(crops (B, R, R, 3) numpy) -> (softmax probs (B, n_classes),
    feats (B, feature_dim))`` as numpy, on the model's device. Batches are
    zero-padded to a multiple of ``batch_pad`` (the JAX package's shape
    bucketing), so a ragged tail runs the same kernel shapes."""
    cfg = model.cfg
    dev = next(model.parameters()).device
    forward = make_forward(model)

    def apply(crops: np.ndarray):
        n = len(crops)
        if n == 0:
            return (np.zeros((0, cfg.n_classes), np.float32),
                    np.zeros((0, cfg.feature_dim), np.float32))
        pad = (-n) % batch_pad
        if pad:
            crops = np.concatenate(
                [crops, np.zeros((pad,) + crops.shape[1:], crops.dtype)])
        x = torch.from_numpy(np.ascontiguousarray(crops, np.float32)).to(dev)
        probs, feats = forward(x)
        return probs[:n].cpu().numpy(), feats[:n].cpu().numpy()

    return apply


def loss_fn(model: CheapCNN, images: torch.Tensor, labels: torch.Tensor,
            label_weights: Optional[torch.Tensor] = None):
    """Cross-entropy; optional per-class weights (OTHER-class reweighting,
    paper footnote 2). Returns ``(loss, {"nll", "acc"})`` as the JAX
    package does: ``nll`` is the (weighted) mean loss, ``acc`` the top-1
    accuracy, both detached 0-d tensors on the model's device."""
    logits, _ = model(images)
    logp = torch.log_softmax(logits, dim=-1)
    labels = labels.long()
    nll = -logp.gather(1, labels[:, None])[:, 0]
    if label_weights is not None:
        nll = nll * label_weights[labels]
    loss = nll.mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"nll": loss.detach(), "acc": acc.detach()}


def count_params(cfg: CheapCNNConfig) -> int:
    total = 0
    for ci, co, s in _plan(cfg):
        total += 3 * 3 * ci * co + 2 * co
    c_last = _plan(cfg)[-1][1]
    total += c_last * cfg.feature_dim + cfg.feature_dim
    total += cfg.feature_dim * cfg.n_classes + cfg.n_classes
    return total


def flops_per_image(cfg: CheapCNNConfig) -> int:
    """Forward FLOPs per image — the paper's ingest-cost unit."""
    total = 0
    res = cfg.input_res
    for ci, co, s in _plan(cfg):
        res = res // s
        total += 2 * res * res * 3 * 3 * ci * co
    c_last = _plan(cfg)[-1][1]
    total += 2 * c_last * cfg.feature_dim
    total += 2 * cfg.feature_dim * cfg.n_classes
    return total
