"""EfficientNet [arXiv:1905.11946]: MBConv + SE, compound width/depth
scaling; b7 = (width 2.0, depth 3.1, native 600px). A port of
``repro.models.efficientnet``.

Batch-norm statistics are threaded functionally as a separate ``state``
tree, as in the JAX package: ``init`` returns ``(params, state)`` and
``forward`` returns ``(logits, new_state)``; in training the batch's
statistics normalise and move the state (``layers.batchnorm``), in eval
the state normalises. Images are NHWC and conv weights HWIO; each
convolution runs on the channels-last view with JAX's ``"SAME"``
padding (``layers.conv``: asymmetric at stride 2).

Params layout: stem/{conv/w, bn/{scale, bias}}, blocks (a list; each
expand/{conv, bn} when it widens, dwconv/w (k, k, 1, c_mid), bn_dw,
se/{w1, b1, w2, b2}, project/{conv, bn}), head/{conv, bn}, fc/{w, b}.
The batch-norm leaves are fp32, every other leaf in the config's dtype.
``mesh`` is the JAX package's argument, and as there it sets no
constraint: on a mesh the parameters and images are DTensors and the
layout follows them.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common import prng
from repro_torch.common.config import EffNetConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.models import layers as L

# B0 stage spec: (expand, channels, layers, stride, kernel)
_B0_STAGES = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]
_STEM = 32
_HEAD = 1280


def _round_ch(c: float, mult: float, div: int = 8) -> int:
    c *= mult
    new = max(div, int(c + div / 2) // div * div)
    if new < 0.9 * c:
        new += div
    return new


def _round_depth(d: int, mult: float) -> int:
    return int(math.ceil(d * mult))


def block_specs(cfg: EffNetConfig) -> List[Tuple[int, int, int, int, int, int]]:
    """List of (c_in, c_mid, c_out, stride, kernel, se) per MBConv block."""
    specs = []
    c_in = _round_ch(_STEM, cfg.width_mult)
    for expand, c, n, stride, k in _B0_STAGES:
        c_out = _round_ch(c, cfg.width_mult)
        for i in range(_round_depth(n, cfg.depth_mult)):
            s = stride if i == 0 else 1
            c_mid = c_in * expand
            se = max(1, c_in // 4)
            specs.append((c_in, c_mid, c_out, s, k, se))
            c_in = c_out
    return specs


def init(cfg: EffNetConfig, seed: int = 0, device: DeviceLike = "cuda"):
    """``(params, state)`` on ``device``: the JAX package's
    ``init(jax.random.PRNGKey(seed), cfg)``, key for key."""
    dev = resolve_device(device)
    dt = L.compute_dtype(cfg.dtype)
    specs = block_specs(cfg)
    ks = prng.split(prng.key(seed, dev), len(specs) + 3)
    stem_c = _round_ch(_STEM, cfg.width_mult)
    head_c = _round_ch(_HEAD, max(1.0, cfg.width_mult))

    params, state = {}, {}
    params["stem"] = {"conv": L.conv_init(ks[0], 3, 3, 3, stem_c, dt)}
    params["stem"]["bn"], state["stem"] = L.bn_init(stem_c, dev)

    blocks_p, blocks_s = [], []
    for i, (ci, cm, co, s, k, se) in enumerate(specs):
        kk = prng.split(ks[i + 1], 4)
        p, st = {}, {}
        if cm != ci:
            p["expand"] = {"conv": L.conv_init(kk[0], 1, 1, ci, cm, dt)}
            p["expand"]["bn"], st["expand"] = L.bn_init(cm, dev)
        p["dwconv"] = {"w": L.conv_init(kk[1], k, k, cm, cm, dt,
                                        groups=cm)["w"]}
        p["bn_dw"], st["dw"] = L.bn_init(cm, dev)
        p["se"] = L.se_init(kk[2], cm, se, dt)
        p["project"] = {"conv": L.conv_init(kk[3], 1, 1, cm, co, dt)}
        p["project"]["bn"], st["project"] = L.bn_init(co, dev)
        blocks_p.append(p)
        blocks_s.append(st)
    params["blocks"] = blocks_p
    state["blocks"] = blocks_s

    params["head"] = {"conv": L.conv_init(ks[-2], 1, 1, specs[-1][2], head_c,
                                          dt)}
    params["head"]["bn"], state["head"] = L.bn_init(head_c, dev)
    params["fc"] = {"w": L.dense_init(ks[-1], head_c, cfg.n_classes,
                                      dtype=dt),
                    "b": torch.zeros(cfg.n_classes, dtype=dt, device=dev)}
    return params, state


def params_from_jax(params: dict, state: dict, cfg: EffNetConfig,
                    device: DeviceLike = "cuda"):
    """JAX-layout ``(params, state)`` trees (numpy or JAX arrays) as the
    port's on ``device``: the batch-norm leaves and the state fp32, every
    other leaf in the config's dtype."""
    dev = resolve_device(device)
    dt = L.compute_dtype(cfg.dtype)
    return (L.tree_from_jax(params, dt, dev),
            L.tree_from_jax(state, torch.float32, dev))


def params_to_jax(params: dict, state: dict):
    """The port's ``(params, state)`` as JAX-layout trees of float32 numpy
    arrays."""
    return L.tree_to_jax(params), L.tree_to_jax(state)


def forward(params: dict, state: dict, images: torch.Tensor,
            cfg: EffNetConfig, train: bool = False, mesh=None,
            features_only: bool = False):
    """images (B, H, W, 3) -> (logits fp32, new_state); with
    ``features_only``, the pooled head features (fp32) in place of the
    logits."""
    dt = L.compute_dtype(cfg.dtype)
    specs = block_specs(cfg)
    x = images.to(dt)
    new_state = {"blocks": []}

    x = L.conv(params["stem"]["conv"], x, stride=2)
    x, new_state["stem"] = L.batchnorm(params["stem"]["bn"], state["stem"],
                                       x, train)
    x = F.silu(x)

    for p, st, (ci, cm, co, s, k, se) in zip(params["blocks"],
                                             state["blocks"], specs):
        inp = x
        nst = {}
        if "expand" in p:
            x = L.conv(p["expand"]["conv"], x)
            x, nst["expand"] = L.batchnorm(p["expand"]["bn"], st["expand"],
                                           x, train)
            x = F.silu(x)
        x = L.conv(p["dwconv"], x, stride=s, groups=cm)
        x, nst["dw"] = L.batchnorm(p["bn_dw"], st["dw"], x, train)
        x = F.silu(x)
        x = L.squeeze_excite(p["se"], x)
        x = L.conv(p["project"]["conv"], x)
        x, nst["project"] = L.batchnorm(p["project"]["bn"], st["project"],
                                        x, train)
        if s == 1 and ci == co:
            x = x + inp
        new_state["blocks"].append(nst)

    x = L.conv(params["head"]["conv"], x)
    x, new_state["head"] = L.batchnorm(params["head"]["bn"], state["head"],
                                       x, train)
    x = F.silu(x)
    feats = x.mean((1, 2))
    if features_only:
        return feats.float(), new_state
    logits = (feats @ params["fc"]["w"] + params["fc"]["b"]).float()
    return logits, new_state


def loss_fn(params: dict, state: dict, images: torch.Tensor,
            labels: torch.Tensor, cfg: EffNetConfig, mesh=None):
    """Cross-entropy in training mode: ``(loss, ({"nll", "acc"},
    new_state))``."""
    logits, new_state = forward(params, state, images, cfg, train=True,
                                mesh=mesh)
    loss, metrics = L.classification_loss(logits, labels)
    return loss, (metrics, new_state)


def count_params(cfg: EffNetConfig) -> int:
    specs = block_specs(cfg)
    stem_c = _round_ch(_STEM, cfg.width_mult)
    head_c = _round_ch(_HEAD, max(1.0, cfg.width_mult))
    total = 3 * 3 * 3 * stem_c + 2 * stem_c
    for ci, cm, co, s, k, se in specs:
        if cm != ci:
            total += ci * cm + 2 * cm
        total += k * k * cm + 2 * cm
        total += cm * se + se + se * cm + cm
        total += cm * co + 2 * co
    total += specs[-1][2] * head_c + 2 * head_c
    total += head_c * cfg.n_classes + cfg.n_classes
    return total


def flops_per_image(cfg: EffNetConfig, img_res: int = None) -> int:
    """Analytic forward FLOPs (2*MACs) per image at the given resolution."""
    res = img_res or cfg.img_res
    specs = block_specs(cfg)
    stem_c = _round_ch(_STEM, cfg.width_mult)
    head_c = _round_ch(_HEAD, max(1.0, cfg.width_mult))
    r = res // 2                       # stem stride 2
    total = 2 * r * r * 3 * 3 * 3 * stem_c
    for ci, cm, co, stride, k, se in specs:
        if cm != ci:
            total += 2 * r * r * ci * cm          # expand 1x1
        r2 = r // stride
        total += 2 * r2 * r2 * k * k * cm         # depthwise
        total += 2 * (cm * se + se * cm)          # SE
        total += 2 * r2 * r2 * cm * co            # project 1x1
        r = r2
    total += 2 * r * r * specs[-1][2] * head_c
    total += 2 * head_c * cfg.n_classes
    return total
