"""DiT: latent diffusion transformer (adaLN-Zero conditioning)
[arXiv:2212.09748], a port of ``repro.models.dit``; ``mesh=`` constrains
the residual stream as the JAX package does (``distributed.sharding``).

Operates on VAE latents (img_res/8, 4 channels); the VAE is a stub, as in
the JAX package: the data gives latents directly. Predicts (noise, sigma)
per DiT's learn_sigma head; training uses the noise MSE at timesteps and
noise drawn from the rng it is given (``common.prng``: JAX's ``split``,
``randint`` and ``normal``, bit for bit). Generation runs a DDIM sampler
loop (one forward per step).

Params layout, the JAX package's (layers stacked on a leading L axis):
  patch/{w, b}, pos_embed (1, T, D), t_embed/{w1, b1, w2, b2},
  label_embed (n_classes + 1, D), layers/attn/..., layers/mlp/{wi, wo},
  layers/adaln/{w (D, 6D), b}, final/{adaln/{w, b}, w, b}
All leaves are in the config's dtype (the norms have no parameters). The
adaLN and final leaves are zeros at init (adaLN-Zero), so the model's
output is 0 until they train.

The schedule's betas follow ``jnp.linspace``'s formula, the timesteps of
``sample`` too (see ``_linspace``), and ``alpha_bars`` multiplies in
order; XLA's ``cumprod`` groups the products otherwise, so the table is
within 1e-6 relative of JAX's, not bitwise.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common import prng
from repro_torch.common.config import DiTConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import (constrain, gathered,
                                              replicate_like)
from repro_torch.models import layers as L


def timestep_embedding(t: torch.Tensor, dim: int = 256,
                       max_period: float = 10000.0) -> torch.Tensor:
    half = dim // 2
    freqs = replicate_like(torch.exp(
        -math.log(max_period) * torch.arange(
            half, dtype=torch.float32, device=t.device) / half), t)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def init(cfg: DiTConfig, seed: int = 0, device: DeviceLike = "cuda") -> dict:
    """Random parameters on ``device``: the JAX package's
    ``init(jax.random.PRNGKey(seed), cfg)``, key for key."""
    dev = resolve_device(device)
    dt = L.compute_dtype(cfg.dtype)
    ks = prng.split(prng.key(seed, dev), 8)
    D = cfg.d_model
    p2c = cfg.patch * cfg.patch * cfg.latent_channels

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def layer_init(k):
        k1, k2, _ = prng.split(k, 3)
        return {
            "attn": L.attn_init(k1, D, cfg.n_heads, cfg.n_heads, dt),
            "mlp": L.mlp_init(k2, D, cfg.d_ff, "gelu", dt),
            "adaln": {"w": zeros(D, 6 * D), "b": zeros(6 * D)},
        }

    return {
        "patch": L.patch_embed_init(ks[1], cfg.patch, cfg.latent_channels,
                                    D, dt),
        "pos_embed": (prng.normal(ks[2], (1, cfg.n_tokens(), D))
                      * 0.02).to(dt),
        "t_embed": {"w1": L.dense_init(ks[3], 256, D, dtype=dt),
                    "b1": zeros(D),
                    "w2": L.dense_init(ks[4], D, D, dtype=dt),
                    "b2": zeros(D)},
        "label_embed": (prng.normal(ks[5], (cfg.n_classes + 1, D))
                        * 0.02).to(dt),
        "layers": L.stacked_layers(prng.split(ks[0], cfg.n_layers),
                                   layer_init),
        "final": {"adaln": {"w": zeros(D, 2 * D), "b": zeros(2 * D)},
                  "w": zeros(D, 2 * p2c),       # noise + sigma
                  "b": zeros(2 * p2c)},
    }


def params_from_jax(tree: dict, cfg: DiTConfig,
                    device: DeviceLike = "cuda") -> dict:
    """A JAX-layout parameter tree (numpy or JAX arrays) as the port's
    dictionary on ``device``, every leaf in the config's dtype."""
    return L.tree_from_jax(tree, L.compute_dtype(cfg.dtype),
                           resolve_device(device))


def params_to_jax(params: dict) -> dict:
    """The port's parameters as a JAX-layout tree of float32 numpy arrays."""
    return L.tree_to_jax(params)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def _layer(cfg: DiTConfig, p: dict, x: torch.Tensor,
           c_act: torch.Tensor, mesh=None) -> torch.Tensor:
    mod = c_act @ p["adaln"]["w"] + p["adaln"]["b"]
    s1, sc1, g1, s2, sc2, g2 = mod.chunk(6, dim=-1)
    h = _modulate(L.layernorm({}, x), s1, sc1)
    h = L.multihead_attention(p["attn"], h, n_heads=cfg.n_heads,
                              n_kv_heads=cfg.n_heads, causal=False,
                              use_rope=False, mesh=mesh)
    x = x + g1[:, None, :] * h
    h = _modulate(L.layernorm({}, x), s2, sc2)
    h = L.mlp(p["mlp"], h, "gelu", mesh=mesh)
    return constrain(x + g2[:, None, :] * h, mesh, "hidden")


def forward(params: dict, latents: torch.Tensor, t: torch.Tensor,
            labels: torch.Tensor, cfg: DiTConfig, mesh=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """latents: (B, h, w, C); t: (B,) int; labels: (B,) int.

    Returns (noise_pred, sigma_pred), each (B, h, w, C) fp32. A latent
    grid other than the config's resizes the pos table bilinearly (the
    higher-res cells). Under a ``mesh`` the residual stream is
    constrained to ``"hidden"``, as in the JAX package, and so is the
    final layer's modulated input (the port's own, ROADMAP C23)."""
    dt = L.compute_dtype(cfg.dtype)
    B, h, w, C = latents.shape
    x = L.patch_embed(params["patch"], latents.to(dt), cfg.patch)
    N = x.shape[1]
    pos = params["pos_embed"]
    if pos.shape[1] != N:
        g_old = int(math.sqrt(pos.shape[1]))
        pos = L.resize_grid(pos.reshape(1, g_old, g_old, -1),
                          int(math.sqrt(N))).reshape(1, N, -1).to(pos.dtype)
    x = constrain(x + pos, mesh, "hidden")

    te = params["t_embed"]
    c = F.silu(timestep_embedding(t).to(dt) @ te["w1"] + te["b1"]) \
        @ te["w2"] + te["b2"]
    # the (n_classes + 1, D) table and the labels whole before the lookup
    # (FSDP's gather of the table; DTensor has no rule for a lookup into a
    # split table, or with labels split over two mesh dims, on every
    # torch): each rank then keeps its rows of the sum below
    c = c + gathered(params["label_embed"])[gathered(labels).long()].to(dt)
    c_act = F.silu(c)
    x = L.run_layers(cfg, _layer, params, x, c_act, mesh)

    fin = params["final"]
    shift, scale = (c_act @ fin["adaln"]["w"] + fin["adaln"]["b"]).chunk(
        2, dim=-1)
    x = constrain(_modulate(L.layernorm({}, x), shift, scale), mesh,
                  "hidden")
    x = x @ fin["w"] + fin["b"]                      # (B, N, 2*p*p*C)

    g = int(math.sqrt(N))
    p_ = cfg.patch
    x = x.reshape(B, g, g, p_, p_, 2 * C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, g * p_, g * p_, 2 * C).float()
    return x[..., :C], x[..., C:]


# ---------------------------------------------------------------------------
# Diffusion process (linear schedule, DDIM sampling)
# ---------------------------------------------------------------------------

N_TRAIN_STEPS = 1000
# XLA's CPU code contracts ``1 - i * (1/div)`` into a fused multiply-add
# over whole blocks of 32 elements once a linspace has this many steps
_FMA_FROM = 352


def _linspace(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` in float32 as the JAX package's
    CPU reference computes it: ``start * (1 - s) + stop * s`` with
    ``s = i / (num - 1)``, the division by the constant compiled as a
    product with its fp32 reciprocal, then ``stop`` appended; from
    ``_FMA_FROM`` steps on, ``1 - s`` is one fused multiply-add on the
    leading whole blocks of 32, as XLA's vectorised loop computes it.
    Exact for the timesteps of ``sample`` (pinned against
    ``jnp.linspace(...).astype(int32)`` for 2 to 1099 steps)."""
    f32 = np.float32
    if num <= 1:
        return np.full((num,), start, f32)
    div = num - 1
    i = np.arange(div, dtype=f32)
    r = f32(1) / f32(div)
    s = (i * r).astype(f32)
    one_minus = (f32(1) - s).astype(f32)
    if div >= _FMA_FROM:
        cut = 32 * (div // 32)
        fused = (-i[:cut].astype(np.float64) * np.float64(r) + 1.0)
        one_minus[:cut] = fused.astype(f32)
    out = (f32(start) * one_minus).astype(f32) + (f32(stop) * s).astype(f32)
    return np.concatenate([out.astype(f32), [f32(stop)]]).astype(f32)


def ddim_timesteps(n_steps: int) -> list:
    """The sampler's timesteps: ``jnp.linspace(999, 0, n_steps)`` cast to
    int32 (truncated: 665.99994 is 665), as Python ints."""
    return [int(v) for v in _linspace(N_TRAIN_STEPS - 1, 0, n_steps)
            .astype(np.int32)]


_ALPHA_BARS: Dict[Tuple[int, str], torch.Tensor] = {}


def alpha_bars(n_steps: int = N_TRAIN_STEPS,
               device: DeviceLike = "cpu") -> torch.Tensor:
    """The linear schedule's cumulative products of ``1 - beta``, betas
    ``linspace(1e-4, 0.02, n_steps)`` in fp32 (``_linspace``), multiplied
    in order in fp32 (XLA groups the products otherwise: within 1e-6
    relative of JAX's). Cached per device."""
    dev = torch.device(device)
    key = (n_steps, str(dev))
    if key not in _ALPHA_BARS:
        betas = _linspace(1e-4, 0.02, n_steps)
        ab = np.cumprod((np.float32(1) - betas).astype(np.float32),
                        dtype=np.float32)
        _ALPHA_BARS[key] = torch.from_numpy(ab).to(dev)
    return _ALPHA_BARS[key]


def loss_fn(params: dict, latents: torch.Tensor, labels: torch.Tensor,
            rng: torch.Tensor, cfg: DiTConfig, mesh=None):
    """Noise-prediction MSE at uniformly drawn timesteps: ``(loss,
    {"mse"})``. ``rng`` is a ``common.prng`` key; the timesteps and the
    noise are JAX's draws from it, made on the latents' device (whole on
    every rank, under a mesh)."""
    B = latents.shape[0]
    dev = latents.device
    k1, k2 = prng.split(rng.to(dev))
    t = prng.randint(k1, (B,), 0, N_TRAIN_STEPS)
    eps = prng.normal(k2, latents.shape)
    ab = alpha_bars(device=dev)[t.long()][:, None, None, None]
    t, eps, ab = (replicate_like(v, latents) for v in (t, eps, ab))
    noisy = torch.sqrt(ab) * latents + torch.sqrt(1 - ab) * eps
    pred, _ = forward(params, noisy, t, labels, cfg, mesh=mesh)
    loss = torch.mean(torch.square(pred - eps))
    return loss, {"mse": loss.detach()}


@torch.no_grad()
def sample(params: dict, rng: torch.Tensor, labels: torch.Tensor,
           cfg: DiTConfig, img_res: int, n_steps: int,
           mesh=None) -> torch.Tensor:
    """DDIM sampler: ``n_steps`` forwards from noise drawn under ``rng``
    (a ``common.prng`` key), on the labels' device. Returns the latents
    (B, img_res/8, img_res/8, C) fp32."""
    dev = labels.device
    B = labels.shape[0]
    res = img_res // cfg.vae_factor
    x = replicate_like(prng.normal(rng.to(dev),
                                   (B, res, res, cfg.latent_channels)),
                       labels)
    ab = replicate_like(alpha_bars(device=dev), labels)
    ts = ddim_timesteps(n_steps)
    one = replicate_like(torch.ones((), dtype=torch.float32, device=dev),
                         labels)
    for i, t_cur in enumerate(ts):
        t_prev = ts[i + 1] if i + 1 < n_steps else -1
        t = replicate_like(torch.full((B,), t_cur, device=dev), labels)
        eps, _ = forward(params, x, t, labels, cfg, mesh=mesh)
        a_cur = ab[t_cur]
        a_prev = ab[t_prev] if t_prev >= 0 else one
        x0 = (x - torch.sqrt(1 - a_cur) * eps) / torch.sqrt(a_cur)
        x = torch.sqrt(a_prev) * x0 + torch.sqrt(1 - a_prev) * eps
    return x
