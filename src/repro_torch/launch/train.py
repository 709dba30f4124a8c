"""Training entry point: the port of ``repro.launch.train``.

Trains any arch of the registry (reduced or full config) on the JAX
package's synthetic data with the whole substrate: AdamW and its
schedule, gradient accumulation over micro-batches, gradient compression,
checkpoint and restart, preemption handling. The four families:
- the decoder LMs (``olmo-1b``, ``granite-34b``, ``moonshot-v1-16b-a3b``,
  ``dbrx-132b``) on the noisy-copy LM task (``lm_data``);
- ViT and DeiT (``vit-l16``, ``vit-s16``, ``deit-b``) and EfficientNet
  (``efficientnet-b7``) on class prototypes plus noise (``vit_data``);
  EfficientNet's loss closes over its initial batch-norm state and drops
  the new one, as the JAX entry point's does;
- DiT (``dit-b2``, ``dit-s2``) on Gaussian latents (``dit_data``), its
  timesteps and noise drawn from the loop's rng.
The weights are JAX's (each model's ``init(cfg, seed=0)``, the same
threefry draw), the batches numpy's ``default_rng(seed)`` draws, batch
for batch, and the loop's rng JAX's, so both entry points print the same
loss lines up to rounding.

  python -m repro_torch.launch.train --arch olmo-1b --steps 20 --device cpu
  python -m repro_torch.launch.train --arch dit-s2 --steps 20 --device cpu
  python -m repro_torch.launch.train --arch olmo-1b --full --steps 20 \\
      --batch 8 --seq 2048 --microbatches 2          # on the card
  python -m repro_torch.launch.train --arch vit-l16 --full --steps 20 \\
      --batch 32                                     # on the card

With ``--ckpt-dir D`` a second run resumes from D's newest checkpoint.
"""
from __future__ import annotations

import argparse
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.config import (DiTConfig, EffNetConfig, LMConfig,
                                       ViTConfig, reduced)
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.data.video import _class_proto
from repro_torch.models import dit, efficientnet, transformer, vit
from repro_torch.train import CheckpointManager, OptConfig, TrainConfig, train
from repro_torch.train.train_loop import param_leaves


def lm_data(cfg: LMConfig, batch: int, seq: int, seed: int = 0,
            device: DeviceLike = "cuda") -> Iterator[dict]:
    """The JAX entry point's synthetic LM task, batch for batch: uniform tokens
    and each position's next token as its label."""
    dev = resolve_device(device)
    r = np.random.default_rng(seed)
    while True:
        toks = r.integers(0, cfg.vocab_size, (batch, seq))
        labels = np.roll(toks, -1, axis=1)
        yield {"tokens": torch.from_numpy(toks).to(dev),
               "labels": torch.from_numpy(labels).to(dev)}


def vit_data(cfg, batch: int, seed: int = 0,
             device: DeviceLike = "cuda") -> Iterator[dict]:
    """The JAX entry point's image task, batch for batch: uniform labels,
    each image its class prototype (``data.video._class_proto`` at
    ``cfg.img_res``) plus N(0, 0.1) noise, in float32. The JAX entry
    point stacks every class's prototype first (4.3 GB of host memory at
    1000 classes of 600 px); here a prototype is made when its class is
    first drawn. Prototypes come from their own generator, so the
    batches are the same bytes."""
    dev = resolve_device(device)
    r = np.random.default_rng(seed)
    protos = {}
    while True:
        y = r.integers(0, cfg.n_classes, batch)
        for c in y:
            if c not in protos:
                protos[c] = _class_proto(int(c), cfg.img_res)
        x = np.stack([protos[c] for c in y]) + r.normal(
            0, 0.1, (batch, cfg.img_res, cfg.img_res, 3))
        yield {"images": torch.from_numpy(x.astype(np.float32)).to(dev),
               "labels": torch.from_numpy(y).to(dev)}


def dit_data(cfg: DiTConfig, batch: int, seed: int = 0,
             device: DeviceLike = "cuda") -> Iterator[dict]:
    """The JAX entry point's diffusion task, batch for batch: N(0, 1)
    latents at ``img_res / vae_factor`` and uniform labels."""
    dev = resolve_device(device)
    r = np.random.default_rng(seed)
    res = cfg.img_res // cfg.vae_factor
    while True:
        lat = r.normal(0, 1, (batch, res, res, cfg.latent_channels))
        y = r.integers(0, cfg.n_classes, batch)
        yield {"latents": torch.from_numpy(lat.astype(np.float32)).to(dev),
               "labels": torch.from_numpy(y).to(dev)}


def build(cfg, batch: int, seq: int, device: DeviceLike):
    """``(params, data, loss_fn)`` of ``cfg``'s family, as the JAX entry
    point builds them (weights from seed 0, data from seed 0)."""
    if isinstance(cfg, LMConfig):
        def loss_fn(p, b, rng):
            return transformer.loss_fn(p, b["tokens"], b["labels"], cfg)
        return (transformer.init(cfg, seed=0, device=device),
                lm_data(cfg, batch, seq, device=device), loss_fn)
    if isinstance(cfg, ViTConfig):
        def loss_fn(p, b, rng):
            return vit.loss_fn(p, b["images"], b["labels"], cfg)
        return (vit.init(cfg, seed=0, device=device),
                vit_data(cfg, batch, device=device), loss_fn)
    if isinstance(cfg, DiTConfig):
        def loss_fn(p, b, rng):
            return dit.loss_fn(p, b["latents"], b["labels"], rng, cfg)
        return (dit.init(cfg, seed=0, device=device),
                dit_data(cfg, batch, device=device), loss_fn)
    if isinstance(cfg, EffNetConfig):
        params, state = efficientnet.init(cfg, seed=0, device=device)

        def loss_fn(p, b, rng):
            loss, (metrics, _) = efficientnet.loss_fn(
                p, state, b["images"], b["labels"], cfg)
            return loss, metrics
        return params, vit_data(cfg, batch, device=device), loss_fn
    raise SystemExit(f"unsupported {type(cfg)}")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="olmo-1b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "int8_ef"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train; prints the JAX entry point's lines and returns ``{"arch",
    "params", "start_step", "history", "final_loss"}`` (``final_loss``
    None when a resumed run had no step left)."""
    args = parse_args(argv)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params, data, loss_fn = build(cfg, args.batch, args.seq, args.device)
    n_params = sum(x.numel() for x in param_leaves(params))
    print(f"[train] arch={cfg.name} params={n_params/1e6:.2f}M "
          f"steps={args.steps}")
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = ckpt.latest_step() if ckpt is not None else None
    if start is not None:
        print(f"[train] resuming from step {start} of {args.ckpt_dir}")
    ocfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                     total_steps=args.steps)
    tcfg = TrainConfig(steps=args.steps, log_every=max(args.steps // 10, 1),
                       n_microbatches=args.microbatches,
                       compression=args.compression,
                       ckpt_every=args.ckpt_every)
    params, hist = train(loss_fn, params, data, ocfg, tcfg, ckpt=ckpt,
                         hooks=[lambda m: print(
                             f"  step {m['step']:5d} loss {m['loss']:.4f} "
                             f"({m['step_time_s']*1e3:.0f} ms/step)")])
    final = hist[-1]["loss"] if hist else None
    if final is None:
        print(f"[train] no step left: the checkpoint is at step {start}")
    else:
        print(f"[train] final loss {final:.4f}")
    return {"arch": cfg.name, "params": n_params, "start_step": start or 0,
            "history": hist, "final_loss": final}


if __name__ == "__main__":
    main()
