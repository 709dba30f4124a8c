"""LM training entry point: the port of ``repro.launch.train`` for the decoder
LMs.

Trains an arch of the port's registry (``olmo-1b``, ``granite-34b``,
``moonshot-v1-16b-a3b``, ``dbrx-132b``; reduced or full config) on the
JAX package's synthetic LM task with the
whole substrate: AdamW and its schedule, gradient accumulation over
micro-batches, gradient compression, checkpoint and restart, preemption
handling. The weights are JAX's (``transformer.init(cfg, seed=0)``, the
same threefry draw) and so are the tokens (``lm_data``: numpy's
``default_rng(seed)``), so both entry points print the same loss lines up to
rounding. The JAX entry point's vision and DiT ids wait for their slice
(ROADMAP A13): the registry rejects them with its own error.

  python -m repro_torch.launch.train --arch olmo-1b --steps 20 --device cpu
  python -m repro_torch.launch.train --arch olmo-1b --full --steps 20 \\
      --batch 8 --seq 2048 --microbatches 2          # on the card

With ``--ckpt-dir D`` a second run resumes from D's newest checkpoint.
"""
from __future__ import annotations

import argparse
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.config import LMConfig, reduced
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.models import transformer
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
    params = transformer.init(cfg, seed=0, device=args.device)
    data = lm_data(cfg, args.batch, args.seq, device=args.device)

    def loss_fn(p, batch):
        return transformer.loss_fn(p, batch["tokens"], batch["labels"], cfg)

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
