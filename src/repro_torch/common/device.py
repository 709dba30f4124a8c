"""Device selection for every entry point of the port.

``resolve_device`` is the one place that turns a caller's ``device``
argument into a ``torch.device``. Asking for CUDA without a card raises:
an entry point never carries on silently on the CPU. It is also the one
place that pins fp32 on the card: cuDNN convolutions default to TF32,
which keeps about three decimal digits, so TF32 is switched off for
convolutions and matrix products, and cuDNN is held to deterministic
algorithms, before the first forward pass on the card.

``device="meta"`` passes through: meta tensors have shapes and dtypes and
no storage, which is what the step builders' abstract inputs are
(``launch.steps``). Nothing runs on them, so this is no fallback.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} was requested but no CUDA device "
                f"is available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {str(device)!r}: "
                         f"expected 'cuda', 'cpu' or 'meta'")
    return dev
