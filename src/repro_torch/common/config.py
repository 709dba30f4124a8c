"""Configuration of the cheap ingest CNN (the only model family this port
runs so far)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CheapCNNConfig:
    """Focus ingest CNN: a small convnet (compressed family member).

    ``n_blocks`` plays the role of "number of conv layers kept" and
    ``input_res`` the rescaled input resolution — the two compression axes the
    paper uses (§4.1). ``n_classes`` shrinks under specialization (§4.3:
    Ls most-frequent classes + OTHER).
    """

    name: str
    input_res: int = 32
    n_blocks: int = 4
    width: int = 64
    n_classes: int = 1000
    feature_dim: int = 128        # penultimate-layer feature vector (clustering)
    in_channels: int = 3
    dtype: str = "float32"

    def flops_per_image(self) -> int:
        from repro_torch.models import cnn
        return cnn.flops_per_image(self)


# The widest cheap CNN of the benchmarks' generic family: with it the top-K
# index ranks all 1000 classes.
CHEAP_CNNS = {
    "cheap1": CheapCNNConfig("cheap1", input_res=32, n_blocks=6, width=48,
                             n_classes=1000, feature_dim=128),
}
