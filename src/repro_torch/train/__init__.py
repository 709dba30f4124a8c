from repro_torch.train.optimizer import OptConfig  # noqa: F401
from repro_torch.train.train_loop import (  # noqa: F401
    TrainConfig, make_train_step, train)
from repro_torch.train.checkpoint import CheckpointManager  # noqa: F401
