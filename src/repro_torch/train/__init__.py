from repro_torch.train.optimizer import OptConfig  # noqa: F401
from repro_torch.train.train_loop import TrainConfig, train  # noqa: F401
