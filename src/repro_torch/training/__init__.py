from repro_torch.training.losses import cross_entropy, total_loss
from repro_torch.training.train_loop import (
    TrainConfig,
    make_loss_fn,
    make_train_step,
    train,
)

__all__ = ["cross_entropy", "total_loss", "TrainConfig", "make_loss_fn",
           "make_train_step", "train"]
