"""Training: the train state and the trainer core."""

from tensor2robot_tpu_torch.train.train_state import (TrainState, apply_ema,
                                                      create_train_state)
from tensor2robot_tpu_torch.train.trainer import Trainer, TrainerConfig

__all__ = ['TrainState', 'Trainer', 'TrainerConfig', 'apply_ema',
           'create_train_state']
