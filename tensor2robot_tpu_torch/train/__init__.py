"""Training: the train state, checkpoints, the trainer and its callbacks."""

from tensor2robot_tpu_torch.train.checkpoints import (
    CheckpointManager, TopologyMismatchError, checkpoints_iterator,
    latest_checkpoint_step)
from tensor2robot_tpu_torch.train.resilience import (GracefulShutdown,
                                                     NonFiniteError,
                                                     PreemptedError)
from tensor2robot_tpu_torch.train.train_state import (TrainState, apply_ema,
                                                      create_train_state)
from tensor2robot_tpu_torch.train.trainer import (Trainer, TrainerCallback,
                                                  TrainerConfig,
                                                  predict_from_model,
                                                  train_eval_model)

__all__ = ['CheckpointManager', 'GracefulShutdown', 'NonFiniteError',
           'PreemptedError', 'TopologyMismatchError', 'TrainState', 'Trainer',
           'TrainerCallback', 'TrainerConfig', 'apply_ema',
           'checkpoints_iterator', 'create_train_state',
           'latest_checkpoint_step', 'predict_from_model', 'train_eval_model']
