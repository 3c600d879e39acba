"""Model protocol, the critic base, the optimizers and warm start."""

from tensor2robot_tpu_torch.models.base import (AbstractT2RModel,
                                                ModelInterface)
from tensor2robot_tpu_torch.models.critic_model import CriticModel
from tensor2robot_tpu_torch.models.warm_start import (
    default_init_from_checkpoint_fn)

__all__ = ['AbstractT2RModel', 'CriticModel', 'ModelInterface',
           'default_init_from_checkpoint_fn']
