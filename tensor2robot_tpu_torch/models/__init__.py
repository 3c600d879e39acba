"""Model protocol, the critic base and the optimizers."""

from tensor2robot_tpu_torch.models.base import (AbstractT2RModel,
                                                ModelInterface)
from tensor2robot_tpu_torch.models.critic_model import CriticModel

__all__ = ['AbstractT2RModel', 'CriticModel', 'ModelInterface']
