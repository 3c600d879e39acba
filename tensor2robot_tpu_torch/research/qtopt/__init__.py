"""QT-Opt: the Grasping44 critic and its T2R model wrapper."""

from tensor2robot_tpu_torch.research.qtopt.networks import Grasping44
from tensor2robot_tpu_torch.research.qtopt.optimizer_builder import build_opt
from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
    DefaultGrasping44ImagePreprocessor, GraspingModelWrapper)

__all__ = [
    'DefaultGrasping44ImagePreprocessor', 'Grasping44', 'GraspingModelWrapper',
    'build_opt'
]
