"""VRGripper workloads: the SNAIL meta-learners and their preprocessing."""

from tensor2robot_tpu_torch.research.vrgripper.vrgripper_env_meta_models import (
    VRGripperEnvLongHorizonModel, VRGripperEnvSequentialModel,
    VRGripperEnvTecModel, pack_vrgripper_meta_features)
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_env_models import (
    DefaultVRGripperPreprocessor)

__all__ = [
    'DefaultVRGripperPreprocessor', 'VRGripperEnvLongHorizonModel',
    'VRGripperEnvSequentialModel', 'VRGripperEnvTecModel',
    'pack_vrgripper_meta_features'
]
