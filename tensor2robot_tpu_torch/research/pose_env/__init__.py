"""Pose env workload: the vision-to-pose regression model and the
continuous Monte-Carlo critic (the toy env, MAML and the collect loop are
ROADMAP queue 1 item 9)."""

from tensor2robot_tpu_torch.research.pose_env.pose_env_models import (
    PoseEnvContinuousMCModel, PoseEnvRegressionModel)

__all__ = ['PoseEnvContinuousMCModel', 'PoseEnvRegressionModel']
