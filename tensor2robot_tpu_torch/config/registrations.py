"""Registers the port's classes and functions as configurables, under the
names the JAX package's configs use. Idempotent: safe to call from every
binary.
"""

from __future__ import annotations

from tensor2robot_tpu_torch.config import gin_lite

_REGISTERED = False


def register() -> None:
  global _REGISTERED
  if _REGISTERED:
    return
  _REGISTERED = True

  # pylint: disable=import-outside-toplevel
  from tensor2robot_tpu_torch import export as export_lib
  from tensor2robot_tpu_torch.data import input_generators as ig
  from tensor2robot_tpu_torch.models import optimizers, warm_start
  from tensor2robot_tpu_torch.policies import CEMPolicy
  from tensor2robot_tpu_torch.predictors import (CheckpointPredictor,
                                                 ExportedModelPredictor)
  from tensor2robot_tpu_torch.research import (grasp2vec, pose_env, qtopt,
                                               vrgripper)
  from tensor2robot_tpu_torch.train import callbacks as callbacks_lib
  from tensor2robot_tpu_torch.train import resilience
  from tensor2robot_tpu_torch.train import trainer as trainer_lib
  from tensor2robot_tpu_torch.utils import mocks
  # pylint: enable=import-outside-toplevel

  reg = gin_lite.external_configurable
  # Trainer entry points.
  reg(trainer_lib.train_eval_model, 'train_eval_model')
  reg(trainer_lib.predict_from_model, 'predict_from_model')
  # Input generators.
  reg(ig.GeneratorInputGenerator, 'GeneratorInputGenerator')
  reg(ig.DefaultRandomInputGenerator, 'DefaultRandomInputGenerator')
  reg(ig.DefaultConstantInputGenerator, 'DefaultConstantInputGenerator')
  reg(ig.DefaultRecordInputGenerator, 'DefaultRecordInputGenerator')
  reg(ig.NativeRecordInputGenerator, 'NativeRecordInputGenerator')
  reg(ig.FractionalRecordInputGenerator, 'FractionalRecordInputGenerator')
  reg(ig.MultiEvalRecordInputGenerator, 'MultiEvalRecordInputGenerator')
  reg(ig.TaskGroupedRecordInputGenerator, 'TaskGroupedRecordInputGenerator')
  # Optimizer factories and learning-rate schedules.
  reg(optimizers.create_adam_optimizer, 'create_adam_optimizer')
  reg(optimizers.create_gradient_descent_optimizer,
      'create_gradient_descent_optimizer')
  reg(optimizers.create_momentum_optimizer, 'create_momentum_optimizer')
  reg(optimizers.create_rms_prop_optimizer, 'create_rms_prop_optimizer')
  reg(optimizers.create_constant_learning_rate_fn,
      'create_constant_learning_rate')
  reg(optimizers.create_exp_decaying_learning_rate_fn,
      'create_exp_decaying_learning_rate')
  # Warm start, callbacks and the preemption handler.
  reg(warm_start.default_init_from_checkpoint_fn,
      'default_init_from_checkpoint_fn')
  reg(warm_start.create_resnet_init_from_checkpoint_fn,
      'create_resnet_init_from_checkpoint_fn')
  reg(callbacks_lib.TensorBoardCallback, 'TensorBoardCallback')
  reg(callbacks_lib.MetricsLoggerCallback, 'MetricsLoggerCallback')
  reg(callbacks_lib.VariableLoggerCallback, 'VariableLoggerCallback')
  reg(callbacks_lib.ResilienceLoggerCallback, 'ResilienceLoggerCallback')
  reg(resilience.install_graceful_shutdown, 'install_graceful_shutdown')
  # Export and serving.
  reg(export_lib.create_default_exporters, 'create_default_exporters')
  reg(export_lib.AsyncExportCallback, 'AsyncExportCallback')
  reg(export_lib.TD3ExportCallback, 'TD3ExportCallback')
  reg(CheckpointPredictor, 'CheckpointPredictor')
  reg(ExportedModelPredictor, 'ExportedModelPredictor')
  reg(CEMPolicy, 'CEMPolicy')
  # Models.
  reg(mocks.MockT2RModel, 'MockT2RModel')
  reg(mocks.MockInputGenerator, 'MockInputGenerator')
  reg(qtopt.GraspingModelWrapper, 'GraspingModelWrapper')
  reg(pose_env.PoseEnvRegressionModel, 'PoseEnvRegressionModel')
  reg(pose_env.PoseEnvContinuousMCModel, 'PoseEnvContinuousMCModel')
  reg(vrgripper.VRGripperEnvSequentialModel, 'VRGripperEnvSequentialModel')
  reg(vrgripper.VRGripperEnvLongHorizonModel, 'VRGripperEnvLongHorizonModel')
  reg(grasp2vec.Grasp2VecModel, 'Grasp2VecModel')
