"""Predictors: restore-and-infer objects driving robot policies."""

from tensor2robot_tpu_torch.predictors.predictors import (AbstractPredictor,
                                                          CheckpointPredictor)

__all__ = ['AbstractPredictor', 'CheckpointPredictor']
