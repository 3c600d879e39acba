"""Predictors: restore-and-infer objects driving robot policies."""

from tensor2robot_tpu_torch.predictors.predictors import (
    AbstractPredictor, CheckpointPredictor, EagerServingFn,
    ExportedModelPredictor, StatelessServingFn, poll_and_load_newest)

__all__ = ['AbstractPredictor', 'CheckpointPredictor', 'EagerServingFn',
           'ExportedModelPredictor', 'StatelessServingFn',
           'poll_and_load_newest']
