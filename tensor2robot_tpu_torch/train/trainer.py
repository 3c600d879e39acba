"""The trainer core: the port's counterpart of
``tensor2robot_tpu/train/trainer.py``.

``Trainer(model, TrainerConfig(...)).train(batch_iter)`` pulls (features,
labels) batches of numpy arrays, as the JAX trainer does, and runs one
step per batch on ``device`` (the card unless the caller asks for the
CPU). A step follows the JAX step body on its plain arm (one microbatch,
stock optimizer, no non-finite guard): preprocess the whole batch, forward
in TRAIN mode (batch statistics update in place), loss, backward,
optimizer step, EMA. It returns ``{'loss', 'q_mean'}``-style summaries as
device tensors, so a step does not wait for the card; ``train`` reads
them at log intervals and at the end.

What the JAX trainer does beyond that is not ported yet and raises
instead of being ignored: checkpoints (a non-empty ``model_dir``),
interleaved eval (``eval_iter_fn``) and the non-finite guard. Batches move
to the card synchronously; an overlapped record feed comes later.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.ops import _dispatch as dispatch
from tensor2robot_tpu_torch.specs import algebra
from tensor2robot_tpu_torch.train.train_state import (TrainState, apply_ema,
                                                      create_train_state)

Batch = Tuple[Mapping[str, Any], Optional[Mapping[str, Any]]]

_NOT_YET = ('is not ported yet: checkpoints, resume, eval and '
            'train_eval_model are ROADMAP.md queue 1 item 3')


@dataclasses.dataclass
class TrainerConfig:
  """Run configuration (the subset of the JAX ``TrainerConfig`` the core
  honours)."""

  model_dir: str = ''
  max_train_steps: int = 1000
  log_interval_steps: int = 100
  seed: int = 0
  nonfinite_mode: str = 'off'


class Trainer:
  """Owns the train state and runs training steps on one device."""

  def __init__(self, model, config: TrainerConfig, device='cuda'):
    if config.model_dir:
      raise NotImplementedError(f'model_dir (checkpoints) {_NOT_YET}.')
    if config.nonfinite_mode != 'off':
      raise NotImplementedError(
          f'nonfinite_mode={config.nonfinite_mode!r} (the non-finite guard) '
          f'{_NOT_YET}.')
    self._model = model
    self._config = config
    self._device = dispatch.resolve_device(device)
    if hasattr(model, 'set_mesh'):
      # Mesh-aware models get the mesh the step runs over before any module
      # is built; the port's trainer runs on one device, so there is none.
      model.set_mesh(None)
    self._preprocessor = model.preprocessor
    self._state: Optional[TrainState] = None

  @property
  def model(self):
    return self._model

  @property
  def config(self) -> TrainerConfig:
    return self._config

  @property
  def state(self) -> Optional[TrainState]:
    return self._state

  @property
  def step(self) -> int:
    return 0 if self._state is None else self._state.step

  def initialize(self, features, labels=None) -> TrainState:
    """Creates the train state; ``features`` (one host batch) is checked
    against the data contract."""
    del labels
    algebra.validate_and_pack(
        self._preprocessor.get_in_feature_specification(ModeKeys.TRAIN),
        dict(features), ignore_batch=True)
    generator = torch.Generator().manual_seed(self._config.seed)
    self._state = create_train_state(self._model, generator, self._device)
    return self._state

  def _to_device(self, tensors) -> Optional[Dict[str, torch.Tensor]]:
    if tensors is None:
      return None
    out = {}
    for key, value in dict(tensors).items():
      if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.ascontiguousarray(value))
      out[key] = value.to(self._device)
    return out

  def _train_step(self, features, labels) -> Dict[str, torch.Tensor]:
    """One optimizer step on one host batch; returns device scalars."""
    state = self._state
    model = self._model
    features, labels = self._preprocessor.preprocess(
        self._to_device(features), self._to_device(labels), ModeKeys.TRAIN,
        state.generator)
    state.optimizer.zero_grad(set_to_none=True)
    outputs = model.inference_network_fn(state.network, features, labels,
                                         ModeKeys.TRAIN)
    loss, scalars = model.model_train_fn(features, labels, outputs,
                                         ModeKeys.TRAIN)
    loss.backward()
    state.optimizer.step()
    apply_ema(state, model.avg_model_params_decay)
    state.step += 1
    scalars = {k: v.detach() for k, v in scalars.items()}
    scalars['loss'] = loss.detach()
    return scalars

  def train(self,
            train_iter: Iterator[Batch],
            eval_iter_fn: Optional[Callable[[], Iterator[Batch]]] = None
            ) -> Dict[str, float]:
    """Steps until ``max_train_steps``; returns the last step's summaries
    as floats."""
    if eval_iter_fn is not None:
      raise NotImplementedError(f'eval_iter_fn (interleaved eval) {_NOT_YET}.')
    pending: Optional[Batch] = None
    if self._state is None:
      pending = next(train_iter)
      self.initialize(pending[0])
    config = self._config
    scalars: Dict[str, torch.Tensor] = {}
    while self._state.step < config.max_train_steps:
      features, labels = pending if pending is not None else next(train_iter)
      pending = None
      scalars = self._train_step(features, labels)
      step = self._state.step
      if config.log_interval_steps and step % config.log_interval_steps == 0:
        logging.info('step %d: %s', step,
                     {k: float(v) for k, v in scalars.items()})
    return {k: float(v) for k, v in scalars.items()}
