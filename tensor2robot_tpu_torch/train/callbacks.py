"""Trainer callbacks: the port's counterpart of
``tensor2robot_tpu/train/callbacks.py``.

The stock implementations of ``trainer.TrainerCallback``: parameter
statistics in the log, train and eval scalars as JSON lines and as
TensorBoard events, and the non-finite guard's counts. The JAX package's
``ProfilerCallback`` waits for the observability plane (ROADMAP queue 1
item 10).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

from tensor2robot_tpu_torch.train.trainer import TrainerCallback


class VariableLoggerCallback(TrainerCallback):
  """Logs the mean and standard deviation (optionally the values) of every
  parameter at each crossed ``log_interval_steps``."""

  def __init__(self, log_interval_steps: int = 100,
               log_values: bool = False):
    self._log_interval_steps = log_interval_steps
    self._log_values = log_values

  def after_step(self, trainer, step: int, scalars) -> None:
    if not trainer.crossed(self._log_interval_steps, step):
      return
    for name, param in trainer.state.network.named_parameters():
      value = param.detach().float().cpu()
      logging.info('var %s mean=%.6f std=%.6f', name, float(value.mean()),
                   float(value.std(unbiased=False)))
      if self._log_values:
        logging.info('var %s value=%s', name, value.numpy())


class MetricsLoggerCallback(TrainerCallback):
  """Appends train and eval scalars as JSON lines to
  ``<model_dir>/<filename>``."""

  def __init__(self, filename: str = 'metrics.jsonl'):
    self._filename = filename

  def _write(self, trainer, record: dict) -> None:
    if not trainer.config.model_dir:
      return
    os.makedirs(trainer.config.model_dir, exist_ok=True)
    path = os.path.join(trainer.config.model_dir, self._filename)
    with open(path, 'a') as f:
      f.write(json.dumps(record) + '\n')

  def after_step(self, trainer, step: int, scalars) -> None:
    if not scalars or not trainer.crossed(trainer.config.log_interval_steps,
                                          step):
      return
    record = {'kind': 'train', 'step': int(step)}
    record.update({k: float(v) for k, v in scalars.items()})
    self._write(trainer, record)

  def after_eval(self, trainer, step: int, metrics) -> None:
    record = {'kind': 'eval', 'step': int(step)}
    record.update({k: float(v) for k, v in metrics.items()})
    self._write(trainer, record)


class ResilienceLoggerCallback(TrainerCallback):
  """Logs the non-finite updates the guard skipped since ``begin``, at each
  crossed log interval and at the end, so a run that absorbs faults is
  seen to absorb them."""

  def __init__(self, log_interval_steps: Optional[int] = None):
    self._log_interval_steps = log_interval_steps
    self._start = 0

  def _skipped(self, trainer) -> int:
    policy = trainer.nonfinite_policy
    return 0 if policy is None else policy.bad_steps - self._start

  def begin(self, trainer) -> None:
    policy = trainer.nonfinite_policy
    self._start = 0 if policy is None else policy.bad_steps

  def after_step(self, trainer, step: int, scalars) -> None:
    interval = (self._log_interval_steps
                if self._log_interval_steps is not None
                else trainer.config.log_interval_steps)
    if not trainer.crossed(interval, step):
      return
    skipped = self._skipped(trainer)
    if skipped:
      policy = trainer.nonfinite_policy
      logging.info(
          'resilience: %d non-finite update(s) skipped so far (%d '
          'consecutive bad step(s), mode=%s).', skipped,
          policy.consecutive_bad, policy.mode)

  def end(self, trainer) -> None:
    skipped = self._skipped(trainer)
    if skipped:
      logging.warning(
          'resilience: run finished with %d non-finite update(s) skipped.',
          skipped)


class TensorBoardCallback(TrainerCallback):
  """Writes train and eval scalars as TensorBoard event files under
  ``<logdir or model_dir/events>/{train,eval}``
  (``torch.utils.tensorboard``, imported at the first write)."""

  def __init__(self, logdir: Optional[str] = None):
    self._logdir = logdir
    self._writers = {}

  def _writer(self, trainer, kind: str):
    if kind not in self._writers:
      from torch.utils.tensorboard import SummaryWriter  # pylint: disable=import-outside-toplevel

      logdir = self._logdir or os.path.join(trainer.config.model_dir,
                                            'events')
      self._writers[kind] = SummaryWriter(os.path.join(logdir, kind))
    return self._writers[kind]

  def _write(self, trainer, kind: str, step: int, scalars) -> None:
    writer = self._writer(trainer, kind)
    for key, value in scalars.items():
      writer.add_scalar(key, float(value), global_step=int(step))
    writer.flush()

  def after_step(self, trainer, step: int, scalars) -> None:
    if not scalars or not trainer.crossed(trainer.config.log_interval_steps,
                                          step):
      return
    self._write(trainer, 'train', step, scalars)

  def after_eval(self, trainer, step: int, metrics) -> None:
    if metrics:
      self._write(trainer, 'eval', step, metrics)

  def end(self, trainer) -> None:
    for writer in self._writers.values():
      writer.close()
    self._writers.clear()
