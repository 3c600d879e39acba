"""Export callbacks: export after every checkpoint, and TD3's lagged export.

The port's counterpart of ``tensor2robot_tpu/export/async_export.py``.
:class:`AsyncExportCallback` exports the serving model after each
checkpoint save on a worker thread, so the train loop does not wait for
the trace and the writes; :class:`TD3ExportCallback` keeps a current and
a one-version-behind (lagged) export directory, TD3's target network on
disk.

The train loop updates the state's tensors in place, so each callback
copies the step and the eval state dict on their device at the save
(``exporters.snapshot_serving_state``) before handing them on.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

from tensor2robot_tpu_torch.export import exporters as exporters_lib
from tensor2robot_tpu_torch.export.exporters import ModelExporter
from tensor2robot_tpu_torch.observability import metrics as metrics_lib
from tensor2robot_tpu_torch.train import resilience
from tensor2robot_tpu_torch.train.trainer import TrainerCallback


class AsyncExportCallback(TrainerCallback):
  """Exports the serving model after each checkpoint save.

  The export runs on a worker thread, one at a time. Like the reference:
  ``last_exported_step`` is persisted into the export root after every
  version, so a restarted run skips what it already exported
  (``export/skipped_already_exported``); once a graceful shutdown has been
  requested, the forced checkpoint's export runs synchronously, since the
  process is about to exit; only the primary process exports.
  ``serialize_serving=False`` writes versions without the serving program
  (predictors then take the model-class path).
  """

  def __init__(self,
               export_dir: Optional[str] = None,
               export_name: str = 'latest_exporter_numpy',
               keep: int = 5,
               asynchronous: bool = True,
               serialize_serving: bool = True):
    self._export_dir = export_dir
    self._export_name = export_name
    self._exporter = ModelExporter(keep=keep,
                                   serialize_serving=serialize_serving)
    self._asynchronous = asynchronous
    self._pending: Optional[threading.Thread] = None

  def _resolve_export_dir(self, trainer) -> str:
    if self._export_dir:
      return self._export_dir
    return os.path.join(trainer.config.model_dir, 'export', self._export_name)

  @staticmethod
  def _shutdown_requested(trainer) -> bool:
    shutdown = trainer.shutdown or resilience.active_shutdown()
    return shutdown is not None and shutdown.requested

  def after_checkpoint(self, trainer, step: int) -> None:
    if not getattr(trainer, 'is_primary_process', True):
      return
    export_dir = self._resolve_export_dir(trainer)
    last = exporters_lib.read_export_state(export_dir).get(
        'last_exported_step')
    if last is not None and int(step) <= int(last):
      metrics_lib.counter('export/skipped_already_exported').inc()
      logging.info('Skipping export of checkpoint step %d: step %d was '
                   'already exported before the restart.', step, last)
      return
    model = trainer.model
    state = exporters_lib.snapshot_serving_state(trainer.state)

    def work():
      self._exporter.export(model, state, export_dir)
      exporters_lib.write_export_state(export_dir,
                                       last_exported_step=int(step))

    if not self._asynchronous or self._shutdown_requested(trainer):
      work()
      return
    self.join()  # one export in flight at a time
    self._pending = threading.Thread(target=work, daemon=True,
                                     name='t2r-async-export')
    self._pending.start()

  def end(self, trainer) -> None:
    self.join()

  def join(self) -> None:
    if self._pending is not None and self._pending.is_alive():
      self._pending.join()
    self._pending = None


class TD3ExportCallback(TrainerCallback):
  """Keeps a current and a lagged export dir: ``lagged_export_dir`` always
  holds the previous exported version (the current one at the first
  save)."""

  def __init__(self, export_dir: str, lagged_export_dir: str, keep: int = 5):
    self._export_dir = export_dir
    self._lagged_export_dir = lagged_export_dir
    self._exporter = ModelExporter(keep=keep)
    self._lagged_exporter = ModelExporter(keep=keep)
    self._previous_state = None

  def after_checkpoint(self, trainer, step: int) -> None:
    del step
    state = exporters_lib.snapshot_serving_state(trainer.state)
    self._exporter.export(trainer.model, state, self._export_dir)
    self._lagged_exporter.export(trainer.model,
                                 self._previous_state or state,
                                 self._lagged_export_dir)
    self._previous_state = state
