"""Input-stream checkpointing: resume the record stream with the model.

The port's counterpart of ``tensor2robot_tpu/train/input_state.py``. The
stream's position is saved beside each model checkpoint and restored with
it:

    gen = NativeRecordInputGenerator(files, batch_size=32, seed=7)
    gen.set_specification_from_model(model, ModeKeys.TRAIN)
    it = gen.create_checkpointable_iterator(ModeKeys.TRAIN)
    trainer = Trainer(model, config, callbacks=[InputStateCallback(it)])
    trainer.train(it)   # resumes the model AND the stream

The callback saves on ``after_checkpoint`` (one state per checkpoint step,
kept while the checkpoint manager keeps that step) and restores on
``begin`` when the trainer restored a step for which a state exists. A
missing state logs and leaves a fresh stream, never an error.

**The saved position is that of the TRAINED batches**: the batches the
iterator delivered less the one the trainer has staged (uploaded ahead of
the step that will train it; ``Trainer.staged_batches``). A resume
therefore continues with the first batch that was not trained, and a
resumed run equals an uninterrupted one bit for bit. This differs on
purpose from the JAX package, whose saved position includes batches its
prefetcher pulled past the trained step, so that a resume skips them.

Each process saves under ``input_state/<name>/process_<rank>/``
(``rank``: the ``torch.distributed`` rank, 0 without a process group).
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import time
from typing import Optional

import torch

from tensor2robot_tpu_torch.train.trainer import TrainerCallback

INPUT_STATE_DIRNAME = 'input_state'
_STEP_RE = re.compile(r'^step_(\d+)$')


def _process_index() -> int:
  if torch.distributed.is_available() and torch.distributed.is_initialized():
    return torch.distributed.get_rank()
  return 0


class InputStateCallback(TrainerCallback):
  """Saves and restores a checkpointable input iterator with the trainer."""

  def __init__(self, iterator, name: str = 'train', keep: int = 5):
    """``iterator`` exposes ``save(path_prefix, pending)`` and
    ``restore(path_prefix)`` (``NativeRecordInputGenerator.
    create_checkpointable_iterator``)."""
    self._iterator = iterator
    self._name = name
    self._keep = keep

  def _root(self, trainer) -> Optional[str]:
    if not trainer.config.model_dir:
      return None
    return os.path.join(trainer.config.model_dir, INPUT_STATE_DIRNAME,
                        self._name, f'process_{_process_index()}')

  @staticmethod
  def _step_dirs(root):
    try:
      entries = os.listdir(root)
    except FileNotFoundError:
      return {}
    return {int(m.group(1)): os.path.join(root, e)
            for e in entries if (m := _STEP_RE.match(e))}

  def begin(self, trainer) -> None:
    root = self._root(trainer)
    step = trainer.step
    if root is None or step == 0:
      return
    path = self._step_dirs(root).get(step)
    if path is None:
      logging.warning(
          'No %r input state for restored step %d under %s; the stream '
          'restarts from the beginning (examples before the checkpoint may '
          'repeat).', self._name, step, root)
      return
    start = time.perf_counter()
    how = self._iterator.restore(os.path.join(path, 'state'))
    logging.info('Restored the %r input stream at step %d by %s in %.1f ms.',
                 self._name, step, how, (time.perf_counter() - start) * 1e3)

  def after_checkpoint(self, trainer, step: int) -> None:
    root = self._root(trainer)
    if root is None:
      return
    final_dir = os.path.join(root, f'step_{int(step)}')
    tmp_dir = os.path.join(root, f'.tmp_{int(step)}')
    shutil.rmtree(tmp_dir, ignore_errors=True)
    os.makedirs(tmp_dir, exist_ok=True)
    self._iterator.save(os.path.join(tmp_dir, 'state'),
                        pending=trainer.staged_batches)
    shutil.rmtree(final_dir, ignore_errors=True)
    os.replace(tmp_dir, final_dir)  # a restore never sees a partial state
    # Every model checkpoint that still exists keeps its stream state;
    # ``keep`` newest only without a checkpoint manager.
    by_step = self._step_dirs(root)
    manager = trainer.checkpoint_manager
    if manager is not None:
      retained = set(int(s) for s in manager.all_steps()) | {int(step)}
      stale = sorted(s for s in by_step if s not in retained)
    else:
      stale = sorted(by_step)[:-self._keep] if self._keep else []
    for old in stale:
      shutil.rmtree(by_step[old], ignore_errors=True)
