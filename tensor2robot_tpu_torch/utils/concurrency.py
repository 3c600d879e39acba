"""Concurrency primitives of the predictor and serving layer: the port's
counterpart of ``tensor2robot_tpu/utils/concurrency.py``.

:class:`ReaderWriterLock` exists because hot-reloading predictors
(``predictors/predictors.py``) swap several fields during ``restore()``
(the serving function, its parameters, the feature spec, the step) while
robot control loops and the serving plane call ``predict()`` from other
threads. Without exclusion a predict could pair the new serving function
with the old parameters, or read a torn spec. Reads are the hot path, so
they share the lock; a reload takes it exclusively.

Writers take priority: once a writer waits, new readers queue behind it,
so a sustained stream of predicts never starves a reload. The lock is
therefore not reentrant: a reader that acquires again while a writer
waits deadlocks, and callers keep their lock scopes flat.
"""

from __future__ import annotations

import contextlib
import threading


class ReaderWriterLock:
  """Many concurrent readers or one writer; writers take priority."""

  def __init__(self):
    self._cond = threading.Condition()
    self._active_readers = 0  # GUARDED_BY(self._cond)
    self._writer_active = False  # GUARDED_BY(self._cond)
    self._writers_waiting = 0  # GUARDED_BY(self._cond)

  def acquire_read(self) -> None:
    with self._cond:
      while self._writer_active or self._writers_waiting:
        self._cond.wait()
      self._active_readers += 1

  def release_read(self) -> None:
    with self._cond:
      self._active_readers -= 1
      if self._active_readers == 0:
        self._cond.notify_all()

  def acquire_write(self) -> None:
    with self._cond:
      self._writers_waiting += 1
      try:
        while self._writer_active or self._active_readers:
          self._cond.wait()
      finally:
        self._writers_waiting -= 1
      self._writer_active = True

  def release_write(self) -> None:
    with self._cond:
      self._writer_active = False
      self._cond.notify_all()

  @contextlib.contextmanager
  def read_locked(self):
    self.acquire_read()
    try:
      yield
    finally:
      self.release_read()

  @contextlib.contextmanager
  def write_locked(self):
    self.acquire_write()
    try:
      yield
    finally:
      self.release_write()
