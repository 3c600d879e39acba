"""Preemption-safe shutdown and the non-finite update policy: the port's
counterpart of ``tensor2robot_tpu/train/resilience.py``.

* :class:`GracefulShutdown` turns SIGTERM/SIGINT into a flag. The trainer
  checks it at each step boundary, forces a checkpoint and raises
  :class:`PreemptedError`, which the trainer binary turns into the
  resumable exit status ``PREEMPTED_EXIT_CODE`` (42). The first signal
  restores the previous handlers, so a second one kills as before.
  :func:`install_graceful_shutdown` installs one process-wide handler that
  every trainer of the process honours (:func:`active_shutdown`).
* :class:`NonFinitePolicy` decides what the host does about a bad step.
  The trainer's step computes an all-finite flag over the loss and the
  gradients on the device and guards the update with it, so a NaN or Inf
  batch never reaches the parameters: the policy counts and skips it
  (halting after a run of ``halt_after`` bad steps), or raises. The counts
  are attributes, mirrored, as in the JAX package, into the metrics
  registry (``resilience/nonfinite_skipped_steps``,
  ``resilience/consecutive_bad_dispatches``) and the flight recorder (a
  ``'nonfinite'`` event a skip), before any raise.

At one step a dispatch the port reads the flag once per step (a one-byte
copy, only with the guard on), so ``'raise'`` raises at the bad step
itself; at K steps a dispatch the trainer observes a dispatch's count one
dispatch later, as the JAX trainer does. Either way the bad step changed
nothing.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional, Tuple

from tensor2robot_tpu_torch.observability import flight
from tensor2robot_tpu_torch.observability import metrics as metrics_lib

# The resumable exit status of a preempted trainer binary: a scheduler
# restarts the job, and the restarted run restores the forced checkpoint.
PREEMPTED_EXIT_CODE = 42


class PreemptedError(RuntimeError):
  """Training stopped by a preemption signal after a forced checkpoint;
  rerunning the job resumes from it. ``exit_code`` is the status a binary
  exits with."""

  exit_code = PREEMPTED_EXIT_CODE

  def __init__(self, step: int):
    super().__init__(
        f'training preempted at step {step}; checkpoint saved, resumable')
    self.step = int(step)


class NonFiniteError(RuntimeError):
  """The non-finite policy halted training (the state is still finite)."""


class NonFinitePolicy:
  """Host-side accounting and decision for device-guarded non-finite steps.

  ``mode``:
    * ``'off'``: no guard in the step (the step as it is without it).
    * ``'skip_update'``: a bad step leaves the parameters, the optimizer's
      moments and counts, the EMA, the batch statistics, ``state.step`` and
      the generator as if the batch had never been drawn; skips are counted
      and ``halt_after`` consecutive bad steps raise :class:`NonFiniteError`,
      so an all-NaN stream cannot spin forever.
    * ``'raise'``: the first bad step raises (after it was skipped).
  """

  MODES = ('off', 'skip_update', 'raise')

  def __init__(self, mode: str = 'skip_update', halt_after: int = 10):
    if mode not in self.MODES:
      raise ValueError(f'nonfinite mode must be one of {self.MODES}, '
                       f'got {mode!r}')
    self.mode = mode
    self.halt_after = int(halt_after)
    self.bad_steps = 0        # total non-finite steps skipped
    self.consecutive_bad = 0  # consecutive steps that were skipped
    # The registry's series exist from the first step whenever the guard
    # is on.
    self._m_bad_steps = metrics_lib.counter(
        'resilience/nonfinite_skipped_steps')
    self._m_consecutive = metrics_lib.gauge(
        'resilience/consecutive_bad_dispatches')

  @property
  def enabled(self) -> bool:
    return self.mode != 'off'

  def observe(self, nonfinite_count: int, step: int) -> None:
    """Accounts one step's (or dispatch's) count of non-finite steps."""
    if not self.enabled:
      return
    count = int(nonfinite_count)
    if count == 0:
      self.consecutive_bad = 0
      self._m_consecutive.set(0)
      return
    self.bad_steps += count
    self.consecutive_bad += 1
    self._m_bad_steps.inc(count)
    self._m_consecutive.set(self.consecutive_bad)
    flight.event(
        'nonfinite', 'resilience/nonfinite_skip',
        f'count={count} step={step} consecutive={self.consecutive_bad} '
        f'mode={self.mode}')
    if self.mode == 'raise':
      raise NonFiniteError(
          f'non-finite loss/grads at step {step} (policy=raise); the update '
          f'was skipped, the state remains finite ({self.bad_steps} bad '
          'step(s) total)')
    logging.warning(
        'Non-finite loss/grads: skipped %d update(s) at step %d (%d total, '
        '%d consecutive, halt at %d).', count, step, self.bad_steps,
        self.consecutive_bad, self.halt_after)
    if self.halt_after and self.consecutive_bad >= self.halt_after:
      raise NonFiniteError(
          f'{self.consecutive_bad} consecutive steps with non-finite '
          f'loss/grads (>= halt_after={self.halt_after}) at step {step}; '
          f'{self.bad_steps} update(s) skipped in total: halting, the input '
          'stream looks systematically broken')


class GracefulShutdown:
  """Converts SIGTERM/SIGINT into a flag checked at step boundaries.

  ``install()`` registers handlers (main thread only; other threads call
  :meth:`request`); the first signal sets the flag and restores the
  previous handlers. Usable as a context manager.
  """

  def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM,
                                                 signal.SIGINT)):
    self._signals = tuple(signals)
    self._event = threading.Event()
    self._prev = {}
    self._installed = False

  @property
  def requested(self) -> bool:
    return self._event.is_set()

  def request(self) -> None:
    """A preemption without a signal (tests, agents without signals)."""
    self._event.set()

  def _handler(self, signum, frame) -> None:
    del frame
    logging.warning(
        'Received signal %d: finishing the step in flight, then '
        'checkpointing and exiting resumable (the next signal kills).',
        signum)
    self._event.set()
    self.uninstall()

  def install(self) -> 'GracefulShutdown':
    if not self._installed:
      for s in self._signals:
        self._prev[s] = signal.signal(s, self._handler)
      self._installed = True
    return self

  def uninstall(self) -> None:
    if self._installed:
      for s, prev in self._prev.items():
        signal.signal(s, prev)
      self._prev.clear()
      self._installed = False

  def __enter__(self) -> 'GracefulShutdown':
    return self.install()

  def __exit__(self, *exc) -> None:
    self.uninstall()


_GLOBAL_SHUTDOWN: Optional[GracefulShutdown] = None


def install_graceful_shutdown() -> GracefulShutdown:
  """Installs the process-wide shutdown handler (idempotent; installing
  again after an ``uninstall`` brings it back)."""
  global _GLOBAL_SHUTDOWN
  if _GLOBAL_SHUTDOWN is None:
    _GLOBAL_SHUTDOWN = GracefulShutdown()
  return _GLOBAL_SHUTDOWN.install()


def active_shutdown() -> Optional[GracefulShutdown]:
  """The process-wide handler, if one was installed."""
  return _GLOBAL_SHUTDOWN
