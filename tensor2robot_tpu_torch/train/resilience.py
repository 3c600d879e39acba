"""The non-finite update policy: the port's counterpart of
``NonFinitePolicy`` and ``NonFiniteError`` in
``tensor2robot_tpu/train/resilience.py``.

The trainer's step computes an all-finite flag over the loss and the
gradients on the device and guards the update with it, so a NaN or Inf
batch never reaches the parameters. :class:`NonFinitePolicy` decides what
the host does about a bad step: count and skip it (halting after a run of
``halt_after`` bad steps), or raise. The counts are attributes; the JAX
package's metrics registry and flight recorder are not ported.

The port reads the flag once per step (a one-byte copy, only with the guard
on), so ``'raise'`` raises at the bad step itself, where the JAX trainer
raises one dispatch later. Either way the bad step changed nothing.
"""

from __future__ import annotations

import logging


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
      return
    self.bad_steps += count
    self.consecutive_bad += 1
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
