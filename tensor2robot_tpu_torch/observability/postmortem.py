"""Postmortem bundles: one JSON file that says what a process was doing
(the port's counterpart of ``tensor2robot_tpu/observability/
postmortem.py``, with the same bundle document). Pure stdlib.

:func:`dump` writes ``<model_dir>/postmortem/<ts>-<pid>-<reason>.json``
with the flight ring's last window, the full ``metrics.report()``, the
metrics time-series window, the last dispatch-breakdown windows, the
topology and the error. ``live=True`` marks a bundle from a process that
keeps running (an SLO burn alert, an anomaly); the serving batcher dumps
one when a reload falls back to the last good generation. Render with
``tools/postmortem.py``.

``dump`` never raises, skips quietly without a directory, writes
atomically (tmp + rename) and is rate-limited to one bundle per
(directory, reason) per :data:`MIN_INTERVAL_SECS`, so a poller retrying a
broken export coalesces into one bundle.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
from typing import Any, Dict, Optional

from tensor2robot_tpu_torch.observability import flight
from tensor2robot_tpu_torch.observability import metrics as metrics_lib
from tensor2robot_tpu_torch.observability import timeseries

__all__ = [
    'dump', 'note_breakdown_window', 'breakdown_windows',
    'POSTMORTEM_DIRNAME', 'DEFAULT_WINDOW_SECS', 'MIN_INTERVAL_SECS',
]

POSTMORTEM_DIRNAME = 'postmortem'
DEFAULT_WINDOW_SECS = 300.0
MIN_INTERVAL_SECS = 30.0
_BREAKDOWN_WINDOWS = 16

_lock = threading.Lock()
_last_dump: Dict[tuple, float] = {}  # GUARDED_BY(_lock)
_windows: 'collections.deque' = collections.deque(  # GUARDED_BY(_lock)
    maxlen=_BREAKDOWN_WINDOWS)


def note_breakdown_window(scalars: Dict[str, float]) -> None:
  """Retains one closed dispatch-breakdown window (bounded ring)."""
  entry = {'time': time.time()}
  entry.update({k: float(v) for k, v in scalars.items()})
  with _lock:
    _windows.append(entry)


def breakdown_windows() -> list:
  with _lock:
    return list(_windows)


def _should_dump(directory: str, reason: str) -> bool:
  key = (os.path.abspath(directory), reason)
  now = time.monotonic()
  with _lock:
    last = _last_dump.get(key)
    if last is not None and now - last < MIN_INTERVAL_SECS:
      return False
    _last_dump[key] = now
    return True


def _reset_rate_limit_for_tests() -> None:
  with _lock:
    _last_dump.clear()
    _windows.clear()


def dump(model_dir: Optional[str],
         reason: str,
         exit_code: Optional[int] = None,
         error: Optional[BaseException] = None,
         topology: Optional[Dict[str, Any]] = None,
         extra: Optional[Dict[str, Any]] = None,
         window_secs: float = DEFAULT_WINDOW_SECS,
         live: bool = False) -> Optional[str]:
  """Writes one bundle; returns its path, or None when skipped (no
  directory, rate-limited, or the write failed: logged, never raised)."""
  if not model_dir:
    return None
  try:
    if not _should_dump(model_dir, reason):
      return None
    bundle = {
        'kind': 'postmortem',
        'version': 1,
        'reason': reason,
        'live': bool(live),
        'exit_code': exit_code,
        'time': time.time(),
        'pid': os.getpid(),
        'window_secs': window_secs,
        'error': None if error is None else {
            'type': type(error).__name__,
            'message': str(error)[:2000],
        },
        'topology': topology,
        'events': flight.events(last_secs=window_secs),
        'breakdown_windows': breakdown_windows(),
        'timeseries': timeseries.history(last_secs=window_secs),
        'metrics_report': metrics_lib.report(),
    }
    if extra:
      bundle['extra'] = extra
    directory = os.path.join(model_dir, POSTMORTEM_DIRNAME)
    os.makedirs(directory, exist_ok=True)
    stamp = time.strftime('%Y%m%dT%H%M%S', time.gmtime())
    path = os.path.join(directory, f'{stamp}-{os.getpid()}-{reason}.json')
    tmp = f'{path}.tmp{os.getpid()}'
    with open(tmp, 'w') as f:
      json.dump(bundle, f, indent=2, sort_keys=True, default=str)
      f.write('\n')
    os.replace(tmp, path)
    logging.warning('Postmortem bundle written: %s (reason: %s).',
                    path, reason)
    return path
  except Exception:  # pylint: disable=broad-except
    logging.exception('Postmortem dump failed (non-fatal).')
    return None
