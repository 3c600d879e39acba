"""Device memory telemetry: the CUDA caching allocator's accounting as
registry gauges (the port's counterpart of ``tensor2robot_tpu/
observability/memory.py``, with the same keys where the card has them).

The keys, from ``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info``:

* ``bytes_in_use`` = ``allocated_bytes.all.current``;
* ``peak_bytes_in_use`` = ``allocated_bytes.all.peak``;
* ``bytes_reserved`` = ``reserved_bytes.all.current`` (what the caching
  allocator holds from CUDA);
* ``bytes_limit`` = the card's total memory.

``largest_alloc_size`` is not published: the caching allocator keeps no
such figure (its ``*.peak`` counters are totals, not the size of one
allocation). They are published as ``device/memory/*`` gauges, sampled on
every router page transition (:func:`sample_page_event`); the trainer's
memory scalars wait with its hooks (ROADMAP queue 1 item 10). A CPU device
has no allocator stats: every entry point returns None or ``{}`` there, as
the JAX module does on its CPU backend.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from tensor2robot_tpu_torch.observability import metrics as metrics_lib

_GAUGE_KEYS = ('bytes_in_use', 'peak_bytes_in_use', 'bytes_limit',
               'bytes_reserved')

SCOPE = 'device/memory'


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
  """The allocator's stats of ``device`` (default: the current CUDA
  device) under the keys above; None on a CPU device or with no card."""
  try:
    if device is None:
      if not torch.cuda.is_available():
        return None
      device = torch.device('cuda', torch.cuda.current_device())
    device = torch.device(device)
    if device.type != 'cuda':
      return None
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
  except (RuntimeError, AssertionError):
    return None
  return {
      'bytes_in_use': int(stats.get('allocated_bytes.all.current', 0)),
      'peak_bytes_in_use': int(stats.get('allocated_bytes.all.peak', 0)),
      'bytes_reserved': int(stats.get('reserved_bytes.all.current', 0)),
      'bytes_limit': int(total),
  }


def record_memory_gauges(device=None) -> Dict[str, int]:
  """Publishes the stats as ``device/memory/*`` gauges; returns them
  ({} when unavailable)."""
  stats = device_memory_stats(device)
  if not stats:
    return {}
  scope = metrics_lib.scope(SCOPE)
  out = {}
  for key in _GAUGE_KEYS:
    if key in stats:
      scope.gauge(key).set(stats[key])
      out[key] = stats[key]
  return out


def sample_page_event(device=None) -> Dict[str, int]:
  """An allocator sample at a router page-in or page-out, counted in
  ``device/memory/page_event_samples``; never raises."""
  try:
    stats = record_memory_gauges(device)
  except Exception:  # pylint: disable=broad-except
    return {}
  metrics_lib.counter('device/memory/page_event_samples').inc()
  return stats
