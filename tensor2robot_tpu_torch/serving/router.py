"""Multi-model router: N export roots, one card, one memory budget (the
port's counterpart of ``tensor2robot_tpu/serving/router.py``, with the
same admission, paging order, metrics and report).

A :class:`ModelRouter` owns one :class:`~tensor2robot_tpu_torch.serving.
batching.DynamicBatcher` per model, each with its own metric scope
(``serving/model/<name>/*``), reload poller and warmed buckets, and adds:

* **LRU model paging under a device-memory byte budget.** The params of a
  model that has not served recently leave the card
  (``TorchBucketExecutor.page_out``) while the host copy and the warmed
  buckets stay, so a page-in is one host-to-device copy, never a reload
  and never a new program (``serving/bucket_compiles`` stays flat).
  Accounting is the executors' own ``param_bytes``, checked against
  ``hbm_budget_bytes`` on every routed submit; the ``device/memory/*``
  gauges (``observability/memory.py``) are the allocator's side, sampled
  at each page transition. A model with queued work is evicted only when
  no idle one is left, and a model is never evicted to admit itself.
* **Priority-class admission.** A request is ``'interactive'`` (the robot
  control tier) or ``'best_effort'`` (offline eval, batch scoring). A
  best-effort request is shed with :class:`~tensor2robot_tpu_torch.serving.
  batching.SheddedError` (HTTP 503 + ``Retry-After``) once its model's
  queue holds ``shed_queue_fraction * max_queue`` requests; interactive is
  refused only by the hard ``max_queue`` bound. Per-class metrics live
  under ``serving/class/<priority>/*``, the total under
  ``serving/shed_requests``.

Every page-in, page-out, shed and budget change lands in the flight ring
(kind ``'router'``).
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from tensor2robot_tpu_torch.observability import flight
from tensor2robot_tpu_torch.observability import memory as memory_lib
from tensor2robot_tpu_torch.observability import metrics as metrics_lib
from tensor2robot_tpu_torch.serving import batching as batching_lib

INTERACTIVE = 'interactive'
BEST_EFFORT = 'best_effort'
# Shed order: later classes shed first. Interactive is never shed by
# policy — only the hard queue bound refuses it.
PRIORITIES = (INTERACTIVE, BEST_EFFORT)


class _ModelEntry:
  """One routed model: its batcher + LRU bookkeeping."""

  __slots__ = ('name', 'batcher', 'last_used')

  def __init__(self, name: str, batcher: batching_lib.DynamicBatcher):
    self.name = name
    self.batcher = batcher
    self.last_used = 0  # GUARDED_BY(router._lock)


class ModelRouter:
  """Routes requests across N models sharing one device.

  ``predictors`` maps model name → predictor (each typically an
  ``ExportedModelPredictor`` over its own export root). Batcher knobs
  (``max_batch``, ``batch_deadline_ms``, ``reload_interval_secs``,
  ``quantize=...``, ...) pass through ``**batcher_kwargs`` and apply to
  every model's batcher; a quantized model's ``param_bytes`` is its
  payload's, which is what the paging budget counts.

  ``hbm_budget_bytes=None`` disables paging (every model stays
  resident). With a budget, models are paged LRU so the resident set's
  summed ``param_bytes`` fits; requests for a paged-out model page it
  back in on the submit path (a host-to-device copy).
  """

  def __init__(self,
               predictors: Dict[str, Any],
               hbm_budget_bytes: Optional[int] = None,
               default_model: Optional[str] = None,
               shed_queue_fraction: float = 0.25,
               retry_after_secs: float = 1.0,
               metrics_prefix: str = 'serving',
               register_report: bool = True,
               **batcher_kwargs):
    if not predictors:
      raise ValueError('ModelRouter needs at least one model')
    if not 0.0 < shed_queue_fraction <= 1.0:
      raise ValueError(f'shed_queue_fraction must be in (0, 1], got '
                       f'{shed_queue_fraction!r}')
    self._metrics_prefix = metrics_prefix.rstrip('/')
    self._register_report = bool(register_report)
    self._hbm_budget = (None if hbm_budget_bytes is None
                        else int(hbm_budget_bytes))
    self._retry_after = float(retry_after_secs)
    self._entries: Dict[str, _ModelEntry] = {}
    for name in predictors:
      if '/' in name or not name:
        raise ValueError(f'model name {name!r} must be a non-empty '
                         'slash-free segment (it scopes metric names)')
      self._entries[name] = _ModelEntry(
          name,
          batching_lib.DynamicBatcher(
              predictors[name],
              metrics_prefix=f'{self._metrics_prefix}/model/{name}',
              register_report=False,
              **batcher_kwargs))
    self._default = default_model or next(iter(self._entries))
    if self._default not in self._entries:
      raise ValueError(f'default model {self._default!r} not among '
                       f'{sorted(self._entries)}')
    any_batcher = next(iter(self._entries.values())).batcher
    self._shed_at = max(1, int(round(
        shed_queue_fraction * any_batcher.max_queue)))
    # LRU clock: monotone use sequence, bumped on every submit.
    self._lock = threading.Lock()
    self._use_seq = itertools.count(1)
    self._started = False  # GUARDED_BY(self._lock)

    s = metrics_lib.scope(self._metrics_prefix)
    self._m_shed = s.counter('shed_requests')
    rs = s.scope('router')
    self._m_models = rs.gauge('models')
    self._m_resident = rs.gauge('models_resident')
    self._m_budget = rs.gauge('hbm_budget_bytes')
    self._m_resident_bytes = rs.gauge('hbm_resident_bytes')
    self._m_budget_overruns = rs.counter('budget_overruns')
    self._class_requests: Dict[str, metrics_lib.Counter] = {}
    self._class_ok: Dict[str, metrics_lib.Counter] = {}
    self._class_shed: Dict[str, metrics_lib.Counter] = {}
    self._class_errors: Dict[str, metrics_lib.Counter] = {}
    self._class_latency: Dict[str, metrics_lib.Histogram] = {}
    for priority in PRIORITIES:
      cs = s.scope(f'class/{priority}')
      self._class_requests[priority] = cs.counter('requests')
      self._class_ok[priority] = cs.counter('ok')
      self._class_shed[priority] = cs.counter('shed')
      self._class_errors[priority] = cs.counter('errors')
      self._class_latency[priority] = cs.histogram('latency_ms')

  # ------------------------------------------------------------- lifecycle

  def start(self) -> 'ModelRouter':
    """Starts every model's batcher (warming all buckets), then enforces
    the HBM budget — a budget that fits K of N models leaves exactly the
    K most recently started resident."""
    with self._lock:
      if self._started:
        return self
      self._started = True
    for entry in self._entries.values():
      entry.batcher.start()
      with self._lock:
        entry.last_used = next(self._use_seq)
    with self._lock:
      paged = self._enforce_budget_locked(keep=None)
      self._publish_residency_locked()
    if paged:
      memory_lib.sample_page_event()
    self._m_models.set(float(len(self._entries)))
    self._m_budget.set(float(self._hbm_budget or 0))
    if self._register_report:
      metrics_lib.register_report_provider(self._metrics_prefix, self.report)
    return self

  def close(self) -> None:
    for entry in self._entries.values():
      entry.batcher.close()
    with self._lock:
      started = self._started
      self._started = False
    if started and self._register_report:
      metrics_lib.unregister_report_provider(self._metrics_prefix)

  def __enter__(self) -> 'ModelRouter':
    return self.start()

  def __exit__(self, *exc) -> None:
    self.close()

  # --------------------------------------------------------------- clients

  @property
  def default_model(self) -> str:
    return self._default

  @property
  def shed_at(self) -> int:
    """Best-effort sheds at this many queued requests (per model)."""
    return self._shed_at

  def models(self) -> List[str]:
    return sorted(self._entries)

  def versions(self) -> Dict[str, int]:
    return {name: entry.batcher.model_version
            for name, entry in self._entries.items()}

  def batcher(self, model: Optional[str] = None
              ) -> batching_lib.DynamicBatcher:
    return self._resolve(model).batcher

  def model_version(self, model: Optional[str] = None) -> int:
    return self._resolve(model).batcher.model_version

  def _resolve(self, model: Optional[str]) -> _ModelEntry:
    name = model or self._default
    entry = self._entries.get(name)
    if entry is None:
      raise batching_lib.RequestError(
          f'unknown model {name!r}; serving {sorted(self._entries)}')
    return entry

  def submit(self,
             features: Dict[str, Any],
             model: Optional[str] = None,
             priority: str = INTERACTIVE,
             request_id: Optional[str] = None,
             trace=None) -> batching_lib.ServingFuture:
    """Admission → paging → the model's batcher.

    Raises :class:`~tensor2robot_tpu_torch.serving.batching.RequestError` for
    an unknown model/priority or a malformed request,
    :class:`~tensor2robot_tpu_torch.serving.batching.SheddedError` when
    admission control sheds this priority class, and the batcher's
    ``OverloadedError`` at the hard queue bound.
    """
    entry = self._resolve(model)
    if priority not in PRIORITIES:
      raise batching_lib.RequestError(
          f'unknown priority {priority!r}; classes: {list(PRIORITIES)}')
    self._class_requests[priority].inc()
    if priority != INTERACTIVE:
      depth = entry.batcher.queue_depth
      if depth >= self._shed_at:
        self._m_shed.inc()
        self._class_shed[priority].inc()
        flight.event(
            'router', f'{self._metrics_prefix}/shed',
            f'model={entry.name} priority={priority} depth={depth} '
            f'shed_at={self._shed_at}')
        raise batching_lib.SheddedError(
            f'best-effort request shed: model {entry.name!r} queue depth '
            f'{depth} >= {self._shed_at} (retry after '
            f'{self._retry_after:.1f}s)',
            retry_after_secs=self._retry_after)
    self._touch_and_page(entry)
    return entry.batcher.submit(
        features, request_id=request_id, trace=trace,
        on_done=self._completion_hook(priority))

  def _completion_hook(self, priority: str) -> Callable:
    latency = self._class_latency[priority]
    ok = self._class_ok[priority]
    errors = self._class_errors[priority]

    def on_done(request) -> None:
      # enqueue_time is on the batcher's clock, time.monotonic.
      latency.observe(1e3 * (time.monotonic() - request.enqueue_time),
                      exemplar=request.request_id)
      (errors if request.error is not None else ok).inc()

    return on_done

  # ---------------------------------------------------------------- paging

  def _touch_and_page(self, entry: _ModelEntry) -> None:
    """Marks ``entry`` most-recently-used, re-enforces the HBM budget,
    and pages the target in when an earlier eviction left it host-only.

    Enforcement runs on EVERY routed submit, not just on page-in: a hot
    model swap places the new generation's params on device off-thread
    (so adoption never stalls a dispatch), which can transiently push
    the resident set over budget — the next submit converges it.
    """
    paged = 0
    with self._lock:
      entry.last_used = next(self._use_seq)
      executor = entry.batcher.current_executor()
      if executor is None or self._hbm_budget is None:
        return
      resident = getattr(executor, 'resident', True)
      paged = self._enforce_budget_locked(
          keep=entry, incoming=0 if resident else int(executor.param_bytes))
      if not resident:
        executor.page_in()
        paged += 1
      self._publish_residency_locked()
    if paged:
      # Residency just changed: refresh the allocator-truth gauges
      # (device/memory/*) outside the lock, so hbm_resident_bytes and
      # the backend's own accounting stay cross-checkable at exactly
      # the moments they move (observability/memory.py).
      memory_lib.sample_page_event()

  def _residency_locked(self):  # HOLDS(self._lock)
    """(entry, executor, bytes) for every currently resident model."""
    out = []
    for entry in self._entries.values():
      executor = entry.batcher.current_executor()
      if executor is not None and getattr(executor, 'resident', True):
        out.append((entry, executor, int(executor.param_bytes)))
    return out

  def _enforce_budget_locked(self, keep: Optional[_ModelEntry],
                             incoming: int = 0) -> int:  # HOLDS(self._lock)
    """Pages out LRU residents until ``incoming`` more bytes fit;
    returns the number of page-outs taken.

    Victims are idle models (no queued work) in LRU order; ``keep`` (the
    model being paged in) is never a victim. If every candidate is busy
    the budget is overrun rather than torn mid-dispatch (counted:
    ``serving/router/budget_overruns``).
    """
    if self._hbm_budget is None:
      return 0
    resident = self._residency_locked()
    used = sum(b for _, _, b in resident)
    if used + incoming <= self._hbm_budget:
      return 0
    victims = sorted(
        (x for x in resident if x[0] is not keep and x[2] > 0),
        key=lambda x: x[0].last_used)
    # Idle victims first: paging out a model with queued requests would
    # only bounce straight back in via the dispatcher's auto page-in.
    victims.sort(key=lambda x: (x[0].batcher.queue_depth > 0,
                                x[0].last_used))
    paged_out = 0
    for entry, executor, nbytes in victims:
      if used + incoming <= self._hbm_budget:
        break
      executor.page_out()
      paged_out += 1
      used -= nbytes
    if used + incoming > self._hbm_budget:
      self._m_budget_overruns.inc()
      logging.warning(
          'HBM budget overrun: %d resident + %d incoming > budget %d '
          '(all candidate victims busy).', used, incoming, self._hbm_budget)
    return paged_out

  def _publish_residency_locked(self) -> None:  # HOLDS(self._lock)
    resident = self._residency_locked()
    self._m_resident.set(float(len(resident)))
    self._m_resident_bytes.set(float(sum(b for _, _, b in resident)))

  def resident_models(self) -> List[str]:
    with self._lock:
      return sorted(e.name for e, _, _ in self._residency_locked())

  def resident_bytes(self) -> int:
    with self._lock:
      return sum(b for _, _, b in self._residency_locked())

  @property
  def hbm_budget(self) -> Optional[int]:
    with self._lock:
      return self._hbm_budget

  def set_hbm_budget(self, nbytes: Optional[int]) -> None:
    """Re-splits the paging budget at runtime (the actuator surface).

    ``None`` disables paging. A shrink is enforced immediately (LRU
    page-outs down to the new budget); a grow takes effect lazily as
    requests page models back in. The re-split lands in the flight ring
    (kind ``'router'``) so postmortems show budget moves on the request
    timeline.
    """
    nbytes = None if nbytes is None else int(nbytes)
    with self._lock:
      old = self._hbm_budget
      if nbytes == old:
        return
      self._hbm_budget = nbytes
      paged = self._enforce_budget_locked(keep=None)
      self._publish_residency_locked()
    if paged:
      memory_lib.sample_page_event()
    self._m_budget.set(float(nbytes or 0))
    flight.event('router', f'{self._metrics_prefix}/router/budget_resplit',
                 f'old={old} new={nbytes}')
    logging.info('Router HBM budget re-split: %s -> %s bytes', old, nbytes)

  # ------------------------------------------------------------- reporting

  def report(self) -> Dict[str, Any]:
    """Router section for ``/metricsz`` (registered under
    ``metrics_prefix``): per-model sub-reports + paging/admission SLOs."""
    p = self._metrics_prefix
    snap = metrics_lib.snapshot(p + '/')
    classes = {}
    for priority in PRIORITIES:
      latency = snap.get(f'{p}/class/{priority}/latency_ms', {}) or {}
      classes[priority] = {
          'requests': snap.get(f'{p}/class/{priority}/requests', 0),
          'ok': snap.get(f'{p}/class/{priority}/ok', 0),
          'shed': snap.get(f'{p}/class/{priority}/shed', 0),
          'errors': snap.get(f'{p}/class/{priority}/errors', 0),
          'latency_ms_p50': latency.get('p50', 0.0),
          'latency_ms_p99': latency.get('p99', 0.0),
      }
    with self._lock:
      resident = {e.name for e, _, _ in self._residency_locked()}
    return {
        'models': {name: dict(entry.batcher.report(),
                              resident=name in resident)
                   for name, entry in self._entries.items()},
        'default_model': self._default,
        'hbm_budget_bytes': self._hbm_budget,
        'hbm_resident_bytes': snap.get(f'{p}/router/hbm_resident_bytes',
                                       0.0),
        'models_resident': sorted(resident),
        'page_ins': metrics_lib.counter('serving/page_ins').value,
        'page_outs': metrics_lib.counter('serving/page_outs').value,
        'budget_overruns': snap.get(f'{p}/router/budget_overruns', 0),
        'shed_requests': snap.get(f'{p}/shed_requests', 0),
        'shed_at_queue_depth': self._shed_at,
        'classes': classes,
    }


def round_robin_models(models: Sequence[str]) -> Callable[[int], str]:
  """index → model name, cycling (loadgen/bench convenience)."""
  models = list(models)

  def pick(index: int) -> str:
    return models[index % len(models)]

  return pick
