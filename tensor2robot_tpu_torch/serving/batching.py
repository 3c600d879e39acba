"""Dynamic cross-client batching over a stateless predictor core.

The port's counterpart of ``tensor2robot_tpu/serving/batching.py``, with
its contract unchanged: concurrent clients' requests are queued, assembled
into one padded dispatch (collect until ``max_batch`` examples or
``batch_deadline_ms``, whichever comes first), executed against the
predictor's :class:`~tensor2robot_tpu_torch.predictors.predictors.
StatelessServingFn` and split back per request.

* **Bucketed batch shapes, warmed once.** Totals are padded up to
  power-of-two buckets (up to ``max_batch``). :class:`TorchBucketExecutor`
  runs the program once at every bucket's batch when a generation is built
  (``serving/bucket_compiles``, ``serving/bucket_compile_ms``), so the
  dispatch path never meets a first-time shape: a steady plane shows the
  counter flat however the client count varies. There is no
  ``torch.compile`` and no CUDA graph here; the program runs eagerly.
* **Padding is replication** of the last example: shape-stable and
  numerically inert. Padded rows are sliced off before the split
  (``serving/padded_examples``).
* **Hot swap between dispatches.** A reload thread polls
  ``predictor.restore()``; a new generation is prepared off the dispatch
  thread (params placed, buckets warmed; a generation with the same
  ``program_key`` and param shapes inherits the warmed set) and adopted
  between two dispatches. No queued request is dropped
  (``serving/model_swaps``); a torn or broken export leaves the last good
  generation serving.
* **One dispatcher thread** does all device work; client threads only
  queue and wait. The queue is bounded (:class:`OverloadedError`).

* **Request tracing.** Every request gets an ID at submit (the HTTP
  edge's ``X-Request-Id``, else generated), which labels its latency
  exemplar and its slow-request log entry. A sampled request
  (``request_trace_sample``), and every request submitted with a
  ``trace=`` context, records its lifecycle (queued, assembled,
  dispatched, returned) in the flight ring, one lock per phase per
  dispatch; a ``trace=`` request also records request, queued and
  dispatch spans into the ``/tracez`` index under its fleet trace id.
* **Incidents.** A reload that fails, or that the predictor absorbed by
  keeping its last good generation (``predictor/load_fallbacks``), writes
  a postmortem bundle into ``postmortem_dir``.

Metrics live in the process registry under ``metrics_prefix`` (default
``serving/``; a :class:`~tensor2robot_tpu_torch.serving.router.ModelRouter`
scopes each model's batcher to ``serving/model/<name>/``), and ``report()``
is registered as the report section of that name. ``queue_depth`` and
``submit(..., on_done=...)`` are the router's hooks; the executor's
``page_out()`` keeps a host copy of the params, so a page-in is one
host-to-device copy.

* **Weight-only quantization behind a parity gate.** ``quantize='int8'``
  or ``'fp8'`` serves the predictor's quantized twin (``quantize/``),
  prepared off the dispatch thread at start and at each reload: the twin is
  checked against full precision on calibration batches
  (``quant_parity_atol`` / ``quant_parity_rtol``); outside the band it is
  refused (``serving/quant_parity_rejects``) and full precision serves, as
  it does when the preparation raises (``serving/quant_errors``). Reload
  polls compare the predictor's own generation, so a poll never
  re-quantizes.

Not ported here: the program-ledger hook (``observability/programs.py``,
ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import collections
import heapq
import itertools
import logging
import os
import threading
import time
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Set, Tuple)

import numpy as np
import torch

from tensor2robot_tpu_torch.observability import flight
from tensor2robot_tpu_torch.observability import metrics as metrics_lib
from tensor2robot_tpu_torch.observability import postmortem, tracing
from tensor2robot_tpu_torch.quantize import quantization as quant_lib
from tensor2robot_tpu_torch.specs.tensor_spec import to_numpy_dtype
from tensor2robot_tpu_torch.specs.dtypes import to_host_numpy


class ServingError(Exception):
  """Base class for serving-plane failures."""


class OverloadedError(ServingError):
  """The request queue is full (or the plane is shutting down)."""


class SheddedError(OverloadedError):
  """Admission control rejected this request; the client should back off
  ``retry_after_secs`` and retry."""

  def __init__(self, message: str, retry_after_secs: float = 1.0):
    super().__init__(message)
    self.retry_after_secs = float(retry_after_secs)


class RequestError(ServingError):
  """This request failed (bad features, dispatch error)."""


def default_buckets(max_batch: int) -> Tuple[int, ...]:
  """Powers of two up to ``max_batch`` (plus ``max_batch`` if not one)."""
  if max_batch < 1:
    raise ValueError(f'max_batch must be >= 1, got {max_batch}')
  buckets = []
  b = 1
  while b < max_batch:
    buckets.append(b)
    b *= 2
  buckets.append(max_batch)
  return tuple(buckets)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
  """Smallest bucket >= n (buckets sorted ascending)."""
  for b in buckets:
    if b >= n:
      return b
  raise ValueError(f'batch of {n} exceeds largest bucket {buckets[-1]}')


def pad_to_bucket(features: Dict[str, np.ndarray], total: int,
                  bucket: int) -> Dict[str, np.ndarray]:
  """Pads the batch dim from ``total`` to ``bucket`` by repeating the last
  example; an exact fit returns ``features`` itself."""
  if total == bucket:
    return features
  return {
      key: np.concatenate([value, np.repeat(value[-1:], bucket - total,
                                            axis=0)], axis=0)
      for key, value in features.items()
  }


class _Request:
  """One client's queued examples and its completion signal."""

  __slots__ = ('features', 'n', 'enqueue_time', 'event', 'outputs', 'error',
               'model_version', 'request_id', 'traced', 'queued_wall',
               'on_done', 'trace')

  def __init__(self, features: Dict[str, np.ndarray], n: int,
               enqueue_time: float, request_id: str = '',
               traced: bool = False,
               on_done: Optional[Callable[['_Request'], None]] = None,
               trace: Optional[tracing.TraceContext] = None):
    self.features = features
    self.n = n
    self.enqueue_time = enqueue_time
    self.event = threading.Event()
    self.outputs: Optional[Dict[str, np.ndarray]] = None
    self.error: Optional[BaseException] = None
    self.model_version: int = -1
    self.request_id = request_id
    self.traced = traced
    # The fleet trace context (trace id, upstream span id), if any.
    self.trace = trace
    # Called on the dispatcher thread after the result is published,
    # holding no batcher lock.
    self.on_done = on_done
    # Wall-clock submit time of a traced request: the dispatcher records
    # its 'queued' event with it, so client threads never touch the ring.
    self.queued_wall: float = 0.0


class ServingFuture:
  """Handle returned by :meth:`DynamicBatcher.submit`."""

  def __init__(self, request: _Request):
    self._request = request

  def result(self, timeout: Optional[float] = None) -> Dict[str, np.ndarray]:
    """Blocks for the batched dispatch; raises on failure or timeout."""
    if not self._request.event.wait(timeout):
      raise TimeoutError(
          f'serving request not completed within {timeout}s (queued '
          f'{time.monotonic() - self._request.enqueue_time:.3f}s ago)')
    if self._request.error is not None:
      raise self._request.error
    return self._request.outputs

  @property
  def model_version(self) -> int:
    return self._request.model_version

  @property
  def request_id(self) -> str:
    return self._request.request_id


def _param_signature(params) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
  """Each leaf's shapes and dtypes (a quantized leaf's payload and
  scale)."""
  return {k: tuple((tuple(t.shape), t.dtype)
                   for t in quant_lib.tensors({k: v}))
          for k, v in params.items()}


class TorchBucketExecutor:
  """One model generation on the device, served at bucketed batches.

  The generation's own device params are served; nothing is copied until
  :meth:`page_out`, which takes the host copy that :meth:`page_in` places
  back. :meth:`warm` runs the program once at each
  bucket's batch; each first run is counted in ``serving/bucket_compiles``
  and timed in ``serving/bucket_compile_ms``. A generation with the same
  ``program_key`` and param shapes inherits the warmed buckets
  (:meth:`compatible_cache`). The params may hold quantized leaves
  (``quantize.QuantizedTensor``); :attr:`param_bytes` counts what the
  device holds.
  """

  def __init__(self, serving, buckets: Sequence[int],
               compiled: Iterable[int] = (), label: str = 'serving'):
    self._fn = serving.fn
    self._label = label
    self._feature_spec = serving.feature_spec
    self._buckets = tuple(buckets)
    self.program_key = serving.program_key
    self.version = serving.version
    self.params_ref = serving.params  # identity marker for swap detection
    self.source_params_ref = serving.params
    self.source_program_key = serving.program_key
    self._device = next(quant_lib.tensors(serving.params)).device
    self._param_signature = _param_signature(serving.params)
    self.param_bytes = quant_lib.param_bytes(serving.params)
    # The page lock orders paging against dispatches: a page-out waits for
    # the dispatch in flight. Exactly one of the two is set.
    self._page_lock = threading.Lock()
    self._device_params = dict(serving.params)  # GUARDED_BY(self._page_lock)
    self._host_params = None  # GUARDED_BY(self._page_lock)
    self._compiled: Set[int] = set(compiled)  # the warmed buckets

  @property
  def device(self) -> torch.device:
    return self._device

  def compatible_cache(self, serving) -> Optional[Set[int]]:
    """The warmed buckets, iff ``serving`` runs the same program over
    params of the same shapes and dtypes (a weights-only swap)."""
    if serving.program_key != self.program_key:
      return None
    if _param_signature(serving.params) != self._param_signature:
      return None
    return set(self._compiled)

  def _zero_features(self, bucket: int) -> Dict[str, np.ndarray]:
    return {key: np.zeros((bucket,) + tuple(spec.shape),
                          dtype=to_numpy_dtype(spec.dtype))
            for key, spec in self._feature_spec.items()}

  def ensure_bucket(self, bucket: int) -> None:
    """Runs the program once at ``bucket``'s batch, the first time."""
    if bucket in self._compiled:
      return
    start = time.perf_counter()
    self._run(self._zero_features(bucket))
    self._compiled.add(bucket)
    metrics_lib.counter('serving/bucket_compiles').inc()
    metrics_lib.histogram('serving/bucket_compile_ms').observe(
        1e3 * (time.perf_counter() - start))

  def warm(self) -> None:
    for bucket in self._buckets:
      self.ensure_bucket(bucket)

  # ------------------------------------------------------------- paging

  @property
  def resident(self) -> bool:
    with self._page_lock:
      return self._device_params is not None

  def page_out(self) -> int:
    """Copies the params to the host and drops the device ones (the warmed
    buckets stay); returns the bytes released."""
    with self._page_lock:
      if self._device_params is None:
        return 0
      self._host_params = quant_lib.map_tensors(
          self._device_params, lambda t: t.detach().to('cpu', copy=True))
      self._device_params = None
      metrics_lib.counter('serving/page_outs').inc()
      flight.event('router', f'{self._label}/page_out',
                   f'version={self.version} bytes={self.param_bytes}')
      return self.param_bytes

  def page_in(self) -> bool:
    """Places the host params on the device again; True iff a copy ran."""
    with self._page_lock:
      if self._device_params is not None:
        return False
      self._page_in_locked()
      return True

  def _page_in_locked(self) -> None:  # HOLDS(self._page_lock)
    start = time.perf_counter()
    self._device_params = quant_lib.map_tensors(
        self._host_params, lambda t: t.to(self._device))
    self._host_params = None
    metrics_lib.counter('serving/page_ins').inc()
    metrics_lib.histogram('serving/page_in_ms').observe(
        1e3 * (time.perf_counter() - start))
    flight.event('router', f'{self._label}/page_in',
                 f'version={self.version} bytes={self.param_bytes}')

  # ------------------------------------------------------------ dispatch

  def _run(self, features: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self._device)
             for k, v in features.items()}
    with self._page_lock:
      if self._device_params is None:
        # A request queued for a generation paged out after admission is
        # served, not failed.
        self._page_in_locked()
      with torch.inference_mode():
        outputs = self._fn(self._device_params, batch)
    return {k: to_host_numpy(v) for k, v in outputs.items()}

  def execute(self, features: Dict[str, np.ndarray],
              bucket: int) -> Dict[str, np.ndarray]:
    """Uploads the padded batch, runs the program, returns numpy."""
    self.ensure_bucket(bucket)
    return self._run(features)


class PredictCallableExecutor:
  """Executor for a predictor without a stateless core: one ``predict()``
  per assembled batch, no buckets, no padding."""

  resident = True

  def __init__(self, predictor):
    self._predictor = predictor
    self.program_key = ('predict_callable', id(predictor))
    self.version = predictor.model_version
    self.params_ref = None
    self.param_bytes = 0

  def warm(self) -> None:
    pass

  def page_out(self) -> int:
    return 0

  def page_in(self) -> bool:
    return False

  def compatible_cache(self, serving) -> Optional[Set[int]]:
    del serving
    return None

  def execute(self, features: Dict[str, np.ndarray],
              bucket: int) -> Dict[str, np.ndarray]:
    del bucket
    return self._predictor.predict(features)


_SLOW_REQUESTS = 10  # the slow-request log's length


class DynamicBatcher:
  """Deadline-aware cross-client batch assembly and single-file dispatch.

  N client threads :meth:`submit`; one dispatcher thread assembles and
  executes; an optional reload thread prepares new generations.
  :meth:`close` drains: queued requests complete, new submits raise
  :class:`OverloadedError`.

  ``metrics_prefix`` scopes the metrics; ``register_report=False`` leaves
  ``report()`` out of ``metrics.report()`` (a router reports its batchers
  itself).
  """

  def __init__(self,
               predictor,
               max_batch: int = 64,
               batch_deadline_ms: float = 5.0,
               max_queue: int = 1024,
               reload_interval_secs: Optional[float] = None,
               quantize: str = 'off',
               quant_parity_atol: float = 0.05,
               quant_parity_rtol: float = 0.05,
               quant_calibration_batches: int = 2,
               quant_calibration_batch_size: int = 4,
               quant_skip_patterns: Sequence[str] = (),
               request_trace_sample: float = 0.0,
               postmortem_dir: Optional[str] = None,
               metrics_prefix: str = 'serving',
               register_report: bool = True):
    if max_batch < 1:
      raise ValueError(f'max_batch must be >= 1, got {max_batch}')
    if quantize not in (None, '', 'off') + quant_lib.MODES:
      raise ValueError(f"quantize must be one of 'off'/'int8'/'fp8', "
                       f'got {quantize!r}')
    self._predictor = predictor
    self._quantize = quantize if quantize not in (None, '') else 'off'
    self._quant_parity_atol = float(quant_parity_atol)
    self._quant_parity_rtol = float(quant_parity_rtol)
    self._quant_calibration_batches = int(quant_calibration_batches)
    self._quant_calibration_batch_size = int(quant_calibration_batch_size)
    self._quant_skip_patterns = tuple(quant_skip_patterns)
    self._max_batch = int(max_batch)
    self._deadline_s = float(batch_deadline_ms) / 1e3
    self._max_queue = int(max_queue)
    self._buckets = default_buckets(self._max_batch)
    self._reload_interval = reload_interval_secs
    if not 0.0 <= float(request_trace_sample) <= 1.0:
      raise ValueError(f'request_trace_sample must be in [0, 1], got '
                       f'{request_trace_sample!r}')
    self._trace_sample = float(request_trace_sample)
    # Every N-th request is traced.
    self._trace_every = (int(round(1.0 / self._trace_sample))
                         if self._trace_sample > 0 else 0)
    self._req_seq = itertools.count(1)
    self._id_prefix = f'r{os.getpid():x}'
    self._postmortem_dir = postmortem_dir
    # The span label of this batcher (the server sets 'replica-<port>');
    # None: the process's tracing.service().
    self.service_label: Optional[str] = None
    self._slow_lock = threading.Lock()
    self._slow_log: List[Tuple[float, int, Dict[str, Any]]] = []  # GUARDED_BY(self._slow_lock)

    self._cond = threading.Condition()
    self._pending: collections.deque = collections.deque()  # GUARDED_BY(self._cond)
    self._closed = False  # GUARDED_BY(self._cond)
    # The reload poller stages, the dispatcher adopts, clients read the
    # live version: all under the one condition.
    self._model = None  # GUARDED_BY(self._cond)
    self._pending_model = None  # GUARDED_BY(self._cond)
    self._feature_spec = None
    # The spec's numpy dtypes, resolved once at start: a request is
    # validated on its client's thread, which then never calls into torch.
    self._numpy_dtypes: Dict[str, np.dtype] = {}
    self._dispatcher: Optional[threading.Thread] = None
    self._reloader: Optional[threading.Thread] = None
    self._reload_stop = threading.Event()
    self._rate_window: collections.deque = collections.deque()
    self._rate_span_s = 5.0

    self._metrics_prefix = metrics_prefix.rstrip('/')
    self._register_report = bool(register_report)
    s = metrics_lib.scope(self._metrics_prefix)
    self._m_requests = s.counter('requests')
    self._m_actions = s.counter('actions')
    self._m_errors = s.counter('request_errors')
    self._m_batch_size = s.histogram('batch_size')
    self._m_latency = s.histogram('request_latency_ms')
    self._m_dispatch = s.histogram('dispatch_ms')
    self._m_padded = s.counter('padded_examples')
    self._m_dispatches = s.counter('dispatches')
    self._m_swaps = s.counter('model_swaps')
    self._m_reload_errors = s.counter('reload_errors')
    self._m_queue_depth = s.gauge('queue_depth')
    self._m_actions_per_sec = s.gauge('actions_per_sec')
    self._m_version = s.gauge('model_version')
    self._m_param_bytes = s.gauge('param_bytes')
    self._m_quant_rejects = s.counter('quant_parity_rejects')
    self._m_quant_errors = s.counter('quant_errors')
    qs = metrics_lib.scope(self._metrics_prefix + '/quant')
    self._m_quant_active = qs.gauge('active')
    self._m_quant_bytes_full = qs.gauge('param_bytes_full')
    self._m_quant_bytes_ratio = qs.gauge('param_bytes_ratio')
    self._m_quant_abs_err = qs.gauge('parity_max_abs_err')
    self._m_quant_rel_err = qs.gauge('parity_max_rel_err')
    # A committed but broken export that the predictor absorbed (it keeps
    # its last good generation) is seen only as this counter moving.
    self._m_predictor_fallbacks = metrics_lib.counter(
        'predictor/load_fallbacks')

  # ------------------------------------------------------------- lifecycle

  def start(self) -> 'DynamicBatcher':
    """Builds the executor, warms every bucket, starts the dispatcher (and
    the reload poller when ``reload_interval_secs`` is set)."""
    if self._dispatcher is not None:
      return self
    self._predictor.assert_is_loaded()
    model = self._build_executor(reuse_from=None)
    model.warm()
    with self._cond:
      self._model = model
    self._feature_spec = self._predictor.get_feature_specification()
    self._numpy_dtypes = {key: to_numpy_dtype(spec.dtype)
                          for key, spec in self._feature_spec.items()}
    self._m_version.set(float(model.version))
    self._m_param_bytes.set(float(model.param_bytes))
    self._dispatcher = threading.Thread(
        target=self._dispatch_loop, daemon=True, name='t2r-serving-dispatch')
    self._dispatcher.start()
    if self._reload_interval is not None:
      self._reloader = threading.Thread(
          target=self._reload_loop, daemon=True, name='t2r-serving-reload')
      self._reloader.start()
    if self._register_report:
      metrics_lib.register_report_provider(self._metrics_prefix, self.report)
    return self

  def close(self) -> None:
    """Orderly drain: completes queued requests, then stops the threads."""
    with self._cond:
      if self._closed:
        return
      self._closed = True
      self._cond.notify_all()
    self._reload_stop.set()
    if self._reloader is not None:
      self._reloader.join(timeout=30.0)
    if self._dispatcher is not None:
      self._dispatcher.join(timeout=60.0)
      # Only a started batcher owns its report section.
      if self._register_report:
        metrics_lib.unregister_report_provider(self._metrics_prefix)

  def __enter__(self) -> 'DynamicBatcher':
    return self.start()

  def __exit__(self, *exc) -> None:
    self.close()

  # --------------------------------------------------------------- clients

  @property
  def feature_spec(self):
    return self._feature_spec

  @property
  def model_version(self) -> int:
    with self._cond:
      model = self._model
    return -1 if model is None else int(model.version)

  @property
  def buckets(self) -> Tuple[int, ...]:
    return self._buckets

  @property
  def max_queue(self) -> int:
    return self._max_queue

  @property
  def metrics_prefix(self) -> str:
    return self._metrics_prefix

  @property
  def queue_depth(self) -> int:
    """Live pending-request count (the router's admission signal)."""
    with self._cond:
      return len(self._pending)

  def current_executor(self):
    with self._cond:
      return self._model

  def submit(self, features: Dict[str, np.ndarray],
             request_id: Optional[str] = None,
             on_done: Optional[Callable[[_Request], None]] = None,
             trace: Optional[tracing.TraceContext] = None
             ) -> ServingFuture:
    """Queues one client's examples; returns a future for the batched
    dispatch. Values carry a leading batch dim and share it (a single
    example may omit it); a request larger than ``max_batch`` is
    rejected. ``request_id`` labels the request in the latency exemplars,
    the slow-request log and its lifecycle events (generated when
    omitted). ``on_done(request)`` runs on the dispatcher thread once the
    result is published. ``trace`` (an ingress ``traceparent`` context)
    records the request's spans under the fleet trace id and traces its
    lifecycle whatever ``request_trace_sample`` is."""
    features = self._validate(features)
    sizes = {np.shape(v)[0] if np.ndim(v) else 1 for v in features.values()}
    if len(sizes) != 1:
      raise RequestError(f'inconsistent per-feature batch sizes: {sizes}')
    (n,) = sizes
    if n < 1 or n > self._max_batch:
      raise RequestError(
          f'request batch {n} outside [1, max_batch={self._max_batch}]')
    seq = next(self._req_seq)
    traced = (trace is not None or
              (bool(self._trace_every) and seq % self._trace_every == 0))
    request = _Request(features, int(n), time.monotonic(),
                       request_id=request_id or f'{self._id_prefix}-{seq}',
                       traced=traced, on_done=on_done, trace=trace)
    if traced:
      request.queued_wall = time.time()
    with self._cond:
      if self._closed:
        raise OverloadedError('serving plane is shut down')
      if len(self._pending) >= self._max_queue:
        raise OverloadedError(
            f'request queue full ({self._max_queue} requests)')
      self._pending.append(request)
      self._m_queue_depth.set(float(len(self._pending)))
      self._cond.notify_all()
    self._m_requests.inc()
    return ServingFuture(request)

  def _validate(self, features: Dict[str, np.ndarray]
                ) -> Dict[str, np.ndarray]:
    """Coerces a request at the edge: exact key set, spec dtypes,
    per-example shapes, batch dim added if omitted."""
    spec = self._feature_spec
    if spec is None:
      return features  # a submit before start() is not validated
    missing = [k for k in spec if k not in features]
    if missing:
      raise RequestError(f'missing features: {sorted(missing)}')
    out = {}
    for key, tensor_spec in spec.items():
      try:
        value = np.asarray(features[key], dtype=self._numpy_dtypes[key])
      except (TypeError, ValueError) as e:
        raise RequestError(f'feature {key!r} not coercible to '
                           f'{tensor_spec.dtype}: {e}') from e
      expected = tuple(tensor_spec.shape)
      while value.ndim < len(expected) + 1:
        value = value[None]
      if value.shape[1:] != expected:
        raise RequestError(f'feature {key!r} has per-example shape '
                           f'{value.shape[1:]}, spec requires {expected}')
      out[key] = value
    return out

  # ------------------------------------------------------------ dispatcher

  def _assemble(self) -> Optional[List[_Request]]:
    """The next batch: waits for a first request, then fills until
    ``max_batch`` examples or the deadline after assembly began. Returns
    None when closed and drained, and an empty batch when a staged
    generation waits on an idle plane (adopted without traffic)."""
    with self._cond:
      while (not self._pending and not self._closed and
             self._pending_model is None):
        self._cond.wait()
      if not self._pending:
        return None if self._closed else []
      batch: List[_Request] = []
      total = 0
      deadline = time.monotonic() + self._deadline_s
      while True:
        while self._pending:
          nxt = self._pending[0]
          if total + nxt.n > self._max_batch:
            break
          self._pending.popleft()
          batch.append(nxt)
          total += nxt.n
          if total == self._max_batch:
            break
        if total >= self._max_batch or self._closed:
          break
        if self._pending and total + self._pending[0].n > self._max_batch:
          break  # the next request only fits the following batch
        remaining = deadline - time.monotonic()
        if remaining <= 0:
          break
        self._cond.wait(timeout=remaining)
      self._m_queue_depth.set(float(len(self._pending)))
      return batch

  def _adopt_pending_model(self):
    """Takes a staged generation and makes it live, in one critical
    section (a staging between a read and a clear would be lost)."""
    with self._cond:
      pending = self._pending_model
      if pending is None:
        return None
      self._pending_model = None
      self._model = pending
    return pending

  def _dispatch_loop(self) -> None:
    while True:
      batch = self._assemble()
      if batch is None:
        return
      pending = self._adopt_pending_model()  # between dispatches only
      if pending is not None:
        self._m_swaps.inc()
        self._m_version.set(float(pending.version))
        self._m_param_bytes.set(float(pending.param_bytes))
        flight.event('swap', f'{self._metrics_prefix}/model_swap',
                     f'version={pending.version}')
        logging.info('Serving hot-swapped to model version %d',
                     pending.version)
      if batch:
        self._execute(batch)

  def _execute(self, batch: List[_Request]) -> None:
    total = sum(r.n for r in batch)
    with self._cond:
      model = self._model
    prefix = self._metrics_prefix
    traced = [r for r in batch if r.traced]
    ctx_traced = [r for r in batch if r.trace is not None]
    assembled_wall = time.time() if traced else 0.0
    if traced:
      assembled = f' batch={len(batch)} total={total}'
      entries = [('request', f'{prefix}/queued',
                  f'id={r.request_id} n={r.n}'
                  + (f' trace={r.trace.trace_id}' if r.trace else ''),
                  r.queued_wall) for r in traced]
      entries.extend(('request', f'{prefix}/assembled',
                      'id=' + r.request_id + assembled) for r in traced)
      flight.events_many(entries)
    start = time.monotonic()
    bucket = total
    try:
      if len(batch) == 1:
        features = batch[0].features
      else:
        features = {k: np.concatenate([np.asarray(r.features[k])
                                       for r in batch], axis=0)
                    for k in batch[0].features}
      if isinstance(model, TorchBucketExecutor):
        bucket = bucket_for(total, self._buckets)
        features = pad_to_bucket(features, total, bucket)
        self._m_padded.inc(bucket - total)
      if traced:
        flight.events_many([('request', f'{prefix}/dispatched',
                             f'id={r.request_id} bucket={bucket}')
                            for r in traced])
      outputs = model.execute(features, bucket)
      offset = 0
      for request in batch:
        request.outputs = {k: v[offset:offset + request.n]
                           for k, v in outputs.items()}
        request.model_version = int(model.version)
        offset += request.n
    except BaseException as e:  # pylint: disable=broad-except
      for request in batch:
        request.error = RequestError(f'batched dispatch failed: {e!r}')
      self._m_errors.inc(len(batch))
    finally:
      now = time.monotonic()
      self._m_dispatches.inc()
      self._m_dispatch.observe(1e3 * (now - start))
      self._m_batch_size.observe(total)
      self._m_actions.inc(total)
      self._note_rate(now, total)
      returned = []
      for request in batch:
        latency_ms = 1e3 * (now - request.enqueue_time)
        self._m_latency.observe(latency_ms, exemplar=request.request_id)
        self._note_slow(request, latency_ms)
        if request.traced:
          returned.append(
              ('request', f'{prefix}/returned',
               f'id={request.request_id} latency_ms={latency_ms:.3f} '
               f'error={int(request.error is not None)}'))
      flight.events_many(returned)
      if ctx_traced:
        self._record_spans(ctx_traced, len(batch), total, bucket,
                           assembled_wall)
      for request in batch:
        request.event.set()
        if request.on_done is not None:
          try:
            request.on_done(request)
          except Exception:  # pylint: disable=broad-except
            logging.exception('serving on_done callback failed')

  def _record_spans(self, requests: List[_Request], size: int, total: int,
                    bucket: int, assembled_wall: float) -> None:
    """A request span parented on the upstream hop, with its queued and
    dispatch children, for each of ``requests``; one ring lock."""
    prefix = self._metrics_prefix
    now_wall = time.time()
    span_dicts = []
    for request in requests:
      request_span = tracing.mint_span_id()
      common = {'trace_id': request.trace.trace_id, 'kind': 'serving',
                'request_id': request.request_id}
      span_dicts.append(dict(
          common, span_id=request_span, parent_id=request.trace.span_id,
          name=f'{prefix}/request', start=request.queued_wall, end=now_wall,
          detail=(f'n={request.n} version={request.model_version} '
                  f'error={int(request.error is not None)}')))
      span_dicts.append(dict(
          common, span_id=tracing.mint_span_id(), parent_id=request_span,
          name=f'{prefix}/queued', start=request.queued_wall,
          end=assembled_wall, detail=f'batch={size} total={total}'))
      span_dicts.append(dict(
          common, span_id=tracing.mint_span_id(), parent_id=request_span,
          name=f'{prefix}/dispatch', start=assembled_wall, end=now_wall,
          detail=f'bucket={bucket}'))
    tracing.record_spans(span_dicts, service_label=self.service_label)

  def _note_slow(self, request: _Request, latency_ms: float) -> None:
    """The bounded top-k-by-latency request log."""
    entry = (latency_ms, id(request), {
        'request_id': request.request_id,
        'latency_ms': round(latency_ms, 3),
        'examples': request.n,
        'model_version': request.model_version,
        'error': request.error is not None,
        'time': time.time(),
    })
    with self._slow_lock:
      if len(self._slow_log) < _SLOW_REQUESTS:
        heapq.heappush(self._slow_log, entry)
      elif latency_ms > self._slow_log[0][0]:
        heapq.heapreplace(self._slow_log, entry)

  def slow_requests(self) -> List[Dict[str, Any]]:
    """The slowest completed requests, slowest first."""
    with self._slow_lock:
      entries = [info for _, _, info in self._slow_log]
    return sorted(entries, key=lambda e: -e['latency_ms'])

  def _note_rate(self, now: float, n: int) -> None:
    window = self._rate_window
    window.append((now, n))
    while window and window[0][0] < now - self._rate_span_s:
      window.popleft()
    if len(window) > 1:
      span = max(now - window[0][0], 1e-3)
      self._m_actions_per_sec.set(sum(c for _, c in window) / span)

  # ---------------------------------------------------------------- reload

  def _build_executor(self, reuse_from):
    try:
      source = self._predictor.stateless_serving_fn()
    except NotImplementedError:
      return PredictCallableExecutor(self._predictor)
    serving = self._quantize_gate(source)
    compiled = (reuse_from.compatible_cache(serving)
                if reuse_from is not None else None)
    executor = TorchBucketExecutor(serving, self._buckets,
                                   compiled=compiled or (),
                                   label=self._metrics_prefix)
    # Reload polls compare the predictor's own generation, not the derived
    # quantized one (see _same_generation).
    executor.source_params_ref = source.params
    executor.source_program_key = source.program_key
    return executor

  def _quantize_gate(self, serving):
    """Weight-only quantization behind the parity gate, on the preparing
    thread (start or the reload poller, never the dispatcher): quantize
    the snapshot, check it against full precision on calibration batches,
    and serve it only inside the band. A band violation
    (``quant_parity_rejects``) or a preparation that raises
    (``quant_errors``) serves full precision instead."""
    mode = self._quantize
    if mode == 'off':
      return serving
    try:
      quantized = quant_lib.quantize_serving_fn(
          serving, mode=mode, skip_patterns=self._quant_skip_patterns)
      report = quant_lib.check_parity(
          serving, quantized, atol=self._quant_parity_atol,
          rtol=self._quant_parity_rtol,
          calibration_batches=self._quant_calibration_batches,
          calibration_batch_size=self._quant_calibration_batch_size)
      full_bytes = quant_lib.param_bytes(serving.params)
    except Exception as e:  # pylint: disable=broad-except
      self._m_quant_errors.inc()
      self._m_quant_active.set(0.0)
      logging.warning('Quantized (%s) serving preparation failed (%r); '
                      'serving full precision.', mode, e)
      return serving
    self._m_quant_abs_err.set(report.max_abs_err)
    self._m_quant_rel_err.set(report.max_rel_err)
    self._m_quant_bytes_full.set(float(full_bytes))
    if not report.ok:
      self._m_quant_rejects.inc()
      self._m_quant_active.set(0.0)
      logging.warning('Quantized (%s) generation refused by the parity '
                      'gate: %s; serving full precision.', mode,
                      report.describe())
      return serving
    quant_bytes = quant_lib.param_bytes(quantized.params)
    self._m_quant_bytes_ratio.set(quant_bytes / max(full_bytes, 1))
    self._m_quant_active.set(1.0)
    logging.info('Quantized (%s) serving adopted: %s; param bytes %d -> %d '
                 '(%.3fx).', mode, report.describe(), full_bytes,
                 quant_bytes, quant_bytes / max(full_bytes, 1))
    return quantized

  def maybe_reload(self) -> bool:
    """One reload poll: restore the predictor and, when a new generation
    loaded, prepare it (params placed, buckets warmed) and stage it for
    adoption between dispatches. Returns True when a swap was staged.
    Never raises: the last good generation keeps serving
    (``serving/reload_errors``). A reload that raises here, and a broken
    export the predictor absorbed, each write a postmortem bundle into
    ``postmortem_dir`` (rate-limited)."""
    fallbacks = self._m_predictor_fallbacks.value
    try:
      if not self._predictor.restore():
        self._note_predictor_fallback(fallbacks)
        return False
      with self._cond:
        current = self._pending_model or self._model
      if (int(self._predictor.model_version) == current.version and
          self._same_generation(current)):
        self._note_predictor_fallback(fallbacks)
        return False
      new_model = self._build_executor(reuse_from=current)
      new_model.warm()
      with self._cond:
        self._pending_model = new_model
        self._cond.notify_all()  # an idle plane adopts it too
      return True
    except Exception as e:  # pylint: disable=broad-except
      self._m_reload_errors.inc()
      flight.event('error', f'{self._metrics_prefix}/reload_failed', repr(e))
      logging.warning('Serving reload failed (%r); continuing on model '
                      'version %d.', e, self.model_version)
      postmortem.dump(self._postmortem_dir, 'serving_reload_failure',
                      error=e, extra={'model_version': self.model_version})
      return False

  def _note_predictor_fallback(self, fallbacks_before: int) -> None:
    """Bundles a reload that the predictor degraded to its last good
    generation internally."""
    if self._m_predictor_fallbacks.value <= fallbacks_before:
      return
    flight.event('error', f'{self._metrics_prefix}/reload_fallback',
                 f'predictor kept last-good version={self.model_version}')
    postmortem.dump(self._postmortem_dir, 'serving_reload_failure',
                    extra={'model_version': self.model_version,
                           'predictor_fallback': True})

  def _same_generation(self, current) -> bool:
    if not isinstance(current, TorchBucketExecutor):
      return True  # a callable executor follows the predictor in place
    try:
      serving = self._predictor.stateless_serving_fn()
    except NotImplementedError:
      return False
    # The source generation: under quantization the executor serves a
    # derived dict the predictor never hands out again, and matching on it
    # would re-quantize at every poll.
    return (serving.params is current.source_params_ref and
            serving.program_key == current.source_program_key)

  def _reload_loop(self) -> None:
    while not self._reload_stop.wait(self._reload_interval):
      self.maybe_reload()

  # ------------------------------------------------------------- reporting

  def report(self) -> Dict[str, Any]:
    """The plane's section of ``metrics.report()`` (keyed by
    ``metrics_prefix``)."""
    p = self._metrics_prefix
    snap = metrics_lib.snapshot(p + '/')
    latency = snap.get(f'{p}/request_latency_ms', {}) or {}
    return {
        'request_trace_sample': self._trace_sample,
        'request_latency_exemplars': latency.get('exemplars', {}),
        'slow_requests': self.slow_requests(),
        'max_batch': self._max_batch,
        'batch_deadline_ms': self._deadline_s * 1e3,
        'buckets': list(self._buckets),
        'model_version': self.model_version,
        'queue_depth': snap.get(f'{p}/queue_depth', 0.0),
        'requests': snap.get(f'{p}/requests', 0),
        'request_errors': snap.get(f'{p}/request_errors', 0),
        'actions': snap.get(f'{p}/actions', 0),
        'actions_per_sec': snap.get(f'{p}/actions_per_sec', 0.0),
        'request_latency_ms_p50': latency.get('p50', 0.0),
        'request_latency_ms_p99': latency.get('p99', 0.0),
        'batch_size': snap.get(f'{p}/batch_size', {}),
        'dispatches': snap.get(f'{p}/dispatches', 0),
        'padded_examples': snap.get(f'{p}/padded_examples', 0),
        'model_swaps': snap.get(f'{p}/model_swaps', 0),
        'reload_errors': snap.get(f'{p}/reload_errors', 0),
        'bucket_compiles': metrics_lib.counter(
            'serving/bucket_compiles').value,
        'param_bytes': int(snap.get(f'{p}/param_bytes', 0.0)),
        'quantize': self._quantize,
        'quantized_active': bool(snap.get(f'{p}/quant/active', 0.0)),
        'quant_parity_rejects': snap.get(f'{p}/quant_parity_rejects', 0),
        'quant_errors': snap.get(f'{p}/quant_errors', 0),
        'quant_param_bytes_full': int(
            snap.get(f'{p}/quant/param_bytes_full', 0.0)),
        'quant_param_bytes_ratio': snap.get(
            f'{p}/quant/param_bytes_ratio', 0.0),
        'quant_parity_max_abs_err': snap.get(
            f'{p}/quant/parity_max_abs_err', 0.0),
        'quant_parity_max_rel_err': snap.get(
            f'{p}/quant/parity_max_rel_err', 0.0),
    }
