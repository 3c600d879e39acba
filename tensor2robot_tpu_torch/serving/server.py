"""HTTP front door for the batched serving plane (the port's counterpart
of ``tensor2robot_tpu/serving/server.py``, with the same JSON contract,
status codes and headers).

A stdlib ``http.server.ThreadingHTTPServer`` on daemon threads. A
connection thread only parses JSON and waits on a :class:`~
tensor2robot_tpu_torch.serving.batching.ServingFuture`; all device work
stays on the batcher's single dispatcher thread, so N concurrent clients
become one padded dispatch per assembly window. The server fronts one
model (``ServingServer(predictor, ...)``) or a whole :class:`~
tensor2robot_tpu_torch.serving.router.ModelRouter` (``ServingServer(
router=router, ...)``).

Endpoints:

* ``POST /v1/predict``: body ``{"features": {<name>: <nested lists>}}``
  (a bare feature dict is accepted too). Each feature carries a leading
  batch dim shared across features; a single example may omit it. Reply:
  ``{"outputs": {...}, "model_version": N, "examples": n, "request_id":
  "..."}``. An ``X-Request-Id`` request header becomes the request's ID
  (else one is generated), echoed as the same response header on every
  status.
* ``POST /v1/models/<name>/predict``: the same against a named model
  (router mode).
* ``X-Priority: interactive|best_effort``: the admission class (router
  mode; default ``interactive``). Best-effort traffic is shed first under
  queue pressure: 503 with ``Retry-After``.
* ``traceparent``: a W3C trace context; the ingress span and the
  batcher's spans go into ``/tracez`` under its trace id.
* ``GET /healthz``: liveness and the loaded model version(s).
* ``GET /statz``: the plane's report (with the SLO engine's section when
  one runs), including the slow-request log and latency exemplars; router
  mode nests per-model sections and the paging and admission figures.
* ``GET /tracez``: this process's span index.

Status codes: 400 malformed request, 404 unknown path or model, 503 shed,
queue full or shutting down (with ``Retry-After``), 504 request timed out
in the plane, 500 dispatch failure.

A JSON body is parsed with ``json.loads`` and each feature with
``np.asarray``: a uint8 frame sent as nested lists arrives as int64 and is
cast back to the spec's dtype by the batcher, value for value. A body of
``wire.MIN_BYTES`` or more is decoded in a decoder process
(:class:`~tensor2robot_tpu_torch.serving.wire.DecoderPool`), so a full-
width frame's decode does not hold the interpreter lock that the
dispatcher and ``/healthz`` need; a decoder that dies answers 500.
"""

from __future__ import annotations

import http.server
import json
import logging
import math
import threading
import time
import urllib.parse
from typing import Any, Dict, Optional

import numpy as np

from tensor2robot_tpu_torch.observability import slo as slo_lib
from tensor2robot_tpu_torch.observability import timeseries, tracing
from tensor2robot_tpu_torch.serving import batching as batching_lib
from tensor2robot_tpu_torch.serving import wire

COMPILATION_CACHE_NOT_PORTED = (
    'compilation_cache_dir: an exported torch program runs eagerly and '
    'has no compiled form to cache; a captured CUDA graph per bucket is '
    'ROADMAP.md queue 1 item 6.')
_MODELS_PREFIX = '/v1/models/'
_PREDICT_SUFFIX = '/predict'


class _PlaneHTTPServer(http.server.ThreadingHTTPServer):
  """The listener, counting the predict requests in its handler threads.

  Handler threads are daemons, so the process does not wait for an idle
  keep-alive connection at exit; but a daemon thread still inside torch
  (a page-in on the submit path) when the interpreter finalizes aborts the
  process. :meth:`refuse_requests` and :meth:`wait_idle` let ``close()``
  turn later predicts away with a 503 and wait for those in flight.
  """

  daemon_threads = True

  def __init__(self, address, handler):
    super().__init__(address, handler)
    self._requests = threading.Condition()
    self._in_flight = 0  # GUARDED_BY(self._requests)
    self._refusing = False  # GUARDED_BY(self._requests)

  def begin_request(self) -> bool:
    """False once the server refuses requests; else counts one in."""
    with self._requests:
      if self._refusing:
        return False
      self._in_flight += 1
      return True

  def end_request(self) -> None:
    with self._requests:
      self._in_flight -= 1
      self._requests.notify_all()

  def refuse_requests(self) -> None:
    with self._requests:
      self._refusing = True

  def wait_idle(self, timeout: float) -> bool:
    with self._requests:
      return self._requests.wait_for(lambda: self._in_flight == 0, timeout)


class _Handler(http.server.BaseHTTPRequestHandler):
  """Thin JSON adapter over the batcher/router; never touches the device."""

  protocol_version = 'HTTP/1.1'  # keep-alive: clients reuse connections

  def log_message(self, format, *args):  # noqa: A002 - stdlib signature
    del format, args  # a load test would spam one line per request

  def _reply(self, code: int, payload: Dict[str, Any],
             request_id: Optional[str] = None,
             retry_after_secs: Optional[float] = None) -> None:
    body = json.dumps(payload).encode()
    self.send_response(code)
    self.send_header('Content-Type', 'application/json')
    self.send_header('Content-Length', str(len(body)))
    if request_id:
      self.send_header('X-Request-Id', request_id)
    if retry_after_secs is not None:
      self.send_header('Retry-After',
                       str(max(1, int(math.ceil(retry_after_secs)))))
    self.end_headers()
    try:
      self.wfile.write(body)
    except (BrokenPipeError, ConnectionResetError):
      pass  # client gave up; the batch result is already accounted

  def do_GET(self):  # noqa: N802 - stdlib naming
    parsed = urllib.parse.urlparse(self.path)
    path = parsed.path.rstrip('/') or '/'
    query = urllib.parse.parse_qs(parsed.query)
    router = self.server.router  # type: ignore[attr-defined]
    batcher = self.server.batcher  # type: ignore[attr-defined]
    if path == '/healthz':
      if router is not None:
        versions = router.versions()
        self._reply(200, {'status': 'ok', 'models': versions,
                          'model_version': versions.get(
                              router.default_model, -1)})
      else:
        self._reply(200, {'status': 'ok',
                          'model_version': batcher.model_version})
    elif path == '/statz':
      plane = router if router is not None else batcher
      doc = plane.report()
      engine = slo_lib.global_engine()
      if engine is not None:
        doc['slo'] = engine.report()
      self._reply(200, doc)
    elif path == '/tracez':
      self._reply(200, tracing.tracez_document(
          trace_id=query.get('trace_id', [None])[0] or None,
          request_id=query.get('request_id', [None])[0] or None,
          probe_only=query.get('probe', [''])[0] not in ('', '0')))
    else:
      self._reply(404, {'error': f'unknown path {path!r}',
                        'endpoints': ['/v1/predict',
                                      '/v1/models/<name>/predict',
                                      '/healthz', '/statz', '/tracez']})

  def _route(self, path: str) -> Optional[str]:
    """Predict path → model name ('' = default) or None (not predict)."""
    if path == '/v1/predict':
      return ''
    if path.startswith(_MODELS_PREFIX) and path.endswith(_PREDICT_SUFFIX):
      name = path[len(_MODELS_PREFIX):-len(_PREDICT_SUFFIX)]
      if name and '/' not in name:
        return name
    return None

  def do_POST(self):  # noqa: N802 - stdlib naming
    if not self.server.begin_request():  # type: ignore[attr-defined]
      self.close_connection = True
      self._reply(503, {'error': 'serving plane is shutting down'},
                  request_id=(self.headers.get('X-Request-Id') or '').strip(),
                  retry_after_secs=1.0)
      return
    try:
      self._predict()
    finally:
      self.server.end_request()  # type: ignore[attr-defined]

  def _predict(self) -> None:
    path = self.path.split('?', 1)[0].rstrip('/')
    # Ingress request ID: honor the client's X-Request-Id (distributed-
    # trace convention) or let the batcher mint one; either way it is
    # echoed on EVERY reply below so the client can quote it.
    request_id = (self.headers.get('X-Request-Id') or '').strip() or None
    # Ingress trace context: a traceparent header puts this request's
    # ingress span (and the batcher's request/queued/dispatch spans
    # below it) into the process /tracez index under the fleet-wide
    # trace id — every status, including sheds: the failed replica of a
    # retried request must show up in the assembled timeline.
    ctx = tracing.parse_traceparent(
        self.headers.get(tracing.TRACEPARENT_HEADER))
    ingress_start = time.time() if ctx else 0.0
    ingress_span = tracing.mint_span_id() if ctx else ''

    def reply(code, payload, request_id=None, **kwargs):
      self._reply(code, payload, request_id=request_id, **kwargs)
      if ctx is not None:
        tracing.record_span(
            'server/request', 'server', ctx.trace_id, ingress_span,
            ctx.span_id, ingress_start, time.time(),
            request_id=request_id or '',
            detail=f'status={code} path={path}',
            service_label=getattr(self.server, 'service_label', None))

    model = self._route(path)
    if model is None:
      reply(404, {'error': f'unknown path {path!r}'},
            request_id=request_id)
      return
    priority = (self.headers.get('X-Priority') or '').strip() or None
    try:
      length = int(self.headers.get('Content-Length', 0))
      features = self.server.decoders.decode(  # type: ignore[attr-defined]
          self.rfile.read(length))
    except (ValueError, TypeError) as e:
      reply(400, {'error': f'malformed request: {e}'},
            request_id=request_id)
      return
    except wire.DecoderExitedError as e:
      reply(500, {'error': str(e)}, request_id=request_id)
      return
    router = self.server.router  # type: ignore[attr-defined]
    child_ctx = (tracing.TraceContext(ctx.trace_id, ingress_span)
                 if ctx is not None else None)
    try:
      if router is not None:
        future = router.submit(
            features, model=model or None,
            priority=priority or 'interactive', request_id=request_id,
            trace=child_ctx)
      else:
        if model or (priority not in (None, 'interactive')):
          # A single-model plane has no router: a named model or a
          # non-default priority class is a contract the caller holds
          # that this server cannot honor — fail loudly, don't ignore.
          reply(
              404 if model else 400,
              {'error': 'this server fronts a single model with no '
                        'admission classes (no router configured)'},
              request_id=request_id)
          return
        future = self.server.batcher.submit(  # type: ignore[attr-defined]
            features, request_id=request_id, trace=child_ctx)
    except batching_lib.SheddedError as e:
      reply(503, {'error': str(e), 'shed': True},
            request_id=request_id,
            retry_after_secs=e.retry_after_secs)
      return
    except batching_lib.OverloadedError as e:
      reply(503, {'error': str(e)}, request_id=request_id,
            retry_after_secs=1.0)
      return
    except batching_lib.RequestError as e:
      reply(400, {'error': str(e)}, request_id=request_id)
      return
    request_id = future.request_id
    timeout = self.server.request_timeout_secs  # type: ignore[attr-defined]
    try:
      outputs = future.result(timeout=timeout)
    except TimeoutError as e:
      reply(504, {'error': str(e)}, request_id=request_id)
      return
    except batching_lib.ServingError as e:
      reply(500, {'error': str(e)}, request_id=request_id)
      return
    examples = next(iter(outputs.values())).shape[0] if outputs else 0
    reply(200, {
        'outputs': {k: np.asarray(v).tolist() for k, v in outputs.items()},
        'model_version': future.model_version,
        'examples': int(examples),
        'request_id': request_id,
    }, request_id=request_id)


class ServingServer:
  """Batcher/router + HTTP server lifecycle as one unit.

  ``port=0`` binds an ephemeral port (read ``.port``/``.url`` after
  :meth:`start`); the bind is loopback by default — serving beyond the
  host is an operator decision via ``host=``. ``close()`` is orderly:
  the listener stops, queued requests drain, the last response leaves
  before threads die.

  Single-model: ``ServingServer(predictor, **batcher_kwargs)`` (knobs:
  ``max_batch``, ``batch_deadline_ms``, ``max_queue``,
  ``reload_interval_secs``, ``quantize='int8'``/``'fp8'`` with its
  ``quant_parity_*`` band, ... — see :class:`~tensor2robot_tpu_torch.
  serving.batching.DynamicBatcher`). Multi-model: ``ServingServer(router=
  ModelRouter(...))`` — the router owns its batchers; batcher kwargs are
  rejected here (configure them on the router).
  """

  def __init__(self,
               predictor=None,
               port: int = 0,
               host: str = '127.0.0.1',
               request_timeout_secs: float = 30.0,
               compilation_cache_dir: Optional[str] = None,
               timeseries_interval_secs: float = 10.0,
               router=None,
               **batcher_kwargs):
    if (predictor is None) == (router is None):
      raise ValueError('pass exactly one of predictor= or router=')
    if router is not None and batcher_kwargs:
      raise ValueError(
          f'batcher kwargs {sorted(batcher_kwargs)} are configured on the '
          'ModelRouter, not the server, in router mode')
    if compilation_cache_dir:
      raise NotImplementedError(COMPILATION_CACHE_NOT_PORTED)
    # Metrics history for /metricsz?history=1 and postmortem bundles
    # (0 disables; idempotent process-global recorder).
    timeseries.maybe_start(timeseries_interval_secs or None)
    self._router = router
    self._batcher = (None if router is not None else
                     batching_lib.DynamicBatcher(predictor,
                                                 **batcher_kwargs))
    self._requested = (host, int(port))
    self._request_timeout_secs = request_timeout_secs
    self._httpd: Optional[_PlaneHTTPServer] = None
    self._thread: Optional[threading.Thread] = None

  @property
  def batcher(self) -> Optional[batching_lib.DynamicBatcher]:
    return self._batcher

  @property
  def router(self):
    return self._router

  @property
  def port(self) -> Optional[int]:
    return None if self._httpd is None else self._httpd.server_address[1]

  @property
  def url(self) -> Optional[str]:
    if self._httpd is None:
      return None
    host, port = self._httpd.server_address[:2]
    return f'http://{host}:{port}'

  def start(self) -> 'ServingServer':
    if self._httpd is not None:
      return self
    if self._router is not None:
      self._router.start()
    else:
      self._batcher.start()
    self._httpd = _PlaneHTTPServer(self._requested, _Handler)
    self._httpd.batcher = self._batcher  # type: ignore[attr-defined]
    self._httpd.router = self._router  # type: ignore[attr-defined]
    self._httpd.request_timeout_secs = (  # type: ignore[attr-defined]
        self._request_timeout_secs)
    self._httpd.decoders = wire.DecoderPool()  # type: ignore[attr-defined]
    # Fleet-timeline attribution: this replica's spans (ingress + its
    # batchers') carry one service label, so an assembled cross-process
    # trace names WHICH replica served (or refused) each hop — even when
    # several replicas share one test process and its span index.
    service = f'replica-{self.port}'
    self._httpd.service_label = service  # type: ignore[attr-defined]
    if self._router is not None:
      for name in self._router.models():
        self._router.batcher(name).service_label = service
    else:
      self._batcher.service_label = service
    self._thread = threading.Thread(
        target=self._httpd.serve_forever, kwargs={'poll_interval': 0.2},
        daemon=True, name='t2r-serving-http')
    self._thread.start()
    if self._router is not None:
      logging.info('Serving plane listening at %s (models=%s)',
                   self.url, self._router.models())
    else:
      logging.info(
          'Serving plane listening at %s (max_batch=%d, deadline=%.1fms, '
          'buckets=%s)', self.url, self._batcher._max_batch,  # pylint: disable=protected-access
          self._batcher._deadline_s * 1e3, list(self._batcher.buckets))  # pylint: disable=protected-access
    return self

  def close(self) -> None:
    """The listener stops, later predicts on open connections get 503,
    the plane drains its queue, and the predicts in flight finish their
    replies before this returns (no handler thread is left in the plane
    when the process exits)."""
    httpd = self._httpd
    if httpd is not None:
      httpd.shutdown()
      httpd.refuse_requests()
    if self._router is not None:
      self._router.close()
    else:
      self._batcher.close()
    if httpd is not None:
      if not httpd.wait_idle(self._request_timeout_secs):
        logging.warning('Predicts still in flight at close.')
      httpd.decoders.close()  # type: ignore[attr-defined]
      httpd.server_close()
      if self._thread is not None:
        self._thread.join(timeout=10.0)
      self._httpd = None
      self._thread = None

  def __enter__(self) -> 'ServingServer':
    return self.start()

  def __exit__(self, *exc) -> None:
    self.close()
