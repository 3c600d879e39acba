"""Front-door balancer: M serving replicas behind one stdlib HTTP door
(the port's counterpart of ``tensor2robot_tpu/serving/balancer.py``, with
the same pick, health, retry and header contract).

A ``ThreadingHTTPServer`` whose handler threads proxy ``POST`` bodies to
backend replicas over keep-alive ``http.client`` connections.

* **Least-outstanding pick.** The next request goes to the healthy
  backend with the fewest requests in flight (ties by index).
* **Health ejection and readmission.** A poller GETs every backend's
  ``/healthz``; ``eject_after`` consecutive failures eject it
  (``balancer/ejections``), ``readmit_after`` consecutive successes admit
  it again. A transport failure mid-request counts as a health failure at
  once. The first probe round runs synchronously in :meth:`Balancer.start`,
  so the initial health is evidence, not an assumption. :meth:`quarantine`
  ejects a backend that probes cannot readmit until :meth:`readmit`.
* **Retry, not drop.** A transport failure (refused or reset connection:
  a restarting replica) retries on the next-best backend, since predict
  is idempotent; a 503 (shedding or draining) retries on an untried
  backend too, and only the last 503 is relayed. A rolling restart of the
  replicas thus fails no client request.
* **Request ID and trace propagation.** The client's ``X-Request-Id`` (or
  one the balancer mints) is forwarded and echoed on every reply, any
  status; a retried request keeps one ID. A client ``traceparent`` records
  a ``balancer/proxy`` span and one ``balancer/attempt`` span per backend
  tried, each attempt forwarding its own span id downstream.

``GET /healthz`` answers for the balancer (200 iff at least one backend
is healthy), ``GET /statz`` returns its report with the fleet-wide
slow-request log merged from every healthy backend's ``/statz``, and
``GET /tracez`` its span index. Metrics live under ``balancer/*``;
ejections and readmissions land in the flight ring (kind ``'balancer'``).
"""

from __future__ import annotations

import collections
import http.client
import http.server
import itertools
import json
import logging
import os
import threading
import time
import urllib.parse
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from tensor2robot_tpu_torch.observability import flight
from tensor2robot_tpu_torch.observability import metrics as metrics_lib
from tensor2robot_tpu_torch.observability import tracing

# Headers copied from the client request onto the proxied request.
_FORWARD_HEADERS = ('Content-Type', 'X-Priority')
_TRANSPORT_ERRORS = (ConnectionError, http.client.HTTPException, OSError)


class _Backend:
  """One replica's balancer-side state (mutable fields guarded by the
  owning balancer's lock)."""

  __slots__ = ('host', 'port', 'index', 'healthy', 'outstanding',
               'consecutive_failures', 'consecutive_successes',
               'proxied', 'ejections', 'quarantined', 'latency_ms')

  def __init__(self, host: str, port: int, index: int):
    self.host = host
    self.port = int(port)
    self.index = index
    self.healthy = True  # GUARDED_BY(balancer lock)
    self.outstanding = 0  # GUARDED_BY(balancer lock)
    self.consecutive_failures = 0  # GUARDED_BY(balancer lock)
    self.consecutive_successes = 0  # GUARDED_BY(balancer lock)
    self.proxied = 0  # GUARDED_BY(balancer lock)
    self.ejections = 0  # GUARDED_BY(balancer lock)
    # Actuator-forced ejection: /healthz success must NOT readmit.
    self.quarantined = False  # GUARDED_BY(balancer lock)
    # Rolling proxied-request latencies (status 200 only), for report().
    self.latency_ms = collections.deque(maxlen=64)  # GUARDED_BY(balancer lock)

  @property
  def address(self) -> str:
    return f'{self.host}:{self.port}'


class _Handler(http.server.BaseHTTPRequestHandler):
  """Proxies predict POSTs; answers balancer-local GETs."""

  protocol_version = 'HTTP/1.1'

  def log_message(self, format, *args):  # noqa: A002 - stdlib signature
    del format, args

  @property
  def _balancer(self) -> 'Balancer':
    return self.server.balancer  # type: ignore[attr-defined]

  def _reply(self, code: int, payload: Union[bytes, Dict[str, Any]],
             request_id: Optional[str] = None,
             retry_after: Optional[str] = None,
             content_type: str = 'application/json') -> None:
    body = (payload if isinstance(payload, bytes)
            else json.dumps(payload).encode())
    self.send_response(code)
    self.send_header('Content-Type', content_type)
    self.send_header('Content-Length', str(len(body)))
    if request_id:
      self.send_header('X-Request-Id', request_id)
    if retry_after:
      self.send_header('Retry-After', retry_after)
    self.end_headers()
    try:
      self.wfile.write(body)
    except (BrokenPipeError, ConnectionResetError):
      pass

  def do_GET(self):  # noqa: N802 - stdlib naming
    parsed = urllib.parse.urlparse(self.path)
    path = parsed.path.rstrip('/') or '/'
    query = urllib.parse.parse_qs(parsed.query)
    if path == '/healthz':
      healthy = self._balancer.healthy_backend_count()
      code = 200 if healthy else 503
      self._reply(code, {'status': 'ok' if healthy else 'no_backends',
                         'backends_healthy': healthy,
                         'backends_total': self._balancer.backend_count()})
    elif path == '/statz':
      self._reply(200, self._balancer.report())
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

  def do_POST(self):  # noqa: N802 - stdlib naming
    balancer = self._balancer
    path = self.path.split('?', 1)[0]
    rid = ((self.headers.get('X-Request-Id') or '').strip()
           or balancer.mint_request_id())
    trace = tracing.parse_traceparent(
        self.headers.get(tracing.TRACEPARENT_HEADER))
    try:
      length = int(self.headers.get('Content-Length', 0))
    except (TypeError, ValueError):
      length = 0
    body = self.rfile.read(length) if length else b''
    headers = {'X-Request-Id': rid}
    for name in _FORWARD_HEADERS:
      value = self.headers.get(name)
      if value:
        headers[name] = value
    status, payload, retry_after = balancer.proxy(
        path, body, headers, trace=trace, request_id=rid)
    self._reply(status, payload, request_id=rid, retry_after=retry_after)


class Balancer:
  """Least-outstanding front door over ``backends`` (host:port pairs).

  ``backends`` accepts ``'host:port'`` strings or ``(host, port)``
  tuples. ``port=0`` binds an ephemeral front-door port (read ``.port``
  after :meth:`start`).
  """

  def __init__(self,
               backends: Sequence[Union[str, Tuple[str, int]]],
               port: int = 0,
               host: str = '127.0.0.1',
               health_interval_secs: float = 0.5,
               eject_after: int = 2,
               readmit_after: int = 1,
               proxy_timeout_secs: float = 30.0,
               retry_after_secs: float = 1.0,
               register_report: bool = True,
               fleet_slow_k: int = 10):
    if not backends:
      raise ValueError('Balancer needs at least one backend')
    self._lock = threading.Lock()
    self._backends: List[_Backend] = []
    for i, spec in enumerate(backends):
      if isinstance(spec, str):
        bhost, _, bport = spec.rpartition(':')
        if not bhost or not bport.isdigit():
          raise ValueError(f'backend {spec!r} is not host:port')
        self._backends.append(_Backend(bhost, int(bport), i))
      else:
        bhost, bport = spec
        self._backends.append(_Backend(bhost, int(bport), i))
    self._requested = (host, int(port))
    self._health_interval = float(health_interval_secs)
    self._eject_after = max(1, int(eject_after))
    self._readmit_after = max(1, int(readmit_after))
    self._proxy_timeout = float(proxy_timeout_secs)
    self._retry_after = str(max(1, int(round(retry_after_secs))))
    self._register_report = bool(register_report)
    self._fleet_slow_k = max(0, int(fleet_slow_k))
    # Span-index attribution label; refined with the bound port at start.
    self._service = 'balancer'
    self._req_seq = itertools.count(1)
    self._id_prefix = f'lb{os.getpid():x}'
    # Per-(thread, backend) keep-alive connections; a proxy thread
    # reuses its connection to a backend across requests.
    self._local = threading.local()
    self._httpd: Optional[http.server.ThreadingHTTPServer] = None
    self._thread: Optional[threading.Thread] = None
    self._health_stop = threading.Event()
    self._health_thread: Optional[threading.Thread] = None

    s = metrics_lib.scope('balancer')
    self._m_requests = s.counter('requests')
    self._m_proxied = s.counter('proxied')
    self._m_retries = s.counter('retries')
    self._m_transport_errors = s.counter('transport_errors')
    self._m_no_backend = s.counter('no_backend_503')
    self._m_ejections = s.counter('ejections')
    self._m_readmissions = s.counter('readmissions')
    self._m_eject_refused = s.counter('eject_refusals')
    self._m_healthy = s.gauge('backends_healthy')

  # ------------------------------------------------------------- lifecycle

  def start(self) -> 'Balancer':
    if self._httpd is not None:
      return self
    # One synchronous probe round BEFORE the front door opens: the
    # initial health state is evidence, not optimism — a balancer that
    # starts before its replicas finish warming must say so on /healthz
    # rather than advertise a fleet that refuses connections.
    for backend in self._backends:
      ok = self._probe(backend)
      with self._lock:
        backend.healthy = ok
        backend.consecutive_successes = 1 if ok else 0
        backend.consecutive_failures = 0 if ok else 1
    self._m_healthy.set(float(self.healthy_backend_count()))
    self._httpd = http.server.ThreadingHTTPServer(self._requested, _Handler)
    self._httpd.daemon_threads = True
    self._httpd.balancer = self  # type: ignore[attr-defined]
    self._service = f'balancer-{self._httpd.server_address[1]}'
    self._thread = threading.Thread(
        target=self._httpd.serve_forever, kwargs={'poll_interval': 0.2},
        daemon=True, name='t2r-balancer-http')
    self._thread.start()
    self._health_thread = threading.Thread(
        target=self._health_loop, daemon=True, name='t2r-balancer-health')
    self._health_thread.start()
    if self._register_report:
      metrics_lib.register_report_provider('balancer', self.report)
    logging.info('Balancer listening at %s over %s', self.url,
                 [b.address for b in self._backends])
    return self

  def close(self) -> None:
    self._health_stop.set()
    if self._health_thread is not None:
      self._health_thread.join(timeout=10.0)
      self._health_thread = None
    if self._httpd is not None:
      self._httpd.shutdown()
      self._httpd.server_close()
      if self._thread is not None:
        self._thread.join(timeout=10.0)
      self._httpd = None
      self._thread = None
      if self._register_report:
        metrics_lib.unregister_report_provider('balancer')

  def __enter__(self) -> 'Balancer':
    return self.start()

  def __exit__(self, *exc) -> None:
    self.close()

  @property
  def port(self) -> Optional[int]:
    return None if self._httpd is None else self._httpd.server_address[1]

  @property
  def url(self) -> Optional[str]:
    if self._httpd is None:
      return None
    host, port = self._httpd.server_address[:2]
    return f'http://{host}:{port}'

  def mint_request_id(self) -> str:
    return f'{self._id_prefix}-{next(self._req_seq)}'

  # ---------------------------------------------------------------- policy

  def backend_count(self) -> int:
    return len(self._backends)

  def healthy_backend_count(self) -> int:
    with self._lock:
      return sum(1 for b in self._backends if b.healthy)

  def quarantine(self, index: int, reason: str = '') -> bool:
    """Actuator-forced ejection of backend ``index``.

    Unlike a health-loop ejection, a quarantined backend is NOT
    re-admitted by clean ``/healthz`` probes — only :meth:`readmit`
    releases it (the actuator's probation policy owns that decision).
    REFUSED (returns False, flight ``balancer/eject_refused``) when the
    target is the last healthy backend: graceful degradation beats a
    self-inflicted total outage.
    """
    with self._lock:
      if not 0 <= index < len(self._backends):
        return False
      backend = self._backends[index]
      if backend.quarantined:
        return False
      healthy_others = sum(1 for b in self._backends
                           if b.healthy and b is not backend)
      refused = backend.healthy and healthy_others == 0
      if not refused:
        if backend.healthy:
          backend.ejections += 1
        backend.healthy = False
        backend.quarantined = True
      healthy = sum(1 for b in self._backends if b.healthy)
    if refused:
      self._m_eject_refused.inc()
      flight.event('balancer', 'balancer/eject_refused',
                   f'backend={backend.address} last_healthy=1 '
                   f'reason={reason}')
      logging.warning('Balancer REFUSED ejecting last healthy backend %s '
                      '(%s)', backend.address, reason)
      return False
    self._m_ejections.inc()
    self._m_healthy.set(float(healthy))
    flight.event('balancer', 'balancer/eject',
                 f'backend={backend.address} forced=1 healthy={healthy} '
                 f'reason={reason}')
    logging.warning('Balancer quarantined backend %s (%s)',
                    backend.address, reason)
    return True

  def readmit(self, index: int, reason: str = '') -> bool:
    """Releases a quarantined backend back into the pick set."""
    with self._lock:
      if not 0 <= index < len(self._backends):
        return False
      backend = self._backends[index]
      if not backend.quarantined:
        return False
      backend.quarantined = False
      backend.healthy = True
      backend.consecutive_failures = 0
      backend.consecutive_successes = 0
      healthy = sum(1 for b in self._backends if b.healthy)
    self._m_readmissions.inc()
    self._m_healthy.set(float(healthy))
    flight.event('balancer', 'balancer/readmit',
                 f'backend={backend.address} forced=1 healthy={healthy} '
                 f'reason={reason}')
    logging.info('Balancer re-admitted quarantined backend %s (%s)',
                 backend.address, reason)
    return True

  def _pick(self, tried: set) -> Optional[_Backend]:
    """Healthy, untried backend with the fewest outstanding requests."""
    with self._lock:
      candidates = [b for b in self._backends
                    if b.healthy and b.index not in tried]
      if not candidates:
        return None
      best = min(candidates, key=lambda b: (b.outstanding, b.index))
      best.outstanding += 1
      best.proxied += 1
      return best

  def _release(self, backend: _Backend) -> None:
    with self._lock:
      backend.outstanding -= 1

  def _note_transport_failure(self, backend: _Backend) -> None:
    """A mid-request connection failure: immediate health evidence."""
    self._m_transport_errors.inc()
    self._note_health(backend, ok=False)

  def _note_health(self, backend: _Backend, ok: bool) -> None:
    with self._lock:
      if ok:
        backend.consecutive_failures = 0
        backend.consecutive_successes += 1
        # A quarantined backend stays out however clean its probes:
        # only an explicit readmit() (actuator probation) releases it.
        transition = (not backend.healthy and not backend.quarantined and
                      backend.consecutive_successes >= self._readmit_after)
        if transition:
          backend.healthy = True
      else:
        backend.consecutive_successes = 0
        backend.consecutive_failures += 1
        transition = (backend.healthy and
                      backend.consecutive_failures >= self._eject_after)
        if transition:
          backend.healthy = False
          backend.ejections += 1
      healthy = sum(1 for b in self._backends if b.healthy)
    self._m_healthy.set(float(healthy))
    if transition:
      if ok:
        self._m_readmissions.inc()
        flight.event('balancer', 'balancer/readmit',
                     f'backend={backend.address} healthy={healthy}')
        logging.info('Balancer re-admitted backend %s', backend.address)
      else:
        self._m_ejections.inc()
        flight.event('balancer', 'balancer/eject',
                     f'backend={backend.address} healthy={healthy}')
        logging.warning('Balancer ejected backend %s', backend.address)

  # ----------------------------------------------------------------- proxy

  def _connection(self, backend: _Backend) -> http.client.HTTPConnection:
    pool = getattr(self._local, 'conns', None)
    if pool is None:
      pool = self._local.conns = {}
    conn = pool.get(backend.index)
    if conn is None:
      conn = http.client.HTTPConnection(
          backend.host, backend.port, timeout=self._proxy_timeout)
      pool[backend.index] = conn
    return conn

  def _drop_connection(self, backend: _Backend) -> None:
    pool = getattr(self._local, 'conns', None)
    if pool is not None:
      conn = pool.pop(backend.index, None)
      if conn is not None:
        conn.close()

  def proxy(self, path: str, body: bytes, headers: Dict[str, str],
            trace: Optional[tracing.TraceContext] = None,
            request_id: str = ''
            ) -> Tuple[int, bytes, Optional[str]]:
    """One client request → (status, body, retry_after_header).

    Walks healthy backends best-first: transport failures and 503s move
    on to the next untried backend; the final result (or the last 503,
    or a 502/503 when nothing answered) is relayed.

    ``trace`` records a ``balancer/proxy`` span plus one
    ``balancer/attempt`` span per backend tried (each forwarding ITS
    span id downstream as the new ``traceparent`` parent), so a
    failed-over request's assembled timeline shows every replica it
    touched.
    """
    self._m_requests.inc()
    if trace is None:
      return self._proxy_walk(path, body, headers, None, '', request_id)
    proxy_span = tracing.mint_span_id()
    start = time.time()
    result: Optional[Tuple[int, bytes, Optional[str]]] = None
    try:
      result = self._proxy_walk(path, body, headers, trace, proxy_span,
                                request_id)
      return result
    finally:
      status = result[0] if result is not None else 502
      tracing.record_span(
          'balancer/proxy', 'balancer', trace.trace_id, proxy_span,
          trace.span_id, start, time.time(), request_id=request_id,
          detail=f'status={status}', service_label=self._service)

  def _note_attempt_span(self, trace: Optional[tracing.TraceContext],
                         proxy_span: str, attempt_span: str,
                         attempt_start: float, backend: _Backend,
                         outcome: str, request_id: str) -> None:
    if trace is None:
      return
    tracing.record_span(
        'balancer/attempt', 'balancer', trace.trace_id, attempt_span,
        proxy_span, attempt_start, time.time(), request_id=request_id,
        detail=f'backend={backend.address} {outcome}',
        service_label=self._service)

  def _proxy_walk(self, path: str, body: bytes, headers: Dict[str, str],
                  trace: Optional[tracing.TraceContext], proxy_span: str,
                  request_id: str) -> Tuple[int, bytes, Optional[str]]:
    tried: set = set()
    last_503: Optional[Tuple[int, bytes, Optional[str]]] = None
    while True:
      backend = self._pick(tried)
      if backend is None:
        if last_503 is not None:
          return last_503
        if tried:
          return (502, json.dumps(
              {'error': f'all {len(tried)} backend(s) unreachable'}
          ).encode(), self._retry_after)
        self._m_no_backend.inc()
        return (503, json.dumps({'error': 'no healthy backends'}).encode(),
                self._retry_after)
      tried.add(backend.index)
      attempt_headers = headers
      attempt_span = ''
      attempt_start = 0.0
      if trace is not None:
        # Each attempt forwards its OWN span id: the backend's ingress
        # span parents on the attempt that actually reached it.
        attempt_span = tracing.mint_span_id()
        attempt_start = time.time()
        attempt_headers = dict(headers)
        attempt_headers[tracing.TRACEPARENT_HEADER] = (
            tracing.format_traceparent(
                tracing.TraceContext(trace.trace_id, attempt_span)))
      proxy_t0 = time.monotonic()
      try:
        try:
          status, payload, retry_after = self._proxy_once(
              backend, path, body, attempt_headers)
          self._note_attempt_span(trace, proxy_span, attempt_span,
                                  attempt_start, backend,
                                  f'status={status}', request_id)
          if status == 200:
            # Completed-request latency only: sheds are fast by design
            # and would dilute the fleet-relative anomaly signal.
            elapsed_ms = (time.monotonic() - proxy_t0) * 1000.0
            with self._lock:
              backend.latency_ms.append(elapsed_ms)
        except _TRANSPORT_ERRORS as e:
          self._note_attempt_span(trace, proxy_span, attempt_span,
                                  attempt_start, backend,
                                  f'error={type(e).__name__}', request_id)
          self._drop_connection(backend)
          self._note_transport_failure(backend)
          self._m_retries.inc()
          logging.warning('Balancer proxy to %s failed (%r); failing over.',
                          backend.address, e)
          continue
      finally:
        self._release(backend)
      if status == 503:
        # Shedding/draining is replica-local: another replica may admit.
        last_503 = (status, payload, retry_after)
        self._m_retries.inc()
        continue
      self._m_proxied.inc()
      return status, payload, retry_after

  def _proxy_once(self, backend: _Backend, path: str, body: bytes,
                  headers: Dict[str, str]
                  ) -> Tuple[int, bytes, Optional[str]]:
    conn = self._connection(backend)
    conn.request('POST', path, body=body, headers=headers)
    response = conn.getresponse()
    payload = response.read()
    return response.status, payload, response.getheader('Retry-After')

  # ---------------------------------------------------------------- health

  def _health_loop(self) -> None:
    while not self._health_stop.wait(self._health_interval):
      for backend in self._backends:
        ok = self._probe(backend)
        self._note_health(backend, ok=ok)

  def _probe(self, backend: _Backend) -> bool:
    conn = None
    try:
      # A fresh connection per probe: the health signal must see the
      # listener, not a stale keep-alive socket.
      conn = http.client.HTTPConnection(
          backend.host, backend.port,
          timeout=max(self._health_interval, 0.5))
      conn.request('GET', '/healthz')
      response = conn.getresponse()
      response.read()
      return response.status == 200
    except _TRANSPORT_ERRORS:
      return False
    finally:
      if conn is not None:
        conn.close()

  # ------------------------------------------------------------- reporting

  def fleet_slow_requests(self, k: Optional[int] = None
                          ) -> List[Dict[str, Any]]:
    """Top-k slowest completed requests FLEET-WIDE, with attribution.

    Scrapes every healthy backend's ``/statz`` (bounded per-backend
    timeout, fresh connections — a slow replica must not wedge the
    front door's own report), collects each plane's bounded
    slow-request log (single-model ``slow_requests`` or the router's
    per-model logs), tags every entry with its backend address (and
    model), and merges by latency. One front-door scrape thus names the
    worst requests anywhere in the fleet.
    """
    k = self._fleet_slow_k if k is None else int(k)
    if k <= 0:
      return []
    with self._lock:
      backends = [(b.address, b.host, b.port)
                  for b in self._backends if b.healthy]
    merged: List[Dict[str, Any]] = []
    for address, host, port in backends:
      conn = None
      try:
        conn = http.client.HTTPConnection(
            host, port, timeout=max(self._health_interval, 0.5))
        conn.request('GET', '/statz')
        response = conn.getresponse()
        doc = json.loads(response.read())
      except _TRANSPORT_ERRORS + (ValueError,):
        continue
      finally:
        if conn is not None:
          conn.close()
      for entry in doc.get('slow_requests') or []:
        merged.append(dict(entry, backend=address))
      for model, sub in (doc.get('models') or {}).items():
        if not isinstance(sub, dict):
          continue
        for entry in sub.get('slow_requests') or []:
          merged.append(dict(entry, backend=address, model=model))
    merged.sort(key=lambda e: -float(e.get('latency_ms', 0.0)))
    return merged[:k]

  def report(self) -> Dict[str, Any]:
    snap = metrics_lib.snapshot('balancer/')
    with self._lock:
      backends = [{
          'address': b.address,
          'healthy': b.healthy,
          'quarantined': b.quarantined,
          'outstanding': b.outstanding,
          'proxied': b.proxied,
          'ejections': b.ejections,
          'consecutive_failures': b.consecutive_failures,
          'latency_ms_mean': (sum(b.latency_ms) / len(b.latency_ms)
                              if b.latency_ms else 0.0),
      } for b in self._backends]
    return {
        'backends': backends,
        'backends_healthy': sum(1 for b in backends if b['healthy']),
        'fleet_slow_requests': self.fleet_slow_requests(),
        'requests': snap.get('balancer/requests', 0),
        'proxied': snap.get('balancer/proxied', 0),
        'retries': snap.get('balancer/retries', 0),
        'transport_errors': snap.get('balancer/transport_errors', 0),
        'no_backend_503': snap.get('balancer/no_backend_503', 0),
        'ejections': snap.get('balancer/ejections', 0),
        'readmissions': snap.get('balancer/readmissions', 0),
        'eject_refusals': snap.get('balancer/eject_refusals', 0),
        'eject_after': self._eject_after,
        'readmit_after': self._readmit_after,
        'health_interval_secs': self._health_interval,
    }


def wait_healthy(balancer: Balancer, min_backends: int,
                 timeout_secs: float = 10.0) -> bool:
  """Test/deploy helper: block until ≥ ``min_backends`` are healthy."""
  deadline = time.monotonic() + timeout_secs
  while time.monotonic() < deadline:
    if balancer.healthy_backend_count() >= min_backends:
      return True
    time.sleep(0.05)
  return balancer.healthy_backend_count() >= min_backends
