"""Live metrics endpoint (the port's counterpart of ``tensor2robot_tpu/
observability/metricsz.py``): a stdlib ``http.server`` on a daemon thread
that serves the registry. Pure stdlib. Opt-in: nothing listens unless a
port is given (``--metricsz-port``) or ``T2R_METRICSZ_PORT`` is set; the
bind is loopback by default.

Endpoints:
  ``/metricsz``              the full ``metrics.report()`` JSON document
                             (each serving plane's section, with its
                             quantization block, as ``/statz`` serves it)
  ``/metricsz?history=1``    the time-series ring (``timeseries.py``)
  ``/metricsz?format=prom``  Prometheus/OpenMetrics text exposition
                             (:func:`prom_exposition`), histogram buckets
                             carrying their request-id exemplars
  ``/tracez``                this process's span index (``?trace_id=`` /
                             ``?request_id=``; ``?probe=1`` returns only
                             the clock and service header)
  ``/programz``              404: the compiled-program ledger
                             (``observability/programs.py``) is not
                             ported (ROADMAP.md queue 1 item 10)
  ``/healthz``               ``{"status": "ok"}``
"""

from __future__ import annotations

import http.server
import json
import logging
import math
import os
import re
import threading
import urllib.parse
from typing import List, Optional

from tensor2robot_tpu_torch.observability import metrics as metrics_lib
from tensor2robot_tpu_torch.observability import timeseries, tracing

ENV_VAR = 'T2R_METRICSZ_PORT'

PROGRAMZ_NOT_PORTED = (
    '/programz: the compiled-program ledger (observability/programs.py) is '
    'not ported: ROADMAP.md queue 1 item 10.')

_PROM_NAME_RE = re.compile(r'[^a-zA-Z0-9_:]')


def _prom_name(name: str) -> str:
  out = _PROM_NAME_RE.sub('_', name)
  if out and out[0].isdigit():
    out = '_' + out
  return out


def _prom_num(value: float) -> str:
  if isinstance(value, float) and math.isinf(value):
    return '+Inf' if value > 0 else '-Inf'
  return repr(value) if isinstance(value, float) else str(value)


_EXEMPLAR_LABEL_RE = re.compile(r'[^\x20-\x7e]')


def _exemplar_suffix(entry: Optional[tuple]) -> str:
  """The OpenMetrics exemplar clause for one bucket line, or ''.

  Format (OpenMetrics 1.0): `` # {trace_id="<label>"} <value> <ts>`` —
  the label is the request/trace id the serving plane attached to the
  observation, so scrape-side tooling can jump from a p99 bucket
  straight to ``/tracez?request_id=...``.
  """
  if not entry:
    return ''
  label, value, ts = entry
  label = _EXEMPLAR_LABEL_RE.sub('_', str(label)).replace('"', '_')[:128]
  return f' # {{trace_id="{label}"}} {_prom_num(float(value))} {ts:.3f}'


def prom_exposition(registry: Optional[metrics_lib.Registry] = None) -> str:
  """The registry as Prometheus/OpenMetrics text exposition (v0.0.4).

  Mapping: ``Counter`` → ``<name>_total`` counter; ``Gauge`` → gauge;
  ``Histogram`` → cumulative ``<name>_bucket{le="..."}`` series over the
  power-of-two buckets plus ``_sum``/``_count``, each bucket carrying
  its stored exemplar (request id + observed value + wall time) when
  one exists. Slash scopes become underscores
  (``serving/request_latency_ms`` → ``serving_request_latency_ms``).
  """
  registry = registry if registry is not None else metrics_lib.registry
  lines: List[str] = []
  for name, metric in registry.items():
    pname = _prom_name(name)
    if isinstance(metric, metrics_lib.Counter):
      lines.append(f'# TYPE {pname}_total counter')
      lines.append(f'{pname}_total {metric.value}')
    elif isinstance(metric, metrics_lib.Gauge):
      lines.append(f'# TYPE {pname} gauge')
      lines.append(f'{pname} {_prom_num(metric.value)}')
    elif isinstance(metric, metrics_lib.Histogram):
      snap = metric.snapshot()
      buckets = metric.bucket_counts()
      exemplars = metric.bucket_exemplars()
      lines.append(f'# TYPE {pname} histogram')
      cumulative = 0
      for exponent in sorted(buckets):
        cumulative += buckets[exponent]
        upper = metrics_lib.Histogram.bucket_upper(exponent)
        lines.append(
            f'{pname}_bucket{{le="{_prom_num(float(upper))}"}} {cumulative}'
            + _exemplar_suffix(exemplars.get(exponent)))
      lines.append(f'{pname}_bucket{{le="+Inf"}} {snap["count"]}')
      lines.append(f'{pname}_sum {_prom_num(float(snap["sum"]))}')
      lines.append(f'{pname}_count {snap["count"]}')
  return '\n'.join(lines) + '\n'


class _Handler(http.server.BaseHTTPRequestHandler):
  """Serves the registry snapshot; everything else 404s."""

  # Silence the default per-request stderr line (a scraper would spam
  # the training logs); failures still log through `logging`.
  def log_message(self, format, *args):  # noqa: A002 - stdlib signature
    del format, args

  def _reply(self, code: int, payload: dict) -> None:
    body = json.dumps(payload, sort_keys=True).encode()
    self.send_response(code)
    self.send_header('Content-Type', 'application/json')
    self.send_header('Content-Length', str(len(body)))
    self.end_headers()
    self.wfile.write(body)

  def _reply_text(self, code: int, text: str, content_type: str) -> None:
    body = text.encode()
    self.send_response(code)
    self.send_header('Content-Type', content_type)
    self.send_header('Content-Length', str(len(body)))
    self.end_headers()
    self.wfile.write(body)

  def do_GET(self):  # noqa: N802 - stdlib naming
    parsed = urllib.parse.urlparse(self.path)
    path = parsed.path.rstrip('/') or '/'
    query = urllib.parse.parse_qs(parsed.query)
    if path == '/metricsz':
      if query.get('format', [''])[0] == 'prom':
        self._reply_text(200, prom_exposition(),
                         'text/plain; version=0.0.4; charset=utf-8')
      elif query.get('history', [''])[0] not in ('', '0'):
        self._reply(200, timeseries.history())
      else:
        self._reply(200, metrics_lib.report())
    elif path == '/tracez':
      self._reply(200, tracing.tracez_document(
          trace_id=query.get('trace_id', [None])[0] or None,
          request_id=query.get('request_id', [None])[0] or None,
          probe_only=query.get('probe', [''])[0] not in ('', '0')))
    elif path == '/programz':
      self._reply(404, {'error': PROGRAMZ_NOT_PORTED})
    elif path == '/healthz':
      self._reply(200, {'status': 'ok'})
    else:
      self._reply(404, {'error': f'unknown path {path!r}',
                        'endpoints': ['/metricsz', '/tracez', '/healthz']})


class MetricsServer:
  """A ``/metricsz`` HTTP server on a daemon thread.

  ``port=0`` binds an ephemeral port; read the resolved one from
  ``.port`` after :meth:`start`. ``close`` is idempotent and releases
  the socket.
  """

  def __init__(self, port: int = 0, host: str = '127.0.0.1'):
    self._requested = (host, int(port))
    self._httpd: Optional[http.server.ThreadingHTTPServer] = None
    self._thread: Optional[threading.Thread] = None

  @property
  def port(self) -> Optional[int]:
    return None if self._httpd is None else self._httpd.server_address[1]

  @property
  def url(self) -> Optional[str]:
    if self._httpd is None:
      return None
    host, port = self._httpd.server_address[:2]
    return f'http://{host}:{port}/metricsz'

  def start(self) -> 'MetricsServer':
    if self._httpd is not None:
      return self
    self._httpd = http.server.ThreadingHTTPServer(self._requested, _Handler)
    self._httpd.daemon_threads = True
    self._thread = threading.Thread(
        target=self._httpd.serve_forever, kwargs={'poll_interval': 0.5},
        daemon=True, name='t2r-metricsz')
    self._thread.start()
    logging.info('Serving metrics at %s', self.url)
    return self

  def close(self) -> None:
    if self._httpd is None:
      return
    self._httpd.shutdown()
    self._httpd.server_close()
    if self._thread is not None:
      self._thread.join(timeout=5.0)
    self._httpd = None
    self._thread = None

  def __enter__(self) -> 'MetricsServer':
    return self.start()

  def __exit__(self, *exc) -> None:
    self.close()


_GLOBAL: Optional[MetricsServer] = None  # GUARDED_BY(_GLOBAL_LOCK)
_GLOBAL_LOCK = threading.Lock()


def global_server() -> Optional[MetricsServer]:
  """The process-wide server started by :func:`maybe_start`, if any."""
  with _GLOBAL_LOCK:
    return _GLOBAL


def maybe_start(port: Optional[int] = None) -> Optional[MetricsServer]:
  """Starts the process-wide ``/metricsz`` server if configured.

  ``port=None`` consults the ``T2R_METRICSZ_PORT`` env var; still-None
  means the endpoint stays off (the default). Idempotent: a second call
  returns the already-running server (a differing port logs a warning
  rather than binding a second socket — one registry, one endpoint).
  Never raises: an unbindable port degrades to a warning, because a
  metrics endpoint must not kill a training job.
  """
  global _GLOBAL
  if port is None:
    env = os.environ.get(ENV_VAR, '').strip()
    if not env:
      return None
    try:
      port = int(env)
    except ValueError:
      logging.warning('Ignoring non-integer %s=%r', ENV_VAR, env)
      return None
  with _GLOBAL_LOCK:
    if _GLOBAL is not None:
      if port not in (0, _GLOBAL.port):
        logging.warning(
            '/metricsz already serving on port %s; ignoring request for '
            'port %d.', _GLOBAL.port, port)
      return _GLOBAL
    try:
      _GLOBAL = MetricsServer(port=port).start()
    except OSError as e:
      logging.warning('Could not start /metricsz on port %d: %s', port, e)
      _GLOBAL = None
    return _GLOBAL


def stop_global() -> None:
  """Stops the process-wide server (tests, orderly shutdown)."""
  global _GLOBAL
  with _GLOBAL_LOCK:
    if _GLOBAL is not None:
      _GLOBAL.close()
      _GLOBAL = None
