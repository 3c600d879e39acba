"""Front-door balancer binary: M serving replicas behind one address.

Proxies ``POST /v1/predict`` and ``/v1/models/<name>/predict`` to the
healthy replica with the fewest outstanding requests, ejects replicas
whose ``/healthz`` fails and readmits them when it recovers. Transport
failures and 503s fail over to the next replica, so a rolling restart of
the replicas (``run_serving`` drains on SIGTERM) fails no client request.
``X-Request-Id``, ``X-Priority`` and ``traceparent`` are forwarded; the
request ID is echoed on every status.

Usage:
  python -m tensor2robot_tpu_torch.bin.run_balancer \\
      --backend 10.0.0.1:8000 --backend 10.0.0.2:8000 --port 9000

``GET /healthz`` answers for the balancer (200 iff a replica is healthy),
``GET /statz`` the per-replica health, outstanding requests and traffic
with the fleet-wide slow-request log, ``GET /tracez`` its span index. Once
listening it prints one JSON line on stdout, ``{"ready": true, "url": ...,
"port": ...}`` (for ``--port 0``); SIGTERM/SIGINT stops it with exit 0.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import sys
import threading


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--backend', action='append', default=[],
                      metavar='HOST:PORT', required=True,
                      help='Repeatable: one serving replica.')
  parser.add_argument('--port', type=int, default=9000,
                      help='Listening port; 0 lets the kernel choose.')
  parser.add_argument('--host', default='127.0.0.1',
                      help='Bind address; loopback by default.')
  parser.add_argument('--health-interval-secs', type=float, default=0.5,
                      help='Backend /healthz poll cadence.')
  parser.add_argument('--eject-after', type=int, default=2,
                      help='Consecutive health failures before ejection.')
  parser.add_argument('--readmit-after', type=int, default=1,
                      help='Consecutive health successes before '
                           'readmission.')
  parser.add_argument('--proxy-timeout-secs', type=float, default=30.0)
  parser.add_argument('--fleet-slow-k', type=int, default=10,
                      help='Rows of the /statz fleet-wide slow-request '
                           'merge (0 disables the backend scrape).')
  parser.add_argument('--metricsz-port', type=int, default=None,
                      help='Also serve the metrics registry at /metricsz.')
  args = parser.parse_args(argv)
  logging.basicConfig(
      level=logging.INFO,
      format='%(asctime)s %(levelname)s %(name)s: %(message)s')

  from tensor2robot_tpu_torch.observability import metricsz  # pylint: disable=import-outside-toplevel
  from tensor2robot_tpu_torch.serving import Balancer  # pylint: disable=import-outside-toplevel

  balancer = Balancer(
      args.backend,
      port=args.port,
      host=args.host,
      health_interval_secs=args.health_interval_secs,
      eject_after=args.eject_after,
      readmit_after=args.readmit_after,
      proxy_timeout_secs=args.proxy_timeout_secs,
      fleet_slow_k=args.fleet_slow_k)

  stop = threading.Event()

  def handle_signal(signum, frame):
    del frame
    logging.info('Received signal %d; shutting down balancer.', signum)
    stop.set()

  previous = {sig: signal.signal(sig, handle_signal)
              for sig in (signal.SIGTERM, signal.SIGINT)}
  try:
    with balancer:
      metricsz.maybe_start(args.metricsz_port)
      logging.info('Balancing %d backend(s) at %s',
                   balancer.backend_count(), balancer.url)
      print(json.dumps({'ready': True, 'url': balancer.url,
                        'port': balancer.port}), flush=True)
      stop.wait()
  finally:
    metricsz.stop_global()
    for sig, handler in previous.items():
      signal.signal(sig, handler)
  return 0


if __name__ == '__main__':
  sys.exit(main())
