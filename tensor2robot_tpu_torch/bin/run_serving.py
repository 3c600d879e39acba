"""Serving binary: batched multi-client serving of export roots over HTTP.

Loads the newest committed export version of each root with
``ExportedModelPredictor`` on the card (``--device cuda``, the default;
``--device cpu`` runs the kernels' plain versions on the host), warms every
batch bucket and serves ``POST /v1/predict`` with dynamic cross-client
batching. Hot model swap is on by default: the reload poller follows the
export root's commit markers and swaps a new version in between two
dispatches (a torn or broken export leaves the last good one serving).

Single model:
  python -m tensor2robot_tpu_torch.bin.run_serving \\
      --export_dir /models/m/export --port 8000 --max-batch 64 \\
      --batch-deadline-ms 5 --metricsz-port 8001

Multi-model (``ModelRouter``: N export roots on one card, LRU paging under
a byte budget, priority-class admission; best-effort sheds with 503 +
``Retry-After`` before interactive is ever refused):
  python -m tensor2robot_tpu_torch.bin.run_serving \\
      --model grasp=/models/grasp/export --model eval=/models/eval/export \\
      --hbm-budget-mb 4096 --shed-queue-fraction 0.25 --port 8000

Named models serve at ``POST /v1/models/<name>/predict``; the priority
class rides the ``X-Priority`` header. Replicas go behind
``tensor2robot_tpu_torch.bin.run_balancer``.

Once listening, the binary prints one JSON line on stdout,
``{"ready": true, "url": ..., "port": ...}``, so ``--port 0`` (a free port
chosen by the kernel) can be used by a supervisor. SIGTERM/SIGINT drains:
the listener stops, queued requests complete and the predicts in flight
finish their replies; the process then exits 0 through ``os._exit``,
without the interpreter's finalization: finalizing with the daemon HTTP
threads of a server that had served traffic still alive aborted the
process on the CPU ("terminate called without an active exception") in
4 of 72 SIGTERMs under traffic and in none of 25 idle ones.

``--quantize int8`` (or ``fp8``) serves each model's weight-only
quantized twin behind the parity gate (``serving/batching.py``):
  python -m tensor2robot_tpu_torch.bin.run_serving \
      --export_dir /models/m/export --port 8000 --quantize int8 \
      --quant-parity-atol 0.05 --quant-parity-rtol 0.05
A generation outside the band serves full precision
(``serving/quant_parity_rejects``); ``GET /statz`` shows the
quantization block.

``--compilation-cache-dir`` (an exported program has no compiled form to
cache; ROADMAP.md queue 1 item 6) raises.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import threading


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--export_dir', default=None,
                      help='Versioned export root (single-model mode; '
                           'exclusive with --model).')
  parser.add_argument('--model', action='append', default=[],
                      metavar='NAME=EXPORT_DIR',
                      help='Repeatable: serve EXPORT_DIR as model NAME '
                           'behind a ModelRouter. The first is the default '
                           'model.')
  parser.add_argument('--hbm-budget-mb', type=float, default=None,
                      help='Device-memory budget of the routed models\' '
                           'params: past it, models are paged out LRU '
                           '(host copy and warmed buckets kept, so a '
                           'page-in is one host-to-device copy). Unset: all '
                           'models stay resident.')
  parser.add_argument('--shed-queue-fraction', type=float, default=0.25,
                      help='Best-effort traffic sheds (503 + Retry-After) '
                           'once a model\'s queue passes this fraction of '
                           '--max-queue.')
  parser.add_argument('--retry-after-secs', type=float, default=1.0,
                      help='Retry-After hint on shed responses.')
  parser.add_argument('--port', type=int, default=8000,
                      help='Listening port; 0 lets the kernel choose (read '
                           'it from the ready line).')
  parser.add_argument('--host', default='127.0.0.1',
                      help='Bind address; loopback by default.')
  parser.add_argument('--device', default='cuda',
                      help="Device of the predictors ('cuda' unless 'cpu' "
                           'is asked for; a CUDA request with no card '
                           'raises).')
  parser.add_argument('--max-batch', type=int, default=64,
                      help='Largest single dispatch.')
  parser.add_argument('--batch-deadline-ms', type=float, default=5.0,
                      help='Max assembly wait: a batch dispatches at '
                           'max-batch examples or this deadline.')
  parser.add_argument('--max-queue', type=int, default=1024,
                      help='Queued-request bound; beyond it clients get '
                           '503.')
  parser.add_argument('--request-timeout-secs', type=float, default=30.0)
  parser.add_argument('--reload-interval-secs', type=float, default=10.0,
                      help='Export-root poll cadence for hot swap; <= 0 '
                           'disables reloading.')
  parser.add_argument('--restore-timeout-secs', type=float, default=0.0,
                      help='How long to wait for the first export.')
  parser.add_argument('--metricsz-port', type=int, default=None,
                      help='Also serve the metrics registry at /metricsz.')
  parser.add_argument('--compilation-cache-dir', default=None,
                      help='Not ported: raises when set.')
  parser.add_argument('--quantize', choices=('off', 'int8', 'fp8'),
                      default='off',
                      help='Weight-only quantized serving: int8 or fp8 '
                           'params with per-output-channel scales, '
                           'dequantized inside each dispatch. Parity-gated: '
                           'a generation outside the band serves full '
                           'precision (serving/quant_parity_rejects).')
  parser.add_argument('--quant-parity-atol', type=float, default=0.05,
                      help='Absolute term of the quantization parity band, '
                           'checked on calibration batches before a '
                           'quantized generation may serve.')
  parser.add_argument('--quant-parity-rtol', type=float, default=0.05,
                      help='Relative term of the quantization parity band '
                           '(scaled by the full-precision output\'s '
                           'largest magnitude).')
  parser.add_argument('--request-trace-sample', type=float, default=0.0,
                      help='Fraction of requests whose lifecycle is '
                           'recorded into the flight ring.')
  parser.add_argument('--postmortem-dir', default=None,
                      help='Directory of incident bundles (a reload falling '
                           'back to the last good model; --slo and '
                           '--anomaly-watch escalations).')
  parser.add_argument('--slo', action='store_true',
                      help='Run the SLO burn-rate engine over the serving '
                           'objectives.')
  parser.add_argument('--slo-latency-threshold-ms', type=float,
                      default=512.0,
                      help='Interactive latency SLO threshold.')
  parser.add_argument('--anomaly-watch', action='store_true',
                      help='Watch the serving time series with median/MAD '
                           'detectors.')
  args = parser.parse_args(argv)
  logging.basicConfig(
      level=logging.INFO,
      format='%(asctime)s %(levelname)s %(name)s: %(message)s')
  if bool(args.export_dir) == bool(args.model):
    parser.error('pass exactly one of --export_dir or --model NAME=DIR '
                 '(repeatable)')

  from tensor2robot_tpu_torch.observability import anomaly as anomaly_lib  # pylint: disable=import-outside-toplevel
  from tensor2robot_tpu_torch.observability import metricsz  # pylint: disable=import-outside-toplevel
  from tensor2robot_tpu_torch.observability import slo as slo_lib  # pylint: disable=import-outside-toplevel
  from tensor2robot_tpu_torch.predictors import ExportedModelPredictor  # pylint: disable=import-outside-toplevel
  from tensor2robot_tpu_torch.serving import ModelRouter, ServingServer  # pylint: disable=import-outside-toplevel

  def load_predictor(export_dir):
    predictor = ExportedModelPredictor(
        export_dir=export_dir, timeout=args.restore_timeout_secs,
        device=args.device)
    if not predictor.restore():
      logging.error('No committed export appeared under %r within %.1fs.',
                    export_dir, args.restore_timeout_secs)
      return None
    return predictor

  reload_interval = (args.reload_interval_secs
                     if args.reload_interval_secs > 0 else None)
  batcher_kwargs = dict(
      max_batch=args.max_batch,
      batch_deadline_ms=args.batch_deadline_ms,
      max_queue=args.max_queue,
      reload_interval_secs=reload_interval,
      quantize=args.quantize,
      quant_parity_atol=args.quant_parity_atol,
      quant_parity_rtol=args.quant_parity_rtol,
      request_trace_sample=args.request_trace_sample,
      postmortem_dir=args.postmortem_dir)
  server_kwargs = dict(
      port=args.port,
      host=args.host,
      request_timeout_secs=args.request_timeout_secs,
      compilation_cache_dir=args.compilation_cache_dir)

  if args.model:
    predictors = {}
    for spec in args.model:
      name, sep, export_dir = spec.partition('=')
      if not sep or not name or not export_dir:
        parser.error(f'--model {spec!r} is not NAME=EXPORT_DIR')
      predictor = load_predictor(export_dir)
      if predictor is None:
        return 1
      predictors[name] = predictor
    router = ModelRouter(
        predictors,
        hbm_budget_bytes=(None if args.hbm_budget_mb is None
                          else int(args.hbm_budget_mb * 1e6)),
        default_model=next(iter(predictors)),
        shed_queue_fraction=args.shed_queue_fraction,
        retry_after_secs=args.retry_after_secs,
        **batcher_kwargs)
    server = ServingServer(router=router, **server_kwargs)
  else:
    predictor = load_predictor(args.export_dir)
    if predictor is None:
      return 1
    server = ServingServer(predictor, **server_kwargs, **batcher_kwargs)

  stop = threading.Event()

  def handle_signal(signum, frame):
    del frame
    logging.info('Received signal %d; draining and shutting down.', signum)
    stop.set()

  previous = {sig: signal.signal(sig, handle_signal)
              for sig in (signal.SIGTERM, signal.SIGINT)}
  engine = None
  watch = None
  try:
    with server:
      metricsz.maybe_start(args.metricsz_port)
      if args.slo:
        models = (server.router.models()
                  if server.router is not None else [])
        engine = slo_lib.SLOEngine(
            slo_lib.serving_objectives(
                models=models,
                latency_threshold_ms=args.slo_latency_threshold_ms),
            postmortem_dir=args.postmortem_dir).start()
      if args.anomaly_watch:
        watch = anomaly_lib.AnomalyWatch(
            postmortem_dir=args.postmortem_dir).start()
      if server.router is not None:
        logging.info('Serving models %s at %s',
                     server.router.versions(), server.url)
      else:
        logging.info('Serving model version %d at %s',
                     server.batcher.model_version, server.url)
      print(json.dumps({'ready': True, 'url': server.url,
                        'port': server.port}), flush=True)
      stop.wait()
  finally:
    if watch is not None:
      watch.stop()
    if engine is not None:
      engine.stop()
    metricsz.stop_global()
    for sig, handler in previous.items():
      signal.signal(sig, handler)
  return 0


def exit_without_finalizing(code: int) -> None:
  """Flushes the standard streams and the log handlers, then exits."""
  logging.shutdown()
  sys.stdout.flush()
  sys.stderr.flush()
  os._exit(code)  # pylint: disable=protected-access


if __name__ == '__main__':
  exit_without_finalizing(main())
