"""Observability: the process metrics registry (``metrics``), the flight
recorder (``flight``), the metrics history ring (``timeseries``), host
spans and cross-process request tracing (``tracing``), postmortem bundles
(``postmortem``), SLO burn-rate alerts (``slo``), the anomaly watch
(``anomaly``), the CUDA allocator gauges (``memory``) and the live
``/metricsz`` endpoint (``metricsz``). The compiled-program ledger
(``programs``), the actuator and the trainer's and record feed's hooks
wait for ROADMAP queue 1 item 10."""

from tensor2robot_tpu_torch.observability import (anomaly, flight, memory,
                                                  metrics, metricsz,
                                                  postmortem, slo, timeseries,
                                                  tracing)
from tensor2robot_tpu_torch.observability.anomaly import AnomalyWatch
from tensor2robot_tpu_torch.observability.flight import FlightRecorder
from tensor2robot_tpu_torch.observability.memory import device_memory_stats
from tensor2robot_tpu_torch.observability.metrics import (Counter, Gauge,
                                                          Histogram, Registry)
from tensor2robot_tpu_torch.observability.slo import Objective, SLOEngine
from tensor2robot_tpu_torch.observability.timeseries import TimeSeriesRecorder
from tensor2robot_tpu_torch.observability.tracing import (TraceContext,
                                                          capture,
                                                          dump_chrome_trace,
                                                          span,
                                                          step_annotation)

__all__ = [
    'anomaly', 'flight', 'memory', 'metrics', 'metricsz', 'postmortem',
    'slo', 'timeseries', 'tracing', 'AnomalyWatch', 'Counter',
    'FlightRecorder', 'Gauge', 'Histogram', 'Objective', 'Registry',
    'SLOEngine', 'TimeSeriesRecorder', 'TraceContext', 'capture',
    'device_memory_stats', 'dump_chrome_trace', 'span', 'step_annotation',
]
