"""Serving plane: the batching core (``batching``: deadline-aware
cross-client batch assembly, bucketed dispatch over a stateless predictor
core, hot model swap between dispatches, paging hooks), multi-model
routing with paging under a byte budget and priority-class admission
(``router``), the stdlib HTTP front door (``server``) and its request
decode, off the interpreter lock for large bodies (``wire``), the
balancer over serving replicas (``balancer``) and closed- and open-loop
load generation (``loadgen``). The batcher serves a weight-only int8 or
fp8 twin of a model behind a parity gate (``quantize=``, the
``quantize`` package)."""

from tensor2robot_tpu_torch.serving.balancer import Balancer
from tensor2robot_tpu_torch.serving.batching import (
    DynamicBatcher,
    OverloadedError,
    PredictCallableExecutor,
    RequestError,
    ServingError,
    ServingFuture,
    SheddedError,
    TorchBucketExecutor,
    bucket_for,
    default_buckets,
    pad_to_bucket,
)
from tensor2robot_tpu_torch.serving.router import ModelRouter
from tensor2robot_tpu_torch.serving.server import ServingServer
