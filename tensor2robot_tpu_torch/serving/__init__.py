"""Serving plane: the batching core (``batching``): deadline-aware
cross-client batch assembly, bucketed dispatch over a stateless predictor
core, hot model swap between dispatches and paging hooks. The router, the
HTTP server, the balancer and the load generator wait for ROADMAP queue 1
item 6."""

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
