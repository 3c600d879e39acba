"""Cross-entropy method (CEM): the port's counterpart of
``tensor2robot_tpu/utils/cross_entropy.py``.

:func:`cross_entropy_method` is the generic numpy maximiser the host-side
policy path uses; :func:`jit_normal_cem` is the device-resident body, a
loop of torch ops on the card with no host synchronisation inside.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

SampleBatch = Union[np.ndarray, Dict[str, np.ndarray]]


def cross_entropy_method(sample_fn: Callable[..., SampleBatch],
                         objective_fn: Callable[[SampleBatch], np.ndarray],
                         update_fn: Callable[[Dict, SampleBatch], Dict],
                         initial_params: Dict[str, Any],
                         num_elites: int,
                         num_iterations: int = 1,
                         threshold_to_terminate: Optional[float] = None
                         ) -> Tuple[SampleBatch, np.ndarray, Dict]:
  """Maximises ``objective_fn`` over samples from ``sample_fn``.

  Returns (final_samples, final_values, final_params).
  """
  updated_params = initial_params
  samples: SampleBatch = None
  values = None
  for _ in range(num_iterations):
    samples = sample_fn(**updated_params)
    values = np.asarray(objective_fn(samples)).reshape(-1)
    elite_idx = np.argsort(values)[-num_elites:]
    if isinstance(samples, dict):
      elite_samples = {k: np.asarray(v)[elite_idx] for k, v in samples.items()}
    else:
      elite_samples = np.asarray(samples)[elite_idx]
    updated_params = update_fn(updated_params, elite_samples)
    if (threshold_to_terminate is not None and
        float(np.max(values)) > threshold_to_terminate):
      break
  return samples, values, updated_params


def jit_normal_cem(objective_fn: Callable[[torch.Tensor], torch.Tensor],
                   num_elites: int,
                   num_iterations: int) -> Callable:
  """Whole-CEM body on the device: sample -> objective -> elite refit.

  ``objective_fn(samples [S, A]) -> values [S]`` runs on device tensors.
  Returns ``run(noise [I, S, A], mean [A], stddev [A]) -> (best_sample,
  best_value, mean, stddev)``, all device tensors: nothing in the loop
  reads a value back to the host. The elite refit matches the numpy path:
  top-``num_elites`` by value, mean and std with Bessel's correction, so
  with the same noise both paths select the same action unless candidates
  score exactly equal.
  """

  def run(noise, mean, stddev):
    samples = values = None
    for i in range(num_iterations):
      samples = mean + stddev * noise[i]
      values = objective_fn(samples).reshape(-1).float()
      _, elite_idx = torch.topk(values, num_elites)
      elites = samples[elite_idx]
      mean = elites.mean(dim=0)
      stddev = elites.std(dim=0, unbiased=True)
    best = torch.argmax(values)
    return samples[best], values[best], mean, stddev

  return run
