"""Policies: predictor-backed action selection for robot loops.

The port's counterpart of ``tensor2robot_tpu/policies/policies.py``
(``Policy`` and ``CEMPolicy``), with the same
``SelectAction(state, context, timestep)`` surface.

``CEMPolicy(device_resident=True)`` keeps the whole CEM loop on the card:
the state is uploaded once per action, the candidate batch is packed on
the device with ``expand`` (no host copy of the tiled image), and the
iterations run ``torch.topk``, ``mean`` and ``std`` on device tensors with
no host synchronisation until the chosen action is read back. Noise is
drawn with numpy (:meth:`CEMPolicy._draw_noise`), one fill for all
iterations, which is the same ``np.random`` stream as the numpy path's
per-iteration draws, so seeded runs agree across paths and with the JAX
package.
"""

from __future__ import annotations

import abc
from typing import Callable, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch.specs import algebra
from tensor2robot_tpu_torch.utils import cross_entropy


class Policy(abc.ABC):
  """Base policy."""

  def __init__(self, predictor=None):
    self._predictor = predictor

  @abc.abstractmethod
  def SelectAction(self, state, context, timestep):
    """Action for the observed state; must not mutate state/context."""


class CEMPolicy(Policy):
  """CEM argmax over a critic's ``q_predicted``.

  The device-resident path needs a model declaring
  ``get_action_specification`` whose ``pack_features`` lays actions out as
  ``action/<key>`` slices of the flat action vector in spec order (the
  CriticModel family).
  """

  def __init__(self,
               t2r_model,
               action_size: int = 2,
               cem_iters: int = 3,
               cem_samples: int = 64,
               num_elites: int = 10,
               pack_fn: Optional[Callable] = None,
               device_resident: bool = False,
               **parent_kwargs):
    super().__init__(**parent_kwargs)
    self._t2r_model = t2r_model
    self._action_size = action_size
    self._cem_iters = cem_iters
    self._cem_samples = cem_samples
    self._num_elites = num_elites
    self._device_resident = device_resident
    self._action_slices = None
    self.sample_fn = self._default_sample_fn
    self.pack_fn = pack_fn or self._default_pack_fn

  def _default_sample_fn(self, mean, stddev):
    return mean + stddev * np.random.standard_normal(
        (self._cem_samples, self._action_size))

  def _draw_noise(self, shape):
    """Noise for the device path: one standard_normal(I, S, A) fill, the
    same np.random stream as the numpy path's per-iteration draws."""
    return np.random.standard_normal(shape).astype(np.float32)

  def _default_pack_fn(self, t2r_model, state, context, timestep, samples):
    del context
    return t2r_model.pack_features(state, samples, timestep)

  def get_cem_action(self, objective_fn):
    """CEM maximisation on the host; returns (best_action, debug)."""

    def update_fn(params, elite_samples):
      del params
      return {
          'mean': np.mean(elite_samples, axis=0),
          'stddev': np.std(elite_samples, axis=0, ddof=1),
      }

    initial_params = {
        'mean': np.zeros(self._action_size),
        'stddev': np.ones(self._action_size),
    }
    samples, values, final_params = cross_entropy.cross_entropy_method(
        self.sample_fn, objective_fn, update_fn, initial_params,
        num_elites=self._num_elites, num_iterations=self._cem_iters)
    idx = int(np.argmax(values))
    debug = {
        'q_predicted': values[idx],
        'final_params': final_params,
        'best_idx': idx,
    }
    return np.asarray(samples)[idx], debug

  def _device_action_slices(self):
    """(key, start, end, shape) of each action/<key> in the flat action
    vector, in spec order."""
    if self._action_slices is None:
      slices, offset = [], 0
      action_spec = algebra.flatten_spec_structure(
          self._t2r_model.get_action_specification())
      for key, spec in action_spec.items():
        size = int(np.prod(spec.shape))
        slices.append((f'action/{key}', offset, offset + size,
                       tuple(spec.shape)))
        offset += size
      if offset != self._action_size:
        raise ValueError(
            f'action specs cover {offset} dims, action_size is '
            f'{self._action_size}.')
      self._action_slices = slices
    return self._action_slices

  def get_cem_action_device(self, state, context, timestep):
    """Whole-CEM-on-device action selection; returns (action, debug)."""
    if getattr(self.sample_fn, '__func__', None) is not (
        CEMPolicy._default_sample_fn):
      raise NotImplementedError(
          'device_resident CEM samples on device (mean + stddev * normal '
          'noise); a custom sample_fn would be silently ignored. Use '
          'device_resident=False with custom samplers, or override '
          '_draw_noise for custom noise.')
    serving_fn = self._predictor.device_serving_fn()
    device = self._predictor.device
    slices = self._device_action_slices()
    # One 1-sample pack resolves the state keys via the model's own
    # packing; only state/ entries go to the device, once.
    probe = self.pack_fn(self._t2r_model, state, context, timestep,
                         np.zeros((1, self._action_size), np.float32))
    state_features = {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in probe.items() if k.startswith('state/')
    }
    dropped = sorted(set(probe) - set(state_features) -
                     {key for key, *_ in slices})
    if dropped:
      raise ValueError(
          f'device_resident CEM forwards only state/ features and the '
          f'action/ slices; pack_features emitted additional serving inputs '
          f'{dropped} that would be silently dropped. Use '
          f'device_resident=False for this model, or fold these inputs '
          f'under state/.')
    num_samples = self._cem_samples

    def objective(samples):
      packed = {
          k: v.expand((num_samples,) + tuple(v.shape[1:]))
          for k, v in state_features.items()
      }
      for key, start, end, shape in slices:
        packed[key] = samples[:, start:end].reshape((num_samples,) + shape)
      return serving_fn(packed)['q_predicted']

    noise = torch.from_numpy(self._draw_noise(
        (self._cem_iters, num_samples, self._action_size))).to(device)
    run = cross_entropy.jit_normal_cem(objective, self._num_elites,
                                       self._cem_iters)
    best, value, mean, stddev = run(
        noise, torch.zeros(self._action_size, device=device),
        torch.ones(self._action_size, device=device))
    debug = {
        'q_predicted': float(value),
        'final_params': {'mean': mean.cpu().numpy(),
                         'stddev': stddev.cpu().numpy()},
    }
    return best.cpu().numpy(), debug

  def SelectAction(self, state, context, timestep):
    if self._device_resident:
      action, _ = self.get_cem_action_device(state, context, timestep)
      return action

    def objective_fn(samples):
      np_inputs = self.pack_fn(self._t2r_model, state, context, timestep,
                               samples)
      return self._predictor.predict(np_inputs)['q_predicted']

    action, _ = self.get_cem_action(objective_fn)
    return action
