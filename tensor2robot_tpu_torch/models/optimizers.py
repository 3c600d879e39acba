"""Optimizers and learning-rate schedules with optax's arithmetic.

The port's counterpart of ``tensor2robot_tpu/models/optimizers.py``. The
JAX package builds optax transformations; here each factory returns an
optimizer factory ``fn(params) -> torch.optim.Optimizer`` whose update is
optax's, term for term, in float32:

* :class:`MomentumSGD`: ``optax.sgd(lr, momentum)``, i.e. ``trace = g +
  momentum * trace`` then ``p -= lr(count) * trace``. This is
  ``torch.optim.SGD`` with ``dampening=0, nesterov=False``, whose first
  step also takes ``trace = g``.
* :class:`RMSProp`: ``optax.rmsprop(lr, decay, eps, momentum)``: ``nu =
  (1 - decay) g^2 + decay nu`` from zero, ``u = -lr(count) g /
  sqrt(nu + eps)`` (eps inside the root), then the momentum trace of u.
  ``torch.optim.RMSprop`` places eps outside the root, so it is not used.
* :class:`Adam`: ``optax.adam(lr, b1, b2, eps)``, bias-corrected moments
  with eps outside the root.

* :class:`GradientDescent`: plain ``optax.sgd(lr)``, ``p += -lr(count) *
  g``, with no slots; with a schedule its groups keep the ``count`` of
  optax's ``ScaleByScheduleState``.

The learning rate is a float or a schedule ``fn(count) -> float`` of the
number of updates applied before this one (optax's ``scale_by_schedule``
count), which each parameter group keeps as ``'count'`` so it travels
with the optimizer's ``state_dict``.

``Adam`` and ``GradientDescent``, and the factories that build them, are
TAGGED for the fused update kernel (``ops/fused_update.py``,
``TrainerConfig.fused_update``): they carry a ``fused_spec``.
``MomentumSGD`` and ``RMSProp`` are untagged and keep the stock path, as
in the JAX package.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Iterable, Union

import torch

from tensor2robot_tpu_torch.ops import fused_update as fused_lib

Schedule = Callable[[int], float]
LearningRate = Union[float, Schedule]


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float,
                      staircase: bool = False) -> Schedule:
  """``optax.exponential_decay``: init * rate ** (count / steps), the
  exponent floored when ``staircase``."""

  def schedule(count: int) -> float:
    if count <= 0:
      return init_value
    p = count / transition_steps
    if staircase:
      p = math.floor(p)
    return init_value * decay_rate**p

  return schedule


def create_constant_learning_rate_fn(learning_rate: float = 1e-4) -> Schedule:
  """``optax.constant_schedule``: the same rate at every count."""
  return lambda count: learning_rate


def create_exp_decaying_learning_rate_fn(
    initial_learning_rate: float = 1e-4,
    decay_steps: int = 10000,
    decay_rate: float = 0.9,
    staircase: bool = True) -> Schedule:
  """The JAX package's exponential-decay factory over
  :func:`exponential_decay`."""
  return exponential_decay(initial_learning_rate, decay_steps, decay_rate,
                           staircase=staircase)


def _as_schedule(learning_rate: LearningRate) -> Schedule:
  if callable(learning_rate):
    return learning_rate
  return lambda count: learning_rate


class MomentumSGD(torch.optim.SGD):
  """Momentum SGD under a learning-rate schedule (see module doc)."""

  def __init__(self, params: Iterable, learning_rate: LearningRate,
               momentum: float = 0.9):
    self.schedule = _as_schedule(learning_rate)
    super().__init__(params, lr=self.schedule(0), momentum=momentum,
                     dampening=0, nesterov=False)
    for group in self.param_groups:
      group.setdefault('count', 0)

  @torch.no_grad()
  def step(self, closure=None):  # pylint: disable=arguments-differ
    for group in self.param_groups:
      group['lr'] = self.schedule(group['count'])
    loss = super().step(closure)
    for group in self.param_groups:
      group['count'] += 1
    return loss


class RMSProp(torch.optim.Optimizer):
  """optax's RMSProp with eps inside the root and a momentum trace of the
  scaled update (see module doc)."""

  def __init__(self, params: Iterable, learning_rate: LearningRate,
               decay: float = 0.9, eps: float = 1e-8,
               momentum: float = 0.0):
    self.schedule = _as_schedule(learning_rate)
    super().__init__(params, dict(decay=decay, eps=eps, momentum=momentum,
                                  count=0))

  @torch.no_grad()
  def step(self, closure=None):  # pylint: disable=arguments-differ
    loss = None if closure is None else closure()
    for group in self.param_groups:
      scale = -self.schedule(group['count'])
      decay, eps, momentum = group['decay'], group['eps'], group['momentum']
      for p in group['params']:
        if p.grad is None:
          continue
        g = p.grad
        state = self.state[p]
        if not state:
          state['nu'] = torch.zeros_like(p)
          state['trace'] = torch.zeros_like(p)
        nu = (1 - decay) * (g * g) + decay * state['nu']
        update = scale * (g * torch.rsqrt(nu + eps))
        trace = update + momentum * state['trace']
        state['nu'], state['trace'] = nu, trace
        p.add_(trace)
      group['count'] += 1
    return loss


class Adam(torch.optim.Optimizer):
  """optax's Adam: bias-corrected moments, eps outside the root. Tagged for
  the fused update (``fused_spec``)."""

  def __init__(self, params: Iterable, learning_rate: LearningRate,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    self.schedule = _as_schedule(learning_rate)
    self.fused_spec = fused_lib.FusedSpec('adam', learning_rate, b1=b1, b2=b2,
                                          eps=eps)
    super().__init__(params, dict(b1=b1, b2=b2, eps=eps, count=0))

  @torch.no_grad()
  def step(self, closure=None):  # pylint: disable=arguments-differ
    loss = None if closure is None else closure()
    for group in self.param_groups:
      scale = -self.schedule(group['count'])
      b1, b2, eps = group['b1'], group['b2'], group['eps']
      count = group['count'] + 1
      correction1 = fused_lib.bias_correction(b1, count)
      correction2 = fused_lib.bias_correction(b2, count)
      for p in group['params']:
        if p.grad is None:
          continue
        g = p.grad
        state = self.state[p]
        if not state:
          state['mu'] = torch.zeros_like(p)
          state['nu'] = torch.zeros_like(p)
        mu = (1 - b1) * g + b1 * state['mu']
        nu = (1 - b2) * (g * g) + b2 * state['nu']
        state['mu'], state['nu'] = mu, nu
        update = (mu / correction1.to(p.device)) / (
            torch.sqrt(nu / correction2.to(p.device)) + eps)
        p.add_(scale * update)
      group['count'] = count
    return loss


class GradientDescent(torch.optim.Optimizer):
  """optax's plain SGD: ``updates = -lr(count) * g``, ``p + updates``. Tagged
  for the fused update (``fused_spec``)."""

  def __init__(self, params: Iterable, learning_rate: LearningRate):
    self.schedule = _as_schedule(learning_rate)
    self.fused_spec = fused_lib.FusedSpec('sgd', learning_rate)
    super().__init__(params, dict(count=0) if callable(learning_rate) else {})

  @torch.no_grad()
  def step(self, closure=None):  # pylint: disable=arguments-differ
    loss = None if closure is None else closure()
    for group in self.param_groups:
      scale = -self.schedule(group.get('count', 0))
      for p in group['params']:
        if p.grad is not None:
          p.add_(p.grad * scale)
      if 'count' in group:
        group['count'] += 1
    return loss


def create_momentum_optimizer(learning_rate: LearningRate = 1e-4,
                              momentum: float = 0.9) -> Callable:
  return functools.partial(MomentumSGD, learning_rate=learning_rate,
                           momentum=momentum)


def create_rms_prop_optimizer(learning_rate: LearningRate = 1e-4,
                              decay: float = 0.9, momentum: float = 0.0,
                              epsilon: float = 1e-10) -> Callable:
  return functools.partial(RMSProp, learning_rate=learning_rate, decay=decay,
                           eps=epsilon, momentum=momentum)


def create_adam_optimizer(learning_rate: LearningRate = 1e-4,
                          beta1: float = 0.9, beta2: float = 0.999,
                          epsilon: float = 1e-8) -> Callable:
  """Adam's factory, tagged for the fused update."""
  return fused_lib.tag(
      functools.partial(Adam, learning_rate=learning_rate, b1=beta1,
                        b2=beta2, eps=epsilon),
      fused_lib.FusedSpec('adam', learning_rate, b1=beta1, b2=beta2,
                          eps=epsilon))


def create_gradient_descent_optimizer(
    learning_rate: LearningRate = 1e-4) -> Callable:
  """Plain SGD's factory, tagged for the fused update."""
  return fused_lib.tag(
      functools.partial(GradientDescent, learning_rate=learning_rate),
      fused_lib.FusedSpec('sgd', learning_rate))


def default_create_optimizer_fn() -> Callable:
  """The JAX package's default: Adam at 1e-4 (tagged)."""
  return create_adam_optimizer()
