"""Optimizers and learning-rate schedules with optax's arithmetic.

The port's counterpart of ``tensor2robot_tpu/models/optimizers.py``. The
JAX package builds optax transformations; here each factory returns an
optimizer factory ``fn(params) -> torch.optim.Optimizer`` whose update is
optax's, term for term, in float32:

* :class:`MomentumSGD`: ``optax.sgd(lr, momentum)``, i.e. ``trace = g +
  momentum * trace`` (from a zero trace) then ``p += trace * -lr(count)``,
  in optax's two roundings. Its ``state_dict`` is ``torch.optim.SGD``'s
  (``momentum_buffer`` slots, group ``lr``), which the checkpoints and the
  JAX-checkpoint conversion read.
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
with the optimizer's ``state_dict``. Each optimizer also steps from rates
handed over on the device (``device_step``; see :class:`_Scheduled`), the
form a captured CUDA graph replays.

``Adam`` and ``GradientDescent``, and the factories that build them, are
TAGGED for the fused update kernel (``ops/fused_update.py``,
``TrainerConfig.fused_update``): they carry a ``fused_spec``.
``MomentumSGD`` and ``RMSProp`` are untagged and keep the stock path, as
in the JAX package.

Two wrappers take an optimizer factory and return one:

* :func:`with_gradient_clipping`: optax's ``clip_by_global_norm``, then
  ``clip``, then the optimizer (:class:`GradientClipping`, stateless);
* :func:`with_gradient_accumulation`: ``optax.MultiSteps``, one real
  update every ``accumulate_steps`` calls from the running mean of the
  gradients (:class:`GradientAccumulation`).

A wrapped optimizer is untagged, as in the JAX package, so
``fused_update=True`` over it takes the stock path. Both keep the protocol
that K steps a dispatch needs (``dispatch_rates``, ``device_step``,
``advance``, ``create_slots``): the accumulation's apply-or-hold is a
device-side select, so which calls of a replay apply may change from
replay to replay.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Iterable, List, Optional, Tuple, Union

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


Rate = Union[float, torch.Tensor]


class _Scheduled:
  """What the port's optimizers share: the schedule, the host ``count``
  each group keeps (the ``state_dict`` format), and two ways to step.

  * ``step()``: the rates of the group's count, as host floats, then the
    count advances, as optax's ``scale_by_schedule`` counts.
  * ``device_step(rates)``: the same update with the rates as tensors on
    the device (``rates`` = (lr, c1, c2) as a float32 tensor of three,
    from :meth:`rates`), and the count left alone: the trainer advances
    the host counts after a dispatch (:meth:`advance`). A captured CUDA
    graph replays this step with new rates at each replay; with the same
    float32 rates the two ways give the same bits.

  Slots are created as zeros at a parameter's first update and updated in
  place, so a captured graph keeps writing the tensors that
  ``state_dict`` reads.
  """

  schedule: Schedule
  slot_names: Tuple[str, ...] = ()

  def create_slots(self) -> None:
    """Creates every trainable parameter's missing slots as zeros (the
    value a first update starts from), so a captured graph finds them."""
    for group in self.param_groups:
      for p in group['params']:
        if p.requires_grad and self.slot_names:
          state = self.state[p]
          for name in self.slot_names:
            if state.get(name) is None:
              state[name] = torch.zeros_like(
                  p, memory_format=torch.preserve_format)

  def rates(self, count: int) -> Tuple[float, float, float]:
    """(lr, c1, c2) of the update applied at ``count``: the rate, and the
    bias corrections of the first and second moment (1.0 where the
    optimizer has none)."""
    return float(self.schedule(count)), 1.0, 1.0

  def dispatch_rates(self, k: int) -> List[Tuple[float, ...]]:
    """The rates of the next ``k`` calls of :meth:`device_step`, one row a
    call, as a dispatch of K steps hands them over (the trainer selects a
    row by the calls applied so far in the dispatch)."""
    count = self.param_groups[0].get('count', 0)
    return [self.rates(count + j) for j in range(k)]

  def _update(self, group, lr: Rate, c1: Rate, c2: Rate) -> None:
    raise NotImplementedError

  @torch.no_grad()
  def step(self, closure=None):  # pylint: disable=arguments-differ
    loss = None if closure is None else closure()
    for group in self.param_groups:
      count = group.get('count', 0)
      self._update(group, *self.rates(count))
      self._count_one(group, count)
    return loss

  @torch.no_grad()
  def device_step(self, rates: torch.Tensor) -> None:
    lr, c1, c2 = rates.unbind(0)
    for group in self.param_groups:
      self._update(group, lr, c1, c2)

  def _count_one(self, group, count: int) -> None:
    if 'count' in group:
      group['count'] = count + 1

  def advance(self, applied: int) -> None:
    """Advances each group's count by ``applied`` updates that
    :meth:`device_step` made."""
    for group in self.param_groups:
      count = group.get('count', 0)
      for _ in range(applied):
        self._count_one(group, count)
        count += 1

  def _slots(self, group, names):
    """(params, grads, one list per slot name) of the group's parameters
    with a gradient; missing slots are created as zeros."""
    params, grads, slots = [], [], [[] for _ in names]
    for p in group['params']:
      if p.grad is None:
        continue
      state = self.state[p]
      for name, column in zip(names, slots):
        if state.get(name) is None:
          state[name] = torch.zeros_like(
              p, memory_format=torch.preserve_format)
        column.append(state[name])
      params.append(p)
      grads.append(p.grad)
    return params, grads, slots


class MomentumSGD(_Scheduled, torch.optim.SGD):
  """Momentum SGD under a learning-rate schedule (see module doc), in
  optax's order: ``trace = g + momentum * trace``, ``p += trace * -lr``
  (two roundings, as optax's chain applies them)."""

  slot_names = ('momentum_buffer',)

  def __init__(self, params: Iterable, learning_rate: LearningRate,
               momentum: float = 0.9):
    self.schedule = _as_schedule(learning_rate)
    super().__init__(params, lr=self.schedule(0), momentum=momentum,
                     dampening=0, nesterov=False)
    for group in self.param_groups:
      group.setdefault('count', 0)

  def _count_one(self, group, count: int) -> None:
    # torch.optim.SGD's group 'lr' keeps the rate of the last update.
    group['lr'] = self.schedule(count)
    super()._count_one(group, count)

  def _update(self, group, lr, c1, c2) -> None:
    del c1, c2
    params, grads, (traces,) = self._slots(group, ('momentum_buffer',))
    if not params:
      return
    torch._foreach_mul_(traces, group['momentum'])  # pylint: disable=protected-access
    torch._foreach_add_(traces, grads)  # pylint: disable=protected-access
    torch._foreach_add_(params, torch._foreach_mul(traces, -lr))  # pylint: disable=protected-access


class RMSProp(_Scheduled, torch.optim.Optimizer):
  """optax's RMSProp with eps inside the root and a momentum trace of the
  scaled update (see module doc)."""

  slot_names = ('nu', 'trace')

  def __init__(self, params: Iterable, learning_rate: LearningRate,
               decay: float = 0.9, eps: float = 1e-8,
               momentum: float = 0.0):
    self.schedule = _as_schedule(learning_rate)
    super().__init__(params, dict(decay=decay, eps=eps, momentum=momentum,
                                  count=0))

  def _update(self, group, lr, c1, c2) -> None:
    del c1, c2
    scale = -lr
    decay, eps, momentum = group['decay'], group['eps'], group['momentum']
    params, grads, (nus, traces) = self._slots(group, ('nu', 'trace'))
    for p, g, nu, trace in zip(params, grads, nus, traces):
      # In place, each term rounded as optax rounds it (a sum of two
      # rounded products in either order is the same float).
      nu.mul_(decay).add_((1 - decay) * (g * g))
      trace.mul_(momentum).add_(scale * (g * torch.rsqrt(nu + eps)))
      p.add_(trace)


class Adam(_Scheduled, torch.optim.Optimizer):
  """optax's Adam: bias-corrected moments, eps outside the root. Tagged for
  the fused update (``fused_spec``)."""

  slot_names = ('mu', 'nu')

  def __init__(self, params: Iterable, learning_rate: LearningRate,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    self.schedule = _as_schedule(learning_rate)
    self.fused_spec = fused_lib.FusedSpec('adam', learning_rate, b1=b1, b2=b2,
                                          eps=eps)
    super().__init__(params, dict(b1=b1, b2=b2, eps=eps, count=0))

  def rates(self, count: int) -> Tuple[float, float, float]:
    return fused_lib.host_rates(self.fused_spec, count)

  def _update(self, group, lr, c1, c2) -> None:
    scale = -lr
    b1, b2, eps = group['b1'], group['b2'], group['eps']
    params, grads, (mus, nus) = self._slots(group, ('mu', 'nu'))
    if not params:
      return
    # The corrections divide as device tensors on both paths: a CUDA
    # division by a host scalar multiplies by its reciprocal instead.
    c1, c2 = (c if isinstance(c, torch.Tensor) else
              torch.tensor(c, dtype=torch.float32).to(params[0].device)
              for c in (c1, c2))
    for p, g, mu, nu in zip(params, grads, mus, nus):
      # In place, each term rounded as optax rounds it (a sum of two
      # rounded products in either order is the same float).
      mu.mul_(b1).add_((1 - b1) * g)
      nu.mul_(b2).add_((1 - b2) * (g * g))
      p.add_(scale * ((mu / c1) / (torch.sqrt(nu / c2) + eps)))


class GradientDescent(_Scheduled, torch.optim.Optimizer):
  """optax's plain SGD: ``updates = -lr(count) * g``, ``p + updates``. Tagged
  for the fused update (``fused_spec``)."""

  def __init__(self, params: Iterable, learning_rate: LearningRate):
    self.schedule = _as_schedule(learning_rate)
    self.fused_spec = fused_lib.FusedSpec('sgd', learning_rate)
    super().__init__(params, dict(count=0) if callable(learning_rate) else {})

  def _update(self, group, lr, c1, c2) -> None:
    del c1, c2
    scale = -lr
    for p in group['params']:
      if p.grad is not None:
        p.add_(p.grad * scale)


class _Wrapped(_Scheduled):
  """An optimizer around ``inner``: its groups, slots, counts, rates and
  ``state_dict`` are the inner optimizer's."""

  def __init__(self, inner):
    self.inner = inner

  param_groups = property(lambda self: self.inner.param_groups)
  state = property(lambda self: self.inner.state)

  def zero_grad(self, set_to_none: bool = True) -> None:
    self.inner.zero_grad(set_to_none=set_to_none)

  def state_dict(self):
    return self.inner.state_dict()

  def load_state_dict(self, state_dict) -> None:
    self.inner.load_state_dict(state_dict)

  def create_slots(self) -> None:
    self.inner.create_slots()

  def rates(self, count: int):
    return self.inner.rates(count)

  def dispatch_rates(self, k: int):
    return self.inner.dispatch_rates(k)

  def advance(self, applied: int) -> None:
    self.inner.advance(applied)


class GradientClipping(_Wrapped):
  """An optimizer whose gradients are clipped before it steps: optax's
  ``clip_by_global_norm(clip_norm)`` (``where(norm < max, g, g / norm *
  max)``, the norm the root of the sum of every gradient's sum of
  squares), then ``clip(clip_value)``, each when set. Stateless."""

  def __init__(self, inner, clip_norm: Optional[float] = None,
               clip_value: Optional[float] = None):
    super().__init__(inner)
    self.clip_norm, self.clip_value = clip_norm, clip_value

  @torch.no_grad()
  def clip(self) -> None:
    """Clips every gradient in place, on the device."""
    grads = [p.grad for group in self.param_groups for p in group['params']
             if p.grad is not None]
    if not grads:
      return
    if self.clip_norm is not None:
      total = None
      for g in grads:
        square = torch.sum(g * g)
        total = square if total is None else total + square
      norm = torch.sqrt(total)
      keep = norm < self.clip_norm
      for g in grads:
        g.copy_(torch.where(keep, g, g / norm * self.clip_norm))
    if self.clip_value is not None:
      for g in grads:
        g.clamp_(-self.clip_value, self.clip_value)

  @torch.no_grad()
  def step(self, closure=None):  # pylint: disable=arguments-differ
    self.clip()
    return self.inner.step(closure)

  @torch.no_grad()
  def device_step(self, rates: torch.Tensor) -> None:
    self.clip()
    self.inner.device_step(rates)


class GradientAccumulation(_Wrapped):
  """``optax.MultiSteps(inner, every_k_schedule=accumulate_steps)``.

  Each call folds the gradients into the running mean ``acc + (g - acc) /
  (mini_step + 1)`` (the ``acc_grads`` slots) and hands the mean to the
  inner optimizer, whose update is kept on the call that completes a
  window and dropped otherwise; the mean then restarts from zero. The
  inner optimizer's count, and so its schedule, moves on applying calls
  only. ``mini_step`` (calls into the window) and ``gradient_step``
  (applied updates) are host integers in the parameter groups, beside the
  inner ``count``.

  On the device (:meth:`device_step`) a call takes a row of five rates:
  the inner rates, then the divisor ``mini_step + 1`` and the apply flag,
  both computed on the host for the call the row belongs to
  (:meth:`dispatch_rates`). The inner update always runs and a
  ``where(apply, new, old)`` over the parameters and the inner slots keeps
  or drops it, optax's ``lax.cond`` as a select, so a captured graph needs
  no host branch. :meth:`step` runs the same device step from the host's
  row, so both ways give the same bits.
  """

  def __init__(self, inner, accumulate_steps: int):
    super().__init__(inner)
    self.accumulate_steps = int(accumulate_steps)
    for group in self.param_groups:
      group.setdefault('mini_step', 0)
      group.setdefault('gradient_step', 0)
    # The inner slots exist before any call, so a dropped update can
    # restore them (optax's init makes them all up front too).
    self.create_slots()

  def create_slots(self) -> None:
    self.inner.create_slots()
    for group in self.param_groups:
      for p in group['params']:
        if p.requires_grad and self.state[p].get('acc_grads') is None:
          self.state[p]['acc_grads'] = torch.zeros_like(
              p, memory_format=torch.preserve_format)

  def dispatch_rates(self, k: int) -> List[Tuple[float, ...]]:
    group = self.param_groups[0]
    count, mini = group.get('count', 0), group['mini_step']
    rows = []
    for j in range(k):
      n = (mini + j) % self.accumulate_steps + 1
      rows.append(tuple(self.inner.rates(
          count + (mini + j) // self.accumulate_steps)) +
                  (float(n), float(n == self.accumulate_steps)))
    return rows

  def advance(self, applied: int) -> None:
    group = self.param_groups[0]
    total = group['mini_step'] + applied
    updates = total // self.accumulate_steps
    self.inner.advance(updates)
    for group in self.param_groups:
      group['mini_step'] = total % self.accumulate_steps
      group['gradient_step'] += updates

  @torch.no_grad()
  def step(self, closure=None):  # pylint: disable=arguments-differ
    loss = None if closure is None else closure()
    params = [p for g in self.param_groups for p in g['params']]
    device = params[0].device if params else torch.device('cpu')
    row = torch.tensor(self.dispatch_rates(1)[0], dtype=torch.float32)
    self.device_step(row.to(device))
    self.advance(1)
    return loss

  @torch.no_grad()
  def device_step(self, rates: torch.Tensor) -> None:
    divisor, flag = rates[3], rates[4]
    apply = flag > 0
    live, accs = [], []
    for group in self.param_groups:
      for p in group['params']:
        if p.grad is None:
          continue
        acc = self.state[p]['acc_grads']
        acc.add_((p.grad - acc) / divisor)
        p.grad.copy_(acc)
        accs.append(acc)
        live.append(p)
        live += [v for k, v in self.state[p].items()
                 if k != 'acc_grads' and isinstance(v, torch.Tensor)]
    old = [t.clone() for t in live]
    self.inner.device_step(rates[:3])
    for t, o in zip(live, old):
      t.copy_(torch.where(apply, t, o))
    for acc in accs:
      acc.masked_fill_(apply, 0.0)


def with_gradient_clipping(optimizer: Callable,
                           clip_norm: Optional[float] = None,
                           clip_value: Optional[float] = None) -> Callable:
  """Global-norm and value clipping in front of an optimizer factory (the
  result is untagged: the fused update does not take it)."""

  def factory(params):
    return GradientClipping(optimizer(params), clip_norm, clip_value)

  return factory


def with_gradient_accumulation(optimizer: Callable,
                               accumulate_steps: int) -> Callable:
  """``optax.MultiSteps``: one real update every ``accumulate_steps``
  calls, across dispatches (see :class:`GradientAccumulation`;
  ``TrainerConfig.grad_accum_microbatches`` slices one batch instead).
  With ``accumulate_steps <= 1`` it returns ``optimizer`` unchanged."""
  if accumulate_steps <= 1:
    return optimizer

  def factory(params):
    return GradientAccumulation(optimizer(params), accumulate_steps)

  return factory


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
