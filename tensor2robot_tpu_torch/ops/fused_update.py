"""Fused optimizer update: a CUDA kernel for the card, a plain version for
the CPU.

The port's counterpart of ``tensor2robot_tpu/ops/fused_update.py``. The
stock update (``models/optimizers.Adam.step``, then the train state's EMA)
is a Python loop of about ten launches per parameter. This module runs the
whole chain (Adam's moments or plain SGD, the apply, the EMA blend and the
non-finite guard's select) as one elementwise pass in which each parameter
element is read once and written once.

* **Tagging, not introspection.** A :class:`FusedSpec` carries the
  hyperparameters the kernel needs. The factories and optimizer classes of
  ``models/optimizers.py`` that the kernel computes exactly (``Adam``,
  ``GradientDescent``) carry one as ``fused_spec``; anything else
  (``MomentumSGD``, ``RMSProp``, a user's optimizer) is untagged and keeps
  the stock path.
* :func:`plan_for` returns ``None`` only for an untagged optimizer or an
  optimizer state it does not recognise (:func:`supports_state`), and logs
  why. It never looks at where the program runs.
* **The gate is the tensor's device** (``ops/_dispatch.py``):
  :func:`update_leaves` launches :func:`fused_update` (``csrc/
  fused_update.cu``) for CUDA tensors and runs :func:`plain_fused_update`
  for CPU tensors. Nothing else switches the path.
* :func:`apply_update` is the trainer's entry: the fused replacement of
  ``optimizer.step()`` + the EMA update + the guard's select, in place. It
  keeps the stock optimizer's ``state_dict`` exactly (``mu``, ``nu`` per
  parameter, ``count`` in the parameter groups), so a fused run and a stock
  run are interchangeable.

The kernel launches once per :data:`LEAVES_PER_LAUNCH` parameters, reading
their pointers from a table passed by value; the learning rate and the bias
corrections are host floats passed by value, and the guard's flag is the
one value read on the device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import logging
from typing import (Callable, Mapping, NamedTuple, Optional, Sequence,
                    Union)

import numpy as np
import torch

from tensor2robot_tpu_torch.ops import _build
from tensor2robot_tpu_torch.ops import _dispatch as dispatch

# Leaves per launch: the kernel's by-value pointer table (kMaxLeaves in
# csrc/fused_update.cu) stays under the 4 KB of kernel arguments.
LEAVES_PER_LAUNCH = 64
KINDS = ('adam', 'sgd')

_SIGNATURES = {
    't2r_fused_update': [ctypes.c_void_p] + [ctypes.c_int] * 4 +
                        [ctypes.c_void_p] + [ctypes.c_float] * 10 +
                        [ctypes.c_void_p],
}


class FusedSpec(NamedTuple):
  """Hyperparameters a tagged optimizer carries for the fused kernel."""

  kind: str                                   # 'adam' | 'sgd'
  learning_rate: Union[float, Callable[[int], float]]
  b1: float = 0.9
  b2: float = 0.999
  eps: float = 1e-8


def tag(factory: Callable, spec: FusedSpec) -> Callable:
  """Marks an optimizer factory ``fn(params) -> Optimizer`` (e.g. a
  ``functools.partial``) with ``spec``; returns the factory."""
  factory.fused_spec = spec
  return factory


def spec_of(optimizer) -> Optional[FusedSpec]:
  """The :class:`FusedSpec` an optimizer or factory carries, else None."""
  spec = getattr(optimizer, 'fused_spec', None)
  return spec if isinstance(spec, FusedSpec) else None


@dataclasses.dataclass(frozen=True)
class FusedPlan:
  """A decision to run the fused pass (see :func:`plan_for`)."""

  spec: FusedSpec
  ema_decay: Optional[float] = None


class Leaf(NamedTuple):
  """One parameter's tensors for the kernel: ``mu``/``nu`` are None for
  SGD, ``ema`` is None without averaging. All float32, one layout."""

  p: torch.Tensor
  g: torch.Tensor
  mu: Optional[torch.Tensor] = None
  nu: Optional[torch.Tensor] = None
  ema: Optional[torch.Tensor] = None


def bias_correction(decay: float, count: int) -> torch.Tensor:
  """1 - decay ** count in float32, as optax computes it (on the CPU)."""
  return 1 - torch.tensor(decay, dtype=torch.float32)**count


def supports_state(spec: FusedSpec, optimizer) -> bool:
  """Whether ``optimizer``'s groups and state are what ``spec`` fuses.

  Every group must hold the spec's hyperparameters and one shared
  ``count`` (required with a schedule); every parameter must be float32
  with no state yet or, for Adam, exactly ``mu`` and ``nu``. Anything else
  (extra slots, mixed hyperparameters, other dtypes) would make the fused
  pass drop or misapply part of the update.
  """
  groups = getattr(optimizer, 'param_groups', None)
  if not groups or spec.kind not in KINDS:
    return False
  counts = {group.get('count') for group in groups}
  if len(counts) != 1:
    return False
  if callable(spec.learning_rate) and counts == {None}:
    return False
  slots = {'mu', 'nu'} if spec.kind == 'adam' else set()
  for group in groups:
    if spec.kind == 'adam' and (group.get('b1'), group.get('b2'),
                                group.get('eps')) != (spec.b1, spec.b2,
                                                      spec.eps):
      return False
    for p in group['params']:
      if p.dtype != torch.float32:
        return False
      state = optimizer.state.get(p)
      if state and set(state) != slots:
        return False
  return True


def plan_for(optimizer, ema_decay: Optional[float] = None
             ) -> Optional[FusedPlan]:
  """The fused plan for ``optimizer``, or None for the stock path.

  None only when the optimizer is untagged or its state is not what the
  kernel rebuilds (:func:`supports_state`); each case logs its reason, so
  a stock run is diagnosable from the log.
  """
  spec = spec_of(optimizer)
  if spec is None or spec.kind not in KINDS:
    logging.info('fused_update: optimizer %s is untagged or of an '
                 'unsupported kind; using the stock update path.',
                 type(optimizer).__name__)
    return None
  if not supports_state(spec, optimizer):
    logging.info('fused_update: optimizer state not recognized (mixed '
                 'groups, extra slots or non-float32 parameters); using the '
                 'stock update path.')
    return None
  return FusedPlan(spec=spec, ema_decay=ema_decay)


# ----------------------------------------------------------------- kernel


def _dense(t: torch.Tensor) -> bool:
  """Whether ``t``'s elements fill one contiguous range of its storage."""
  expected = 1
  for size, stride in sorted(zip(t.shape, t.stride()), key=lambda x: x[1]):
    if size != 1 and stride != expected:
      return False
    expected *= size
  return True


def _layout(t: torch.Tensor):
  """Shape and strides, leaving out the strides of size-1 dimensions (they
  never address an element, and autograd may give a gradient other ones)."""
  return tuple(t.shape), tuple(st for size, st in zip(t.shape, t.stride())
                               if size != 1)


def _check_leaves(leaves: Sequence[Leaf], adam: bool, has_ema: bool,
                  device: torch.device) -> None:
  for i, leaf in enumerate(leaves):
    p = leaf.p
    tensors = [p, leaf.g]
    if adam:
      tensors += [leaf.mu, leaf.nu]
    if has_ema:
      tensors.append(leaf.ema)
    shape, stride = p.shape, p.stride()
    for t in tensors:
      if t is None:
        raise ValueError(f'fused_update leaf {i}: a tensor is missing.')
      if t.dtype != torch.float32 or t.device != device:
        raise ValueError(
            f'fused_update leaf {i}: every tensor must be float32 on '
            f'{device}, got {t.dtype} on {t.device}.')
      if (t.stride() != stride or t.shape != shape) and (
          _layout(t) != _layout(p)):
        raise ValueError(
            f'fused_update leaf {i}: shapes/strides differ ({tuple(t.shape)} '
            f'{t.stride()} against {tuple(shape)} {stride}); the kernel does '
            'not copy.')
    if not (p.is_contiguous() or _dense(p)):
      raise ValueError(f'fused_update leaf {i}: not dense (strides {stride}).')


def fused_update(leaves: Sequence[Leaf], kind: str, lr: float, c1: float,
                 c2: float, b1: float, b2: float, eps: float,
                 decay: Optional[float],
                 ok: Optional[torch.Tensor] = None) -> None:
  """Launches the CUDA kernel (``csrc/fused_update.cu``) over ``leaves`` on
  the current stream, in place: one launch per
  :data:`LEAVES_PER_LAUNCH` leaves.

  ``kind`` is 'adam' or 'sgd'; ``decay`` None leaves the EMA off; ``ok``
  (a one-element CUDA bool tensor) turns the guard on: where it holds
  False nothing is written. Raises on CPU tensors, on a tensor whose dtype,
  shape or strides differ from its parameter's, and on a launch error.
  """
  if kind not in KINDS:
    raise ValueError(f'fused_update kind must be one of {KINDS}, got {kind!r}')
  leaves = [leaf for leaf in leaves if leaf.p.numel()]
  if not leaves:
    return
  device = leaves[0].p.device
  if device.type != 'cuda':
    raise ValueError(f'fused_update takes CUDA tensors, got {device}.')
  adam, has_ema, guard = kind == 'adam', decay is not None, ok is not None
  _check_leaves(leaves, adam, has_ema, device)
  if guard and (ok.device != device or ok.dtype != torch.bool or
                ok.numel() != 1):
    raise ValueError('fused_update: ok must be one bool element on the '
                     "parameters' device.")
  decay = 0.0 if decay is None else float(decay)
  table = np.array(
      [(leaf.p.data_ptr(), leaf.g.data_ptr(),
        leaf.mu.data_ptr() if adam else 0, leaf.nu.data_ptr() if adam else 0,
        leaf.ema.data_ptr() if has_ema else 0, leaf.p.numel())
       for leaf in leaves], np.int64)
  lib = _build.load('fused_update', _SIGNATURES)
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    for start in range(0, len(leaves), LEAVES_PER_LAUNCH):
      chunk = np.ascontiguousarray(table[start:start + LEAVES_PER_LAUNCH])
      status = lib.t2r_fused_update(
          chunk.ctypes.data, len(chunk), int(adam), int(has_ema), int(guard),
          ok.data_ptr() if guard else None, lr, c1, c2, b1, b2, 1.0 - b1,
          1.0 - b2, eps, decay, 1.0 - decay, stream)
      _build.check(lib, status, 'fused_update')
      fused_update.launches += 1


fused_update.launches = 0


@torch.no_grad()
def plain_fused_update(leaves: Sequence[Leaf], kind: str, lr: float,
                       c1: float, c2: float, b1: float, b2: float,
                       eps: float, decay: Optional[float],
                       ok: Optional[torch.Tensor] = None) -> None:
  """The kernel's function in plain PyTorch, on any device, in place.

  Transcribes the JAX package's ``_make_kernel`` term for term: the
  moments, the bias-corrected update with eps outside the root, the apply,
  the EMA blend, then ``where(ok, new, old)`` for every output.
  """
  if kind not in KINDS:
    raise ValueError(f'fused_update kind must be one of {KINDS}, got {kind!r}')
  for leaf in leaves:
    p, g, mu, nu, ema = leaf
    if kind == 'adam':
      new_mu = (1.0 - b1) * g + b1 * mu
      new_nu = (1.0 - b2) * (g * g) + b2 * nu
      update = (new_mu / c1) / (torch.sqrt(new_nu / c2) + eps)
    else:
      update = g
    new_p = p - lr * update
    results, olds = [new_p], [p]
    if kind == 'adam':
      results += [new_mu, new_nu]
      olds += [mu, nu]
    if decay is not None:
      results.append(ema * decay + new_p * (1.0 - decay))
      olds.append(ema)
    if ok is not None:
      results = [torch.where(ok.reshape(()), n, o)
                 for n, o in zip(results, olds)]
    for old, new in zip(olds, results):
      old.copy_(new)


def update_leaves(leaves: Sequence[Leaf], kind: str, lr: float, c1: float,
                  c2: float, b1: float, b2: float, eps: float,
                  decay: Optional[float],
                  ok: Optional[torch.Tensor] = None) -> None:
  """The fused update over ``leaves``: the kernel for CUDA tensors, the
  plain version for CPU tensors."""
  if not leaves:
    return
  fn = (fused_update if dispatch.kernels_enabled(leaves[0].p) else
        plain_fused_update)
  fn(leaves, kind, lr, c1, c2, b1, b2, eps, decay, ok)


# ------------------------------------------------------------------ apply


@torch.no_grad()
def apply_update(plan: FusedPlan, optimizer,
                 ema: Optional[Mapping[torch.Tensor, torch.Tensor]] = None,
                 ok: Optional[torch.Tensor] = None) -> bool:
  """The fused replacement of ``optimizer.step()`` + the EMA update + the
  guard's select, in place on the parameters, the optimizer's state and
  ``ema`` (float32 EMA tensors keyed by their parameter).

  ``ok`` is the guard's one-element bool tensor on the parameters' device
  (None: no guard). Where it holds False, the kernel writes nothing and the
  counts stay: everything is left as it was. Its value is read back once
  (a one-byte copy) to advance the host-side counts; without the guard
  nothing is read back. Returns whether the update was applied.

  Parameters without a gradient are skipped, as the stock optimizer skips
  them; their EMA still takes its blend, as the stock EMA does. Adam's
  moments are created as zeros at the first step, as the stock ``Adam``
  creates them, before the guard is read.
  """
  spec = plan.spec
  adam = spec.kind == 'adam'
  groups = optimizer.param_groups
  count = groups[0].get('count', 0)
  # The rate at the pre-increment count, as optax's scale_by_schedule.
  rate = spec.learning_rate
  lr = float(rate(count) if callable(rate) else rate)
  c1 = c2 = 1.0
  if adam:
    c1 = float(bias_correction(spec.b1, count + 1))
    c2 = float(bias_correction(spec.b2, count + 1))
  decay = plan.ema_decay if ema is not None else None
  leaves, idle_emas, idle_params = [], [], []
  for group in groups:
    for p in group['params']:
      p_ema = ema.get(p) if decay is not None else None
      if p.grad is None:
        if p_ema is not None:
          idle_emas.append(p_ema)
          idle_params.append(p.detach())
        continue
      mu = nu = None
      if adam:
        state = optimizer.state[p]
        if not state:
          state['mu'] = torch.zeros_like(p, memory_format=torch.preserve_format)
          state['nu'] = torch.zeros_like(p, memory_format=torch.preserve_format)
        mu, nu = state['mu'], state['nu']
      leaves.append(Leaf(p.detach(), p.grad, mu, nu, p_ema))
  update_leaves(leaves, spec.kind, lr, c1, c2, spec.b1, spec.b2, spec.eps,
                decay, ok)
  applied = True if ok is None else bool(ok)
  if applied:
    if idle_emas:
      torch._foreach_mul_(idle_emas, decay)  # pylint: disable=protected-access
      torch._foreach_add_(idle_emas, idle_params, alpha=1.0 - decay)  # pylint: disable=protected-access
    for group in groups:
      if 'count' in group:
        group['count'] += 1
  return applied

