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
  :func:`apply_update` launches the kernel (``csrc/fused_update.cu``) for
  CUDA tensors and runs :func:`plain_fused_update` for CPU tensors.
  Nothing else switches the path.
* :func:`apply_update` is the trainer's entry: the fused replacement of
  ``optimizer.step()`` + the EMA update + the guard's select, in place. It
  keeps the stock optimizer's ``state_dict`` exactly (``mu``, ``nu`` per
  parameter, ``count`` in the parameter groups), so a fused run and a stock
  run are interchangeable.

The kernel reads its leaves' pointers from a table passed by value, one
launch for up to :data:`LEAVES_PER_LAUNCH` parameters (every path's in one
launch a step); the learning rate and the bias corrections are host floats
passed by value, or, for a step that a CUDA graph replays, read from a
small device buffer (``rates``) that the trainer fills before each replay;
the guard's flag is read on the device.
:func:`fused_update` is the one-shot entry: it validates its leaves and
packs their table at every call. The trainer's :func:`apply_update` packs
the table from each step's addresses too, but validates the leaves once (a
:class:`PreparedUpdate`), and each step only checks by identity and
address that the tensors are those it validated, and the new gradients'
layouts.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
import logging
import math
import operator
from typing import (Callable, List, Mapping, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from tensor2robot_tpu_torch.ops import _build
from tensor2robot_tpu_torch.ops import _dispatch as dispatch

# Leaves per launch: the kernel's by-value pointer table (kMaxLeaves in
# csrc/fused_update.cu), sized to Hopper's 32,764 bytes of kernel
# parameters. Every path's parameters fit one launch.
LEAVES_PER_LAUNCH = 512
KINDS = ('adam', 'sgd')
# A packed leaf is one row of the table the C entry reads: the device
# addresses of p, g, mu, nu and ema (0 where the variant does not read
# it), then the element count.
_ROW = 6
_G_COLUMN = 1

_SIGNATURES = {
    't2r_fused_update': [ctypes.c_void_p] + [ctypes.c_int] * 4 +
                        [ctypes.c_void_p] * 2 + [ctypes.c_float] * 10 +
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
  """A decision to run the fused pass (see :func:`plan_for`). ``prepared``
  keeps one slot: the last step's :class:`PreparedUpdate` (see
  :func:`prepare`)."""

  spec: FusedSpec
  ema_decay: Optional[float] = None
  prepared: list = dataclasses.field(default_factory=lambda: [None],
                                     compare=False, repr=False)


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


def host_bias_correction(decay: float, count: int) -> float:
  """:func:`bias_correction` as a Python float, bit for bit, without a
  tensor: torch raises a float32 scalar to an integer power in double
  precision and rounds once, except the cube, which it multiplies out in
  float32."""
  base = np.float32(decay)
  power = (base * base * base if count == 3 else
           np.float32(math.pow(float(base), count)))
  return float(np.float32(1.0) - power)


def host_rates(spec: FusedSpec, count: int) -> Tuple[float, float, float]:
  """(lr, c1, c2) of the update applied at ``count`` (optax's
  pre-increment count): the rate, and for Adam the bias corrections at
  ``count + 1`` (1.0 for SGD), as the kernel takes them."""
  rate = spec.learning_rate
  lr = float(rate(count) if callable(rate) else rate)
  if spec.kind != 'adam':
    return lr, 1.0, 1.0
  return (lr, host_bias_correction(spec.b1, count + 1),
          host_bias_correction(spec.b2, count + 1))


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


def _pack(columns: Sequence[Optional[Sequence[torch.Tensor]]]) -> np.ndarray:
  """The table the C entry reads from the leaves as columns (p, g, mu, nu,
  ema): one row of :data:`_ROW` int64 values a non-empty leaf, the
  addresses of its five tensors (0 for a column that is None), then its
  element count."""
  table = np.zeros((len(columns[0]), _ROW), np.int64)
  for column, tensors in enumerate(columns):
    if tensors is not None:
      table[:, column] = list(map(torch.Tensor.data_ptr, tensors))
  table[:, _ROW - 1] = list(map(torch.Tensor.numel, columns[0]))
  return table[table[:, _ROW - 1] > 0]


def _check_ok(ok: torch.Tensor, device: torch.device) -> None:
  if ok.device != device or ok.dtype != torch.bool or ok.numel() != 1:
    raise ValueError('fused_update: ok must be one bool element on the '
                     "parameters' device.")


def _check_rates(rates: torch.Tensor, device: torch.device) -> None:
  if (rates.device != device or rates.dtype != torch.float32 or
      rates.shape != (3,) or not rates.is_contiguous()):
    raise ValueError('fused_update: rates must be a contiguous float32 '
                     "tensor of three (lr, c1, c2) on the parameters' "
                     'device.')


def _launch(table: np.ndarray, device: torch.device, kind: str, lr: float,
            c1: float, c2: float, b1: float, b2: float, eps: float,
            decay: Optional[float], ok: Optional[torch.Tensor],
            rates: Optional[torch.Tensor] = None) -> None:
  """Launches the kernel over a packed ``table`` on the current stream:
  one launch per :data:`LEAVES_PER_LAUNCH` rows. With ``rates`` the kernel
  reads lr, c1 and c2 from that device buffer and ignores the floats."""
  adam, has_ema, guard = kind == 'adam', decay is not None, ok is not None
  decay = 0.0 if decay is None else float(decay)
  table = np.ascontiguousarray(table, np.int64)
  address = table.ctypes.data
  lib = _build.load('fused_update', _SIGNATURES)
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    for start in range(0, len(table), LEAVES_PER_LAUNCH):
      count = min(LEAVES_PER_LAUNCH, len(table) - start)
      status = lib.t2r_fused_update(
          address + start * table.strides[0], count, int(adam), int(has_ema),
          int(guard), ok.data_ptr() if guard else None,
          None if rates is None else rates.data_ptr(), lr, c1, c2, b1, b2,
          1.0 - b1, 1.0 - b2, eps, decay, 1.0 - decay, stream)
      _build.check(lib, status, 'fused_update')
      fused_update.launches += 1


def fused_update(leaves: Sequence[Leaf], kind: str, lr: float, c1: float,
                 c2: float, b1: float, b2: float, eps: float,
                 decay: Optional[float],
                 ok: Optional[torch.Tensor] = None,
                 rates: Optional[torch.Tensor] = None) -> None:
  """Launches the CUDA kernel (``csrc/fused_update.cu``) over ``leaves`` on
  the current stream, in place: one launch per
  :data:`LEAVES_PER_LAUNCH` leaves. The one-shot entry: it validates the
  leaves and packs their table at every call (the trainer's
  :func:`apply_update` packs once, see :class:`PreparedUpdate`).

  ``kind`` is 'adam' or 'sgd'; ``decay`` None leaves the EMA off; ``ok``
  (a one-element CUDA bool tensor) turns the guard on: where it holds
  False nothing is written. ``rates`` (a float32 CUDA tensor of three)
  makes the kernel read lr, c1 and c2 from the device in place of the
  floats. Raises on CPU tensors, on a tensor whose dtype, shape or strides
  differ from its parameter's, and on a launch error.
  """
  if kind not in KINDS:
    raise ValueError(f'fused_update kind must be one of {KINDS}, got {kind!r}')
  leaves = [leaf for leaf in leaves if leaf.p.numel()]
  if not leaves:
    return
  device = leaves[0].p.device
  if device.type != 'cuda':
    raise ValueError(f'fused_update takes CUDA tensors, got {device}.')
  adam, has_ema = kind == 'adam', decay is not None
  _check_leaves(leaves, adam, has_ema, device)
  if ok is not None:
    _check_ok(ok, device)
  if rates is not None:
    _check_rates(rates, device)
  columns = [list(column) for column in zip(*leaves)]
  for column, used in ((2, adam), (3, adam), (4, has_ema)):
    columns[column] = columns[column] if used else None
  _launch(_pack(columns), device, kind, lr, c1, c2, b1, b2, eps, decay, ok,
          rates)


fused_update.launches = 0


@torch.no_grad()
def plain_fused_update(leaves: Sequence[Leaf], kind: str, lr: float,
                       c1: float, c2: float, b1: float, b2: float,
                       eps: float, decay: Optional[float],
                       ok: Optional[torch.Tensor] = None,
                       rates: Optional[torch.Tensor] = None) -> None:
  """The kernel's function in plain PyTorch, on any device, in place.

  Transcribes the JAX package's ``_make_kernel`` term for term: the
  moments, the bias-corrected update with eps outside the root, the apply,
  the EMA blend, then ``where(ok, new, old)`` for every output. With
  ``rates`` (float32 lr, c1, c2 on the leaves' device, the kernel's
  device buffer) it reads those in place of the floats: the same float32
  values give the same bits.
  """
  if kind not in KINDS:
    raise ValueError(f'fused_update kind must be one of {KINDS}, got {kind!r}')
  if rates is not None:
    lr, c1, c2 = rates.unbind(0)
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


# ------------------------------------------------------------------ apply


# Per-element accessors for the per-step checks, which map them over every
# parameter in C rather than loop in Python.
_GRAD = operator.attrgetter('grad')
_DTYPE = operator.attrgetter('dtype')
_SHAPE = operator.attrgetter('shape')
_MU = operator.itemgetter('mu')
_NU = operator.itemgetter('nu')
_DATA_PTR = torch.Tensor.data_ptr
_STRIDE = torch.Tensor.stride


def _same(a: Sequence, b: Sequence) -> bool:
  """Whether ``a`` and ``b`` hold the same objects in the same order."""
  return len(a) == len(b) and all(map(operator.is_, a, b))


class Operands(NamedTuple):
  """One step's operands of :func:`apply_update`, read afresh from the
  optimizer and the EMA mapping. ``columns`` are the leaves as the table's
  first five columns (p, g, mu, nu, ema; the parameters with a gradient,
  in group order), None where the variant does not read one; ``idle`` the
  parameters without a gradient and their EMA tensors, which still take
  the EMA blend."""

  has_grad: List[bool]
  columns: List[Optional[List[torch.Tensor]]]
  idle: List[List[torch.Tensor]]

  def fixed(self) -> List[torch.Tensor]:
    """Every tensor but the gradients."""
    p, _, *state = self.columns
    return list(itertools.chain(p, *filter(None, state), *self.idle))

  def leaves(self) -> List[Leaf]:
    p, *rest = self.columns
    none = [None] * len(p)
    return list(map(Leaf, map(torch.Tensor.detach, p),
                    *(none if c is None else c for c in rest)))


def _operands(plan: FusedPlan, optimizer,
              ema: Optional[Mapping[torch.Tensor, torch.Tensor]]) -> Operands:
  """This step's :class:`Operands`. Adam's moments of a parameter without
  state are created as zeros, as the stock ``Adam`` creates them at its
  first step."""
  everything = [p for group in optimizer.param_groups for p in group['params']]
  grads = list(map(_GRAD, everything))
  has_grad = list(map(operator.is_not, grads, itertools.repeat(None)))
  params = list(itertools.compress(everything, has_grad))
  columns = [params, list(itertools.compress(grads, has_grad)), None, None,
             None]
  idle = []
  if plan.spec.kind == 'adam':
    slots = list(map(optimizer.state.__getitem__, params))
    for p, slot in zip(params, slots) if not all(slots) else ():
      if not slot:
        slot['mu'] = torch.zeros_like(p, memory_format=torch.preserve_format)
        slot['nu'] = torch.zeros_like(p, memory_format=torch.preserve_format)
    columns[2:4] = list(map(_MU, slots)), list(map(_NU, slots))
  if ema is not None and plan.ema_decay is not None:
    columns[4] = list(map(ema.get, params))
    idle = [p for p, has in zip(everything, has_grad) if not has and p in ema]
    idle = [idle, list(map(ema.__getitem__, idle))]
  return Operands(has_grad, columns, idle)


class PreparedUpdate:
  """The validated leaves of one optimizer's fused update, kept for the
  steps that follow.

  Built from a step's :class:`Operands`, it validates every non-empty leaf
  as :func:`fused_update` does. :meth:`holds` tells, at a later step,
  whether that validation still stands: the same parameters have
  gradients, the parameters, moments and EMA tensors are the same objects
  (it keeps them, so none is freed while it is compared) at the same
  addresses (``Module.to`` moves a parameter's storage under the same
  object), and each new gradient has its predecessor's dtype and layout.
  The trainer sets the gradients to None every step, so they are the one
  thing new. Where it holds, the table's other columns are those packed
  at validation, so :meth:`pack` writes only the gradients' addresses.
  """

  def __init__(self, operands: Operands):
    leaves = [leaf for leaf in operands.leaves() if leaf.p.numel()]
    if leaves:
      _check_leaves(leaves, operands.columns[2] is not None,
                    operands.columns[4] is not None, leaves[0].p.device)
    self.has_grad = operands.has_grad
    self.fixed = operands.fixed()
    if any(t is None for t in self.fixed):
      raise ValueError('fused_update: a parameter has no EMA tensor.')
    self.addresses = list(map(_DATA_PTR, self.fixed))
    grads = operands.columns[_G_COLUMN]
    self.grad_layouts = list(map(_STRIDE, grads)), list(map(_SHAPE, grads))
    self.rows = [bool(p.numel()) for p in operands.columns[0]]
    # The table without the gradients' column.
    self.base = _pack([None if column == _G_COLUMN else tensors
                       for column, tensors in enumerate(operands.columns)])

  def holds(self, operands: Operands) -> bool:
    """Whether this validation stands for ``operands`` (see the class
    doc)."""
    grads = operands.columns[_G_COLUMN]
    return (operands.has_grad == self.has_grad and
            _same(operands.fixed(), self.fixed) and
            list(map(_DATA_PTR, self.fixed)) == self.addresses and
            all(map(operator.is_, map(_DTYPE, grads),
                    itertools.repeat(torch.float32))) and
            (list(map(_STRIDE, grads)), list(map(_SHAPE, grads))) ==
            self.grad_layouts)

  def pack(self, operands: Operands) -> np.ndarray:
    """The kernel's table for ``operands``, for which it holds."""
    table = self.base.copy()
    table[:, _G_COLUMN] = list(map(
        _DATA_PTR, itertools.compress(operands.columns[_G_COLUMN], self.rows)))
    return table


def prepare(plan: FusedPlan, optimizer,
            ema: Optional[Mapping[torch.Tensor, torch.Tensor]] = None):
  """(a :class:`PreparedUpdate` that holds for this step, this step's
  :class:`Operands`): the plan's kept one when it holds, else one
  validated anew and kept in its place. Keyed on nothing: the trainer
  builds a new EMA mapping every step, and whether it holds is decided by
  the tensors themselves."""
  operands = _operands(plan, optimizer, ema)
  prepared = plan.prepared[0]
  if prepared is None or not prepared.holds(operands):
    prepared = PreparedUpdate(operands)
    plan.prepared[0] = prepared
  return prepared, operands


@torch.no_grad()
def apply_update(plan: FusedPlan, optimizer,
                 ema: Optional[Mapping[torch.Tensor, torch.Tensor]] = None,
                 ok: Optional[torch.Tensor] = None,
                 rates: Optional[torch.Tensor] = None) -> bool:
  """The fused replacement of ``optimizer.step()`` + the EMA update + the
  guard's select, in place on the parameters, the optimizer's state and
  ``ema`` (float32 EMA tensors keyed by their parameter): the kernel for
  CUDA tensors, one launch over the table packed this step (see
  :func:`prepare`), the plain version for CPU tensors.

  ``ok`` is the guard's one-element bool tensor on the parameters' device
  (None: no guard). Where it holds False, the kernel writes nothing and the
  counts stay: everything is left as it was. Its value is read back once
  (a one-byte copy) to advance the host-side counts; without the guard
  nothing is read back. Returns whether the update was applied.

  ``rates`` (a float32 tensor of three on the parameters' device: lr, c1,
  c2, from :func:`host_rates`) is the form a captured CUDA graph replays:
  the kernel reads the rates from that buffer, nothing is read back, the
  host counts stay (the caller advances them once it knows how many
  updates applied) and the function returns True. The table is packed
  from this call's gradients, which a graph keeps at fixed addresses.

  Parameters without a gradient are skipped, as the stock optimizer skips
  them; their EMA still takes its blend, as the stock EMA does. Adam's
  moments are created as zeros at the first step, as the stock ``Adam``
  creates them, before the guard is read.
  """
  spec = plan.spec
  groups = optimizer.param_groups
  lr, c1, c2 = host_rates(spec, groups[0].get('count', 0))
  prepared, operands = prepare(plan, optimizer, ema)
  decay = plan.ema_decay if operands.columns[4] is not None else None
  params = operands.columns[0]
  if params:
    if dispatch.kernels_enabled(params[0]):
      table = prepared.pack(operands)
      if len(table):
        if ok is not None:
          _check_ok(ok, params[0].device)
        if rates is not None:
          _check_rates(rates, params[0].device)
        _launch(table, params[0].device, spec.kind, lr, c1, c2, spec.b1,
                spec.b2, spec.eps, decay, ok, rates)
    else:
      plain_fused_update(operands.leaves(), spec.kind, lr, c1, c2, spec.b1,
                         spec.b2, spec.eps, decay, ok, rates)
  if rates is not None:
    if operands.idle and operands.idle[0]:
      idle_params, idle_emas = operands.idle
      blended = torch._foreach_add(  # pylint: disable=protected-access
          torch._foreach_mul(idle_emas, decay), idle_params,  # pylint: disable=protected-access
          alpha=1.0 - decay)
      for old, new in zip(idle_emas, blended):
        old.copy_(new if ok is None else torch.where(ok.reshape(()), new,
                                                     old))
    return True
  applied = True if ok is None else bool(ok)
  if applied:
    if operands.idle and operands.idle[0]:
      idle_params, idle_emas = operands.idle
      torch._foreach_mul_(idle_emas, decay)  # pylint: disable=protected-access
      torch._foreach_add_(idle_emas, idle_params,  # pylint: disable=protected-access
                          alpha=1.0 - decay)
    for group in groups:
      if 'count' in group:
        group['count'] += 1
  return applied
