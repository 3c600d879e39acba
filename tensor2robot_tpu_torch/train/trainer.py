"""The trainer core: the port's counterpart of
``tensor2robot_tpu/train/trainer.py``.

``Trainer(model, TrainerConfig(...)).train(batch_iter)`` pulls (features,
labels) batches of numpy arrays, as the JAX trainer does, and runs one
step per batch on ``device`` (the card unless the caller asks for the
CPU). A step follows the JAX step body with one microbatch: preprocess the
whole batch, forward in TRAIN mode (batch statistics update in place),
loss, backward, then the update, on one of two arms:

* stock: ``optimizer.step()``, then the EMA;
* fused (``fused_update=True`` and a tagged optimizer, see
  ``ops/fused_update.py``): one kernel pass a step runs the optimizer, the
  EMA and the guard's select, from a pointer table packed once per
  optimizer in which only the gradients' addresses change.

With ``nonfinite_mode`` ``'skip_update'`` or ``'raise'``, the step computes
:func:`all_finite` over the loss and the gradients on the device. The fused
arm hands that flag to the kernel, which writes nothing when it is False;
the stock arm reads it and does not step. Either way the host reads the
flag once (a one-byte copy), keeps the step and the optimizer's counts, and
restores the batch statistics and the generator (``train_state.snapshot``),
so a bad batch leaves the state as if it had never been drawn; the policy
(``train/resilience.py``) counts it, halts after ``nonfinite_halt_after``
consecutive bad steps, or raises at once. The JAX trainer reads its flag one
dispatch later; here ``'raise'`` raises at the bad step itself, with the
same state. With the guard off a step adds no synchronisation.

A step returns ``{'loss', 'q_mean'}``-style summaries as device tensors, so
it does not wait for the card; ``train`` reads them at log intervals and at
the end. Training stops at ``max_train_steps`` applied updates or when the
iterator runs out.

What the JAX trainer does beyond that is not ported yet and raises
instead of being ignored: checkpoints (a non-empty ``model_dir``) and
interleaved eval (``eval_iter_fn``). Batches move to the card
synchronously; an overlapped record feed comes later.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.ops import _dispatch as dispatch
from tensor2robot_tpu_torch.ops import fused_update as fused_lib
from tensor2robot_tpu_torch.specs import algebra
from tensor2robot_tpu_torch.train import resilience
from tensor2robot_tpu_torch.train.train_state import (TrainState, apply_ema,
                                                      create_train_state,
                                                      restore, snapshot)

Batch = Tuple[Mapping[str, Any], Optional[Mapping[str, Any]]]

_NOT_YET = ('is not ported yet: checkpoints, resume, eval and '
            'train_eval_model are ROADMAP.md queue 1 item 3')


@dataclasses.dataclass
class TrainerConfig:
  """Run configuration (the subset of the JAX ``TrainerConfig`` the core
  honours)."""

  model_dir: str = ''
  max_train_steps: int = 1000
  log_interval_steps: int = 100
  seed: int = 0
  # The fused optimizer/EMA/guard update (ops/fused_update.py): over a
  # tagged optimizer (models/optimizers.py: Adam, GradientDescent) the whole
  # update runs as one kernel pass per LEAVES_PER_LAUNCH parameters; an
  # untagged optimizer keeps the stock path (logged once).
  fused_update: bool = False
  # 'off' | 'skip_update' | 'raise' (train/resilience.NonFinitePolicy); a
  # skip run halts after nonfinite_halt_after consecutive bad steps.
  nonfinite_mode: str = 'off'
  nonfinite_halt_after: int = 10


def all_finite(loss: torch.Tensor, grads) -> torch.Tensor:
  """Device-side guard flag: a one-element bool tensor, True when the loss
  and every floating gradient are finite. No host synchronisation.

  Two ``foreach`` norms over the gradients: a NaN anywhere makes the L1
  norm NaN, an infinity makes the max norm infinite (the L1 norm alone
  could overflow on large finite gradients; the max norm alone need not
  carry a NaN through every reduction order)."""
  grads = [g for g in grads if g is not None and g.is_floating_point()]
  checks = [torch.isfinite(loss.detach().float()).all().reshape(1)]
  if grads:
    l1 = torch.stack(torch._foreach_norm(grads, 1))  # pylint: disable=protected-access
    top = torch.stack(torch._foreach_norm(grads, float('inf')))  # pylint: disable=protected-access
    checks += [torch.isfinite(top).all().reshape(1),
               (~torch.isnan(l1)).all().reshape(1)]
  return torch.cat(checks).all().reshape(1)


class Trainer:
  """Owns the train state and runs training steps on one device."""

  def __init__(self, model, config: TrainerConfig, device='cuda'):
    if config.model_dir:
      raise NotImplementedError(f'model_dir (checkpoints) {_NOT_YET}.')
    self._nonfinite_policy = (
        resilience.NonFinitePolicy(config.nonfinite_mode,
                                   config.nonfinite_halt_after)
        if config.nonfinite_mode != 'off' else None)
    self._fused_plan: Optional[fused_lib.FusedPlan] = None
    self._model = model
    self._config = config
    self._device = dispatch.resolve_device(device)
    if hasattr(model, 'set_mesh'):
      # Mesh-aware models get the mesh the step runs over before any module
      # is built; the port's trainer runs on one device, so there is none.
      model.set_mesh(None)
    self._preprocessor = model.preprocessor
    self._state: Optional[TrainState] = None

  @property
  def model(self):
    return self._model

  @property
  def config(self) -> TrainerConfig:
    return self._config

  @property
  def state(self) -> Optional[TrainState]:
    return self._state

  @property
  def nonfinite_policy(self) -> Optional[resilience.NonFinitePolicy]:
    """The non-finite policy (None when ``nonfinite_mode='off'``)."""
    return self._nonfinite_policy

  @property
  def fused_plan(self) -> Optional[fused_lib.FusedPlan]:
    """The fused update's plan; None on the stock path."""
    return self._fused_plan

  @property
  def step(self) -> int:
    return 0 if self._state is None else self._state.step

  def initialize(self, features, labels=None) -> TrainState:
    """Creates the train state; ``features`` (one host batch) is checked
    against the data contract."""
    del labels
    algebra.validate_and_pack(
        self._preprocessor.get_in_feature_specification(ModeKeys.TRAIN),
        dict(features), ignore_batch=True)
    generator = torch.Generator().manual_seed(self._config.seed)
    self._state = create_train_state(self._model, generator, self._device)
    if self._config.fused_update:
      # plan_for logs the reason when it returns None (untagged optimizer or
      # unrecognised state).
      self._fused_plan = fused_lib.plan_for(
          self._state.optimizer,
          ema_decay=(self._model.avg_model_params_decay
                     if self._state.ema is not None else None))
    return self._state

  def _to_device(self, tensors) -> Optional[Dict[str, torch.Tensor]]:
    if tensors is None:
      return None
    out = {}
    for key, value in dict(tensors).items():
      if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.ascontiguousarray(value))
      out[key] = value.to(self._device)
    return out

  def _train_step(self, features, labels) -> Dict[str, torch.Tensor]:
    """One optimizer step on one host batch; returns device scalars."""
    state = self._state
    model = self._model
    policy = self._nonfinite_policy
    before = snapshot(state) if policy is not None else None
    features, labels = self._preprocessor.preprocess(
        self._to_device(features), self._to_device(labels), ModeKeys.TRAIN,
        state.generator)
    state.optimizer.zero_grad(set_to_none=True)
    outputs = model.inference_network_fn(state.network, features, labels,
                                         ModeKeys.TRAIN)
    loss, scalars = model.model_train_fn(features, labels, outputs,
                                         ModeKeys.TRAIN)
    loss.backward()
    ok = None
    if policy is not None:
      ok = all_finite(loss, [p.grad for p in state.network.parameters()])
    if self._fused_plan is not None:
      applied = fused_lib.apply_update(self._fused_plan, state.optimizer,
                                       state.ema_by_param(), ok)
    else:
      applied = ok is None or bool(ok)
      if applied:
        state.optimizer.step()
        apply_ema(state, model.avg_model_params_decay)
    if applied:
      state.step += 1
    else:
      restore(state, before)
    scalars = {k: v.detach() for k, v in scalars.items()}
    scalars['loss'] = loss.detach()
    if policy is not None:
      scalars['nonfinite_count'] = torch.tensor(0 if applied else 1)
      policy.observe(0 if applied else 1, state.step)
    return scalars

  def train(self,
            train_iter: Iterator[Batch],
            eval_iter_fn: Optional[Callable[[], Iterator[Batch]]] = None
            ) -> Dict[str, float]:
    """Steps until ``max_train_steps`` updates are applied or the iterator
    runs out; returns the last step's summaries as floats."""
    if eval_iter_fn is not None:
      raise NotImplementedError(f'eval_iter_fn (interleaved eval) {_NOT_YET}.')
    pending: Optional[Batch] = None
    if self._state is None:
      pending = next(train_iter)
      self.initialize(pending[0])
    config = self._config
    scalars: Dict[str, torch.Tensor] = {}
    while self._state.step < config.max_train_steps:
      if pending is None:
        pending = next(train_iter, None)
        if pending is None:
          break
      features, labels = pending
      pending = None
      scalars = self._train_step(features, labels)
      step = self._state.step
      if config.log_interval_steps and step % config.log_interval_steps == 0:
        logging.info('step %d: %s', step,
                     {k: float(v) for k, v in scalars.items()})
    return {k: float(v) for k, v in scalars.items()}
