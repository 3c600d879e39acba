"""Train state: everything a training step mutates, in one object.

The port's counterpart of ``tensor2robot_tpu/train/train_state.py``. The
JAX package keeps an immutable pytree (step, params, batch statistics,
optimizer state, EMA, rng key) that each jitted step replaces. Here the
network module owns its parameters and batch statistics, the optimizer
owns its slots, and a step updates them in place, as is usual in PyTorch:
the state is the step count, the network, the optimizer, the EMA and the
generator that preprocessing draws from.

``ema`` is the JAX package's ``ema_params``: float32 copies of the
parameters, updated after every optimizer step as ``ema * decay + p *
(1 - decay)``, in place. It starts as a copy of the initial parameters. On
the fused update path (``TrainerConfig.fused_update``) the kernel writes the
EMA, so :func:`apply_ema` does not run.

The JAX state is a value, so its non-finite guard keeps the old one. Here
the network's batch statistics are updated in place by the forward pass and
the generator advances with every draw, so a guarded step takes a
:func:`snapshot` of both before it starts and :func:`restore` puts them back
when the step is skipped. The step count and the optimizer's counts are
host integers that a skipped step does not advance. A step that a captured
CUDA graph replays cannot read its flag on the host: it copies what it may
change on the device (:func:`guarded_tensors`, :func:`device_snapshot`)
and selects old against new there (:func:`device_select`), JAX's
``where(ok, new, old)``.

:func:`state_dict` and :func:`load_state_dict` carry the whole state to a
checkpoint payload and back: the step, the network's ``state_dict``
(parameters and batch statistics), the optimizer's (its slots, and each
group's ``count``, which drives the learning-rate schedule), the EMA and
the generator's state. A load copies into the live tensors (``copy_``) and
replaces none: the fused update's ``PreparedUpdate``
(``ops/fused_update.py``) keeps the very tensors it validated, and a
serving function keeps its network, so both go on with the loaded values.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
  step: int
  network: nn.Module
  optimizer: torch.optim.Optimizer
  ema: Optional[Dict[str, torch.Tensor]]
  generator: torch.Generator

  def ema_by_param(self) -> Optional[Dict[torch.Tensor, torch.Tensor]]:
    """The EMA tensors keyed by their parameter (None without averaging)."""
    if self.ema is None:
      return None
    return {p: self.ema[name] for name, p in self.network.named_parameters()}

  def eval_state_dict(self) -> Dict[str, torch.Tensor]:
    """The network's ``state_dict`` as eval and export read it: the EMA in
    place of the parameters when averaging is on, batch statistics as
    they are."""
    state = dict(self.network.state_dict())
    if self.ema is not None:
      state.update(self.ema)
    return state


@dataclasses.dataclass
class StepSnapshot:
  """What a step changes in place before its update: the network's buffers
  (batch statistics) and the generator's state."""

  buffers: Dict[str, torch.Tensor]
  generator_state: torch.Tensor


def snapshot(state: TrainState) -> StepSnapshot:
  return StepSnapshot(
      buffers={name: b.detach().clone()
               for name, b in state.network.named_buffers()},
      generator_state=state.generator.get_state())


@torch.no_grad()
def restore(state: TrainState, snap: StepSnapshot) -> None:
  """Puts a :func:`snapshot`'s buffers and generator state back."""
  for name, b in state.network.named_buffers():
    b.copy_(snap.buffers[name])
  state.generator.set_state(snap.generator_state)


def guarded_tensors(state: TrainState,
                    with_update: bool = True) -> List[torch.Tensor]:
  """What a guarded step changes in place: the batch statistics and, with
  ``with_update``, the parameters, the optimizer's slot tensors and the
  EMA (the fused kernel guards those itself)."""
  tensors = list(state.network.buffers())
  if with_update:
    tensors += list(state.network.parameters())
    for slots in state.optimizer.state.values():
      tensors += [v for v in slots.values() if isinstance(v, torch.Tensor)]
    tensors += list((state.ema or {}).values())
  return tensors


def device_snapshot(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
  """Copies of ``tensors`` on their devices: the old side of a device-side
  select (:func:`device_select`). Nothing is read back to the host, so a
  step inside a captured CUDA graph can take one."""
  return [t.detach().clone() for t in tensors]


@torch.no_grad()
def device_select(tensors: List[torch.Tensor], snap: List[torch.Tensor],
                  ok: torch.Tensor) -> None:
  """``where(ok, new, old)`` in place over ``tensors`` (JAX's guarded state
  transition): where the one-element flag ``ok`` is False, each tensor
  gets its :func:`device_snapshot` copy back, bit for bit."""
  flag = ok.reshape(())
  for live, old in zip(tensors, snap):
    live.copy_(torch.where(flag, live, old))


def create_train_state(model, generator: torch.Generator,
                       device) -> TrainState:
  """Builds the network with the model's initialisers (drawn on the CPU
  from ``generator``), runs the model's warm-start hook, moves it to
  ``device`` and builds the optimizer and the EMA on it."""
  network = model.create_module()
  model.init_network(network, generator)
  if model.init_from_checkpoint_fn is not None:
    model.init_from_checkpoint_fn(network)
  network = network.to(device)
  optimizer = model.create_optimizer()(network.parameters())
  ema = None
  if model.use_avg_model_params:
    ema = {name: p.detach().float().clone()
           for name, p in network.named_parameters()}
  return TrainState(step=0, network=network, optimizer=optimizer, ema=ema,
                    generator=generator)


@torch.no_grad()
def apply_ema(state: TrainState, decay: float) -> None:
  """One EMA update from the network's current parameters, in place (a
  no-op when averaging is off)."""
  if state.ema is None:
    return
  emas, params = [], []
  for name, p in state.network.named_parameters():
    emas.append(state.ema[name])
    params.append(p.detach().float())
  torch._foreach_mul_(emas, decay)  # pylint: disable=protected-access
  torch._foreach_add_(emas, params, alpha=1.0 - decay)  # pylint: disable=protected-access


def state_dict(state: TrainState) -> Dict[str, Any]:
  """The checkpoint payload of ``state``: references to the live tensors
  (a checkpoint manager copies them to the host)."""
  return {
      'step': state.step,
      'network': state.network.state_dict(),
      'optimizer': state.optimizer.state_dict(),
      'ema': state.ema,
      'generator': state.generator.get_state(),
  }


def eval_state_dict(payload: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """:meth:`TrainState.eval_state_dict` of a checkpoint payload: the EMA in
  place of the parameters when averaging is on."""
  state = dict(payload['network'])
  if payload.get('ema') is not None:
    state.update(payload['ema'])
  return state


def _copy_into(live: torch.Tensor, value: torch.Tensor, what: str) -> None:
  if live.shape != value.shape or live.dtype != value.dtype:
    raise ValueError(f'{what}: the checkpoint holds {tuple(value.shape)} '
                     f'{value.dtype}, the state {tuple(live.shape)} '
                     f'{live.dtype}')
  live.copy_(value)


@torch.no_grad()
def _load_optimizer(optimizer: torch.optim.Optimizer,
                    payload: Mapping[str, Any]) -> None:
  """The optimizer's ``state_dict`` into its live slots: a slot the state
  holds takes the payload's values in place; one it lacks is created like
  its parameter; one the payload lacks goes."""
  params = [p for group in optimizer.param_groups for p in group['params']]
  groups = payload['param_groups']
  sizes = [len(g['params']) for g in optimizer.param_groups]
  if sizes != [len(g['params']) for g in groups]:
    raise ValueError(f'The checkpoint\'s optimizer groups hold '
                     f'{[len(g["params"]) for g in groups]} parameters, the '
                     f'state\'s {sizes}.')
  by_id = dict(zip([i for group in groups for i in group['params']], params))
  saved = {by_id[i]: slots for i, slots in payload['state'].items()}
  for n, p in enumerate(params):
    live = optimizer.state[p]
    slots = saved.get(p, {})
    for key in [k for k in live if k not in slots]:
      del live[key]
    for key, value in slots.items():
      if not isinstance(value, torch.Tensor):
        live[key] = value
      elif isinstance(live.get(key), torch.Tensor):
        _copy_into(live[key], value, f'optimizer slot {key} of parameter {n}')
      elif value.shape == p.shape:
        live[key] = torch.empty_like(p, dtype=value.dtype).copy_(value)
      else:
        live[key] = value.to(p.device, copy=True)
    if not live:
      del optimizer.state[p]
  for group, saved_group in zip(optimizer.param_groups, groups):
    group.update({k: v for k, v in saved_group.items() if k != 'params'})


@torch.no_grad()
def load_state_dict(state: TrainState, payload: Mapping[str, Any]) -> None:
  """A :func:`state_dict` payload into ``state``, in place (module doc)."""
  state.network.load_state_dict(payload['network'], strict=True)
  _load_optimizer(state.optimizer, payload['optimizer'])
  ema = payload.get('ema')
  if (ema is None) != (state.ema is None) or (
      ema is not None and set(ema) != set(state.ema)):
    raise ValueError('The checkpoint\'s EMA does not match the state\'s '
                     f'(averaging {"on" if ema is not None else "off"} in the '
                     'checkpoint).')
  for name, value in (ema or {}).items():
    _copy_into(state.ema[name], value, f'EMA {name}')
  state.generator.set_state(payload['generator'])
  state.step = int(payload['step'])
