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
host integers that a skipped step does not advance.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

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
