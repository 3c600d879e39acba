"""Activation recompute (rematerialisation) policies for the conv towers.

The port's counterpart of ``tensor2robot_tpu/layers/remat.py``. A model
names a policy and its towers run each block as a checkpoint region
(``torch.utils.checkpoint`` without re-entry): the forward keeps only the
block's inputs, and the backward recomputes the block's activations from
them. Activation memory then follows one block and the boundaries instead
of every block, at the price of about one more forward.

Policies (:data:`REMAT_POLICIES`):

* ``none``: no region; every activation the backward needs is kept.
* ``conv_towers``: each tower block is a region; inside it only the
  results of plain matrix products (``aten.mm`` / ``aten.addmm``: the JAX
  policy's "dots with no batch dimensions", cheap weight-stationary
  projections) are kept, so the large [B, C, H, W] conv and norm
  activations are recomputed.
* ``full``: the same regions, nothing inside them kept.

Wrapping a call leaves the module tree alone, so parameter and buffer
names are the same with and without recompute and checkpoints
interchange. The recomputed forward computes the same values as the
first one, so the gradients are bit for bit those without recompute.

Batch statistics: a train-mode batch norm updates its running averages in
its forward, and the backward's recompute runs that forward a second
time. :func:`recomputing` is True while a region recomputes (a
thread-local flag set by the region's recompute context, entered in the
thread that runs the backward), and the port's batch norms update their
running averages only when it is False, so each region's statistics move
once a step, as flax's remat moves them. Regions keep no random-number
state (``preserve_rng_state=False``): no tower draws random numbers, and
reading the card's generator state is not allowed while a CUDA graph
captures.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch
from torch.utils import checkpoint as torch_checkpoint

REMAT_NONE = 'none'
REMAT_CONV_TOWERS = 'conv_towers'
REMAT_FULL = 'full'
REMAT_POLICIES = (REMAT_NONE, REMAT_CONV_TOWERS, REMAT_FULL)

_state = threading.local()


def validate_remat_policy(policy: Optional[str]) -> str:
  """Normalises/validates a policy name (None -> 'none')."""
  policy = REMAT_NONE if policy is None else str(policy)
  if policy not in REMAT_POLICIES:
    raise ValueError(
        f'Unknown remat_policy {policy!r}; expected one of {REMAT_POLICIES}.')
  return policy


def recomputing() -> bool:
  """Whether this thread is inside a region's backward recompute."""
  return getattr(_state, 'depth', 0) > 0


@contextlib.contextmanager
def _recompute_flag():
  _state.depth = getattr(_state, 'depth', 0) + 1
  try:
    yield
  finally:
    _state.depth -= 1


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
  del ctx, args, kwargs
  return (torch_checkpoint.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
          else torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def _contexts(policy: str):
  """(forward context, recompute context) of one region."""
  if policy == REMAT_CONV_TOWERS:
    forward, recompute = torch_checkpoint.create_selective_checkpoint_contexts(
        _save_dots)
  else:
    forward, recompute = contextlib.nullcontext(), contextlib.nullcontext()

  @contextlib.contextmanager
  def flagged():
    with recompute, _recompute_flag():
      yield

  return forward, flagged()


def checkpointed(fn: Callable, policy: Optional[str], *args):
  """``fn(*args)``, as a checkpoint region under ``policy`` (a plain call
  for 'none')."""
  policy = validate_remat_policy(policy)
  if policy == REMAT_NONE or not torch.is_grad_enabled():
    return fn(*args)
  return torch_checkpoint.checkpoint(
      fn, *args, use_reentrant=False, preserve_rng_state=False,
      context_fn=lambda: _contexts(policy))
