"""Warm start: partial restore from a checkpoint, the port's counterpart of
``tensor2robot_tpu/models/warm_start.py``.

:func:`default_init_from_checkpoint_fn` returns the hook that
``AbstractT2RModel(init_from_checkpoint_fn=...)`` runs on the freshly
initialised network, before the optimizer and the EMA are built: every
entry of the network's ``state_dict`` whose name (and shape) the source
holds is copied from it, the rest keeps its fresh initialisation.
:func:`create_resnet_init_from_checkpoint_fn` restores a ResNet backbone
and leaves the FiLM generator and the classifier head fresh.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from tensor2robot_tpu_torch.train import checkpoints as ckpt_lib


def load_checkpoint_state_dict(checkpoint_path: str
                               ) -> Dict[str, torch.Tensor]:
  """The network ``state_dict`` of a trainer step directory
  (``ckpt_<n>/``, its trained parameters, not the EMA), a checkpoint
  payload file, or a bare ``state_dict`` file."""
  if os.path.isdir(checkpoint_path):
    checkpoint_path = ckpt_lib.state_path(checkpoint_path)
  tree = torch.load(checkpoint_path, map_location='cpu', weights_only=True)
  if 'network' in tree and 'step' in tree:
    return tree['network']
  return tree


def default_init_from_checkpoint_fn(
    checkpoint_path: str,
    include: Optional[Sequence[str]] = None,
    exclude: Sequence[str] = (),
    source_prefix: str = '',
    target_prefix: str = '',
    restore_model_state: bool = True) -> Callable[[nn.Module], None]:
  """Builds an ``init_from_checkpoint_fn(network)`` hook.

  Args:
    checkpoint_path: the source (see :func:`load_checkpoint_state_dict`).
    include: if given, only names containing one of these substrings are
      restored.
    exclude: names containing any of these substrings keep their fresh
      initialisation (e.g. a classifier head).
    source_prefix: prefix the source's names carry in place of
      ``target_prefix`` (restore a submodule trained on its own into a
      larger network).
    target_prefix: only names starting with it are matched.
    restore_model_state: also restore matching buffers (batch statistics).

  Returns:
    A hook that restores every matching (name, shape) entry in place and
    raises ``ValueError`` when no parameter matched.
  """

  def selected(name: str) -> bool:
    if include is not None and not any(s in name for s in include):
      return False
    return not any(s in name for s in exclude)

  @torch.no_grad()
  def init_fn(network: nn.Module) -> None:
    source = load_checkpoint_state_dict(checkpoint_path)
    params = {name for name, _ in network.named_parameters()}
    matched = state_matched = 0
    for name, target in network.state_dict().items():
      if not name.startswith(target_prefix) or not selected(name):
        continue
      if name not in params and not restore_model_state:
        continue
      key = source_prefix + name[len(target_prefix):]
      if key not in source:
        continue
      value = source[key]
      if tuple(value.shape) != tuple(target.shape):
        logging.warning('warm start: shape mismatch at %s: %s vs %s; '
                        'skipped', name, tuple(value.shape),
                        tuple(target.shape))
        continue
      target.copy_(value)
      if name in params:
        matched += 1
      else:
        state_matched += 1
    if matched == 0:
      raise ValueError(
          f'Warm start from {checkpoint_path!r} matched no parameters '
          f'(include={include}, exclude={list(exclude)}).')
    logging.info('warm start: restored %d params + %d state vars from %s',
                 matched, state_matched, checkpoint_path)

  return init_fn


def create_resnet_init_from_checkpoint_fn(
    checkpoint_path: str,
    restore_film: bool = False,
    restore_head: bool = False,
    **kwargs) -> Callable[[nn.Module], None]:
  """Pretrained-ResNet partial restore: the backbone (convs and norms) of
  a ``layers/resnet.py`` ``ResNet`` / ``FilmResNet`` checkpoint, keeping
  the FiLM generator (names containing ``film``) and the classifier head
  (``final_dense``) freshly initialised unless ``restore_film`` /
  ``restore_head`` ask for them. Other arguments go to
  :func:`default_init_from_checkpoint_fn`."""
  exclude = list(kwargs.pop('exclude', ()))
  if not restore_film:
    exclude.append('film')
  if not restore_head:
    exclude.append('final_dense')
  return default_init_from_checkpoint_fn(
      checkpoint_path, exclude=tuple(exclude), **kwargs)
