"""JAX variables -> port state_dict for the Grasping44 network.

Takes the variables tree the JAX package serves from
(``jax.device_get(state.eval_variables)``: ``{'params': ...,
'batch_stats': ...}`` with numpy leaves) and returns the ``state_dict`` of
``research/qtopt/networks.Grasping44``:

* conv kernels HWIO -> OIHW (``conv<l>/Conv_0/kernel`` ->
  ``conv<l>.conv.weight``); ``conv1_1/kernel`` stays HWIO, because the
  port's ``SpaceToDepthConv`` keeps flax's ``nn.Conv`` tree;
* Dense kernels [in, out] -> [out, in] (``weight``), biases unchanged;
* BatchNorm ``scale``/``bias`` (params) and ``mean``/``var``
  (batch_stats), including the ``bn1`` tree of ``_PooledBatchNormRelu``;
* flax's auto-numbered top-level ``BatchNorm_<i>``: ``BatchNorm_0`` is the
  grasp embedding's (``fcgrasp_bn``), ``BatchNorm_<i>`` for i >= 1 is
  ``fc<i-1>``'s (``fc<i-1>_bn``), in the order the JAX module calls them.

Every leaf must map: an unmapped key, a collection the port does not hold
(e.g. ``fp8_stats``), or two keys mapping to one name raises instead of
being left unused. Loading with ``load_state_dict(strict=True)`` then
raises on any name the network expects and the tree lacks.
"""

from __future__ import annotations

import re
from collections import abc as collections_abc
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_CONV = re.compile(r'conv\d+$')
_DENSE = re.compile(r'(fcgrasp|fcgrasp2|fc\d+|logit|logit_\d+)$')
_TOP_BN = re.compile(r'BatchNorm_(\d+)$')


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
  for key, value in tree.items():
    path = prefix + (str(key),)
    if isinstance(value, collections_abc.Mapping):
      yield from _flatten(value, path)
    else:
      yield path, value


def _top_bn_name(index: int) -> str:
  return 'fcgrasp_bn' if index == 0 else f'fc{index - 1}_bn'


def _hwio_to_oihw(a: np.ndarray) -> np.ndarray:
  return a.transpose(3, 2, 0, 1)


def _dense_to_linear(a: np.ndarray) -> np.ndarray:
  return a.T


def _rule(path: Tuple[str, ...]) -> Optional[Tuple[str, Any]]:
  """(port name, transform) for one flax leaf path, or None."""
  collection, *head, leaf = path
  if collection == 'params':
    if head == ['conv1_1'] and leaf in ('kernel', 'bias'):
      return f'conv1_1.{leaf}', None
    if len(head) == 2 and _CONV.match(head[0]):
      if head[1] == 'Conv_0' and leaf == 'kernel':
        return f'{head[0]}.conv.weight', _hwio_to_oihw
      if head[1] == 'BatchNorm_0' and leaf in ('scale', 'bias'):
        return f'{head[0]}.bn.{leaf}', None
    if head == ['bn1'] and leaf == 'bias':
      return 'bn1.bias', None
    if len(head) == 1:
      bn = _TOP_BN.match(head[0])
      if bn and leaf in ('scale', 'bias'):
        return f'{_top_bn_name(int(bn.group(1)))}.{leaf}', None
      if _DENSE.match(head[0]):
        if leaf == 'kernel':
          return f'{head[0]}.weight', _dense_to_linear
        if leaf == 'bias':
          return f'{head[0]}.bias', None
  elif collection == 'batch_stats' and leaf in ('mean', 'var'):
    if len(head) == 2 and _CONV.match(head[0]) and head[1] == 'BatchNorm_0':
      return f'{head[0]}.bn.{leaf}', None
    if head == ['bn1']:
      return f'bn1.{leaf}', None
    if len(head) == 1:
      bn = _TOP_BN.match(head[0])
      if bn:
        return f'{_top_bn_name(int(bn.group(1)))}.{leaf}', None
  return None


def jax_variables_to_torch(
    variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """The Grasping44 JAX variables tree -> the port's ``state_dict``."""
  state_dict: Dict[str, torch.Tensor] = {}
  sources: Dict[str, str] = {}
  unmapped = []
  for path, value in _flatten(variables):
    rule = _rule(path)
    key = '/'.join(path)
    if rule is None:
      unmapped.append(key)
      continue
    name, transform = rule
    if name in sources:
      raise ValueError(
          f'{key!r} and {sources[name]!r} both map to {name!r}.')
    array = np.array(value, dtype=np.float32)
    if transform is not None:
      array = transform(array)
    state_dict[name] = torch.from_numpy(np.ascontiguousarray(array))
    sources[name] = key
  if unmapped:
    raise ValueError(
        f'Unmapped JAX variables (no Grasping44 counterpart): {unmapped}')
  return state_dict
