"""JAX variables -> port state_dicts: Grasping44, the SNAIL networks, the
pose_env networks, the ResNet towers and Grasp2Vec.

:func:`jax_variables_to_torch` maps the Grasping44 tree;
:func:`snail_variables_to_torch` maps the SNAIL trees of the vrgripper
meta models (see its docstring); :func:`pose_env_variables_to_torch`
maps the pose_env regression and critic trees;
:func:`resnet_variables_to_torch` maps a ``ResNet`` / ``FilmResNet`` /
Grasp2Vec ``Embedding`` tree and :func:`grasp2vec_variables_to_torch` the
Grasp2Vec model's two towers;
:func:`optax_state_to_torch` carries an optax Adam, momentum or SGD
state, under gradient clipping and ``MultiSteps`` accumulation too, across
as the port optimizer's ``state_dict``;
:func:`jax_train_state_to_torch` maps a whole JAX ``TrainState`` onto the
port's checkpoint payload. The Grasping44 rules:

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
  ``fc<i-1>``'s (``fc<i-1>_bn``), in the order the JAX module calls them;
* the ``fp8_stats`` windows of ``matmul_precision='fp8'``
  (``<layer>/.../<lhs|rhs>/amax_history``) -> ``<layer>.fp8.<lhs|rhs>.
  amax_history`` (``conv<l>.conv.fp8...`` in the tower blocks; conv1's two
  flax scopes, one a kernel policy, both ``conv1_1.fp8...``).

Every leaf must map: an unmapped key, a collection the port does not hold,
or two keys mapping to one name raises instead of being left unused.
Loading with ``load_state_dict(strict=True)`` then raises on any name the
network expects and the tree lacks.
"""

from __future__ import annotations

import re
from collections import abc as collections_abc
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

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
  elif collection == 'fp8_stats' and leaf == 'amax_history':
    return _fp8_rule(head)
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


_FP8_SIDES = ('lhs', 'rhs')


def _fp8_rule(head) -> Optional[Tuple[str, Any]]:
  """An ``fp8_stats`` window (``.../<lhs|rhs>/amax_history``) -> the
  ``amax_history`` buffer of the port layer's ``fp8`` injection. conv1's
  scope is the conv injection's (``kernel_policy='none'``) or the
  space-to-depth conv's operand hook (``'pool_conv'``); both land on
  ``conv1_1.fp8``."""
  if not head or head[-1] not in _FP8_SIDES:
    return None
  side, scope = head[-1], head[:-1]
  if scope in (['conv1_1', 'Fp8ConvGeneralDilated_0'],
               ['conv1_1', '_ConvOperandQdq_0']):
    return f'conv1_1.fp8.{side}.amax_history', None
  if (len(scope) == 3 and _CONV.match(scope[0]) and
      scope[1:] == ['Conv_0', 'Fp8ConvGeneralDilated_0']):
    return f'{scope[0]}.conv.fp8.{side}.amax_history', None
  if (len(scope) == 2 and _DENSE.match(scope[0]) and
      scope[1] == 'Fp8DotGeneral_0'):
    return f'{scope[0]}.fp8.{side}.amax_history', None
  return None


def _mapped_state_dict(variables: Mapping[str, Any], rule, what: str
                       ) -> Dict[str, torch.Tensor]:
  """Every leaf through ``rule``; an unmapped leaf or two leaves mapping to
  one name raise."""
  state_dict: Dict[str, torch.Tensor] = {}
  sources: Dict[str, str] = {}
  unmapped = []
  for path, value in _flatten(variables):
    key = '/'.join(path)
    mapped = rule(path)
    if mapped is None:
      unmapped.append(key)
      continue
    name, transform = mapped
    if name in sources:
      raise ValueError(f'{key!r} and {sources[name]!r} both map to {name!r}.')
    array = np.array(value, dtype=np.float32)
    if transform is not None:
      array = transform(array)
    state_dict[name] = torch.from_numpy(np.ascontiguousarray(array))
    sources[name] = key
  if unmapped:
    raise ValueError(f'Unmapped JAX variables (no {what} counterpart): '
                     f'{unmapped}')
  return state_dict


def jax_variables_to_torch(
    variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """The Grasping44 JAX variables tree -> the port's ``state_dict``."""
  return _mapped_state_dict(variables, _rule, 'Grasping44')


# ------------------------------------------------------------ SNAIL trees

_SNAIL_SCOPES = {'Conv_0': 'conv', 'Dense_0': 'key', 'Dense_1': 'query',
                 'Dense_2': 'value'}
_DENSE_BLOCK = re.compile(r'DenseBlock_(\d+)$')


def _kernel_to_weight(a: np.ndarray) -> np.ndarray:
  """flax kernel layouts -> torch weight layouts, by rank: Dense [in, out]
  -> [out, in]; 1-D Conv [k, in, out] -> [out, in, k]; 2-D Conv HWIO ->
  OIHW."""
  if a.ndim == 2:
    return a.T
  if a.ndim == 3:
    return a.transpose(2, 1, 0)
  if a.ndim == 4:
    return _hwio_to_oihw(a)
  raise ValueError(f'No torch layout for a rank-{a.ndim} kernel')


def _snail_scope(name: str) -> str:
  block = _DENSE_BLOCK.match(name)
  if block:
    return f'blocks.{int(block.group(1)) - 1}'
  return _SNAIL_SCOPES.get(name, name)


def snail_variables_to_torch(
    variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """The JAX variables tree of a vrgripper SNAIL network
  (``_SnailSequenceNet`` / ``_LongHorizonSnailNet``, or any of their
  layers: the vision tower, ``TCBlock``, the attention blocks) -> the
  port's ``state_dict``.

  * scopes keep their names, except flax's automatic ones:
    ``DenseBlock_<i>`` -> ``blocks.<i-1>``, a CausalConv's ``Conv_0`` ->
    ``conv``, and in ``AttentionBlock`` ``Dense_0`` / ``Dense_1`` /
    ``Dense_2`` -> ``key`` / ``query`` / ``value`` (the order the flax
    module creates them); ``MultiHeadAttentionBlock`` names its own;
  * ``kernel`` -> ``weight`` in torch's layout (:func:`_kernel_to_weight`);
    ``bias`` and LayerNorm/BatchNorm ``scale`` keep their names;
  * ``batch_stats`` ``mean`` / ``var`` -> the BatchNorm buffers.

  Every leaf must map, as for :func:`jax_variables_to_torch`.
  """
  state_dict: Dict[str, torch.Tensor] = {}
  unmapped = []
  for path, value in _flatten(variables):
    collection, *head, leaf = path
    key = '/'.join(path)
    if collection == 'params' and leaf in ('kernel', 'bias', 'scale'):
      transform = _kernel_to_weight if leaf == 'kernel' else None
      leaf = 'weight' if leaf == 'kernel' else leaf
    elif collection == 'batch_stats' and leaf in ('mean', 'var'):
      transform = None
    else:
      unmapped.append(key)
      continue
    name = '.'.join([_snail_scope(h) for h in head] + [leaf])
    array = np.array(value, dtype=np.float32)
    if transform is not None:
      array = transform(array)
    state_dict[name] = torch.from_numpy(np.ascontiguousarray(array))
  if unmapped:
    raise ValueError(f'Unmapped JAX variables (no SNAIL counterpart): '
                     f'{unmapped}')
  return state_dict


_POSE_SCOPES = {'ImageFeaturesToPoseModel_0': 'pose_model'}
_FLAX_AUTO = re.compile(r'(LayerNorm|Dense)_(\d+)$')


def pose_env_variables_to_torch(
    variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """The JAX variables tree of a pose_env network (``_RegressionNet`` or
  ``_CriticNet`` of ``research/pose_env/pose_env_models.py``) -> the
  port's ``state_dict``.

  * scopes keep their names, except flax's automatic ones:
    ``ImageFeaturesToPoseModel_0`` -> ``pose_model``, inside it
    ``LayerNorm_<i>`` -> ``pose_norm<i>``; in the critic ``LayerNorm_<i>``
    -> ``norm<i>`` and ``Dense_<i>`` -> ``fc<i>``;
  * ``kernel`` -> ``weight`` in torch's layout (:func:`_kernel_to_weight`);
    ``bias``, LayerNorm ``scale`` and the MLP's ``bias_transform`` keep
    their names.

  Every leaf must map, as for :func:`jax_variables_to_torch`.
  """
  state_dict: Dict[str, torch.Tensor] = {}
  unmapped = []
  for path, value in _flatten(variables):
    collection, *head, leaf = path
    if collection != 'params' or leaf not in ('kernel', 'bias', 'scale',
                                              'bias_transform'):
      unmapped.append('/'.join(path))
      continue
    names = []
    in_pose = False
    for scope in head:
      if scope in _POSE_SCOPES:
        in_pose = True
        names.append(_POSE_SCOPES[scope])
        continue
      auto = _FLAX_AUTO.match(scope)
      if auto and auto.group(1) == 'LayerNorm':
        scope = f'{"pose_norm" if in_pose else "norm"}{auto.group(2)}'
      elif auto:
        scope = f'fc{auto.group(2)}'
      names.append(scope)
    array = np.array(value, dtype=np.float32)
    if leaf == 'kernel':
      array, leaf = _kernel_to_weight(array), 'weight'
    state_dict['.'.join(names + [leaf])] = torch.from_numpy(
        np.ascontiguousarray(array))
  if unmapped:
    raise ValueError(f'Unmapped JAX variables (no pose_env counterpart): '
                     f'{unmapped}')
  return state_dict


# ------------------------------------------------------ ResNet, Grasp2Vec

_RESNET_SCOPE = re.compile(
    r'(resnet|film_generator|film\d+|initial_conv|final_dense|conv[123]|proj|'
    r'block_layer\d+_block\d+)$')
_RESNET_NORM = re.compile(r'_BatchNorm_(\d+)$')
_GRASP2VEC_TOWERS = ('scene', 'goal')


def _resnet_rule(path: Tuple[str, ...]) -> Optional[Tuple[str, Any]]:
  """(port name, transform) for one leaf of a ResNet-family flax tree, or
  None: scopes keep their names, flax's ``_BatchNorm_<n>/BatchNorm_0``
  becomes ``bn<n>``; a conv or dense ``kernel`` becomes ``weight`` in
  torch's layout; norms carry ``scale``/``bias`` (params) and
  ``mean``/``var`` (batch_stats), dense layers ``bias``."""
  collection, *head, leaf = path
  names = []
  norm = False
  i = 0
  while i < len(head):
    scope = head[i]
    match = _RESNET_NORM.match(scope)
    if match:
      if head[i + 1:i + 2] != ['BatchNorm_0'] or i + 2 != len(head):
        return None
      names.append(f'bn{match.group(1)}')
      norm = True
      break
    if not _RESNET_SCOPE.match(scope):
      return None
    names.append(scope)
    i += 1
  if not names:
    return None
  dense = re.match(r'(final_dense|film\d+)$', names[-1]) is not None
  if collection == 'params':
    if norm and leaf in ('scale', 'bias'):
      return '.'.join(names + [leaf]), None
    if not norm and leaf == 'kernel':
      return '.'.join(names + ['weight']), _kernel_to_weight
    if dense and leaf == 'bias':
      return '.'.join(names + [leaf]), None
  elif collection == 'batch_stats' and norm and leaf in ('mean', 'var'):
    return '.'.join(names + [leaf]), None
  return None


def resnet_variables_to_torch(
    variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """The JAX variables tree of a ``ResNet``, ``FilmResNet`` or Grasp2Vec
  ``Embedding`` (``layers/resnet.py``, ``research/grasp2vec/
  networks.py``) -> the port module's ``state_dict``:

  * scopes keep their names (``resnet``, ``film_generator``, ``film<i>``,
    ``initial_conv``, ``block_layer<i>_block<j>``, ``conv1..3``, ``proj``,
    ``final_dense``); flax's ``_BatchNorm_<n>/BatchNorm_0`` -> ``bn<n>``;
  * conv kernels HWIO -> OIHW and Dense kernels [in, out] -> [out, in]
    (``weight``); biases and norm scales unchanged; ``batch_stats``
    ``mean`` / ``var`` -> the norms' buffers.

  Every leaf must map, as for :func:`jax_variables_to_torch`.
  """
  return _mapped_state_dict(variables, _resnet_rule, 'ResNet')


def _grasp2vec_rule(path: Tuple[str, ...]) -> Optional[Tuple[str, Any]]:
  collection, *head = path
  if len(head) < 2 or head[0] not in _GRASP2VEC_TOWERS:
    return None
  mapped = _resnet_rule((collection,) + tuple(head[1:]))
  if mapped is None:
    return None
  return f'{head[0]}.{mapped[0]}', mapped[1]


def grasp2vec_variables_to_torch(
    variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """The Grasp2Vec model's JAX variables (each collection split into
  ``scene`` and ``goal``, one ``Embedding`` tree each) -> the
  ``state_dict`` of the port's two towers (``scene.*``, ``goal.*``), each
  by :func:`resnet_variables_to_torch`'s rules. Every leaf must map."""
  return _mapped_state_dict(variables, _grasp2vec_rule, 'Grasp2Vec')


# -------------------------------------------------------- optimizer state


def optax_state_to_torch(
    optimizer: torch.optim.Optimizer,
    network: torch.nn.Module,
    adam: Optional[Tuple[Any, Any, Any]] = None,
    schedule_count: Optional[Any] = None,
    variables_to_torch: Callable[[Mapping[str, Any]], Dict[str, torch.Tensor]]
    = jax_variables_to_torch,
    momentum: Optional[Mapping[str, Any]] = None,
    multi_steps: Optional[Tuple[Any, Any, Any]] = None) -> Dict[str, Any]:
  """An optax optimizer state, as numpy, -> ``optimizer``'s ``state_dict``.

  ``adam`` is an optax ``ScaleByAdamState``'s ``(count, mu, nu)``, ``mu``
  and ``nu`` params trees of ``network``'s JAX counterpart, mapped by
  ``variables_to_torch`` (:func:`jax_variables_to_torch` or
  :func:`snail_variables_to_torch`); ``momentum`` is a ``TraceState``'s
  ``trace`` tree, which becomes each parameter's ``momentum_buffer``
  (optax's ``t = momentum * t + g`` is torch SGD's buffer with
  ``dampening=0``); ``schedule_count`` is a ``ScaleByScheduleState``'s
  count. The port's optimizers keep one ``count`` per parameter group for
  Adam and the schedule, so the two must agree. ``multi_steps`` is an
  ``optax.MultiStepsState``'s ``(mini_step, gradient_step, acc_grads)``
  (``models/optimizers.GradientAccumulation``: the groups' ``mini_step``
  and ``gradient_step``, the ``acc_grads`` slots; its inner state is
  passed as the other arguments). Gradient clipping keeps no state. Load
  the result with ``optimizer.load_state_dict`` or
  ``train_state.load_state_dict``.
  """
  names = {id(p): name for name, p in network.named_parameters()}
  order = [names[id(p)] for group in optimizer.param_groups
           for p in group['params']]
  template = optimizer.state_dict()
  state: Dict[int, Dict[str, torch.Tensor]] = {i: {} for i in
                                               range(len(order))}
  counts = set()
  slots = []
  if adam is not None:
    count, mu, nu = adam
    slots += [('mu', mu), ('nu', nu)]
    counts.add(int(np.asarray(count)))
  if momentum is not None:
    slots.append(('momentum_buffer', momentum))
  if multi_steps is not None:
    slots.append(('acc_grads', multi_steps[2]))
  for slot, tree in slots:
    tree = variables_to_torch({'params': tree})
    if set(tree) != set(order):
      raise ValueError(
          f'{slot} maps to {sorted(set(tree) ^ set(order))} differently from '
          'the optimizer\'s parameters.')
    for i, name in enumerate(order):
      state[i][slot] = tree[name]
  state = {i: entry for i, entry in state.items() if entry}
  if schedule_count is not None:
    counts.add(int(np.asarray(schedule_count)))
  if len(counts) > 1:
    raise ValueError(f'The Adam and schedule counts differ ({counts}); the '
                     'port keeps one count.')
  groups = [dict(group) for group in template['param_groups']]
  for group in groups:
    if multi_steps is not None:
      if 'mini_step' not in group:
        raise ValueError('The optax state accumulates (MultiSteps) but the '
                         'optimizer does not (with_gradient_accumulation).')
      group['mini_step'] = int(np.asarray(multi_steps[0]))
      group['gradient_step'] = int(np.asarray(multi_steps[1]))
    if counts:
      if 'count' not in group:
        raise ValueError('The optimizer keeps no count (a constant-rate '
                         'GradientDescent) but the optax state has one.')
      group['count'] = next(iter(counts))
  return {'state': state, 'param_groups': groups}


def _optax_parts(opt_state) -> Dict[str, Any]:
  """The Adam moments, the momentum trace, the schedule count and the
  ``MultiSteps`` accumulation found in an optax state (nested tuples of
  optax's named states)."""
  parts: Dict[str, Any] = {}
  fields = set(getattr(opt_state, '_fields', ()))  # optax's namedtuples
  if {'mini_step', 'gradient_step', 'acc_grads'} <= fields:
    parts['multi_steps'] = (opt_state.mini_step, opt_state.gradient_step,
                            opt_state.acc_grads)
    for key, value in _optax_parts(opt_state.inner_opt_state).items():
      parts[key] = value
  elif {'count', 'mu', 'nu'} <= fields:
    parts['adam'] = (opt_state.count, opt_state.mu, opt_state.nu)
  elif 'trace' in fields:
    parts['momentum'] = opt_state.trace
  elif 'count' in fields:
    parts['schedule_count'] = opt_state.count
  elif isinstance(opt_state, (tuple, list)):
    for item in opt_state:
      for key, value in _optax_parts(item).items():
        if key in parts:
          raise ValueError(f'The optax state holds two {key} entries.')
        parts[key] = value
  return parts


def jax_train_state_to_torch(
    state_numpy,
    trainer_state,
    seed: int = 0,
    variables_to_torch: Callable[[Mapping[str, Any]], Dict[str, torch.Tensor]]
    = jax_variables_to_torch) -> Dict[str, Any]:
  """A JAX ``TrainState`` with numpy leaves (``jax.device_get(state)``) ->
  the port's checkpoint payload (``train/train_state.state_dict``) for
  ``trainer_state``, the port's train state of the same model:

  * ``params`` and ``model_state`` (batch statistics) -> the network;
  * ``ema_params`` -> the EMA;
  * ``opt_state`` -> the optimizer (the Adam moments or the momentum
    trace, the schedule count, and a ``MultiSteps`` window:
    :func:`optax_state_to_torch`);
  * ``step`` -> the step.

  The JAX ``rng`` key does not cross over: the two packages draw from
  different generators, so the payload's generator is a
  ``torch.Generator`` seeded with ``seed`` (pass ``TrainerConfig.seed``).
  """
  network = variables_to_torch(
      {'params': state_numpy.params, **dict(state_numpy.model_state or {})})
  ema = None
  if state_numpy.ema_params is not None:
    ema = variables_to_torch({'params': state_numpy.ema_params})
  optimizer = optax_state_to_torch(
      trainer_state.optimizer, trainer_state.network,
      variables_to_torch=variables_to_torch,
      **_optax_parts(state_numpy.opt_state))
  return {
      'step': int(np.asarray(state_numpy.step)),
      'network': network,
      'optimizer': optimizer,
      'ema': ema,
      'generator': torch.Generator().manual_seed(seed).get_state(),
  }
