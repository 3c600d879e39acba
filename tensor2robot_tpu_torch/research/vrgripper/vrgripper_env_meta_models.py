"""VRGripper meta models: the SNAIL sequential and long-horizon learners.

The port's counterpart of
``tensor2robot_tpu/research/vrgripper/vrgripper_env_meta_models.py``:

* :func:`pack_vrgripper_meta_features` — obs + cached demo episodes → the
  MetaExample feature layout;
* :class:`VRGripperEnvTecModel` — the TEC model's specs, preprocessor and
  ``pack_features``; its network (``_TecNet``) is not ported yet, so
  ``create_module`` raises;
* :class:`VRGripperEnvSequentialModel` (``_SnailSequenceNet``) — the
  RL²/SNAIL meta-learner: the (condition ‖ inference) frame sequence runs
  through a causal TC/attention stack and the action is read off the
  inference tail;
* :class:`VRGripperEnvLongHorizonModel` (``_long_horizon_net``) — the
  same skeleton with multi-head attention blocks.

The attention blocks run the flash kernels in TRAIN and EVAL on the card.
PREDICT takes the flash forward on every device (``serving=True``): it is
the custom op ``t2r::flash_fwd``, so an exported serving program holds it
as a node (two, one per attention block) that launches the kernel on the
card and runs the plain version on the CPU. The JAX package pins PREDICT
to the dense form because a Mosaic kernel cannot lower for a CPU host; the
custom op has no such limit. Like the JAX models, these return their preprocessor without the
bfloat16 dtype policy, so the whole network computes in float32 and the
flash kernels take float32 q, k, v.

Not ported yet (ROADMAP.md queue 1): the MDN head
(``num_mixture_components > 1``), the TEC network, MAML, and ring/Ulysses
sequence parallelism (a mesh whose ``seq`` axis is larger than 1).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch.layers import snail
from tensor2robot_tpu_torch.layers.vision_layers import (Dense,
                                                         ImagesToFeaturesModel)
from tensor2robot_tpu_torch.meta_learning import preprocessors
from tensor2robot_tpu_torch.models.base import AbstractT2RModel, set_mode
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_env_models import (
    DefaultVRGripperPreprocessor)
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec

_MDN_NOT_YET = ('num_mixture_components > 1 (the MDN head, layers/mdn.py) is '
                'not ported yet: ROADMAP.md queue 1 item 9')
_SEQ_PARALLEL_NOT_YET = ('a mesh with a seq axis larger than 1 (ring/Ulysses '
                         'sequence parallelism) is not ported yet: ROADMAP.md '
                         'queue 1 item 10')


def pack_vrgripper_meta_features(state,
                                 prev_episode_data,
                                 timestep: int,
                                 episode_length: int,
                                 num_condition_samples_per_task: int
                                 ) -> SpecStruct:
  """Packs an (image, pose) observation and demo episodes into numpy meta
  features."""
  del timestep
  image, pose = state
  image = np.asarray(image, np.float32)
  pose = np.asarray(pose, np.float32)
  meta_features = SpecStruct()
  # Inference episode: the current observation broadcast over the episode.
  inf_images = np.broadcast_to(image, (episode_length,) + image.shape).copy()
  inf_poses = np.broadcast_to(pose, (episode_length,) + pose.shape).copy()
  meta_features['inference/features/image/0'] = inf_images[None]
  meta_features['inference/features/gripper_pose/0'] = inf_poses[None]

  def pack_condition_features(episode_data, idx):
    images = np.stack([np.asarray(t[0][0], np.float32)
                       for t in episode_data])[:episode_length]
    poses = np.stack([np.asarray(t[0][1], np.float32)
                      for t in episode_data])[:episode_length]
    actions = np.stack([np.asarray(t[1], np.float32)
                        for t in episode_data])[:episode_length]
    pad = episode_length - images.shape[0]
    if pad > 0:
      images = np.concatenate([images, np.repeat(images[-1:], pad, axis=0)])
      poses = np.concatenate([poses, np.repeat(poses[-1:], pad, axis=0)])
      actions = np.concatenate(
          [actions, np.repeat(actions[-1:], pad, axis=0)])
    meta_features[f'condition/features/image/{idx}'] = images[None]
    meta_features[f'condition/features/gripper_pose/{idx}'] = poses[None]
    meta_features[f'condition/labels/action/{idx}'] = actions[None]

  for idx in range(num_condition_samples_per_task):
    if prev_episode_data and idx < len(prev_episode_data):
      pack_condition_features(prev_episode_data[idx], idx)
    else:
      dummy = [((image, pose), np.zeros(7, np.float32), 0.0, None, True, {})]
      pack_condition_features(dummy, idx)
  return meta_features


# ------------------------------------------------------------------- TEC


class VRGripperEnvTecModel(AbstractT2RModel):
  """Task-Embedded Control Network: specs, preprocessor, policy packing.

  The network and its losses (``_TecNet``, the contrastive embedding loss)
  are not ported yet; :meth:`create_module` raises.
  """

  def __init__(self,
               action_size: int = 7,
               gripper_pose_size: int = 14,
               num_waypoints: int = 1,
               episode_length: int = 40,
               embed_loss_weight: float = 0.1,
               fc_embed_size: int = 32,
               ignore_embedding: bool = False,
               num_mixture_components: int = 1,
               predict_end_weight: float = 0.0,
               use_film: bool = False,
               image_size: Tuple[int, int] = (100, 100),
               num_condition_samples_per_task: int = 1,
               **kwargs):
    super().__init__(**kwargs)
    self._action_size = action_size
    self._gripper_pose_size = gripper_pose_size
    self._num_waypoints = num_waypoints
    self._episode_length = episode_length
    self._embed_loss_weight = embed_loss_weight
    self._fc_embed_size = fc_embed_size
    self._ignore_embedding = ignore_embedding
    self._num_mixture_components = num_mixture_components
    self._predict_end_weight = predict_end_weight
    self._use_film = use_film
    self._image_size = tuple(image_size)
    self._num_condition_samples_per_task = num_condition_samples_per_task

  # ----------------------------------------------------------------- specs

  def _episode_feature_specification(self, mode: str) -> SpecStruct:
    """Single-episode feature spec."""
    del mode
    spec = SpecStruct()
    spec['image'] = TensorSpec(
        shape=(self._episode_length,) + self._image_size + (3,),
        dtype=np.float32, name='image0', data_format='JPEG')
    spec['gripper_pose'] = TensorSpec(
        shape=(self._episode_length, self._gripper_pose_size),
        dtype=np.float32, name='world_pose_gripper')
    return spec

  def _episode_label_specification(self, mode: str) -> SpecStruct:
    del mode
    spec = SpecStruct()
    spec['action'] = TensorSpec(
        shape=(self._episode_length,
               self._num_waypoints * self._action_size),
        dtype=np.float32, name='action_world')
    return spec

  @property
  def preprocessor(self):
    base_preprocessor = DefaultVRGripperPreprocessor(
        model_feature_specification_fn=self._episode_feature_specification,
        model_label_specification_fn=self._episode_label_specification)
    return preprocessors.FixedLenMetaExamplePreprocessor(
        base_preprocessor=base_preprocessor,
        num_condition_samples_per_task=(
            self._num_condition_samples_per_task))

  def get_feature_specification(self, mode: str) -> SpecStruct:
    return preprocessors.create_maml_feature_spec(
        self._episode_feature_specification(mode),
        self._episode_label_specification(mode))

  def get_label_specification(self, mode: str) -> SpecStruct:
    return preprocessors.create_maml_label_spec(
        self._episode_label_specification(mode))

  # ---------------------------------------------------------------- network

  def create_module(self) -> nn.Module:
    raise NotImplementedError(
        'The TEC network (_TecNet) is not ported yet: ROADMAP.md queue 1 '
        'item 9.')

  def inference_network_fn(self, network, features, labels, mode):
    raise NotImplementedError(
        'The TEC network (_TecNet) is not ported yet: ROADMAP.md queue 1 '
        'item 9.')

  def model_train_fn(self, features, labels, inference_outputs, mode):
    raise NotImplementedError(
        'The TEC losses are not ported yet: ROADMAP.md queue 1 item 9.')

  # ----------------------------------------------------------------- policy

  def pack_features(self, state, prev_episode_data, timestep) -> SpecStruct:
    return pack_vrgripper_meta_features(
        state, prev_episode_data, timestep, self._episode_length,
        self._num_condition_samples_per_task)


# ------------------------------------------------------------- sequential


class _SnailSequenceNet(nn.Module):
  """SNAIL policy over the (condition ‖ inference) sequence: per-frame
  vision features + aux input → causal TC/attention stack → per-step
  output head. Parameter names follow the flax tree (``frame_features``,
  ``in_proj``, ``tc1``, ``attn1``, ``tc2``, ``attn2``, ``out``).
  ``attention_block(in_channels)`` builds each attention block (default:
  single-head :class:`~tensor2robot_tpu_torch.layers.snail.AttentionBlock`,
  key 64, value ``filters``)."""

  def __init__(self, num_outputs: int, sequence_length: int, aux_size: int,
               filters: int = 32, return_attention_probs: bool = False,
               attention_block: Optional[Callable[[int], nn.Module]] = None):
    super().__init__()
    self.return_attention_probs = return_attention_probs
    if attention_block is None:
      def attention_block(in_channels):
        return snail.AttentionBlock(in_channels, key_size=64,
                                    value_size=filters,
                                    return_prob=return_attention_probs)
    self.frame_features = ImagesToFeaturesModel()
    self.in_proj = Dense(2 * 32 + aux_size, 64)
    self.tc1 = snail.TCBlock(64, sequence_length, filters)
    self.attn1 = attention_block(self.tc1.out_channels)
    self.tc2 = snail.TCBlock(self.attn1.out_channels, sequence_length,
                             filters)
    self.attn2 = attention_block(self.tc2.out_channels)
    self.out = Dense(self.attn2.out_channels, num_outputs)

  def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
    self.frame_features.init_weights(generator)
    snail.init_snail_weights(self, generator)

  def forward(self, images, aux_input, serving: bool = False):
    """images [B, T, H, W, C], aux_input [B, T, P] → (poses [B, T, out],
    end_points). ``serving=True`` (the PREDICT path) sends the attention
    blocks through the flash forward on every device (``layers/snail``)."""
    b, t = images.shape[:2]
    merged = images.reshape((-1,) + tuple(images.shape[2:]))
    frame_features, _ = self.frame_features(merged)
    net = frame_features.reshape(b, t, -1)
    dtype = torch.promote_types(net.dtype, aux_input.dtype)
    net = self.in_proj(torch.cat([net.to(dtype), aux_input.to(dtype)], -1))
    net = self.tc1(net)
    net, attn1 = self.attn1(net, serving=serving)
    net = self.tc2(net)
    net, attn2 = self.attn2(net, serving=serving)
    end_points = {}
    if self.return_attention_probs:
      end_points['attn_probs/0'] = attn1['attn_prob']
      end_points['attn_probs/1'] = attn2['attn_prob']
    return self.out(net), end_points


class VRGripperEnvSequentialModel(VRGripperEnvTecModel):
  """RL²/SNAIL meta-learner over the concatenated condition + inference
  frames, with the action read from the inference tail."""

  def __init__(self,
               condition_gripper_pose: bool = False,
               greedy_action: bool = False,
               return_attention_probs: bool = False,
               **kwargs):
    super().__init__(**kwargs)
    if self._num_mixture_components > 1:
      raise NotImplementedError(_MDN_NOT_YET)
    del greedy_action  # only the MDN head, not ported yet, samples
    self._condition_gripper_pose = condition_gripper_pose
    self._return_attention_probs = return_attention_probs

  def _num_outputs(self) -> int:
    return self._num_waypoints * self._action_size

  def create_module(self) -> _SnailSequenceNet:
    return _SnailSequenceNet(
        num_outputs=self._num_outputs(),
        sequence_length=2 * self._episode_length,
        aux_size=self._gripper_pose_size,
        return_attention_probs=self._return_attention_probs)

  def _sequence_inputs(self, features):
    """Concatenates condition and inference episode 0 across time; like
    the JAX model, exactly one episode of each kind."""
    num_con = features['condition/features/image'].shape[1]
    num_inf = features['inference/features/image'].shape[1]
    if num_con != 1 or num_inf != 1:
      raise ValueError(
          'VRGripperEnvSequentialModel supports exactly 1 condition and 1 '
          f'inference episode per task, got {num_con} and {num_inf}.')
    con_images = features['condition/features/image'][:, 0]
    inf_images = features['inference/features/image'][:, 0]
    con_pose = features['condition/features/gripper_pose'][:, 0]
    inf_pose = features['inference/features/gripper_pose'][:, 0]
    if not self._condition_gripper_pose:
      # Imitation from video: conditioning sees frames, not trajectories.
      con_pose = torch.zeros_like(con_pose)
    images = torch.cat([con_images, inf_images], dim=1)
    aux = torch.cat([con_pose, inf_pose], dim=1)
    return images, aux, con_images.shape[1]

  def inference_network_fn(self, network, features, labels, mode):
    del labels
    features, _ = self.validated_features(features, mode)
    set_mode(network, mode)
    images, aux, condition_length = self._sequence_inputs(features)
    poses, end_points = network(images, aux,
                                serving=mode == ModeKeys.PREDICT)
    outputs = SpecStruct()
    for key, value in end_points.items():
      outputs[key] = value
    outputs['inference_output'] = poses[:, condition_length:][:, None]
    return outputs

  def model_train_fn(self, features, labels, inference_outputs, mode):
    del features, mode
    action = labels['action'].float()
    prediction = inference_outputs['inference_output'].float()
    bc_loss = torch.mean(torch.square(prediction - action))
    return bc_loss, {'bc_loss': bc_loss}

  def pack_features(self, state, prev_episode_data, timestep,
                    current_episode_data=None) -> SpecStruct:
    """Packs meta features, splicing in the running episode's history."""
    np_features = pack_vrgripper_meta_features(
        state, prev_episode_data, timestep, self._episode_length,
        self._num_condition_samples_per_task)
    if current_episode_data is not None and timestep > 0:
      for key in ('image', 'gripper_pose'):
        full_key = f'inference/features/{key}/0'
        np_features[full_key][0, :timestep] = (
            current_episode_data[full_key][0, :timestep])
    return np_features


# ----------------------------------------------------------- long horizon


def _long_horizon_net(num_outputs: int, sequence_length: int, aux_size: int,
                      num_heads: int, head_size: int) -> _SnailSequenceNet:
  """The SNAIL stack with multi-head attention blocks (the JAX package's
  ``_LongHorizonSnailNet`` on one device)."""
  return _SnailSequenceNet(
      num_outputs, sequence_length, aux_size,
      attention_block=lambda in_channels: snail.MultiHeadAttentionBlock(
          in_channels, num_heads, head_size))


class VRGripperEnvLongHorizonModel(VRGripperEnvSequentialModel):
  """SNAIL meta-learner with multi-head causal attention for long
  episodes. ``sequence_parallelism``: 'auto', 'ulysses', 'ring' or 'none';
  on one device (no mesh, or a ``seq`` axis of size 1) every choice runs
  the attention locally, as the JAX model does."""

  def __init__(self,
               num_attention_heads: int = 8,
               attention_head_size: int = 8,
               sequence_parallelism: str = 'auto',
               **kwargs):
    kwargs.setdefault('return_attention_probs', False)
    if kwargs.pop('return_attention_probs'):
      raise ValueError(
          'VRGripperEnvLongHorizonModel never materializes [B, T, T] '
          'attention probabilities (that tensor is what the long-horizon '
          'path eliminates).')
    super().__init__(**kwargs)
    if sequence_parallelism not in ('auto', 'ulysses', 'ring', 'none'):
      raise ValueError(
          f'Unknown sequence_parallelism: {sequence_parallelism!r}')
    self._num_attention_heads = num_attention_heads
    self._attention_head_size = attention_head_size
    self._sequence_parallelism = sequence_parallelism

  def set_mesh(self, mesh) -> None:
    """Trainer plumbing: the mesh the step runs over (None: one device).
    A mesh is anything with a ``shape`` mapping of axis sizes; one whose
    ``seq`` axis is larger than 1 raises until sequence parallelism is
    ported, unless ``sequence_parallelism='none'``."""
    if (mesh is not None and self._sequence_parallelism != 'none' and
        dict(mesh.shape).get('seq', 1) > 1):
      raise NotImplementedError(_SEQ_PARALLEL_NOT_YET)

  def create_module(self) -> _SnailSequenceNet:
    return _long_horizon_net(
        num_outputs=self._num_outputs(),
        sequence_length=2 * self._episode_length,
        aux_size=self._gripper_pose_size,
        num_heads=self._num_attention_heads,
        head_size=self._attention_head_size)
