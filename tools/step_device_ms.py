"""Device milliseconds of a training step on the card, for comparing trees.

Three arms, one a process (an early profiler session can leave a later one
in the same process empty):

* ``float32``: the QT-Opt critic (Grasping44) under the reference's float32
  policy (``GraspingModelWrapper(device_type='cpu')`` trained on the card:
  conv1's float32 forward and dW on the CUDA cores, the pools' kernels), at
  batch 32 from seeded uint8 frames;
* ``grasp2vec``: Grasp2Vec (ResNet-50 v2 towers, 472x472 crops, bfloat16,
  the stem pools' kernels: the backward's gather route) at batch 16 from
  ``DefaultRandomInputGenerator`` batches;
* ``kernels``: the checkout's own ``chip_smoke.py`` timings of conv1's
  float32 routes (``conv_float32_timing``) and of the stem pool's kernels
  (``stem_pool_timing``), which log each kernel beside its plain version,
  its library call and its bound.

Each training arm builds its trainer, runs two warm-up steps, then profiles
``--steps`` steps with ``torch.profiler`` and prints, as one JSON line, the
device time a step (every kernel's and copy's own rows, without the
profiler's 'Activity Buffer Request' row), the rows of the conv1 dW and
pool backward kernels a step, and the card's name and power limit.

Run from the root of the checkout to measure, with it first on the path,
so that two checkouts can be measured in turns on one card:

    PYTHONPATH=. python <repo>/tools/step_device_ms.py --arm float32
"""

import argparse
import json
import subprocess

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.ops import _dispatch
from tensor2robot_tpu_torch.research.qtopt import GraspingModelWrapper
from tensor2robot_tpu_torch.train import Trainer, TrainerConfig

KERNEL_ROWS = ('conv_dw', 'pool_bwd')


def qtopt_batches(seed, count, batch):
  """Seeded (features, labels) host batches: uint8 frames, actions, 0/1
  rewards."""
  rng = np.random.RandomState(seed)
  return [({'state/image': rng.randint(0, 256, (batch, 512, 640, 3),
                                       dtype=np.uint8),
            'action/world_vector': rng.randn(batch, 3).astype(np.float32),
            'action/vertical_rotation': rng.randn(batch, 2).astype(
                np.float32)},
           {'reward': rng.randint(0, 2, (batch, 1)).astype(np.float32)})
          for _ in range(count)]


def arm(name, seed):
  """(model, a list of host batches) of one arm."""
  if name == 'float32':
    return (GraspingModelWrapper(device_type='cpu', kernel_policy='pool_conv'),
            qtopt_batches(seed, 2, 32))
  from tensor2robot_tpu_torch.research.grasp2vec import Grasp2VecModel  # pylint: disable=import-outside-toplevel
  model = Grasp2VecModel(scene_size=(472, 472), goal_size=(472, 472),
                         kernel_policy='pool')
  gen = input_generators.DefaultRandomInputGenerator(batch_size=16)
  gen.set_specification_from_model(model, ModeKeys.TRAIN)
  it = gen.create_iterator(ModeKeys.TRAIN)
  return model, [next(it) for _ in range(2)]


def main():
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--arm', choices=('float32', 'grasp2vec', 'kernels'),
                      required=True)
  parser.add_argument('--steps', type=int, default=3)
  parser.add_argument('--seed', type=int, default=0)
  args = parser.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit('step_device_ms: no CUDA card is visible')
  if args.arm == 'kernels':
    import chip_smoke  # pylint: disable=import-outside-toplevel
    card = chip_smoke.phase_card()
    generator = torch.Generator(device='cuda').manual_seed(args.seed)
    record = {}
    chip_smoke.conv_float32_timing(record, card, generator, 108)
    chip_smoke.stem_pool_timing(record, generator)
    return
  model, batches = arm(args.arm, args.seed)
  trainer = Trainer(model, TrainerConfig(model_dir='', max_train_steps=1,
                                         log_interval_steps=0,
                                         seed=args.seed), device='cuda')
  with _dispatch.force_kernels(True):
    for _ in range(2):  # the first builds the state
      trainer.train(iter(batches), None)
      trainer.config.max_train_steps = trainer.step + 1
    torch.cuda.synchronize()
    trainer.config.max_train_steps = trainer.step + args.steps
    steps = [batches[i % len(batches)] for i in range(args.steps)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      trainer.train(iter(steps), None)
      torch.cuda.synchronize()
  rows = [e for e in prof.key_averages()
          if str(getattr(e, 'device_type', '')).endswith('CUDA') and
          e.key != 'Activity Buffer Request' and
          not getattr(e, 'is_user_annotation', False) and
          not e.key.startswith('Optimizer.')]

  def device_us(event):
    return (getattr(event, 'self_device_time_total', None) or
            getattr(event, 'self_cuda_time_total', 0))

  kernels = {}
  for e in rows:
    for name in KERNEL_ROWS:
      if name in e.key:
        kernels[e.key] = kernels.get(e.key, 0) + device_us(e)
  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True,
      check=False).stdout.strip()
  print(json.dumps({
      'arm': args.arm, 'steps': args.steps, 'step': trainer.step,
      'device_ms_per_step': sum(device_us(e) for e in rows) / args.steps /
                            1e3,
      'kernel_ms_per_step': {k: v / args.steps / 1e3
                             for k, v in sorted(kernels.items())},
      'card': card}))


if __name__ == '__main__':
  main()
