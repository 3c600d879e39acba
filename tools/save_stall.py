"""What the train loop pays for an asynchronous checkpoint save, split.

Trains one model on the card from host batches made beforehand, with
``async_checkpoints`` on and saves at steps ``--save-at`` and twice that
(the first save also allocates what later saves reuse), and reports:

* the ms of every step (host clock, synchronised after each step by a
  callback), the steps before the first save (no save in them) against
  the ``--after`` steps after each save (the save's call falls in the
  first, the writer thread runs during the next ones);
* each save's parts: the whole ``CheckpointManager.save`` call and its
  synchronous host copy (the manager's ``timings['copy_ms']``), and on
  the writer thread ``torch.save`` (the serialization and its writes to
  the page cache) and ``os.fsync``;
* how long the interpreter lock was out of reach: a heartbeat thread
  wakes every 0.5 ms, and a gap between two wakes far above that is time
  in which no other Python thread could run. The longest gap and the sum
  of the gaps' excess over 1 ms are given for the quiet steps and for
  each write's span (the writer's ``torch.save`` and fsync);
* the payload's size (``state.pt``), the card's name and power limit and
  the torch version.

Two models: ``qtopt`` (Grasping44, batch 32, seeded uint8 frames) and
``grasp2vec`` (ResNet-50 v2 towers at 472x472, batch 16,
``DefaultRandomInputGenerator`` batches). Run from the root of the
checkout to measure, with it first on the path, so that two checkouts can
be measured in turns on one card:

    PYTHONPATH=. python <repo>/tools/save_stall.py --model qtopt grasp2vec
"""

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

import numpy as np
import torch

from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.ops import _dispatch
from tensor2robot_tpu_torch.train import Trainer, TrainerCallback, TrainerConfig
from tensor2robot_tpu_torch.train import checkpoints as ckpt_lib

HEARTBEAT_S = 0.0005


class _Spans:
  """(start, end) perf_counter spans of the calls of a wrapped function
  made on a checkpoint writer thread."""

  def __init__(self, owner, name):
    self.spans = []
    self._owner, self._name = owner, name
    self._real = real = getattr(owner, name)

    def timed(*args, **kwargs):
      start = time.perf_counter()
      try:
        return real(*args, **kwargs)
      finally:
        if threading.current_thread().name.startswith('t2r-ckpt'):
          self.spans.append((start, time.perf_counter()))

    setattr(owner, name, timed)

  def restore(self):
    setattr(self._owner, self._name, self._real)


class _Heartbeat(threading.Thread):
  """Wakes every HEARTBEAT_S and keeps the wake times."""

  def __init__(self):
    super().__init__(daemon=True)
    self.times = []
    self.stop = threading.Event()

  def run(self):
    while not self.stop.is_set():
      self.times.append(time.perf_counter())
      time.sleep(HEARTBEAT_S)

  def gaps(self, start, end):
    """(longest gap ms, sum of gap excess over 1 ms) within [start, end]."""
    t = np.asarray(self.times)
    t = t[(t >= start) & (t <= end)]
    if len(t) < 2:
      return 0.0, 0.0
    gaps = np.diff(t) * 1e3
    return float(gaps.max()), float(np.clip(gaps - 1.0, 0, None).sum())


class _Clock(TrainerCallback):

  def __init__(self):
    self.ends, self.last = {}, None

  def begin(self, trainer):
    torch.cuda.synchronize()
    self.ends[trainer.step] = time.perf_counter()

  def after_step(self, trainer, step, scalars):
    torch.cuda.synchronize()
    self.ends[step] = time.perf_counter()


def qtopt(seed, count):
  from tensor2robot_tpu_torch.research.qtopt import GraspingModelWrapper  # pylint: disable=import-outside-toplevel
  rng = np.random.RandomState(seed)
  batches = [({'state/image': rng.randint(0, 256, (32, 512, 640, 3),
                                          dtype=np.uint8),
               'action/world_vector': rng.randn(32, 3).astype(np.float32),
               'action/vertical_rotation': rng.randn(32, 2).astype(
                   np.float32)},
              {'reward': rng.randint(0, 2, (32, 1)).astype(np.float32)})
             for _ in range(count)]
  return (GraspingModelWrapper(device_type='gpu', kernel_policy='pool_conv'),
          batches)


def grasp2vec(seed, count):
  from tensor2robot_tpu_torch.research.grasp2vec import Grasp2VecModel  # pylint: disable=import-outside-toplevel
  model = Grasp2VecModel(scene_size=(472, 472), goal_size=(472, 472),
                         kernel_policy='pool')
  gen = input_generators.DefaultRandomInputGenerator(batch_size=16)
  gen.set_specification_from_model(model, ModeKeys.TRAIN)
  it = gen.create_iterator(ModeKeys.TRAIN)
  first = [next(it) for _ in range(4)]
  return model, [first[i % 4] for i in range(count)]


def measure(name, seed, save_at, after, root, card):
  if after >= save_at:
    raise ValueError('--after must be below --save-at')
  total = 2 * save_at + after
  model, batches = {'qtopt': qtopt, 'grasp2vec': grasp2vec}[name](
      seed, total)
  model_dir = root / name
  clock = _Clock()
  trainer = Trainer(model, TrainerConfig(
      model_dir=str(model_dir), max_train_steps=total,
      save_interval_steps=save_at, eval_interval_steps=0,
      log_interval_steps=0, seed=seed, async_checkpoints=True),
                    callbacks=[clock], device='cuda')
  saves = _Spans(torch, 'save')
  fsyncs = _Spans(os, 'fsync')
  heart = _Heartbeat()
  heart.start()
  calls = {}
  real_save = ckpt_lib.CheckpointManager.save

  def save(self, step, payload, force=False):
    start = time.perf_counter()
    saved = real_save(self, step, payload, force=force)
    if saved:
      calls[step] = dict(self.timings, call_ms=1e3 * (
          time.perf_counter() - start))
    return saved

  ckpt_lib.CheckpointManager.save = save
  try:
    with _dispatch.force_kernels(True):
      trainer.train(iter(batches), None)
  finally:
    ckpt_lib.CheckpointManager.save = real_save
    saves.restore()
    fsyncs.restore()
    heart.stop.set()
    heart.join()
  ms = {s: 1e3 * (clock.ends[s] - clock.ends[s - 1])
        for s in range(2, total + 1)}
  quiet = [ms[s] for s in range(3, save_at + 1)]
  quiet_mean = float(np.mean(quiet))
  size_mb = os.path.getsize(ckpt_lib.state_path(str(
      model_dir / 'checkpoints' / f'ckpt_{save_at}'))) / 1e6
  report = {
      'model': name, 'card': card, 'torch': torch.__version__,
      'payload_mb': round(size_mb, 3),
      'quiet_ms': [round(v, 3) for v in quiet],
      'quiet_mean_ms': round(quiet_mean, 3),
      'quiet_spread_ms': round(max(quiet) - min(quiet), 3),
      'heartbeat_quiet': [round(v, 3) for v in heart.gaps(
          clock.ends[2], clock.ends[save_at])]}
  for k, at in enumerate((save_at, 2 * save_at)):
    after_save = [ms[s] for s in range(at + 1, at + after + 1)]
    write = saves.spans[k]
    write_end = max(write[1], fsyncs.spans[k][1]) if len(
        fsyncs.spans) > k else write[1]
    call = calls[at]
    report[f'save_{at}'] = {
        'after_save_ms': [round(v, 3) for v in after_save],
        'first_step_excess_ms': round(after_save[0] - quiet_mean, 3),
        'call_ms': round(call['call_ms'], 3),
        'copy_ms': round(call['copy_ms'], 3),
        'excess_beyond_copy_ms': round(after_save[0] - quiet_mean -
                                       call['copy_ms'], 3),
        'rest_excess_ms': round(sum(after_save[1:]) - quiet_mean * (
            after - 1), 3),
        'writer_torch_save_ms': round(1e3 * (write[1] - write[0]), 3),
        'writer_fsync_ms': round(1e3 * (fsyncs.spans[k][1] -
                                        fsyncs.spans[k][0]), 3)
                           if len(fsyncs.spans) > k else None,
        'writer_span_ms': round(1e3 * (write_end - write[0]), 3),
        'heartbeat_writer': [round(v, 3) for v in heart.gaps(write[0],
                                                             write_end)]}
  print(json.dumps(report), flush=True)


def main():
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--model', nargs='+', default=['qtopt', 'grasp2vec'],
                      choices=('qtopt', 'grasp2vec'))
  parser.add_argument('--save-at', type=int, default=8)
  parser.add_argument('--after', type=int, default=5)
  parser.add_argument('--repeats', type=int, default=2)
  parser.add_argument('--seed', type=int, default=0)
  args = parser.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit('save_stall: no CUDA card is visible')
  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True,
      check=False).stdout.strip()
  out = pathlib.Path('chiprun_out')
  out.mkdir(exist_ok=True)
  root = pathlib.Path(tempfile.mkdtemp(prefix='save_stall_', dir=out))
  try:
    for _ in range(args.repeats):
      for name in args.model:
        measure(name, args.seed, args.save_at, args.after, root, card)
        shutil.rmtree(root / name, ignore_errors=True)
        torch.cuda.empty_cache()
  finally:
    shutil.rmtree(root, ignore_errors=True)


if __name__ == '__main__':
  main()
