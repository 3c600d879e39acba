#!/usr/bin/env python3
"""Drives the PyTorch/H100 port's main path once on one CUDA card.

    python3 chip_smoke.py [--seed N] [--actions N] [--profile]

Run from the repository root. The phases:

1. the card (``nvidia-smi`` name and power limit) and torch/CUDA versions;
2. build every CUDA kernel from ``tensor2robot_tpu_torch/ops/csrc``;
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes: the pool bitwise (values and slots) at the three
   QT-Opt pools in bfloat16 plus odd and tie cases in float32; conv1 at
   [64, 472, 472, 3] in bfloat16 (band: 2**-7 relative, one bfloat16 ulp)
   and in float32 with TF32 off (band 1e-5);
4. the main path at full width: ``GraspingModelWrapper(device_type='gpu',
   kernel_policy='pool_conv')`` -> ``CheckpointPredictor`` with seeded
   random weights -> ``CEMPolicy(64 samples x 3 iterations,
   device_resident=True)`` on 512x640 uint8 frames, one warm-up action and
   then timed actions, with every launch counter set to 0 just before and
   read just after (3 conv1 and 9 pool launches per action); then
   ``predict`` on 8 frame/action pairs, and a float32 check of the full
   network on the card against the same network on the CPU (plain
   versions) on 2 pairs: q, and the end points ``pool2``, ``final_conv``
   and ``logits``;
5. timings at the main path's shapes with CUDA events: each kernel, its
   plain version, one library call computing the same function
   (``F.max_pool2d(return_indices=True)``, ``F.conv2d`` in channels-last),
   and each kernel's bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16);
   ``--profile`` adds a ``torch.profiler`` breakdown of two actions,
   written to ``chiprun_out/chip_smoke_profile.txt``.

The line before the last is a JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before it,
and nothing falls back to the CPU.
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.ops import _build, _dispatch, conv_s2d, pool
from tensor2robot_tpu_torch.policies import CEMPolicy
from tensor2robot_tpu_torch.predictors import CheckpointPredictor
from tensor2robot_tpu_torch.research.qtopt import GraspingModelWrapper

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
POOLS = (  # name, input NHWC, window, strides (all SAME padding)
    ('pool1', (64, 236, 236, 64), (3, 3), (3, 3)),
    ('pool2', (64, 79, 79, 64), (3, 3), (3, 3)),
    ('pool3', (64, 27, 27, 64), (2, 2), (2, 2)),
)
CONV1_X = (64, 472, 472, 3)
CONV1_W = (6, 6, 3, 64)
OUT_DIR = pathlib.Path(__file__).resolve().parent / 'chiprun_out'


def log(*parts):
  print(*parts, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
  """Mean device time of one call of ``fn``: each call is timed alone with
  CUDA events, after a 256 MB write has flushed the 50 MB L2 cache, so its
  inputs come from device memory as the bytes bound assumes."""
  flush = torch.empty(256 * 2**20, dtype=torch.uint8, device='cuda')
  for _ in range(warmup):
    fn()
  events = []
  for _ in range(iters):
    flush.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    events.append((start, end))
  torch.cuda.synchronize()
  return sum(start.elapsed_time(end) for start, end in events) / iters


def tied_normal(shape, dtype, generator, device):
  """Seeded normal data with ties (channel 0 rounded to halves)."""
  x = torch.randn(shape, generator=generator, device=device)
  x[..., 0] = torch.round(x[..., 0] * 2) / 2
  return x.to(dtype).contiguous()


def phase_card():
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60).stdout.strip()
  card = smi.splitlines()[0].strip()
  log(card)
  log(f'card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, '
      f'python {sys.version.split()[0]}')
  return card


def phase_build():
  start = time.perf_counter()
  reports = _build.build()
  seconds = time.perf_counter() - start
  log(f'build: {seconds:.1f} s for {list(reports) or "cached libraries"}')
  for name, report in reports.items():
    for line in report.splitlines():
      if 'registers' in line or 'spill' in line:
        log(f'  ptxas {name}: {line.strip()}')


def phase_check_pool(generator):
  cases = [(name, shape, window, strides, torch.bfloat16)
           for name, shape, window, strides in POOLS]
  cases += [('odd_f32', (2, 11, 13, 16), (3, 2), (1, 2), torch.float32),
            ('overlap_f32', (4, 23, 23, 64), (3, 3), (2, 2), torch.float32)]
  max_err = 0.0
  for name, shape, window, strides, dtype in cases:
    x = tied_normal(shape, dtype, generator, 'cuda')
    pads = pool.resolve_padding('SAME', window, strides, shape[1:3])
    got = pool.pool_fwd(x, window, strides, pads)
    want = pool.plain_max_pool_argmax(x, window, strides, pads)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
      raise AssertionError(f'pool_fwd {name} differs from its plain version')
    max_err = max(max_err, float((got[0].float() - want[0].float()).abs()
                                 .max()))
    log(f'check pool_fwd {name} {shape} {str(dtype)[6:]}: bitwise')
  tie = torch.zeros((1, 4, 4, 8), device='cuda')
  tie[0, 2, 2] = tie[0, 3, 3] = 9.0
  out, slot = pool.pool_fwd(tie, (2, 2), (2, 2), ((0, 0), (0, 0)))
  torch.cuda.synchronize()
  if int(slot[0, 1, 1].max()) != 0 or int(slot[0, 0, 0].max()) != 0:
    raise AssertionError('pool_fwd tie did not keep the first slot')
  if float(out[0, 1, 1].min()) != 9.0:
    raise AssertionError('pool_fwd tie value')
  log('check pool_fwd planted tie: first slot wins')
  return max_err


def phase_check_conv(generator):
  pads = conv_s2d.resolve_padding('SAME', CONV1_W[:2], (2, 2), CONV1_X[1:3])
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  errors = {}
  for dtype, band in ((torch.bfloat16, 2.0**-7), (torch.float32, 1e-5)):
    x = torch.rand(CONV1_X, generator=generator, device='cuda').to(dtype)
    w = (0.1 * torch.randn(CONV1_W, generator=generator, device='cuda')).to(
        dtype)
    got = conv_s2d.conv_s2d_fwd(x, w, (2, 2), pads).float()
    want = conv_s2d.plain_conv2d(x, w, (2, 2), pads).float()
    torch.cuda.synchronize()
    err = (got - want).abs()
    limit = band * want.abs() + (1e-6 if dtype == torch.bfloat16 else band)
    if not bool((err <= limit).all()):
      raise AssertionError(
          f'conv_s2d_fwd {dtype} outside its band: max err '
          f'{float(err.max())}')
    errors[dtype] = float(err.max())
    log(f'check conv_s2d_fwd {CONV1_X} {str(dtype)[6:]}: max abs err '
        f'{errors[dtype]:.3e} (band {band:.1e} relative)')
    del x, w, got, want, err, limit
  return errors[torch.bfloat16]


def phase_main_path(seed, actions):
  model = GraspingModelWrapper(device_type='gpu', kernel_policy='pool_conv')
  predictor = CheckpointPredictor(model, device='cuda')
  predictor.init_randomly(torch.Generator().manual_seed(seed))
  policy = CEMPolicy(t2r_model=model, predictor=predictor, action_size=5,
                     cem_samples=64, cem_iters=3, num_elites=6,
                     device_resident=True)
  frames = np.random.RandomState(seed).randint(
      0, 256, (actions + 1, 512, 640, 3), dtype=np.uint8)
  np.random.seed(seed)
  with _dispatch.force_kernels(True):
    policy.SelectAction(frames[0], None, 0)  # warm-up
    torch.cuda.synchronize()
    pool.pool_fwd.launches = 0
    conv_s2d.conv_s2d_fwd.launches = 0
    start = time.perf_counter()
    chosen = [policy.SelectAction(frames[t], None, t)
              for t in range(1, actions + 1)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {'conv_s2d_fwd': conv_s2d.conv_s2d_fwd.launches,
                'pool_fwd': pool.pool_fwd.launches}
  for action in chosen:
    if action.shape != (5,) or not np.isfinite(action).all():
      raise AssertionError(f'bad action {action!r}')
  if launches != {'conv_s2d_fwd': 3 * actions, 'pool_fwd': 9 * actions}:
    raise AssertionError(f'launches over {actions} actions: {launches}')
  ms_per_action = 1e3 * seconds / actions
  log(f'main path: {actions} actions, {ms_per_action:.2f} ms/action '
      f'(host clock, synchronised), launches {launches}, last action '
      f'{np.array2string(chosen[-1], precision=4)}')

  rng = np.random.RandomState(seed + 1)
  images = rng.randint(0, 256, (8, 512, 640, 3), dtype=np.uint8)
  pairs = rng.randn(8, 5).astype(np.float32)
  with _dispatch.force_kernels(True):
    q = predictor.predict({'state/image': images,
                           'action/world_vector': pairs[:, :3],
                           'action/vertical_rotation': pairs[:, 3:]})
  q = q['q_predicted']
  if q.shape != (8,) or not np.isfinite(q).all() or not (
      (q >= 0) & (q <= 1)).all():
    raise AssertionError(f'bad predict output {q!r}')
  log(f'predict: 8 pairs, q_predicted {np.array2string(q, precision=4)}')
  return ms_per_action, launches, policy, frames


def spread_weights(network, generator):
  """Kernels of std 1/sqrt(fan_in), so a float32 check sees real signal
  (a fresh critic scores everything near 0.5)."""
  state = {}
  for name, value in network.state_dict().items():
    if name.endswith(('kernel', 'weight')):
      fan_in = (value[..., 0].numel() if name.endswith('kernel') else
                value[0].numel())
      value = torch.randn(value.shape, generator=generator) / fan_in**0.5
    elif name.endswith(('bias', 'mean')):
      value = 0.1 * torch.randn(value.shape, generator=generator)
    elif name.endswith('var'):
      value = 0.5 + torch.rand(value.shape, generator=generator)
    state[name] = value
  return state


def phase_reference(seed):
  """The whole float32 network on the card (kernels) against the CPU
  (plain versions) on 2 full-width pairs, TF32 off."""
  model = GraspingModelWrapper(device_type='cpu', kernel_policy='pool_conv')
  on_card = CheckpointPredictor(model, device='cuda')
  on_cpu = CheckpointPredictor(model, device='cpu')
  on_card.init_randomly()
  on_cpu.init_randomly()
  state = spread_weights(on_cpu.network, torch.Generator().manual_seed(seed))
  on_card.network.load_state_dict(state)
  on_cpu.network.load_state_dict(state)
  rng = np.random.RandomState(seed + 2)
  features = {
      'state/image': rng.randint(0, 256, (2, 512, 640, 3), dtype=np.uint8),
      'action/world_vector': rng.randn(2, 3).astype(np.float32),
      'action/vertical_rotation': rng.randn(2, 2).astype(np.float32),
  }
  with _dispatch.force_kernels(True):
    got = on_card.predict(features)['q_predicted']
  with _dispatch.force_kernels(False):
    want = on_cpu.predict(features)['q_predicted']
  err = float(np.abs(got - want).max())
  if not np.isfinite(got).all() or err > 1e-4:
    raise AssertionError(f'card {got} vs cpu {want}: err {err}')
  log(f'reference: float32 network card vs cpu on 2 pairs, q {got} vs '
      f'{want}, max abs err {err:.2e} (band 1e-4)')
  # q of a random critic moves little with the image, so the image tower's
  # end points are held too, each within 1e-4 of its largest magnitude.
  def end_points(predictor, kernels):
    device_features = {k: torch.from_numpy(v).to(predictor.device)
                       for k, v in features.items()}
    with torch.inference_mode(), _dispatch.force_kernels(kernels):
      inputs, _ = model.preprocessor.preprocess(device_features, None,
                                                ModeKeys.PREDICT)
      return predictor.network(inputs['state/image'],
                               model.grasp_params(inputs))[1]

  card_points = end_points(on_card, True)
  cpu_points = end_points(on_cpu, False)
  for name in ('pool2', 'final_conv', 'logits'):
    want = cpu_points[name]
    err = float((card_points[name].cpu() - want).abs().max())
    scale = float(want.abs().max())
    if not err <= 1e-4 * scale:
      raise AssertionError(f'end point {name}: err {err} at scale {scale}')
    log(f'reference: end point {name} {tuple(want.shape)}: max abs err '
        f'{err:.2e} at max magnitude {scale:.3e} (band 1e-4 relative)')


def pool_bytes(shape, window, strides, itemsize):
  pads = pool.resolve_padding('SAME', window, strides, shape[1:3])
  (plh, phh), (plw, phw) = pads
  oh = (shape[1] + plh + phh - window[0]) // strides[0] + 1
  ow = (shape[2] + plw + phw - window[1]) // strides[1] + 1
  outputs = shape[0] * oh * ow * shape[3]
  return (np.prod(shape) * itemsize + outputs * (itemsize + 4), pads,
          outputs * window[0] * window[1])


def library_pool(x_nhwc, window, strides, pads):
  """One F.max_pool2d call for the same pool: the high-end pad of SAME is
  ceil_mode's, a symmetric one is padding=."""
  (plh, _), _ = pads
  x = x_nhwc.permute(0, 3, 1, 2)
  if plh:
    return F.max_pool2d(x, window, strides, padding=plh, return_indices=True)
  return F.max_pool2d(x, window, strides, ceil_mode=True, return_indices=True)


def phase_timing(generator, pool_err, conv_err, launches):
  record = {'pool_fwd': dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                             bytes=0, ops=0)}
  for name, shape, window, strides in POOLS:
    x = tied_normal(shape, torch.bfloat16, generator, 'cuda')
    nbytes, pads, ops = pool_bytes(shape, window, strides, 2)
    lib_vals, _ = library_pool(x, window, strides, pads)
    if not torch.equal(lib_vals.permute(0, 2, 3, 1),
                       pool.pool_fwd(x, window, strides, pads)[0]):
      raise AssertionError(f'library pool {name} computes another function')
    ms = cuda_ms(lambda: pool.pool_fwd(x, window, strides, pads))
    plain = cuda_ms(
        lambda: pool.plain_max_pool_argmax(x, window, strides, pads), iters=5)
    lib = cuda_ms(lambda: library_pool(x, window, strides, pads))
    bound = 1e3 * nbytes / HBM_BYTES_PER_S
    log(f'time pool_fwd {name} {shape} bf16: kernel {ms:.4f} ms, plain '
        f'{plain:.4f} ms, F.max_pool2d {lib:.4f} ms, bound {bound:.4f} ms '
        f'({nbytes / 1e6:.1f} MB)')
    entry = record['pool_fwd']
    entry['ms'] += ms
    entry['plain_ms'] += plain
    entry['library_ms'] += lib
    entry['bytes'] += nbytes
    entry['ops'] += ops
    del x, lib_vals

  x = torch.rand(CONV1_X, generator=generator, device='cuda').to(
      torch.bfloat16)
  w = (0.1 * torch.randn(CONV1_W, generator=generator, device='cuda')).to(
      torch.bfloat16)
  pads = conv_s2d.resolve_padding('SAME', CONV1_W[:2], (2, 2), CONV1_X[1:3])
  x_cl = x.permute(0, 3, 1, 2)
  w_cl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
  ms = cuda_ms(lambda: conv_s2d.conv_s2d_fwd(x, w, (2, 2), pads))
  plain = cuda_ms(lambda: conv_s2d.plain_conv2d(x, w, (2, 2), pads), iters=5)
  lib = cuda_ms(lambda: F.conv2d(x_cl, w_cl, stride=2, padding=pads[0][0]))
  pixels = CONV1_X[0] * 236 * 236
  patch = int(np.prod(CONV1_W[:3]))
  nbytes = 2 * (np.prod(CONV1_X) + np.prod(CONV1_W) + pixels * CONV1_W[3])
  ops = 2 * pixels * patch * CONV1_W[3]
  log(f'time conv_s2d_fwd {CONV1_X} bf16: kernel {ms:.4f} ms, plain '
      f'{plain:.4f} ms, F.conv2d {lib:.4f} ms, bytes bound '
      f'{1e3 * nbytes / HBM_BYTES_PER_S:.4f} ms ({nbytes / 1e6:.1f} MB), '
      f'ops bound {1e3 * ops / BF16_FLOP_PER_S:.4f} ms ({ops / 1e9:.1f} '
      'GFLOP)')
  record['conv_s2d_fwd'] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                bytes=nbytes, ops=ops)

  kernels = []
  meta = {
      'pool_fwd': ('tensor2robot_tpu_torch/ops/csrc/pool.cu',
                   'tensor2robot_tpu/ops/pool.py:258', pool_err),
      'conv_s2d_fwd': ('tensor2robot_tpu_torch/ops/csrc/conv_s2d.cu',
                       'tensor2robot_tpu/ops/conv_s2d.py:223', conv_err),
  }
  for name, (source, replaces, err) in meta.items():
    entry = record[name]
    bytes_ms = 1e3 * entry['bytes'] / HBM_BYTES_PER_S
    ops_ms = 1e3 * entry['ops'] / BF16_FLOP_PER_S
    kernels.append({
        'name': name, 'route': 'cuda', 'source': source,
        'replaces': replaces, 'launches': launches[name],
        'max_abs_err': err, 'ms': entry['ms'],
        'plain_ms': entry['plain_ms'], 'bound_ms': max(bytes_ms, ops_ms),
        'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
        'library_ms': entry['library_ms'],
    })
  return kernels


def phase_profile(policy, frames):
  """Device time by kernel over two actions (torch.profiler)."""
  from torch.profiler import ProfilerActivity, profile

  np.random.seed(1)
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    for t in range(2):
      policy.SelectAction(frames[t], None, t)
    torch.cuda.synchronize()
  averages = prof.key_averages()
  table = averages.table(sort_by='self_cuda_time_total', row_limit=40)
  OUT_DIR.mkdir(exist_ok=True)
  (OUT_DIR / 'chip_smoke_profile.txt').write_text(table)
  # The kernels' own rows (device_type CUDA); older torch names the
  # device time after CUDA.
  device_us = sum(
      getattr(e, 'self_device_time_total', None) or
      getattr(e, 'self_cuda_time_total', 0) for e in averages
      if str(getattr(e, 'device_type', '')).endswith('CUDA'))
  log(f'profile: {device_us / 2e3:.3f} ms of device kernel time per action '
      f'(2 actions); table in chiprun_out/chip_smoke_profile.txt')
  for line in table.splitlines()[:16]:
    log('  ' + line)


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--actions', type=int, default=5)
  parser.add_argument('--profile', action='store_true')
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA card is visible; nothing was run.',
          file=sys.stderr)
    return 2
  card = phase_card()
  phase_build()
  generator = torch.Generator(device='cuda').manual_seed(args.seed)
  pool_err = phase_check_pool(generator)
  conv_err = phase_check_conv(generator)
  torch.cuda.empty_cache()
  ms_per_action, launches, policy, frames = phase_main_path(args.seed,
                                                            args.actions)
  phase_reference(args.seed)
  torch.cuda.empty_cache()
  kernels = phase_timing(generator, pool_err, conv_err, launches)
  if args.profile:
    phase_profile(policy, frames)
  log(f'ms/action {ms_per_action:.3f} on {card}')
  log(json.dumps({'kernels': kernels}))
  log(card)
  log(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
