"""Trainer binary: parse config files, call ``train_eval_model``.

All wiring lives in config files; the binary parses ``--gin_configs`` /
``--gin_bindings``, installs the preemption handler first, and calls one
function. A preempted run exits with the resumable status 42.

Usage:
  python -m tensor2robot_tpu_torch.bin.run_t2r_trainer \\
      --gin_configs tensor2robot_tpu_torch/research/qtopt/configs/train_qtopt.gin \\
      --gin_bindings "train_eval_model.model_dir = '/path/to/model_dir'"

The model directory then holds ``checkpoints/ckpt_<step>/`` with their
commit markers, ``config-0.gin`` (the parsed config, written at start)
and ``operative_config-0.gin`` (the bindings used, written at the end).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from tensor2robot_tpu_torch import config as t2r_config
from tensor2robot_tpu_torch.train import resilience


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--gin_configs', action='append', default=[],
                      help='Path to a gin config file (repeatable).')
  parser.add_argument('--gin_bindings', action='append', default=[],
                      help='Individual gin bindings (repeatable).')
  parser.add_argument(
      '--handle_preemption', action=argparse.BooleanOptionalAction,
      default=True,
      help='Convert SIGTERM/SIGINT into a forced checkpoint and the '
           'resumable exit status 42.')
  args = parser.parse_args(argv)
  # Before any work: a SIGTERM while the config parses or the state builds
  # still exits resumable.
  shutdown = (resilience.install_graceful_shutdown()
              if args.handle_preemption else None)
  try:
    return _run(args)
  finally:
    # Once training is over a SIGTERM kills as usual, and a caller of
    # main() gets its own signal dispositions back.
    if shutdown is not None:
      shutdown.uninstall()


def _run(args):
  t2r_config.register_framework_configurables()
  t2r_config.parse_config_files_and_bindings(
      config_files=args.gin_configs, bindings=args.gin_bindings)
  try:
    model_dir = t2r_config.query_parameter('train_eval_model.model_dir',
                                           resolve=True)
  except t2r_config.ConfigError:
    model_dir = None
  if not isinstance(model_dir, str):
    model_dir = None

  def save_config(text, filename):
    if not model_dir:
      return
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, filename), 'w') as f:
      f.write(text)

  save_config(t2r_config.config_str(), 'config-0.gin')
  train_eval_model = t2r_config.get_configurable('train_eval_model')
  try:
    result = train_eval_model()
  except resilience.PreemptedError as e:
    logging.warning('%s; exiting with resumable status %d.', e, e.exit_code)
    sys.exit(e.exit_code)
  operative = t2r_config.operative_config_str()
  logging.info('Operative config:\n%s', operative)
  save_config(operative, 'operative_config-0.gin')
  return result


if __name__ == '__main__':
  logging.basicConfig(level=logging.INFO)
  main()
