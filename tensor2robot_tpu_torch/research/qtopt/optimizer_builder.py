"""QT-Opt optimizer builder: hparams -> optimizer factory.

The port's counterpart of
``tensor2robot_tpu/research/qtopt/optimizer_builder.py``: an
exponentially decaying learning rate (staircase, every ``examples_per_epoch
/ batch_size * num_epochs_per_decay`` updates) feeding momentum SGD,
RMSProp or Adam, each with optax's arithmetic (``models/optimizers.py``).
Parameter averaging is the train state's EMA (``use_avg_model_params``),
so the builder returns the plain optimizer.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from tensor2robot_tpu_torch.models import optimizers


def default_hparams() -> Dict[str, Any]:
  """The wrapper's default hparams."""
  return dict(
      batch_size=32,
      examples_per_epoch=3000000,
      learning_rate_decay_factor=0.999,
      learning_rate=1e-4,
      model_weights_averaging=0.9999,
      momentum=0.9,
      num_epochs_per_decay=2.0,
      optimizer='momentum',
      rmsprop_decay=0.9,
      rmsprop_epsilon=1.0,
      adam_beta2=0.999,
      adam_epsilon=1e-8,
      use_avg_model_params=True,
  )


def build_opt(hparams: Optional[Dict[str, Any]]) -> Callable:
  """hparams -> ``fn(params) -> torch.optim.Optimizer``; unknown optimizer
  names take Adam, as the JAX builder does."""
  merged = default_hparams()
  merged.update(hparams or {})
  hparams = merged

  decay_steps = int(hparams['examples_per_epoch'] / hparams['batch_size'] *
                    hparams['num_epochs_per_decay'])
  learning_rate = optimizers.exponential_decay(
      init_value=hparams['learning_rate'],
      transition_steps=decay_steps,
      decay_rate=hparams['learning_rate_decay_factor'],
      staircase=True)

  optimizer = hparams['optimizer']
  if optimizer == 'momentum':
    return optimizers.create_momentum_optimizer(
        learning_rate, momentum=hparams['momentum'])
  if optimizer == 'rmsprop':
    return optimizers.create_rms_prop_optimizer(
        learning_rate, decay=hparams['rmsprop_decay'],
        momentum=hparams['momentum'], epsilon=hparams['rmsprop_epsilon'])
  return optimizers.create_adam_optimizer(
      learning_rate, beta1=hparams['momentum'],
      beta2=hparams['adam_beta2'], epsilon=hparams['adam_epsilon'])
