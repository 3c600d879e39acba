"""Seeded numpy weights for the JAX-vs-port parity tests.

Both packages get the same numpy variables tree: the JAX package directly,
the port through ``tensor2robot_tpu_torch.utils.convert``. Kernels are
drawn with std 1/sqrt(fan_in) (not the 0.01 init of a fresh critic, under
which every candidate action scores within float32 epsilon of 0.5), so
activations keep their scale through the tower and candidate actions get
distinct scores.
"""

import numpy as np


def random_variables(shapes, seed: int):
  """A tree of float32 numpy leaves shaped like ``shapes`` (a nested dict
  of objects with ``.shape``, e.g. from ``jax.eval_shape``)."""
  rng = np.random.RandomState(seed)

  def fill(tree, path):
    out = {}
    for key in sorted(tree):
      value = tree[key]
      if isinstance(value, dict) or hasattr(value, 'items'):
        out[key] = fill(dict(value), path + (key,))
        continue
      shape = tuple(value.shape)
      if key == 'kernel':
        fan_in = int(np.prod(shape[:-1]))
        leaf = rng.randn(*shape) / np.sqrt(fan_in)
      elif key == 'scale':
        leaf = 1.0 + 0.1 * rng.randn(*shape)
      elif key == 'var':
        leaf = 0.5 + rng.rand(*shape)
      else:  # bias, mean
        leaf = 0.1 * rng.randn(*shape)
      out[key] = leaf.astype(np.float32)
    return out

  return fill(dict(shapes), ())
