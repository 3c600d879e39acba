"""Kernel dispatch for the hand-written CUDA ops.

The port's counterpart of ``tensor2robot_tpu/ops/_pallas_dispatch.py``.

* **The gate is the tensor's device, and nothing else**
  (:func:`kernels_enabled`). A CUDA tensor launches the kernel, or the
  call raises; a CPU tensor runs the kernel's plain PyTorch version. There
  is no probe of what imports or builds, and no fallback: a kernel that
  fails to build or launch raises.
* :func:`force_kernels` / ``T2R_FORCE_PALLAS_KERNELS`` turn a mismatch
  between the wanted path and the tensor's device into an error instead of
  switching path: forced on, a CPU tensor at a kernel entry raises (a run
  that must go through the kernels cannot quietly compute on the host);
  forced off, a CUDA tensor raises.
* The ``kernel_policy`` model knob (``'none' | 'pool' | 'pool_conv'``)
  names which kernel families a tower routes through its kernel entries.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional

import torch

KERNEL_NONE = 'none'
KERNEL_POOL = 'pool'
KERNEL_POOL_CONV = 'pool_conv'
KERNEL_POLICIES = (KERNEL_NONE, KERNEL_POOL, KERNEL_POOL_CONV)


def validate_kernel_policy(policy: Optional[str]) -> str:
  """Normalises/validates a kernel-policy name (None -> 'none')."""
  policy = KERNEL_NONE if policy is None else str(policy)
  if policy not in KERNEL_POLICIES:
    raise ValueError(
        f'Unknown kernel_policy {policy!r}; expected one of '
        f'{KERNEL_POLICIES}.')
  return policy


def policy_enables_pool(policy: Optional[str]) -> bool:
  """Whether the policy routes max-pools through ``ops.pool``."""
  return validate_kernel_policy(policy) in (KERNEL_POOL, KERNEL_POOL_CONV)


def policy_enables_conv(policy: Optional[str]) -> bool:
  """Whether the policy routes the first conv through ``ops.conv_s2d``."""
  return validate_kernel_policy(policy) == KERNEL_POOL_CONV


_FORCE_ENV = 'T2R_FORCE_PALLAS_KERNELS'
_force_override = threading.local()


def _forced() -> Optional[bool]:
  override = getattr(_force_override, 'value', None)
  if override is not None:
    return bool(override)
  env = os.environ.get(_FORCE_ENV)
  if env is not None:
    return env.strip().lower() not in ('', '0', 'false', 'off')
  return None


def kernels_enabled(x: torch.Tensor) -> bool:
  """True when ``x`` lies on a CUDA device (the kernel launches), False on
  the CPU (the plain version runs). Raises when a :func:`force_kernels`
  override disagrees with the device."""
  on_cuda = x.device.type == 'cuda'
  forced = _forced()
  if forced is not None and forced != on_cuda:
    raise RuntimeError(
        f'Kernels are forced {"on" if forced else "off"} but the tensor '
        f'lies on {x.device}: a CUDA tensor always launches the kernel and '
        'a CPU tensor always runs the plain version.')
  return on_cuda


@contextlib.contextmanager
def force_kernels(enabled: bool = True):
  """Within the context, a kernel entry raises unless the tensor's device
  agrees with ``enabled`` (see module docstring)."""
  previous = getattr(_force_override, 'value', None)
  _force_override.value = enabled
  try:
    yield
  finally:
    _force_override.value = previous


def resolve_device(device) -> torch.device:
  """The torch device an entry point runs on; raises for a CUDA request on
  a host with no visible card rather than running on the CPU."""
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        f'Device {device} was requested but no CUDA card is visible; pass '
        "device='cpu' to run the plain versions on the host.")
  return device
