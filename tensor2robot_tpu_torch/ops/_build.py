"""Builds the CUDA sources under ``ops/csrc`` at first use and loads them.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, loaded through ``ctypes``. The command is

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <name>.cu

with ``<hash>`` taken over the source and the flags, so an edited source
builds anew and an unchanged one is loaded from ``build/torch_kernels/``
beside the package (listed in ``.gitignore``). :func:`build` starts one
``nvcc`` per missing library, all at once, and waits for them together. A
failed build raises with nvcc's stderr; nothing falls back.

Each C entry point returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises when that is not ``cudaSuccess``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Mapping, Sequence

CSRC_DIR = pathlib.Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / 'build' / (
    'torch_kernels')
SOURCES = ('pool', 'conv_s2d')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
  """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
  cuda_home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
  candidate = pathlib.Path(cuda_home) / 'bin' / 'nvcc'
  if candidate.is_file():
    return str(candidate)
  found = shutil.which('nvcc')
  if found is None:
    raise RuntimeError(
        'nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA '
        'kernels build from source at first use and need the CUDA toolkit.')
  return found


def library_path(name: str) -> pathlib.Path:
  source = (CSRC_DIR / f'{name}.cu').read_bytes()
  digest = hashlib.sha256(source + ' '.join(NVCC_FLAGS).encode()).hexdigest()
  return BUILD_DIR / f'lib{name}-{digest[:16]}.so'


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
  """Compiles every missing library, one ``nvcc`` per source, all started
  together. Returns each built library's compiler output (``ptxas``
  register and shared-memory report); raises if any build fails."""
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  pending = []
  for name in names:
    out = library_path(name)
    if out.exists():
      continue
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    cmd = [nvcc_path(), *NVCC_FLAGS, '-o', str(tmp),
           str(CSRC_DIR / f'{name}.cu')]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    pending.append((name, out, tmp, proc))
  reports, errors = {}, []
  for name, out, tmp, proc in pending:
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
      errors.append(f'{name}.cu: nvcc exited {proc.returncode}\n{stderr}')
      continue
    os.replace(tmp, out)
    reports[name] = (stdout + stderr).strip()
  if errors:
    raise RuntimeError('CUDA kernel build failed:\n' + '\n'.join(errors))
  return reports


def load(name: str,
         signatures: Mapping[str, Sequence]) -> ctypes.CDLL:
  """The loaded library for ``csrc/<name>.cu``, built if missing.

  ``signatures`` maps each C entry point to its ``argtypes``; every entry
  point returns an ``int`` status (see :func:`check`).
  """
  with _lock:
    lib = _libs.get(name)
    if lib is None:
      build((name,))
      lib = ctypes.CDLL(str(library_path(name)))
      for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
      error_string = lib.t2r_error_string
      error_string.argtypes = [ctypes.c_int]
      error_string.restype = ctypes.c_char_p
      _libs[name] = lib
  return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
  """Raises when a C entry point reported a CUDA error."""
  if status != 0:
    message = lib.t2r_error_string(status).decode()
    raise RuntimeError(f'{what}: CUDA error {status} ({message})')
