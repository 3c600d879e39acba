"""The port's native (C++) host libraries, built at first use, bound by ctypes.

* ``record_io.cpp``: TFRecord framing with CRC32C, a threaded round-robin
  interleave reader, a tf.Example and tf.SequenceExample wire parser (no
  protobuf) and the PNG row unfilter;
* ``jpeg_decode.cpp``: libjpeg batch decode into a contiguous buffer.

Each source compiles with

    g++ -O3 -std=c++17 -shared -fPIC -pthread <src> -o lib<stem>-<hash>.so

(``-ljpeg`` for the decoder) into ``build/native/`` beside the package
(listed in ``.gitignore``), ``<hash>`` taken over the source and the
flags, so an edited source builds anew and an unchanged one is loaded
from there. Concurrent builders write a temporary file each and rename it
into place. **A failed build raises** with the compiler's output; nothing
falls back.

The JPEG route is taken where libjpeg's header is on the compiler's
include path (:func:`libjpeg_available`, one preprocessor run, cached);
``data/image_codec.py`` decodes JPEG with PIL elsewhere.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Dict, Optional, Sequence

SRC_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / 'build' / 'native'
CXX_FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC', '-pthread')

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_libjpeg: Optional[bool] = None


def library_path(stem: str, link: Sequence[str] = ()) -> pathlib.Path:
  source = (SRC_DIR / f'{stem}.cpp').read_bytes()
  flags = ' '.join(CXX_FLAGS + tuple(link)).encode()
  digest = hashlib.sha256(source + flags).hexdigest()[:16]
  return BUILD_DIR / f'lib{stem}-{digest}.so'


def build(stem: str, link: Sequence[str] = ()) -> pathlib.Path:
  """Compiles ``<stem>.cpp`` unless its library is already built; returns
  the library's path. Raises ``RuntimeError`` when the compiler fails."""
  out = library_path(stem, link)
  if out.exists():
    return out
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_name(f'{out.name}.tmp{os.getpid()}-{threading.get_ident()}')
  cmd = ['g++', *CXX_FLAGS, str(SRC_DIR / f'{stem}.cpp'), '-o', str(tmp),
         *link]
  try:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          check=False)
  except OSError as e:
    raise RuntimeError(f'cannot run the C++ compiler for {stem}.cpp: {e}') from e
  if proc.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f'building {stem}.cpp failed ({" ".join(cmd)}):\n'
                       f'{proc.stderr[-4000:]}')
  tmp.replace(out)  # atomic: racing builders converge on one file
  return out


def _load(stem: str, bind, link: Sequence[str] = ()) -> ctypes.CDLL:
  with _lock:
    lib = _libs.get(stem)
    if lib is None:
      lib = bind(ctypes.CDLL(str(build(stem, link))))
      _libs[stem] = lib
    return lib


def _bind_record_io(lib: ctypes.CDLL) -> ctypes.CDLL:
  u8p = ctypes.POINTER(ctypes.c_uint8)
  sig = {
      't2r_writer_open': (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_char_p]),
      't2r_writer_write': (ctypes.c_int, [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_uint64]),
      't2r_writer_flush': (ctypes.c_int, [ctypes.c_void_p]),
      't2r_writer_close': (ctypes.c_int, [ctypes.c_void_p]),
      't2r_reader_open': (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int]),
      't2r_reader_next': (ctypes.c_int64, [ctypes.c_void_p,
                                           ctypes.POINTER(u8p)]),
      't2r_reader_error': (ctypes.c_char_p, [ctypes.c_void_p]),
      't2r_reader_seek': (ctypes.c_int, [ctypes.c_void_p, ctypes.c_uint64]),
      't2r_reader_close': (None, [ctypes.c_void_p]),
      't2r_interleave_open': (ctypes.c_void_p, [
          ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
          ctypes.c_int, ctypes.c_int]),
      't2r_interleave_next': (ctypes.c_int64, [ctypes.c_void_p,
                                               ctypes.POINTER(u8p)]),
      't2r_interleave_error': (ctypes.c_char_p, [ctypes.c_void_p]),
      't2r_interleave_close': (None, [ctypes.c_void_p]),
      't2r_masked_crc32c': (ctypes.c_uint32, [ctypes.c_char_p,
                                              ctypes.c_uint64]),
      't2r_parser_create': (ctypes.c_void_p, [
          ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
          ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
          ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
          ctypes.c_int]),
      't2r_parser_sequence_lengths': (ctypes.c_int, [
          ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
          ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
          ctypes.POINTER(ctypes.c_int64)]),
      't2r_parser_set_steps': (None, [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int64)]),
      't2r_parser_parse_batch': (ctypes.c_int, [
          ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
          ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
          ctypes.POINTER(ctypes.c_void_p)]),
      't2r_parser_error': (ctypes.c_char_p, [ctypes.c_void_p]),
      't2r_parser_destroy': (None, [ctypes.c_void_p]),
      't2r_png_unfilter': (ctypes.c_int64, [
          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
          ctypes.c_int]),
  }
  for name, (restype, argtypes) in sig.items():
    fn = getattr(lib, name)
    fn.restype, fn.argtypes = restype, argtypes
  return lib


def _bind_jpeg(lib: ctypes.CDLL) -> ctypes.CDLL:
  lib.t2r_jpeg_decode_batch.restype = ctypes.c_int
  lib.t2r_jpeg_decode_batch.argtypes = [
      ctypes.POINTER(ctypes.c_char_p),  # bufs
      ctypes.POINTER(ctypes.c_uint64),  # lens
      ctypes.c_int,                     # n
      ctypes.POINTER(ctypes.c_uint8),   # out
      ctypes.c_int, ctypes.c_int, ctypes.c_int,  # h, w, c
      ctypes.c_int,                     # num_threads
      ctypes.POINTER(ctypes.c_int32),   # status
  ]
  return lib


def record_io() -> ctypes.CDLL:
  """The record-IO library (built at first use; raises if it cannot be)."""
  return _load('record_io', _bind_record_io)


def libjpeg_available() -> bool:
  """Whether ``jpeglib.h`` is on the C++ compiler's include path."""
  global _libjpeg
  with _lock:
    if _libjpeg is None:
      try:
        proc = subprocess.run(['g++', '-E', '-x', 'c++', '-'],
                              input='#include <cstdio>\n#include <jpeglib.h>\n',
                              capture_output=True, text=True, timeout=60,
                              check=False)
        _libjpeg = proc.returncode == 0
      except OSError:
        _libjpeg = False
    return _libjpeg


def jpeg_decode() -> ctypes.CDLL:
  """The libjpeg batch decoder (built at first use; raises if it cannot
  be, libjpeg's header present or not)."""
  return _load('jpeg_decode', _bind_jpeg, link=('-ljpeg',))
