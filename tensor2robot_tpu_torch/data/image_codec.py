"""Encoded images of the record feed: decode by magic bytes, encode PNG.

The port's counterpart of the image part of
``tensor2robot_tpu/data/native_io.py`` (``_decode_image``,
``_native_jpeg_batch``) and of ``example_codec._decode_image_tensor``.
Like ``tf.io.decode_image``, the bytes decide the codec, not the spec's
``data_format``:

* empty bytes decode to zeros (the codec's convention for a missing
  image);
* PNG (``\\x89PNG``) inflated by ``zlib`` from the standard library, its
  row filters undone by the port's C++ library
  (``native/record_io.cpp``, ``t2r_png_unfilter``; rows of filter 0 alone
  need no pass): 8-bit gray, RGB or RGBA, not interlaced, all five row
  filters;
* JPEG (``\\xff\\xd8``) through the port's libjpeg batch decoder
  (``native/jpeg_decode.cpp``, ISLOW, bit for bit PIL's decode) where
  libjpeg's header is present, else through PIL, imported here and only
  here;
* anything else, or JPEG with neither libjpeg nor PIL, raises.

Channels are forced to the spec's count as the JAX package's PIL route
does: gray to RGB by repetition, RGBA to RGB by dropping alpha, RGB or
RGBA to gray by PIL's ``convert('L')`` (ITU-R 601-2 luma in 16-bit fixed
point). A decoded size other than the spec's raises, naming the feature. A
batch's blobs decode into one contiguous buffer: [B, H, W, C] for an
image feature, and for an episode's frames ([T, H, W, C] specs) or a
sequence's steps the same buffer seen as [B, T, H, W, C]
(``example_codec.decode_values``), on one shared pool of threads.

:func:`encode_png` writes the port's shards (filter 0 by default, zlib at
a chosen level); it takes any of the five filters per row, which is how
the tests cover the decoder.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import struct
import threading
import zlib
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from tensor2robot_tpu_torch import native

PNG_MAGIC = b'\x89PNG\r\n\x1a\n'
JPEG_MAGIC = b'\xff\xd8'
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel
_JPEG_OK, _JPEG_EMPTY, _JPEG_BAD_SHAPE = 0, 1, 3


def jpeg_route() -> str:
  """'libjpeg' where libjpeg's header is on the compiler's include path,
  else 'pil' (PIL importable), else 'none'."""
  if native.libjpeg_available():
    return 'libjpeg'
  try:
    import PIL.Image  # pylint: disable=import-outside-toplevel,unused-import
    return 'pil'
  except ImportError:
    return 'none'


# ------------------------------------------------------------------- PNG


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
  a, b, c = (x.astype(np.int16) for x in (a, b, c))
  p = a + b - c
  pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
  return np.where((pa <= pb) & (pa <= pc), a,
                  np.where(pb <= pc, b, c)).astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
  """[H, W, C] uint8 pixels of an 8-bit, non-interlaced gray (C=1), RGB
  (3) or RGBA (4) PNG; other PNGs raise ``ValueError``. Chunks are read
  as views and inflated into a buffer of the exact size, and the rows are
  unfiltered in C++, so the work runs outside the interpreter lock (zlib
  and ctypes release it) and decodes on several threads scale. The pixels may be a strided view of the inflated rows."""
  if bytes(data[:8]) != PNG_MAGIC:
    raise ValueError('not a PNG')
  view = memoryview(data)
  pos, header, idat = len(PNG_MAGIC), None, []
  while pos + 8 <= len(view):
    length, kind = struct.unpack_from('>I4s', view, pos)
    body = view[pos + 8:pos + 8 + length]
    if len(body) != length or pos + 12 + length > len(view):
      raise ValueError('truncated PNG chunk')
    (crc,) = struct.unpack_from('>I', view, pos + 8 + length)
    # IDAT's own CRC is not checked, as PIL does not: zlib's adler32
    # covers the pixel stream, and a record's bytes are covered by its
    # TFRecord CRC32C.
    if kind != b'IDAT' and zlib.crc32(body, zlib.crc32(kind)) != crc:
      raise ValueError(f'PNG chunk {kind!r}: crc mismatch')
    pos += 12 + length
    if kind == b'IHDR':
      header = struct.unpack('>IIBBBBB', body)
    elif kind == b'IDAT':
      idat.append(body)
    elif kind == b'IEND':
      break
  if header is None or not idat:
    raise ValueError('PNG without IHDR or IDAT')
  width, height, depth, color, compression, filtering, interlace = header
  if (depth != 8 or color not in _PNG_CHANNELS or compression or filtering or
      interlace):
    raise ValueError(
        f'PNG of bit depth {depth}, colour type {color}, interlace '
        f'{interlace}: only 8-bit gray, RGB and RGBA, not interlaced, are '
        f'decoded')
  bpp = _PNG_CHANNELS[color]
  stride = width * bpp
  size = height * (stride + 1)
  raw = np.frombuffer(zlib.decompress(
      idat[0] if len(idat) == 1 else b''.join(idat), bufsize=size), np.uint8)
  if raw.size != size:
    raise ValueError(f'PNG pixel data of {raw.size} bytes, expected {size}')
  rows = raw.reshape(height, stride + 1)
  kinds = rows[:, 0]
  if not kinds.any():
    return rows[:, 1:].reshape(height, width, bpp)
  pixels = np.empty((height, stride), np.uint8)
  bad = native.record_io().t2r_png_unfilter(raw.ctypes.data,
                                            pixels.ctypes.data, height,
                                            stride, bpp)
  if bad:
    raise ValueError(f'PNG row filter {int(kinds[bad - 1])} does not exist')
  return pixels.reshape(height, width, bpp)


def _chunk(kind: bytes, body: bytes) -> bytes:
  return (struct.pack('>I', len(body)) + kind + body +
          struct.pack('>I', zlib.crc32(kind + body) & 0xffffffff))


def _filter_rows(pixels: np.ndarray, kinds: np.ndarray,
                 bpp: int) -> np.ndarray:
  """Each row filtered by its kind (computed on the original samples)."""
  out = np.empty((pixels.shape[0], pixels.shape[1] + 1), np.uint8)
  out[:, 0] = kinds
  if not kinds.any():
    out[:, 1:] = pixels
    return out
  x = pixels.astype(np.int16)
  left = np.zeros_like(x)
  left[:, bpp:] = x[:, :-bpp]
  up = np.zeros_like(x)
  up[1:] = x[:-1]
  upleft = np.zeros_like(x)
  upleft[1:, bpp:] = x[:-1, :-bpp]
  preds = (np.zeros_like(x), left, up, (left + up) >> 1,
           _paeth(left, up, upleft).astype(np.int16))
  for kind in range(5):
    rows = kinds == kind
    if rows.any():
      out[rows, 1:] = ((x[rows] - preds[kind][rows]) & 0xff).astype(np.uint8)
  return out


def encode_png(image: np.ndarray, level: int = 6,
               filters: Union[int, Sequence[int]] = 0) -> bytes:
  """PNG bytes of an [H, W], [H, W, 1], [H, W, 3] or [H, W, 4] uint8
  image; ``filters`` is one row filter (0-4) for every row or a sequence
  cycled over the rows; ``level`` is zlib's compression level."""
  image = np.asarray(image)
  if image.dtype != np.uint8:
    raise ValueError(f'PNG encode takes uint8, got {image.dtype}')
  if image.ndim == 2:
    image = image[..., None]
  height, width, channels = image.shape
  color = {1: 0, 3: 2, 4: 6}.get(channels)
  if color is None:
    raise ValueError(f'PNG encode takes 1, 3 or 4 channels, got {channels}')
  kinds = np.resize(np.asarray(filters, np.uint8).reshape(-1), height)
  rows = _filter_rows(image.reshape(height, width * channels), kinds,
                      channels)
  return b''.join([
      PNG_MAGIC,
      _chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, 8, color, 0, 0,
                                  0)),
      _chunk(b'IDAT', zlib.compress(rows.tobytes(), level)),
      _chunk(b'IEND', b''),
  ])


# ----------------------------------------------------------------- decode


def force_channels(pixels: np.ndarray, channels: int) -> np.ndarray:
  """[H, W, c] uint8 -> [H, W, channels], as PIL's ``convert``."""
  have = pixels.shape[-1]
  if have == channels:
    return pixels
  if channels == 3:
    return np.repeat(pixels, 3, axis=-1) if have == 1 else pixels[..., :3]
  if channels == 1:
    rgb = pixels[..., :3].astype(np.uint32)
    luma = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 +
            0x8000) >> 16
    return luma.astype(np.uint8)[..., None]
  raise ValueError(f'cannot make {channels} channels of {have}')


def _decode_pil(data: bytes, channels: int) -> np.ndarray:
  import io  # pylint: disable=import-outside-toplevel
  try:
    import PIL.Image  # pylint: disable=import-outside-toplevel
  except ImportError as e:
    raise RuntimeError(
        'JPEG decode needs libjpeg\'s header (jpeglib.h) for the native '
        'decoder, or PIL; this host has neither') from e
  img = PIL.Image.open(io.BytesIO(data))
  if channels == 3 and img.mode != 'RGB':
    img = img.convert('RGB')
  elif channels == 1 and img.mode != 'L':
    img = img.convert('L')
  arr = np.asarray(img)
  return arr[..., None] if arr.ndim == 2 else arr


def _check_shape(pixels: np.ndarray, shape: Tuple[int, ...], key) -> None:
  if pixels.shape != shape:
    raise ValueError(f'Decoded image for feature {key!r} has shape '
                     f'{pixels.shape}, but the spec declares {shape}.')


def decode_image(data: bytes, shape: Sequence[int], dtype=np.uint8,
                 key=None) -> np.ndarray:
  """One encoded image -> ``shape`` ([H, W, C]) in ``dtype``."""
  out = np.empty((1,) + tuple(shape), dtype)
  decode_image_batch([data], shape, dtype, out=out, key=key)
  return out[0]


_POOLS: Dict[int, concurrent.futures.ThreadPoolExecutor] = {}
_POOL_LOCK = threading.Lock()


def _pool(workers: int) -> concurrent.futures.ThreadPoolExecutor:
  """A decode pool per size, shared by every parse fn of the process and
  never shut down (another iterator may be mapping on it)."""
  with _POOL_LOCK:
    pool = _POOLS.get(workers)
    if pool is None:
      pool = _POOLS[workers] = concurrent.futures.ThreadPoolExecutor(
          max_workers=workers, thread_name_prefix='t2r-decode')
    return pool


def _decode_jpeg_native(raws, indices, out, workers, key) -> None:
  """libjpeg decodes of ``raws[indices]`` into ``out[indices]`` (straight
  into ``out`` when every image of the batch is a JPEG)."""
  lib = native.jpeg_decode()
  n = len(indices)
  h, w, c = out.shape[1:]
  whole = n == len(out)
  staged = out if whole else np.empty((n, h, w, c), np.uint8)
  status = np.zeros(n, np.int32)
  bufs = (ctypes.c_char_p * n)(*[bytes(raws[i]) for i in indices])
  lens = (ctypes.c_uint64 * n)(*[len(raws[i]) for i in indices])
  lib.t2r_jpeg_decode_batch(
      bufs, lens, n, staged.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
      h, w, c, max(1, int(workers)),
      status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
  for j, i in enumerate(indices):
    if status[j] == _JPEG_BAD_SHAPE:
      raise ValueError(f'Decoded image for feature {key!r} (image {i} of the '
                       f'batch) is not of the spec\'s shape {(h, w, c)}.')
    if status[j] not in (_JPEG_OK, _JPEG_EMPTY):
      raise ValueError(f'JPEG decode of feature {key!r} failed (libjpeg '
                       f'status {int(status[j])}, image {i} of the batch)')
    if not whole:
      out[i] = staged[j]


def decode_image_batch(raws: Sequence[bytes], shape: Sequence[int],
                       dtype=np.uint8, out: Optional[np.ndarray] = None,
                       workers: int = 0, key=None) -> np.ndarray:
  """[N, *shape] images of ``raws`` (see the module doc), written into
  ``out`` (contiguous, [N, *shape], ``dtype``) when given, e.g. a ring
  slot of ``data/engine.py``. ``workers`` > 1 decodes PNGs on a shared
  thread pool and JPEGs on that many libjpeg threads."""
  shape = tuple(int(d) for d in shape)
  if len(shape) != 3:
    raise ValueError(f'images are decoded to [H, W, C], not {shape}')
  n = len(raws)
  dtype = np.dtype(dtype)
  if out is None:
    out = np.empty((n,) + shape, dtype)
  elif (out.shape != (n,) + shape or out.dtype != dtype or
        not out.flags['C_CONTIGUOUS']):
    raise ValueError(f'decode buffer for {key!r} must be contiguous {dtype} '
                     f'{(n,) + shape}, got {out.dtype} {out.shape}')
  channels = shape[-1]
  jpegs, pngs = [], []
  for i, raw in enumerate(raws):
    magic = bytes(raw[:8])
    if not magic:
      out[i] = 0
    elif magic == PNG_MAGIC:
      pngs.append(i)
    elif magic.startswith(JPEG_MAGIC):
      jpegs.append(i)
    else:
      raise ValueError(f'feature {key!r}, image {i} of the batch: neither '
                       f'PNG nor JPEG bytes ({bytes(raw[:8])!r})')

  def png_into(i):
    pixels = force_channels(decode_png(raws[i]), channels)
    _check_shape(pixels, shape, key)
    out[i] = pixels

  def pil_into(i):
    pixels = _decode_pil(bytes(raws[i]), channels)
    _check_shape(pixels, shape, key)
    out[i] = pixels

  jobs = [(png_into, i) for i in pngs]
  if jpegs:
    route = jpeg_route()
    if route == 'libjpeg' and dtype == np.uint8 and channels in (1, 3):
      _decode_jpeg_native(raws, jpegs, out, workers, key)
    elif route == 'none':
      raise RuntimeError(
          f'feature {key!r}: JPEG decode needs libjpeg\'s header '
          '(jpeglib.h) for the native decoder, or PIL; this host has '
          'neither')
    else:
      jobs += [(pil_into, i) for i in jpegs]
  def run(chunk):
    for fn, i in chunk:
      fn(i)

  if workers and workers > 1 and len(jobs) > 1:
    # One task per thread, each a contiguous run of images: fewer hand-offs
    # of the interpreter lock than a task per image.
    chunks = [jobs[k::int(workers)] for k in range(min(int(workers),
                                                       len(jobs)))]
    for _ in _pool(int(workers)).map(run, chunks):
      pass
  else:
    run(jobs)
  return out
