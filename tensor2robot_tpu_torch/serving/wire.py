"""The JSON wire's request decode, in the serving process or in decoder
processes of its own.

A predict body is ``{"features": {<name>: <nested lists>}}`` (or a bare
feature dict). :func:`decode_features` parses it with ``json.loads`` and
each feature with ``np.asarray``, as ``tensor2robot_tpu/serving/
server.py`` does. One 512×640×3 frame is a 5 MB body, and its decode is
two C calls that hold the interpreter lock for a few hundred ms: every
other thread of the serving process (the batcher's dispatcher, the
listener, a balancer's ``/healthz`` probe) waits behind it.
:class:`DecoderPool` runs the same function in child processes for bodies
of ``min_bytes`` or more, so such a decode leaves the lock free and
several bodies decode at once; smaller bodies decode in the caller.

Run as a script (``python wire.py``), this file is one decoder: it
imports json, numpy and the stdlib only, reads messages from stdin and
writes replies to stdout, each an 8-byte little-endian length and its
bytes. A reply is the pickle of ``(True, features)`` or ``(False,
exception)``. It exits at the end of its input, which comes when its
parent closes the pipe or dies.
"""

from __future__ import annotations

import json
import pickle
import struct
import subprocess
import sys
import threading
from typing import Any, Dict, List

import numpy as np

_LENGTH = struct.Struct('<Q')
# In-process, a body this size decodes in about 20 ms of the lock.
MIN_BYTES = 1 << 18
DECODERS = 4  # decoder processes a pool starts at most


def decode_features(body: bytes) -> Dict[str, np.ndarray]:
  """The feature dict of a predict body; ValueError/TypeError when it is
  malformed (the server's 400)."""
  payload = json.loads(body or b'{}')
  raw = payload.get('features', payload)
  if not isinstance(raw, dict) or not raw:
    raise ValueError('body must carry a non-empty feature dict')
  return {k: np.asarray(v) for k, v in raw.items()}


class DecoderExitedError(RuntimeError):
  """A decoder process ended before it replied."""


def _read_message(stream) -> bytes:
  head = stream.read(_LENGTH.size)
  if len(head) < _LENGTH.size:
    raise EOFError('the pipe closed')
  (length,) = _LENGTH.unpack(head)
  data = stream.read(length)
  if len(data) < length:
    raise EOFError('the pipe closed mid-message')
  return data


def _write_message(stream, data: bytes) -> None:
  stream.write(_LENGTH.pack(len(data)))
  stream.write(data)
  stream.flush()


class DecoderPool:
  """Up to :data:`DECODERS` decoder processes, started as bodies need
  them; a process that fails is dropped and a later body starts another.
  """

  def __init__(self):
    self.min_bytes = MIN_BYTES
    self._cond = threading.Condition()
    self._idle: List[subprocess.Popen] = []  # GUARDED_BY(self._cond)
    self._running = 0  # GUARDED_BY(self._cond)
    self._closed = False  # GUARDED_BY(self._cond)

  def decode(self, body: bytes) -> Dict[str, np.ndarray]:
    """:func:`decode_features` of ``body``: in a decoder process when it
    is ``min_bytes`` or more, else here. Raises what the function raises,
    or :class:`DecoderExitedError`."""
    if len(body) < self.min_bytes:
      return decode_features(body)
    process = self._take()
    try:
      _write_message(process.stdin, body)
      ok, value = pickle.loads(_read_message(process.stdout))
    except (EOFError, OSError) as e:
      self._drop(process)
      raise DecoderExitedError(
          f'decoder process {process.pid} ended before it replied '
          f'(exit {process.poll()})') from e
    except BaseException:
      self._drop(process)
      raise
    self._give(process)
    if not ok:
      raise value
    return value

  def _take(self) -> subprocess.Popen:
    with self._cond:
      while not self._idle and self._running >= DECODERS:
        self._cond.wait()
      if self._idle:
        return self._idle.pop()
      self._running += 1
    try:
      return subprocess.Popen([sys.executable, __file__],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    except BaseException:
      with self._cond:
        self._running -= 1
        self._cond.notify()
      raise

  def _give(self, process: subprocess.Popen) -> None:
    with self._cond:
      if not self._closed:
        self._idle.append(process)
        self._cond.notify()
        return
    self._drop(process)

  def _drop(self, process: subprocess.Popen) -> None:
    _stop(process)
    with self._cond:
      self._running -= 1
      self._cond.notify()

  def close(self) -> None:
    """Stops the idle processes; one still decoding stops when its reply
    is read."""
    with self._cond:
      self._closed = True
      idle, self._idle = self._idle, []
    for process in idle:
      self._drop(process)


def _stop(process: subprocess.Popen) -> None:
  for stream in (process.stdin, process.stdout):
    try:
      stream.close()
    except OSError:
      pass
  try:
    process.wait(timeout=5.0)
  except subprocess.TimeoutExpired:
    process.kill()
    process.wait()


def _serve(stdin, stdout) -> None:
  while True:
    try:
      body = _read_message(stdin)
    except EOFError:
      return
    try:
      reply: Any = (True, decode_features(body))
    except Exception as e:  # pylint: disable=broad-except
      reply = (False, e)
    try:
      data = pickle.dumps(reply, protocol=pickle.HIGHEST_PROTOCOL)
    except Exception as e:  # pylint: disable=broad-except
      data = pickle.dumps((False, RuntimeError(f'unpicklable reply: {e!r}')))
    _write_message(stdout, data)


if __name__ == '__main__':
  _serve(sys.stdin.buffer, sys.stdout.buffer)
