"""Constant-time stream-position reconstruction for the native record feed.

The port's copy of ``tensor2robot_tpu/data/seek_resume.py``. The native
record stream is a pure function of (file list, cycle length, seed,
shuffle size): a strict block_length=1 round-robin interleave over per-slot
file chains, then a seeded fixed-size shuffle buffer. Both stages invert
once per-shard record counts are known (the shard-index sidecars,
``data/shard_index.py``), so a resume at ANY depth reduces to:

  1. closed-form interleave math: which (shard, ordinal) produced every
     raw-stream position, and where each reader stands after N records;
  2. a vectorized replay of the shuffle RNG (``RandomState.randint(k,
     size=P)`` consumes the same variate stream as P scalar draws),
     recovering the rng state AND which raw indices sit in the buffer
     without touching a record;
  3. at most ``shuffle_buffer_size`` indexed record reads to refill the
     buffer, plus per-slot seeks for the partial epoch.

``input_generators.NativeRecordInputGenerator`` drives this and degrades
loudly to the replay path when an index is missing or stale.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# Vectorized shuffle replay works in bounded chunks so a billion-record
# position never materializes a billion-entry draw array.
_SHUFFLE_CHUNK = 1 << 20


class InterleaveLayout:
  """Closed-form position algebra for the C++ interleave reader's order.

  Mirrors ``native/record_io.cpp``: ``S = min(cycle_length, n_files)``
  slots; slot ``s`` owns files ``s, s+S, s+2S, …`` read sequentially;
  the consumer round-robins slots (one record per visit), skipping
  exhausted slots. Equivalently: in round ``r`` every slot with more
  than ``r`` records emits its ``r``-th record, in slot order.
  """

  def __init__(self, counts: Sequence[int], cycle_length: int):
    if not counts:
      raise ValueError('need at least one shard')
    slots = cycle_length if cycle_length > 0 else 16
    self.num_slots = min(slots, len(counts))
    self.counts = [int(c) for c in counts]
    self.slot_files: List[List[int]] = [
        list(range(s, len(counts), self.num_slots))
        for s in range(self.num_slots)
    ]
    self.slot_totals = [
        sum(self.counts[f] for f in files) for files in self.slot_files
    ]
    self.total = sum(self.slot_totals)
    # Per-slot cumulative file counts, for slot-ordinal -> (file, ordinal).
    self._slot_cum: List[List[int]] = []
    for files in self.slot_files:
      cum, acc = [], 0
      for f in files:
        acc += self.counts[f]
        cum.append(acc)
      self._slot_cum.append(cum)

  def emitted_before_round(self, r: int) -> int:
    """Records emitted in rounds < r (= C(r)): sum over min(n_s, r)."""
    return sum(min(n, r) for n in self.slot_totals)

  def _rank(self, slot: int, r: int) -> int:
    """Active slots before ``slot`` in round ``r``."""
    return sum(1 for s in range(slot) if self.slot_totals[s] > r)

  def position_of(self, slot: int, r: int) -> int:
    """Within-epoch position at which slot emits its r-th record."""
    return self.emitted_before_round(r) + self._rank(slot, r)

  def locate(self, pos: int) -> Tuple[int, int]:
    """Within-epoch position -> (slot, round) that produced it."""
    if not 0 <= pos < self.total:
      raise ValueError(f'position {pos} out of range [0, {self.total})')
    lo, hi = 0, max(self.slot_totals)  # r in [lo, hi): C(r) <= pos
    while hi - lo > 1:
      mid = (lo + hi) // 2
      if self.emitted_before_round(mid) <= pos:
        lo = mid
      else:
        hi = mid
    r = lo
    j = pos - self.emitted_before_round(r)
    for s in range(self.num_slots):
      if self.slot_totals[s] > r:
        if j == 0:
          return s, r
        j -= 1
    raise AssertionError('locate: inconsistent layout')  # pragma: no cover

  def slot_consumed_at(self, slot: int, pos: int) -> int:
    """Records slot has emitted once ``pos`` records were emitted."""
    n = self.slot_totals[slot]
    if n == 0 or pos <= 0:
      return 0
    lo, hi = 0, n  # count rounds r with position_of(slot, r) < pos
    while lo < hi:
      mid = (lo + hi) // 2
      if self.position_of(slot, mid) < pos:
        lo = mid + 1
      else:
        hi = mid
    return lo

  def slot_record(self, slot: int, ordinal: int) -> Tuple[int, int]:
    """Slot-local ordinal -> (file index, record ordinal in file)."""
    cum = self._slot_cum[slot]
    if not 0 <= ordinal < self.slot_totals[slot]:
      raise ValueError(
          f'slot {slot} ordinal {ordinal} out of range '
          f'({self.slot_totals[slot]} records)')
    i = bisect.bisect_right(cum, ordinal)
    prev = cum[i - 1] if i else 0
    return self.slot_files[slot][i], ordinal - prev

  def record_at(self, pos: int) -> Tuple[int, int]:
    """Within-epoch position -> (file index, record ordinal in file)."""
    slot, r = self.locate(pos)
    return self.slot_record(slot, r)

  def per_file_position(self, pos: int) -> List[Tuple[int, int]]:
    """Reader state once ``pos`` records were emitted: for every slot,
    (next file index, next record ordinal in that file); a fully
    consumed slot reports (-1, 0)."""
    out = []
    for s in range(self.num_slots):
      consumed = self.slot_consumed_at(s, pos)
      if consumed >= self.slot_totals[s]:
        out.append((-1, 0))
      else:
        out.append(self.slot_record(s, consumed))
    return out


def simulate_shuffle(seed: Optional[int], buffer_size: int,
                     emitted: int) -> Tuple[np.random.RandomState,
                                            np.ndarray]:
  """Replays the shuffle WITHOUT data: rng state + buffered raw indices.

  The stream's shuffle (``input_generators``) fills a ``buffer_size``
  buffer from raw records 0..bs-1, then emission ``t`` draws ``j =
  rng.randint(bs)``, emits slot ``j`` and refills it with raw record
  ``bs + t``. So after ``emitted`` emissions, slot ``j`` holds raw index
  ``bs + t_last(j)`` (its latest refill) or its initial ``j``. Both the
  final rng state and ``t_last`` come from a chunked vectorized replay —
  ``randint(bs, size=n)`` consumes the identical underlying variate
  stream as n scalar draws (pinned by test) — so this is O(emitted)
  numpy work with O(buffer) memory, ~milliseconds at 100k records.
  """
  rng = np.random.RandomState(seed)
  last = np.full(buffer_size, -1, np.int64)
  done = 0
  while done < emitted:
    n = int(min(_SHUFFLE_CHUNK, emitted - done))
    draws = rng.randint(buffer_size, size=n)
    # maximum.at keeps the LAST refill per slot (t is increasing) with
    # well-defined semantics under duplicate indices.
    np.maximum.at(last, draws, np.arange(done, done + n, dtype=np.int64))
    done += n
  buffered = np.where(last >= 0, buffer_size + last,
                      np.arange(buffer_size, dtype=np.int64))
  return rng, buffered


def local_to_global(local_index: int, process_count: int,
                    process_index: int, epoch_total: int) -> Tuple[int, int]:
  """Element-sharded local raw index -> (epoch, within-epoch position).

  The element shard filters each epoch's enumeration independently
  (``i % process_count == process_index`` with ``i`` reset per epoch),
  so a process's epoch slice has ``len(range(pi, T, pc))`` records.
  """
  per_epoch = len(range(process_index, epoch_total, process_count))
  if per_epoch == 0:
    raise ValueError(
        f'process {process_index}/{process_count} owns no records of a '
        f'{epoch_total}-record epoch')
  epoch, rank = divmod(local_index, per_epoch)
  return epoch, process_index + rank * process_count


@dataclasses.dataclass
class ResumePlan:
  """Everything ``_build_batches`` needs to continue mid-stream."""

  layout: InterleaveLayout
  files: List[str]
  buffer: Optional[List[bytes]]  # shuffle buffer contents, stream order
  rng: Optional[np.random.RandomState]  # advanced past all prior draws
  epoch: int                    # epoch holding the next raw record
  within_epoch: int             # next GLOBAL within-epoch position
  records_local: int            # local raw records already consumed
  process_count: int = 1
  process_index: int = 0
  # path -> validated ShardIndex, set by the caller so the partial-epoch
  # readers seek without re-loading sidecars.
  indexes: Optional[Dict[str, object]] = None


def plan_resume(
    files: Sequence[str],
    counts: Sequence[int],
    cycle_length: int,
    seed: Optional[int],
    shuffle_buffer_size: int,
    records_emitted: int,
    shuffled: bool,
    fetch: Callable[[str, Sequence[int]], Dict[int, bytes]],
    process_count: int = 1,
    process_index: int = 0,
) -> ResumePlan:
  """Builds the constant-time resume plan for a stream position.

  ``records_emitted`` is the POST-shuffle position (delivered batches ×
  batch size). ``fetch(path, ordinals) -> {ordinal: bytes}`` performs
  the indexed reads (``records.read_records_at``).
  """
  layout = InterleaveLayout(counts, cycle_length)
  if layout.total == 0:
    raise ValueError('cannot resume over empty shards')
  if shuffled and shuffle_buffer_size > 1:
    rng, buffered = simulate_shuffle(seed, shuffle_buffer_size,
                                     records_emitted)
    raw_local = shuffle_buffer_size + records_emitted
    # Group the ≤ buffer_size indexed reads per shard.
    wanted: Dict[str, List[int]] = {}
    located = []
    for raw in buffered.tolist():
      epoch, within = local_to_global(raw, process_count, process_index,
                                      layout.total)
      del epoch  # repeated epochs re-read the same bytes
      file_idx, ordinal = layout.record_at(within)
      located.append((files[file_idx], ordinal))
      wanted.setdefault(files[file_idx], []).append(ordinal)
    payloads = {
        path: fetch(path, sorted(set(ordinals)))
        for path, ordinals in wanted.items()
    }
    buffer = [payloads[path][ordinal] for path, ordinal in located]
  else:
    rng, buffer = None, None
    raw_local = records_emitted
  epoch, within = local_to_global(raw_local, process_count, process_index,
                                  layout.total)
  return ResumePlan(layout=layout, files=list(files), buffer=buffer,
                    rng=rng, epoch=epoch, within_epoch=within,
                    records_local=raw_local,
                    process_count=process_count,
                    process_index=process_index)


def iter_epoch_from(
    layout: InterleaveLayout,
    files: Sequence[str],
    start_pos: int,
    open_at: Callable[[str, int], Iterator[bytes]],
) -> Iterator[Tuple[int, bytes]]:
  """Yields (within-epoch position, record) from ``start_pos`` to epoch
  end, byte-identical in order to the C++ interleave reader.

  Used ONLY for the resumed partial epoch: per-slot readers are opened
  at their seek positions (``open_at(path, ordinal)``) and read
  sequentially; subsequent full epochs go back through the native
  prefetching interleave.
  """
  if start_pos >= layout.total:
    return
  start_slot, start_round = layout.locate(start_pos)
  positions = layout.per_file_position(start_pos)

  # Lazy per-slot chained readers from each slot's seek position.
  def slot_stream(slot: int) -> Iterator[bytes]:
    file_idx, ordinal = positions[slot]
    if file_idx < 0:
      return
    files_in_slot = layout.slot_files[slot]
    at = files_in_slot.index(file_idx)
    for i in range(at, len(files_in_slot)):
      f = files_in_slot[i]
      yield from open_at(files[f], ordinal if f == file_idx else 0)

  streams = [None] * layout.num_slots
  pos = start_pos
  r = start_round
  max_rounds = max(layout.slot_totals)
  while r < max_rounds:
    for s in range(layout.num_slots):
      if layout.slot_totals[s] <= r:
        continue  # slot exhausted before this round
      if r == start_round and s < start_slot:
        continue  # already emitted before the resume point
      if streams[s] is None:
        streams[s] = slot_stream(s)
      record = next(streams[s], None)
      if record is None:
        raise RuntimeError(
            f'shard set changed under a resumed stream: slot {s} ran '
            f'out of records at round {r} (index said '
            f'{layout.slot_totals[s]})')
      yield pos, record
      pos += 1
    r += 1
