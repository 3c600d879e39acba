// Native record IO runtime: TFRecord framing, CRC32C, a threaded
// interleaved prefetch reader and a tf.Example wire parser.
//
// The PyTorch port's own copy of tensor2robot_tpu/native/record_io.cpp
// (the same code and the same C interface), bound through ctypes by
// tensor2robot_tpu_torch/native/__init__.py and used by
// tensor2robot_tpu_torch/data/native_io.py. Format per record (TFRecord
// wire format, interoperable with tf.io):
//
//   uint64 length (LE) | uint32 masked_crc32c(length) |
//   payload bytes      | uint32 masked_crc32c(payload)
//
// The interleave reader runs one worker thread per slot (slot s owns
// files s, s+C, s+2C, ...), each filling a bounded queue; the consumer
// round-robins across slots (block_length=1 semantics, deterministic
// order) so disk latency overlaps the training step. The plain Python
// reader of data/records.py is this reader's plain version.
//
// Beside them, and not in the JAX package's copy: the SequenceExample
// FeatureLists of the parser (t2r_parser_sequence_lengths,
// t2r_parser_set_steps, a sequence flag in t2r_parser_create) and
// t2r_png_unfilter, the PNG row filters undone for data/image_codec.py's
// decoder.

#include <cstdint>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- crc32c

uint32_t g_crc_table[8][256];

void crc32c_init() {
  const uint32_t poly = 0x82f63b78u;  // Castagnoli, reflected
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = i;
    for (int k = 0; k < 8; k++) crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    g_crc_table[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = g_crc_table[0][i];
    for (int t = 1; t < 8; t++) {
      crc = (crc >> 8) ^ g_crc_table[0][crc & 0xff];
      g_crc_table[t][i] = crc;
    }
  }
}

struct CrcInit {
  CrcInit() { crc32c_init(); }
} g_crc_init;

uint32_t crc32c(const uint8_t* data, size_t n) {
  uint32_t crc = 0xffffffffu;
  // Slicing-by-8 over aligned middle, bytewise head/tail.
  while (n >= 8) {
    uint32_t lo;
    uint32_t hi;
    memcpy(&lo, data, 4);
    memcpy(&hi, data + 4, 4);
    lo ^= crc;
    crc = g_crc_table[7][lo & 0xff] ^ g_crc_table[6][(lo >> 8) & 0xff] ^
          g_crc_table[5][(lo >> 16) & 0xff] ^ g_crc_table[4][lo >> 24] ^
          g_crc_table[3][hi & 0xff] ^ g_crc_table[2][(hi >> 8) & 0xff] ^
          g_crc_table[1][(hi >> 16) & 0xff] ^ g_crc_table[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ g_crc_table[0][(crc ^ *data++) & 0xff];
  return crc ^ 0xffffffffu;
}

uint32_t masked_crc(const uint8_t* data, size_t n) {
  uint32_t crc = crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

// ----------------------------------------------------------------- writer

struct Writer {
  FILE* f = nullptr;
};

// ----------------------------------------------------------------- reader

struct Reader {
  FILE* f = nullptr;
  bool verify = true;
  std::string current;
  std::string error;

  // Returns 1 record-read, 0 EOF, -1 error.
  int next() {
    uint8_t header[12];
    size_t got = fread(header, 1, 12, f);
    if (got == 0) return 0;
    if (got != 12) {
      error = "truncated record header";
      return -1;
    }
    uint64_t len;
    uint32_t len_crc;
    memcpy(&len, header, 8);
    memcpy(&len_crc, header + 8, 4);
    if (verify && masked_crc(header, 8) != len_crc) {
      error = "corrupted record length (crc mismatch)";
      return -1;
    }
    // With CRC verification off, a corrupt length field is caught only
    // here: cap at 1 GiB (far above any real tf.Example) and never let
    // resize() throw across the extern "C"/ctypes boundary.
    if (len > (1ull << 30)) {
      error = "implausible record length";
      return -1;
    }
    try {
      current.resize(len);
    } catch (const std::exception& e) {
      error = std::string("record allocation failed: ") + e.what();
      return -1;
    }
    if (len && fread(&current[0], 1, len, f) != len) {
      error = "truncated record payload";
      return -1;
    }
    uint32_t data_crc;
    if (fread(&data_crc, 1, 4, f) != 4) {
      error = "truncated record footer";
      return -1;
    }
    if (verify &&
        masked_crc(reinterpret_cast<const uint8_t*>(current.data()),
                   current.size()) != data_crc) {
      error = "corrupted record payload (crc mismatch)";
      return -1;
    }
    return 1;
  }
};

// ------------------------------------------------- interleave prefetcher

struct FileQueue {
  std::deque<std::string> q;
  std::mutex mu;
  std::condition_variable cv_push;
  std::condition_variable cv_pop;
  bool done = false;
  std::string error;
};

struct Interleave {
  std::vector<std::unique_ptr<FileQueue>> queues;  // one per SLOT
  std::vector<std::vector<std::string>> slot_files;
  std::vector<std::thread> workers;
  size_t capacity = 64;
  size_t cursor = 0;
  size_t open_files = 0;  // live SLOTS
  std::vector<bool> exhausted;
  std::string current;
  std::string error;
  bool stopping = false;
  std::mutex stop_mu;

  ~Interleave() {
    {
      std::lock_guard<std::mutex> l(stop_mu);
      stopping = true;
    }
    for (auto& fq : queues) {
      std::lock_guard<std::mutex> l(fq->mu);
      fq->done = true;
      fq->cv_push.notify_all();
      fq->cv_pop.notify_all();
    }
    for (auto& t : workers)
      if (t.joinable()) t.join();
  }

  bool stop_requested() {
    std::lock_guard<std::mutex> l(stop_mu);
    return stopping;
  }
};

// One worker per SLOT: reads its statically-assigned files (slot s owns
// files s, s+C, s+2C, ...) sequentially, so thread count and queue memory
// are bounded by the cycle length, not the file count.
void worker_read_slot(Interleave* it, FileQueue* fq,
                      const std::vector<std::string>* files, bool verify) {
  for (const std::string& path : *files) {
    Reader r;
    r.verify = verify;
    r.f = fopen(path.c_str(), "rb");
    if (!r.f) {
      std::lock_guard<std::mutex> l(fq->mu);
      fq->error = "cannot open " + path;
      fq->done = true;
      fq->cv_pop.notify_all();
      return;
    }
    for (;;) {
      int rc = r.next();
      if (rc != 1) {
        if (rc < 0) {
          std::lock_guard<std::mutex> l(fq->mu);
          fq->error = path + ": " + r.error;
          fq->done = true;
          fq->cv_pop.notify_all();
          fclose(r.f);
          return;
        }
        break;  // EOF: advance to this slot's next file
      }
      std::unique_lock<std::mutex> l(fq->mu);
      fq->cv_push.wait(l, [&] {
        return fq->q.size() < it->capacity || fq->done;
      });
      if (fq->done) {  // shutdown
        fclose(r.f);
        return;
      }
      fq->q.push_back(std::move(r.current));
      fq->cv_pop.notify_one();
      l.unlock();
      if (it->stop_requested()) {
        fclose(r.f);
        return;
      }
    }
    fclose(r.f);
  }
  std::lock_guard<std::mutex> l(fq->mu);
  fq->done = true;
  fq->cv_pop.notify_all();
}

}  // namespace

extern "C" {

// ----------------------------------------------------------- writer API

void* t2r_writer_open(const char* path, const char* mode) {
  FILE* f = fopen(path, (mode && mode[0] == 'a') ? "ab" : "wb");
  if (!f) return nullptr;
  auto* w = new Writer();
  w->f = f;
  return w;
}

int t2r_writer_write(void* handle, const void* data, uint64_t len) {
  auto* w = static_cast<Writer*>(handle);
  uint8_t header[12];
  memcpy(header, &len, 8);
  uint32_t len_crc = masked_crc(header, 8);
  memcpy(header + 8, &len_crc, 4);
  uint32_t data_crc =
      masked_crc(static_cast<const uint8_t*>(data), len);
  if (fwrite(header, 1, 12, w->f) != 12) return -1;
  if (len && fwrite(data, 1, len, w->f) != len) return -1;
  if (fwrite(&data_crc, 1, 4, w->f) != 4) return -1;
  return 0;
}

int t2r_writer_flush(void* handle) {
  return fflush(static_cast<Writer*>(handle)->f);
}

int t2r_writer_close(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  int rc = fclose(w->f);
  delete w;
  return rc;
}

// ----------------------------------------------------------- reader API

void* t2r_reader_open(const char* path, int verify_crc) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new Reader();
  r->f = f;
  r->verify = verify_crc != 0;
  return r;
}

// Returns payload length and sets *data (valid until the next call);
// -1 on EOF, -2 on error (see t2r_reader_error).
int64_t t2r_reader_next(void* handle, const uint8_t** data) {
  auto* r = static_cast<Reader*>(handle);
  int rc = r->next();
  if (rc == 0) return -1;
  if (rc < 0) return -2;
  *data = reinterpret_cast<const uint8_t*>(r->current.data());
  return static_cast<int64_t>(r->current.size());
}

const char* t2r_reader_error(void* handle) {
  return static_cast<Reader*>(handle)->error.c_str();
}

// Repositions the reader to an absolute byte offset — a RECORD BOUNDARY
// from a shard index sidecar (data/shard_index.py); seeking mid-record
// surfaces as a framing/CRC error on the next read, never silence.
// Returns 0 on success, -1 on seek failure.
int t2r_reader_seek(void* handle, uint64_t offset) {
  auto* r = static_cast<Reader*>(handle);
  if (fseeko(r->f, static_cast<off_t>(offset), SEEK_SET) != 0) {
    r->error = "seek failed";
    return -1;
  }
  return 0;
}

void t2r_reader_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  fclose(r->f);
  delete r;
}

// ------------------------------------------------------- interleave API

void* t2r_interleave_open(const char** paths, int n_paths,
                          int cycle_length, int queue_capacity,
                          int verify_crc) {
  if (n_paths <= 0) return nullptr;
  int slots = cycle_length > 0 ? cycle_length : 16;
  if (slots > n_paths) slots = n_paths;
  auto* it = new Interleave();
  it->capacity = queue_capacity > 0 ? queue_capacity : 64;
  it->exhausted.assign(slots, false);
  it->open_files = slots;
  it->slot_files.resize(slots);
  for (int i = 0; i < n_paths; i++)
    it->slot_files[i % slots].push_back(paths[i]);
  for (int s = 0; s < slots; s++)
    it->queues.emplace_back(new FileQueue());
  for (int s = 0; s < slots; s++)
    it->workers.emplace_back(worker_read_slot, it, it->queues[s].get(),
                             &it->slot_files[s], verify_crc != 0);
  return it;
}

// Round-robin pop across slots (block_length=1). Returns length, -1
// when every slot is exhausted, -2 on error.
int64_t t2r_interleave_next(void* handle, const uint8_t** data) {
  auto* it = static_cast<Interleave*>(handle);
  while (it->open_files > 0) {
    size_t i = it->cursor % it->queues.size();
    if (it->exhausted[i]) {
      it->cursor++;
      continue;
    }
    FileQueue* fq = it->queues[i].get();
    std::unique_lock<std::mutex> l(fq->mu);
    fq->cv_pop.wait(l, [&] { return !fq->q.empty() || fq->done; });
    if (!fq->q.empty()) {
      it->current = std::move(fq->q.front());
      fq->q.pop_front();
      fq->cv_push.notify_one();
      l.unlock();
      it->cursor++;
      *data = reinterpret_cast<const uint8_t*>(it->current.data());
      return static_cast<int64_t>(it->current.size());
    }
    // done && empty → file finished (or errored)
    if (!fq->error.empty()) {
      it->error = fq->error;
      return -2;
    }
    it->exhausted[i] = true;
    it->open_files--;
    it->cursor++;
  }
  return -1;
}

const char* t2r_interleave_error(void* handle) {
  return static_cast<Interleave*>(handle)->error.c_str();
}

void t2r_interleave_close(void* handle) {
  delete static_cast<Interleave*>(handle);
}

// ------------------------------------------------------------ utilities

uint32_t t2r_masked_crc32c(const void* data, uint64_t len) {
  return masked_crc(static_cast<const uint8_t*>(data), len);
}

}  // extern "C"

// ===================================================================
// tf.Example / tf.SequenceExample wire-format parser (no protobuf
// dependency).
//
// Schema subset used by the spec-driven codec (data/example_codec.py,
// whose plain Python decoder is this parser's plain version):
//   Example{1: Features{1: map<string, Feature{1:BytesList 2:FloatList
//   3:Int64List}>}}
//   SequenceExample{1: Features (the context), 2: FeatureLists{1:
//   map<string, FeatureList{1: Feature*}>}}
// Fixed- and padded-varlen float/int64 features fill contiguous [B, N]
// buffers; bytes features (encoded images, N of them an example) are
// returned as (offset, length) spans into the caller's record so Python
// can slice without copying. A sequence field's steps fill [B, T, N]
// (spans: [B, T, 1, 2]), T the batch's longest list, which a first pass
// (t2r_parser_sequence_lengths) measures and t2r_parser_set_steps hands
// to the parse.

namespace {

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end && shift < 64) {
      uint8_t b = *p++;
      v |= static_cast<uint64_t>(b & 0x7f) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
    }
    ok = false;
    return 0;
  }

  bool skip(uint32_t wire) {
    switch (wire) {
      case 0: varint(); return ok;
      case 1: if (end - p < 8) return ok = false; p += 8; return true;
      case 2: {
        uint64_t n = varint();
        if (!ok || static_cast<uint64_t>(end - p) < n) return ok = false;
        p += n;
        return true;
      }
      case 5: if (end - p < 4) return ok = false; p += 4; return true;
      default: return ok = false;
    }
  }

  // Returns (field, wire) or field=0 at end.
  bool tag(uint32_t* field, uint32_t* wire) {
    if (p >= end) return false;
    uint64_t t = varint();
    if (!ok) return false;
    *field = static_cast<uint32_t>(t >> 3);
    *wire = static_cast<uint32_t>(t & 7);
    return true;
  }

  Cursor sub() {
    uint64_t n = varint();
    Cursor c{p, p, false};
    if (!ok || static_cast<uint64_t>(end - p) < n) return c;
    c.end = p + n;
    c.ok = true;
    p += n;
    return c;
  }
};

enum FieldKind { kFloat = 0, kInt64 = 1, kBytes = 2 };

struct FieldSpec {
  std::string key;
  int kind;
  int64_t flat_len;   // elements per example (per step of a sequence);
                      // for kBytes: max spans
  int required;
  int varlen;         // pad/clip to flat_len; fixed specs error on mismatch
  int sequence;       // a FeatureList of steps of exactly flat_len values
  int64_t steps = 0;  // a sequence field's T in this batch's buffer
};

struct Parser {
  std::vector<FieldSpec> fields;
  std::string error;
};

// Parses one Feature submessage into output row b (of a sequence field:
// row b * steps + step).
bool parse_feature(Cursor fc, const FieldSpec& fs, int64_t b,
                   void* out, const uint8_t* rec_base, Parser* pr,
                   int64_t step = -1) {
  uint32_t field, wire;
  int64_t count = 0;
  while (fc.tag(&field, &wire)) {
    if (!fc.ok) break;
    if (field == 2 && fs.kind == kFloat && wire == 2) {  // FloatList
      Cursor lc = fc.sub();
      if (!fc.ok || !lc.ok) break;
      uint32_t f2, w2;
      float* dst = static_cast<float*>(out) + b * fs.flat_len;
      while (lc.tag(&f2, &w2)) {
        if (f2 == 1 && w2 == 2) {  // packed
          Cursor pc = lc.sub();
          if (!lc.ok || !pc.ok) { lc.ok = false; break; }
          int64_t n = (pc.end - pc.p) / 4;
          for (int64_t i = 0; i < n; i++) {
            if (count < fs.flat_len)
              memcpy(dst + count, pc.p + 4 * i, 4);
            count++;  // clip extras (varlen clip semantics)
          }
        } else if (f2 == 1 && w2 == 5) {  // unpacked float
          if (lc.end - lc.p < 4) { lc.ok = false; break; }
          if (count < fs.flat_len) memcpy(dst + count, lc.p, 4);
          count++;
          lc.p += 4;
        } else if (!lc.skip(w2)) {
          break;
        }
      }
      if (!lc.ok) { pr->error = fs.key + ": malformed FloatList"; return false; }
    } else if (field == 3 && fs.kind == kInt64 && wire == 2) {  // Int64List
      Cursor lc = fc.sub();
      if (!fc.ok || !lc.ok) break;
      uint32_t f2, w2;
      int64_t* dst = static_cast<int64_t*>(out) + b * fs.flat_len;
      while (lc.tag(&f2, &w2)) {
        if (f2 == 1 && w2 == 2) {  // packed varints
          Cursor pc = lc.sub();
          if (!lc.ok || !pc.ok) { lc.ok = false; break; }
          while (pc.p < pc.end && pc.ok) {
            uint64_t v = pc.varint();
            if (!pc.ok) break;
            if (count < fs.flat_len)
              dst[count] = static_cast<int64_t>(v);
            count++;
          }
          if (!pc.ok) { lc.ok = false; break; }
        } else if (f2 == 1 && w2 == 0) {
          uint64_t v = lc.varint();
          if (!lc.ok) break;
          if (count < fs.flat_len) dst[count] = static_cast<int64_t>(v);
          count++;
        } else if (!lc.skip(w2)) {
          break;
        }
      }
      if (!lc.ok) { pr->error = fs.key + ": malformed Int64List"; return false; }
    } else if (field == 1 && fs.kind == kBytes && wire == 2) {  // BytesList
      Cursor lc = fc.sub();
      if (!fc.ok || !lc.ok) break;
      uint32_t f2, w2;
      // spans buffer: int64 [B, flat_len, 2] of (offset, length)
      int64_t* dst = static_cast<int64_t*>(out) + b * fs.flat_len * 2;
      while (lc.tag(&f2, &w2)) {
        if (f2 == 1 && w2 == 2) {
          Cursor bc = lc.sub();
          if (!lc.ok || !bc.ok) { lc.ok = false; break; }
          if (count < fs.flat_len) {
            dst[count * 2] = bc.p - rec_base;
            dst[count * 2 + 1] = bc.end - bc.p;
          }
          count++;
        } else if (!lc.skip(w2)) {
          break;
        }
      }
      if (!lc.ok) { pr->error = fs.key + ": malformed BytesList"; return false; }
    } else if (!fc.skip(wire)) {
      break;
    }
  }
  if (!fc.ok) {
    pr->error = fs.key + ": malformed Feature";
    return false;
  }
  if (fs.sequence) {
    if (count != fs.flat_len) {
      pr->error = fs.key + ": step " + std::to_string(step) + " has " +
                  std::to_string(count) + " values, expected " +
                  std::to_string(fs.flat_len);
      return false;
    }
    return true;
  }
  if (count == 0 && fs.required) {
    pr->error = fs.key + ": required feature empty/missing";
    return false;
  }
  if (!fs.varlen && count != 0 && count != fs.flat_len) {
    pr->error = fs.key + ": expected " + std::to_string(fs.flat_len) +
                " values, got " + std::to_string(count);
    return false;
  }
  return true;
}

// Calls fn(field index, FeatureList cursor) for each entry of a
// FeatureLists message whose key is a sequence field's; false when the
// message is malformed.
template <typename Fn>
bool for_each_feature_list(Cursor lists, Parser* pr, Fn fn) {
  uint32_t f1, w1;
  while (lists.tag(&f1, &w1)) {
    if (f1 != 1 || w1 != 2) {
      if (!lists.skip(w1)) return false;
      continue;
    }
    Cursor entry = lists.sub();
    if (!lists.ok || !entry.ok) return false;
    std::string key;
    Cursor list{nullptr, nullptr, false};
    uint32_t f2, w2;
    while (entry.tag(&f2, &w2)) {
      if (f2 == 1 && w2 == 2) {
        Cursor kc = entry.sub();
        if (!entry.ok || !kc.ok) return false;
        key.assign(reinterpret_cast<const char*>(kc.p), kc.end - kc.p);
      } else if (f2 == 2 && w2 == 2) {
        list = entry.sub();
        if (!entry.ok) return false;
      } else if (!entry.skip(w2)) {
        return false;
      }
    }
    if (!entry.ok) return false;
    for (size_t i = 0; i < pr->fields.size(); i++) {
      if (pr->fields[i].sequence && pr->fields[i].key == key) {
        if (list.ok && !fn(i, list)) return false;
        break;
      }
    }
  }
  return lists.ok;
}

// The Feature submessages of a FeatureList, in order: fn(step, cursor).
template <typename Fn>
bool for_each_step(Cursor list, Fn fn) {
  uint32_t f, w;
  int64_t step = 0;
  while (list.tag(&f, &w)) {
    if (f != 1 || w != 2) {
      if (!list.skip(w)) return false;
      continue;
    }
    Cursor feature = list.sub();
    if (!list.ok || !feature.ok) return false;
    if (!fn(step++, feature)) return false;
  }
  return list.ok;
}

}  // namespace

extern "C" {

// Output buffers are pre-filled by the caller with pad/default values;
// the parser only overwrites what the wire data provides.
void* t2r_parser_create(const char** keys, const int* kinds,
                        const int64_t* flat_lens, const int* required,
                        const int* varlen, const int* sequence,
                        int n_fields) {
  auto* p = new Parser();
  for (int i = 0; i < n_fields; i++) {
    p->fields.push_back(FieldSpec{keys[i], kinds[i], flat_lens[i],
                                  required[i], varlen[i], sequence[i]});
  }
  return p;
}

// The step count of every sequence field of every record: lengths is
// int64 [B, n_sequence_fields], the sequence fields in creation order. A
// record without one of the lists fails, as tf.io.parse_sequence_example
// fails on a missing FixedLenSequenceFeature. Returns 0 or -1 (see
// t2r_parser_error).
int t2r_parser_sequence_lengths(void* handle, const uint8_t* const* recs,
                                const uint64_t* lens, int64_t batch,
                                int64_t* lengths) {
  auto* pr = static_cast<Parser*>(handle);
  pr->error.clear();
  std::vector<int64_t> slot(pr->fields.size(), -1);
  int64_t n_seq = 0;
  for (size_t i = 0; i < pr->fields.size(); i++)
    if (pr->fields[i].sequence) slot[i] = n_seq++;
  std::vector<int64_t> count(pr->fields.size());
  for (int64_t b = 0; b < batch; b++) {
    std::fill(count.begin(), count.end(), -1);
    Cursor rc{recs[b], recs[b] + lens[b]};
    uint32_t field, wire;
    bool ok = true;
    while (ok && rc.tag(&field, &wire)) {
      if (!rc.ok) break;
      if (field != 2 || wire != 2) {
        if (!rc.skip(wire)) break;
        continue;
      }
      Cursor lists = rc.sub();
      if (!rc.ok || !lists.ok) { rc.ok = false; break; }
      ok = for_each_feature_list(lists, pr, [&](size_t i, Cursor list) {
        int64_t steps = 0;
        if (!for_each_step(list, [&](int64_t, Cursor) { steps++; return true; }))
          return false;
        count[i] = steps;
        return true;
      });
    }
    if (!rc.ok || !ok) {
      pr->error = "malformed Example at batch index " + std::to_string(b);
      return -1;
    }
    for (size_t i = 0; i < pr->fields.size(); i++) {
      if (slot[i] < 0) continue;
      if (count[i] < 0) {
        pr->error = pr->fields[i].key + ": feature list missing";
        return -1;
      }
      lengths[b * n_seq + slot[i]] = count[i];
    }
  }
  return 0;
}

// Each sequence field's T (steps in its output buffer), in creation
// order of the sequence fields, for the next t2r_parser_parse_batch.
void t2r_parser_set_steps(void* handle, const int64_t* steps) {
  auto* pr = static_cast<Parser*>(handle);
  int64_t j = 0;
  for (auto& fs : pr->fields)
    if (fs.sequence) fs.steps = steps[j++];
}

const char* t2r_parser_error(void* handle) {
  return static_cast<Parser*>(handle)->error.c_str();
}

// Fills per-field output buffers for a batch of serialized Examples or
// SequenceExamples. float fields: float32 [B, flat_len]; int64 fields:
// int64 [B, flat_len]; bytes fields: int64 [B, flat_len, 2] (offset, len)
// into each record; a sequence field the same with [B, steps] rows.
// Buffers must be pre-filled by the caller with pad/default values.
// Returns 0 on success, -1 on error (see t2r_parser_error).
int t2r_parser_parse_batch(void* handle, const uint8_t* const* recs,
                           const uint64_t* lens, int64_t batch,
                           void* const* outs) {
  auto* pr = static_cast<Parser*>(handle);
  pr->error.clear();
  size_t nf = pr->fields.size();
  std::vector<bool> seen(nf);
  for (int64_t b = 0; b < batch; b++) {
    std::fill(seen.begin(), seen.end(), false);
    Cursor rc{recs[b], recs[b] + lens[b]};
    uint32_t field, wire;
    while (rc.tag(&field, &wire)) {
      if (!rc.ok) break;
      if (field == 2 && wire == 2) {  // a SequenceExample's FeatureLists
        Cursor lists = rc.sub();
        if (!rc.ok || !lists.ok) { rc.ok = false; break; }
        bool failed = false;
        bool ok = for_each_feature_list(lists, pr, [&](size_t i, Cursor list) {
          const FieldSpec& fs = pr->fields[i];
          return for_each_step(list, [&](int64_t t, Cursor feature) {
            if (t >= fs.steps) return true;  // a later duplicate list
            if (!parse_feature(feature, fs, b * fs.steps + t, outs[i],
                               recs[b], pr, t)) {
              failed = true;
              return false;
            }
            return true;
          });
        });
        if (failed) return -1;
        if (!ok) { rc.ok = false; break; }
        continue;
      }
      if (field != 1 || wire != 2) {  // not Features
        if (!rc.skip(wire)) break;
        continue;
      }
      Cursor feats = rc.sub();
      if (!rc.ok || !feats.ok) { rc.ok = false; break; }
      uint32_t f1, w1;
      while (feats.tag(&f1, &w1)) {
        if (f1 != 1 || w1 != 2) {  // not a map entry
          if (!feats.skip(w1)) break;
          continue;
        }
        Cursor entry = feats.sub();
        if (!feats.ok || !entry.ok) { feats.ok = false; break; }
        // map entry: field 1 key, field 2 Feature
        std::string key;
        Cursor feature{nullptr, nullptr, false};
        uint32_t f2, w2;
        while (entry.tag(&f2, &w2)) {
          if (f2 == 1 && w2 == 2) {
            Cursor kc = entry.sub();
            if (!entry.ok || !kc.ok) { entry.ok = false; break; }
            key.assign(reinterpret_cast<const char*>(kc.p), kc.end - kc.p);
          } else if (f2 == 2 && w2 == 2) {
            feature = entry.sub();
            if (!entry.ok) break;
          } else if (!entry.skip(w2)) {
            break;
          }
        }
        if (!entry.ok) { feats.ok = false; break; }
        for (size_t i = 0; i < nf; i++) {
          if (!pr->fields[i].sequence && pr->fields[i].key == key) {
            if (feature.ok) {
              if (!parse_feature(feature, pr->fields[i], b, outs[i],
                                 recs[b], pr))
                return -1;
              seen[i] = true;
            }
            break;
          }
        }
      }
      if (!feats.ok) { rc.ok = false; break; }
    }
    if (!rc.ok) {
      pr->error = "malformed Example at batch index " + std::to_string(b);
      return -1;
    }
    for (size_t i = 0; i < nf; i++) {
      if (!seen[i] && pr->fields[i].required && !pr->fields[i].sequence) {
        pr->error = pr->fields[i].key + ": required feature missing";
        return -1;
      }
    }
  }
  return 0;
}

void t2r_parser_destroy(void* handle) {
  delete static_cast<Parser*>(handle);
}

}  // extern "C"

// ---------------------------------------------------------- PNG row filters
//
// `raw` holds `height` rows of one filter byte and `stride` samples, as
// zlib inflates a non-interlaced PNG; `out` receives the height x stride
// samples with each row's filter undone (PNG 1.2, section 6), `bpp` bytes
// to a pixel (1, 3 or 4). Sample arithmetic is modulo 256. The filters
// that read the left pixel keep it, and the upper-left one, in registers,
// one lane a channel, and Paeth's predictor is a branch-free select.
// Returns 0, or 1 + the index of the first row whose filter byte is not
// 0-4 (`out` is then partial); -1 for another `bpp`. The first row's
// upper neighbours are zeros.

namespace {

inline int paeth_predictor(int a, int b, int c) {
  // p = a + b - c; |p - a| = |b - c|, |p - b| = |a - c|.
  const int pa = std::abs(b - c), pb = std::abs(a - c),
            pc = std::abs(a + b - 2 * c);
  const int b_or_c = pb <= pc ? b : c;
  return pa <= (pb <= pc ? pb : pc) ? a : b_or_c;
}

// Sub (1), Average (3) or Paeth (4): each sample adds a predictor of its
// left neighbour, so the row runs one lane a channel.
template <int BPP, int KIND>
void unfilter_left(const uint8_t* in, const uint8_t* up, uint8_t* row,
                   int64_t stride) {
  int left[BPP] = {}, upleft[BPP] = {};
  for (int64_t i = 0; i < stride; i += BPP) {
    for (int k = 0; k < BPP; k++) {
      const int above = up[i + k];
      const int pred = KIND == 1 ? left[k]
                       : KIND == 3 ? (left[k] + above) >> 1
                                   : paeth_predictor(left[k], above,
                                                     upleft[k]);
      left[k] = (in[i + k] + pred) & 0xff;
      upleft[k] = above;
      row[i + k] = static_cast<uint8_t>(left[k]);
    }
  }
}

template <int BPP>
bool unfilter_row(int kind, const uint8_t* in, const uint8_t* up,
                  uint8_t* row, int64_t stride) {
  switch (kind) {
    case 0:
      std::memcpy(row, in, static_cast<size_t>(stride));
      return true;
    case 1:
      unfilter_left<BPP, 1>(in, up, row, stride);
      return true;
    case 2:  // Up
      for (int64_t i = 0; i < stride; i++)
        row[i] = static_cast<uint8_t>(in[i] + up[i]);
      return true;
    case 3:
      unfilter_left<BPP, 3>(in, up, row, stride);
      return true;
    case 4:
      unfilter_left<BPP, 4>(in, up, row, stride);
      return true;
    default:
      return false;
  }
}

template <int BPP>
int64_t unfilter(const uint8_t* raw, uint8_t* out, int64_t height,
                 int64_t stride) {
  const std::vector<uint8_t> zeros(static_cast<size_t>(stride), 0);
  for (int64_t r = 0; r < height; r++) {
    const uint8_t* in = raw + r * (stride + 1);
    uint8_t* row = out + r * stride;
    if (!unfilter_row<BPP>(in[0], in + 1, r ? row - stride : zeros.data(),
                           row, stride))
      return r + 1;
  }
  return 0;
}

}  // namespace

extern "C" int64_t t2r_png_unfilter(const uint8_t* raw, uint8_t* out,
                                    int64_t height, int64_t stride,
                                    int bpp) {
  switch (bpp) {
    case 1: return unfilter<1>(raw, out, height, stride);
    case 3: return unfilter<3>(raw, out, height, stride);
    case 4: return unfilter<4>(raw, out, height, stride);
    default: return -1;
  }
}
