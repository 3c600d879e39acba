// Native JPEG batch decoder for the record input pipeline.
//
// The PyTorch port's own copy of tensor2robot_tpu/native/jpeg_decode.cpp:
// libjpeg decoding straight into the caller's contiguous [N, H, W, C]
// batch buffer (a ring slot of data/engine.py), so batch assembly needs no
// per-image intermediates. Python binds it through ctypes
// (tensor2robot_tpu_torch/native/__init__.py). data/image_codec.py routes
// only JPEG bytes here and raises on any status but kOk and kEmpty.
//
// Built as its own shared object, linked with -ljpeg.

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

// Per-image decode status written back to the caller.
enum Status : int32_t {
  kOk = 0,
  kEmpty = 1,      // empty bytes: buffer slot zero-filled (codec convention)
  kNotJpeg = 2,    // no JPEG magic: slot untouched
  kBadShape = 3,   // decoded geometry != (H, W): slot untouched
  kError = 4,      // libjpeg failure: slot untouched
};

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* mgr = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(mgr->jump, 1);
}

void output_message(j_common_ptr) {}  // silence stderr chatter

int32_t decode_one(const uint8_t* buf, uint64_t len, uint8_t* out,
                   int height, int width, int channels) {
  if (len == 0) {
    memset(out, 0, static_cast<size_t>(height) * width * channels);
    return kEmpty;
  }
  if (len < 3 || buf[0] != 0xFF || buf[1] != 0xD8) return kNotJpeg;

  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  err.pub.output_message = output_message;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return kError;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = (channels == 1) ? JCS_GRAYSCALE : JCS_RGB;
  // ISLOW, the method PIL also uses: decoded pixels are bit for bit
  // PIL's (IFAST would be faster but one LSB off).
  cinfo.dct_method = JDCT_ISLOW;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != height ||
      static_cast<int>(cinfo.output_width) != width ||
      static_cast<int>(cinfo.output_components) != channels) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return kBadShape;
  }
  const size_t stride = static_cast<size_t>(width) * channels;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return kOk;
}

}  // namespace

extern "C" {

// Decodes n JPEG buffers into the contiguous out[n, height, width,
// channels] uint8 buffer. status[i] receives a Status per image; slots
// whose status is kNotJpeg/kBadShape/kError are left untouched (the
// caller raises). num_threads <= 1 decodes inline (the right
// choice on single-core hosts); otherwise images are striped across
// worker threads (libjpeg contexts are per-call, so this is safe).
// Returns the number of non-Ok, non-Empty statuses.
int t2r_jpeg_decode_batch(const uint8_t** bufs, const uint64_t* lens,
                          int n, uint8_t* out, int height, int width,
                          int channels, int num_threads,
                          int32_t* status) {
  const size_t image_bytes =
      static_cast<size_t>(height) * width * channels;
  auto work = [&](int begin, int end) {
    for (int i = begin; i < end; i++) {
      status[i] = decode_one(bufs[i], lens[i], out + i * image_bytes,
                             height, width, channels);
    }
  };
  if (num_threads <= 1 || n <= 1) {
    work(0, n);
  } else {
    int workers = num_threads < n ? num_threads : n;
    std::vector<std::thread> threads;
    threads.reserve(workers);
    int chunk = (n + workers - 1) / workers;
    for (int w = 0; w < workers; w++) {
      int begin = w * chunk;
      int end = begin + chunk < n ? begin + chunk : n;
      if (begin >= end) break;
      threads.emplace_back(work, begin, end);
    }
    for (auto& t : threads) t.join();
  }
  int failures = 0;
  for (int i = 0; i < n; i++) {
    if (status[i] != kOk && status[i] != kEmpty) failures++;
  }
  return failures;
}

}  // extern "C"
