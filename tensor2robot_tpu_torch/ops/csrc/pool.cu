// Argmax-slot max pool, forward: NHWC in, (pooled, int32 window slot) out.
//
// Replaces: tensor2robot_tpu/ops/pool.py, _pool_fwd_kernel (launched by
// _pool_call <- max_pool_argmax <- pallas_max_pool).
//
// Semantics (bitwise those of the TPU kernel): padding is -inf and never
// wins against finite data; the window is walked in row-major order
// (slot = dy * kw + dx); the running maximum starts at slot 0 and moves
// only on a strictly greater value, so ties keep the first maximal slot.
//
// What bounds it on an H100: bytes. Each output reads kh*kw inputs and
// does one compare per input, so the pool is far below the card's
// operations-per-byte ridge. At the QT-Opt pool1 shape ([64,236,236,64]
// bf16, 3x3/s3) it reads 456 MB and writes 51 MB of values and 102 MB of
// slots: about 0.18 ms at 3.35 TB/s.
//
// Design: one thread per output element, C innermost, so the 32 threads
// of a warp read 32 neighbouring channels of the same input pixel (one
// coalesced segment per window tap) and write neighbouring outputs. With
// non-overlapping windows every input byte is read exactly once. There is
// no channel blocking and no staging in shared memory: the TPU kernel
// staged a whole [H, W, cb] block in VMEM because its grid runs in order
// on one core, while here the card's many warps in flight hide the
// latency of direct loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  // Exact: v is one of the bf16 inputs (or -inf).
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void pool_fwd_kernel(const T* __restrict__ x, T* __restrict__ out,
                                int32_t* __restrict__ slot, int H, int W,
                                int C, int kh, int kw, int sh, int sw,
                                int plh, int plw, int OH, int OW,
                                int64_t total) {
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(idx % C);
    int64_t t = idx / C;
    const int ow = (int)(t % OW);
    t /= OW;
    const int oh = (int)(t % OH);
    const int64_t b = t / OH;
    const int h0 = oh * sh - plh;
    const int w0 = ow * sw - plw;
    const T* xb = x + b * H * (int64_t)W * C + c;
    float best = -CUDART_INF_F;
    int best_slot = 0;
    for (int dy = 0; dy < kh; ++dy) {
      const int ih = h0 + dy;
      const bool row_ok = ih >= 0 && ih < H;
      for (int dx = 0; dx < kw; ++dx) {
        const int iw = w0 + dx;
        const float v = (row_ok && iw >= 0 && iw < W)
                            ? to_float(xb[((int64_t)ih * W + iw) * C])
                            : -CUDART_INF_F;
        const int s = dy * kw + dx;
        if (s == 0) {
          best = v;
        } else if (v > best) {
          best = v;
          best_slot = s;
        }
      }
    }
    store(out + idx, best);
    slot[idx] = best_slot;
  }
}

template <typename T>
int launch(const void* x, void* out, void* slot, int B, int H, int W, int C,
           int kh, int kw, int sh, int sw, int plh, int plw, int OH, int OW,
           cudaStream_t stream) {
  const int64_t total = (int64_t)B * OH * OW * C;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;
  pool_fwd_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<int32_t*>(slot), H, W, C, kh, kw, sh, sw, plh, plw, OH, OW,
      total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
int t2r_pool_fwd(const void* x, void* out, void* slot, int dtype, int B,
                 int H, int W, int C, int kh, int kw, int sh, int sw, int plh,
                 int plw, int OH, int OW, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, out, slot, B, H, W, C, kh, kw, sh, sw, plh, plw,
                         OH, OW, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, out, slot, B, H, W, C, kh, kw, sh, sw,
                                 plh, plw, OH, OW, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* t2r_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
