// Argmax-slot max pool: forward (NHWC in, (pooled, int32 window slot) out)
// and the routing backward (cotangent + slots in, dx out).
//
// Forward. Replaces: tensor2robot_tpu/ops/pool.py, _pool_fwd_kernel
// (launched by _pool_call <- max_pool_argmax <- pallas_max_pool).
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
//
// Backward. Replaces: tensor2robot_tpu/ops/pool.py, _pool_bwd_kernel
// (launched by _pool_grad_call <- _pool_vjp_bwd).
//
// dx[b, ih, iw, c] is the sum of g[b, oh, ow, c] over the windows (oh, ow)
// that cover the element and whose slot names it, taken in ascending
// (oh, ow) order and rounded to the cotangent's dtype after every add, as
// the TPU kernel's reversed-slot accumulation does. An element no window
// selects gets 0.
//
// What bounds it on an H100: bytes. It reads g and the int32 slots once
// and writes dx once, with one compare and at most kh*kw adds per input
// element. At the QT-Opt pool1 shape (g [32,79,79,64] bf16 -> dx
// [32,236,236,64]) that is 25.6 MB + 51.1 MB read and 228.1 MB written:
// about 0.091 ms at 3.35 TB/s.
//
// Design: the gather form. One thread per input pixel and 8 neighbouring
// channels (C innermost), so a thread moves 16-byte vectors: the 8 slots
// and 8 cotangents of each covering window in, 8 dx values out. It finds
// the windows that cover it from the geometry (at most one for QT-Opt's
// non-overlapping pools), reads the cotangents only when a slot names its
// position, and adds them. Every dx element is written exactly once: no
// atomics, no zero-fill pass. Index arithmetic is 32-bit when the tensors
// allow it. The TPU kernel interleaved whole routed planes in VMEM
// instead; here the window search is a few integer ops per thread and the
// neighbouring input pixels of one window hit the same g and slot lines in
// L1. Channel counts that are not a multiple of 8, or unaligned tensors,
// take the same kernel one channel per thread.

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
  // Exact: v is one of the bf16 inputs (or -inf) or a sum already rounded
  // to bf16.
  *p = __float2bfloat16_rn(v);
}
// Rounds a float to T and back: the sum of two T values in T's precision.
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// kVec consecutive elements (1, or 8 in 16- and 32-byte vector accesses;
// the caller guarantees the alignment).
template <int kVec>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (kVec == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    v[0] = *p;
  }
}
template <int kVec>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  if constexpr (kVec == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
  } else {
    v[0] = __bfloat162float(*p);
  }
}
template <int kVec>
__device__ __forceinline__ void load_vec(const int32_t* p, int* v) {
  if constexpr (kVec == 8) {
    const int4 a = reinterpret_cast<const int4*>(p)[0];
    const int4 b = reinterpret_cast<const int4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    v[0] = *p;
  }
}
template <int kVec>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (kVec == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    *p = v[0];
  }
}
template <int kVec>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (kVec == 8) {
    uint4 u;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(v[i]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
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

template <typename T, typename Index, int kVec>
__global__ void pool_bwd_kernel(const T* __restrict__ g,
                                const int32_t* __restrict__ slot,
                                T* __restrict__ dx, int H, int W, int C,
                                int kh, int kw, int sh, int sw, int plh,
                                int plw, int OH, int OW, Index total) {
  const int groups = C / kVec;
  for (Index idx = blockIdx.x * (Index)blockDim.x + threadIdx.x; idx < total;
       idx += (Index)gridDim.x * blockDim.x) {
    const int c = (int)(idx % groups) * kVec;
    Index t = idx / groups;
    const int iw = (int)(t % W);
    t /= W;
    const int ih = (int)(t % H);
    const Index b = t / H;
    // Position in the padded extent; window (oh, ow) covers rows
    // [oh*sh, oh*sh + kh) and columns [ow*sw, ow*sw + kw) of it.
    const int ph = ih + plh;
    const int pw = iw + plw;
    const int lo_h = ph - kh + 1;
    const int lo_w = pw - kw + 1;
    const int oh0 = lo_h <= 0 ? 0 : (lo_h + sh - 1) / sh;
    const int ow0 = lo_w <= 0 ? 0 : (lo_w + sw - 1) / sw;
    const int oh1 = min(ph / sh, OH - 1);
    const int ow1 = min(pw / sw, OW - 1);
    const Index gb = b * OH * OW * C + c;
    float acc[kVec];
    bool routed[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      acc[i] = 0.f;
      routed[i] = false;
    }
    for (int oh = oh0; oh <= oh1; ++oh) {
      const int dy = ph - oh * sh;
      for (int ow = ow0; ow <= ow1; ++ow) {
        const int s = dy * kw + (pw - ow * sw);
        const Index o = gb + ((Index)oh * OW + ow) * C;
        int sl[kVec];
        load_vec<kVec>(slot + o, sl);
        bool any = false;
#pragma unroll
        for (int i = 0; i < kVec; ++i) any |= sl[i] == s;
        if (!any) continue;
        float v[kVec];
        load_vec<kVec>(g + o, v);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          if (sl[i] == s) {
            acc[i] = routed[i] ? round_to(acc[i] + v[i], g) : v[i];
            routed[i] = true;
          }
        }
      }
    }
    store_vec<kVec>(dx + idx * kVec, acc);
  }
}

template <typename T, typename Index, int kVec>
int launch_bwd_as(const void* g, const void* slot, void* dx, int B, int H,
                  int W, int C, int kh, int kw, int sh, int sw, int plh,
                  int plw, int OH, int OW, cudaStream_t stream) {
  const int64_t total = (int64_t)B * H * W * C / kVec;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;
  pool_bwd_kernel<T, Index, kVec><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const int32_t*>(slot),
      static_cast<T*>(dx), H, W, C, kh, kw, sh, sw, plh, plw, OH, OW,
      (Index)total);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch_bwd(const void* g, const void* slot, void* dx, int B, int H,
               int W, int C, int kh, int kw, int sh, int sw, int plh,
               int plw, int OH, int OW, cudaStream_t stream) {
  const bool vec = C % 8 == 0 && aligned16(g) && aligned16(slot) &&
                   aligned16(dx);
  // 32-bit indices when every offset into dx and into g fits.
  const int64_t limit = (int64_t)1 << 31;
  const bool small =
      (int64_t)B * H * W * C < limit && (int64_t)B * OH * OW * C < limit;
  if (vec && small) {
    return launch_bwd_as<T, int32_t, 8>(g, slot, dx, B, H, W, C, kh, kw, sh,
                                        sw, plh, plw, OH, OW, stream);
  }
  if (vec) {
    return launch_bwd_as<T, int64_t, 8>(g, slot, dx, B, H, W, C, kh, kw, sh,
                                        sw, plh, plw, OH, OW, stream);
  }
  if (small) {
    return launch_bwd_as<T, int32_t, 1>(g, slot, dx, B, H, W, C, kh, kw, sh,
                                        sw, plh, plw, OH, OW, stream);
  }
  return launch_bwd_as<T, int64_t, 1>(g, slot, dx, B, H, W, C, kh, kw, sh,
                                      sw, plh, plw, OH, OW, stream);
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

// g: [B, OH, OW, C] in dtype, slot: int32 of the same shape, dx:
// [B, H, W, C] in dtype. Returns cudaGetLastError().
int t2r_pool_bwd(const void* g, const void* slot, void* dx, int dtype, int B,
                 int H, int W, int C, int kh, int kw, int sh, int sw, int plh,
                 int plw, int OH, int OW, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_bwd<float>(g, slot, dx, B, H, W, C, kh, kw, sh, sw, plh,
                             plw, OH, OW, s);
  }
  if (dtype == 1) {
    return launch_bwd<__nv_bfloat16>(g, slot, dx, B, H, W, C, kh, kw, sh, sw,
                                     plh, plw, OH, OW, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* t2r_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
