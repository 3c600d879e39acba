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
// slots: about 0.18 ms at 3.35 TB/s (0.206 ms over the three pools of
// one CEM iteration at B = 64).
//
// Design, for the H100's memory system (the backward's, below, applied to
// the forward):
// - 8 channels a thread in 16-byte accesses: one uint4 load per tap in
//   bf16, two float4 in float32; 8 pooled values (16 or 32 bytes) and 8
//   int32 slots (two int4) stored per thread. At C = 64, 8 threads cover a
//   pixel and a warp 4 output pixels, so each window row a warp reads is
//   one contiguous run of input (1.5 KB at pool1's 3x3/s3).
// - No 64-bit division. A 2-D grid: y walks the B*OH output rows (striding
//   past 65535), x the row's (ow, channel group) pairs, so a thread decodes
//   its position with two 32-bit divisions. Offsets are 32-bit when every
//   one fits in 2**31 elements; a 64-bit instantiation serves the rest.
// - All taps in flight. The windows the QT-Opt paths run (3x3 and 2x2) are
//   template parameters: a thread issues all of a window's loads, then
//   compares. A tap in the padding loads a clamped address inside the
//   image and reads as -inf, so no load waits on a branch. Any other
//   window takes the same kernel with a runtime loop.
// - Default caching. With non-overlapping windows every input byte is read
//   once, but streaming hints (ld/st.global.cs) measured slower in
//   chip_smoke.py's pool timing.
// - Channel counts that are not a multiple of 8, or tensors that are not
//   16-byte aligned, take the same kernel one channel per thread.
// - The compare is a strictly-greater select per lane in row-major tap
//   order, never a max instruction (whose NaN and signed-zero choices
//   differ and which gives no slot): slot 0 seeds the maximum, a NaN there
//   sticks, ties and -0.0 against +0.0 keep the first slot. Values are
//   written back as the winning input's bits.
//
// The TPU kernel staged a whole [H, W, cb] block in VMEM because its grid
// runs in order on one core; here the card's many warps in flight hide the
// latency of direct loads.
//
// Backward. Replaces: tensor2robot_tpu/ops/pool.py, _pool_bwd_kernel
// (launched by _pool_grad_call <- _pool_vjp_bwd).
//
// dx[b, ih, iw, c] is the sum of g[b, oh, ow, c] over the windows (oh, ow)
// that cover the element and whose slot names it, taken in ascending
// (oh, ow) order and rounded to the cotangent's dtype after every add, as
// the TPU kernel's reversed-slot accumulation does (from +0, so a lone -0.0
// cotangent gives +0). An element no window selects gets +0. Where windows
// do not overlap (stride == window), an element has at most one window,
// and dx is that window's g, bit for bit, or +0: the TPU kernel's
// interleave branch.
//
// What bounds it on an H100: bytes. It reads g and the int32 slots once
// and writes dx once. At the QT-Opt pool1 shape (g [32,79,79,64] bf16 ->
// dx [32,236,236,64]) that is 25.6 MB + 51.1 MB read and 228.1 MB written:
// about 0.091 ms at 3.35 TB/s, most of it dx's stores. At the Grasp2Vec
// stem (g [32,118,118,64] bf16 -> dx [32,236,236,64], 3x3/s2) it is 57.0
// MB + 114.1 MB read and 228.1 MB written: 0.1192 ms.
//
// Two routes, chosen by launch_bwd (mirrored by ops/pool.py bwd_launch,
// which the C entry refuses to differ from):
// - Scatter (stride == window; all three QT-Opt pools). The forward's 2-D
//   grid: one thread owns one window x 8 channels (y walks the B*OH window
//   rows, striding past 65535; x a row's (ow, channel group) pairs), so it
//   decodes its position with two 32-bit divisions. It loads the window's
//   g (one uint4 in bf16, two in float32) and its 8 slots (two int4) once,
//   then stores each of the window's kh*kw 16-byte positions inside the
//   image: g's bits in the lanes whose slot names the position, +0
//   elsewhere. No compare against another window, no re-read of g or the
//   slots, every dx element written once. The 3x3 and 2x2 windows are
//   template parameters with all stores unrolled; other windows loop at
//   run time. Padded positions are skipped. Image rows and columns that no
//   window covers (VALID tails, which the TPU kernel zero-pads) are
//   written as +0 by the threads of the last window row and column.
// - Gather (overlapping windows; the Grasp2Vec stem's 3x3/s2). The input
//   pixels fall into sh x sw phase blocks, and the pixels of one block are
//   covered only by the same ceil(kh/sh) x ceil(kw/sw) windows (2 x 2 at
//   the stem). A thread owns one block x 8 channels: it reads those
//   windows' slots and cotangent once, adds each into the pixels whose
//   position its slot names, in ascending (oh, ow) order, and stores its
//   pixels in 16-byte vectors, every dx element once, no atomics, no
//   zero-fill pass. Persistent blocks on a 2-D grid (x: a tile column and
//   channel span, y: strided over the batch's tile rows, no 64-bit
//   division in the narrow instantiations) walk tiles of 4 x 8 blocks x 64
//   channels at the stem; each tile's windows, with a halo of
//   ceil(kh/sh) - 1 rows and ceil(kw/sw) - 1 columns, are staged with
//   16-byte cp.async into shared memory (each window's slots and g leave
//   device memory about once, not once a covered pixel), two stages, the
//   next tile's copies issued before this tile's adds. The 3x3/s2 window
//   is a template parameter; other windows run the same loops at run
//   time, and a window whose halo would not fit a block is read from
//   device memory instead. The TPU kernel interleaved whole routed planes
//   in VMEM.
// Both routes take channel counts that are not a multiple of 8, or
// unaligned tensors, one channel a thread, and 64-bit offsets past 2**31
// elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------- forward

// Threads of a forward block, along one output row's (ow, channel group)
// pairs. Grid y covers the B*OH output rows, at most kFwdMaxGridY blocks
// that stride over the rest.
constexpr int kFwdThreads = 128;
constexpr int kFwdMaxGridY = 65535;
// Channels a thread pools in the vector instantiation (16 bytes of bf16).
constexpr int kFwdVec = 8;
// Offsets are 32-bit when every one is below 2**kNarrowIndexBits.
constexpr int kNarrowIndexBits = 31;

// The windows with an instantiation of their own, all taps in flight;
// every other window takes the runtime loop.
__host__ __device__ constexpr bool fixed_window(int kh, int kw) {
  return (kh == 3 && kw == 3) || (kh == 2 && kw == 2);
}

// One tap of kVec channels as loaded, with its lanes read as floats
// (exactly: a bf16 is the high half of its float).
template <typename T, int kVec>
struct Tap;

template <>
struct Tap<__nv_bfloat16, 8> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void pad() {
    const unsigned neg_inf = 0xff80ff80u;  // two bf16 -inf
    u = make_uint4(neg_inf, neg_inf, neg_inf, neg_inf);
  }
  __device__ __forceinline__ float lane(int i) const {
    const unsigned w = i < 2 ? u.x : i < 4 ? u.y : i < 6 ? u.z : u.w;
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

template <>
struct Tap<float, 8> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void pad() {
    a = b = make_float4(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F,
                        -CUDART_INF_F);
  }
  __device__ __forceinline__ float lane(int i) const {
    const float4& q = i < 4 ? a : b;
    const int j = i & 3;
    return j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
  }
};

template <>
struct Tap<__nv_bfloat16, 1> {
  unsigned short h;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    h = *reinterpret_cast<const unsigned short*>(p);
  }
  __device__ __forceinline__ void pad() { h = 0xff80; }
  __device__ __forceinline__ float lane(int) const {
    return __uint_as_float((unsigned)h << 16);
  }
};

template <>
struct Tap<float, 1> {
  float f;
  __device__ __forceinline__ void load(const float* p) { f = *p; }
  __device__ __forceinline__ void pad() { f = -CUDART_INF_F; }
  __device__ __forceinline__ float lane(int) const { return f; }
};

// Loads tap (ih, iw) of image `image` (its first row index, b * H). A tap
// in the padding loads the nearest pixel inside the image, so the load
// issues without a branch, and reads as -inf.
template <typename T, typename Index, int kVec>
__device__ __forceinline__ void load_tap(Tap<T, kVec>& tap, const T* x,
                                         Index image, int ih, int iw, int H,
                                         int W, int C, int c) {
  const bool inside = ih >= 0 && ih < H && iw >= 0 && iw < W;
  const int ch = min(max(ih, 0), H - 1);
  const int cw = min(max(iw, 0), W - 1);
  tap.load(x + ((image + ch) * W + cw) * C + c);
  if (!inside) tap.pad();
}

// The running maximum moves only on a strictly greater value, per lane.
template <typename T, int kVec>
__device__ __forceinline__ void take(const Tap<T, kVec>& tap, int s,
                                     float* best, int* best_slot) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const float v = tap.lane(i);
    if (s == 0 || v > best[i]) {
      best[i] = v;
      best_slot[i] = s;
    }
  }
}

// The pooled values, as the winning inputs' bits (bf16: the float's high
// half), and the slots.
template <int kVec>
__device__ __forceinline__ void store_pooled(__nv_bfloat16* p,
                                             const float* v) {
  if constexpr (kVec == 8) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = (__float_as_uint(v[2 * i]) >> 16) |
             (__float_as_uint(v[2 * i + 1]) & 0xffff0000u);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *reinterpret_cast<unsigned short*>(p) =
        (unsigned short)(__float_as_uint(v[0]) >> 16);
  }
}
template <int kVec>
__device__ __forceinline__ void store_pooled(float* p, const float* v) {
  if constexpr (kVec == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    *p = v[0];
  }
}
template <int kVec>
__device__ __forceinline__ void store_slots(int32_t* p, const int* s) {
  if constexpr (kVec == 8) {
    reinterpret_cast<int4*>(p)[0] = make_int4(s[0], s[1], s[2], s[3]);
    reinterpret_cast<int4*>(p)[1] = make_int4(s[4], s[5], s[6], s[7]);
  } else {
    *p = s[0];
  }
}

// KH = KW = 0: the window is (kh, kw) at run time.
template <typename T, typename Index, int kVec, int KH, int KW>
__global__ void __launch_bounds__(kFwdThreads)
    pool_fwd_kernel(const T* __restrict__ x, T* __restrict__ out,
                    int32_t* __restrict__ slot, int H, int W, int C, int kh,
                    int kw, int sh, int sw, int plh, int plw, int OH, int OW,
                    int rows) {
  const int groups = C / kVec;
  const int col = blockIdx.x * kFwdThreads + threadIdx.x;
  if (col >= OW * groups) return;
  const int ow = col / groups;
  const int c = (col - ow * groups) * kVec;
  const int w0 = ow * sw - plw;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int b = row / OH;
    const int h0 = (row - b * OH) * sh - plh;
    const Index image = (Index)b * H;
    float best[kVec];
    int best_slot[kVec];
    if constexpr (KH > 0) {
      Tap<T, kVec> taps[KH * KW];
#pragma unroll
      for (int dy = 0; dy < KH; ++dy) {
#pragma unroll
        for (int dx = 0; dx < KW; ++dx) {
          load_tap(taps[dy * KW + dx], x, image, h0 + dy, w0 + dx, H, W, C,
                   c);
        }
      }
#pragma unroll
      for (int s = 0; s < KH * KW; ++s) take(taps[s], s, best, best_slot);
    } else {
      for (int dy = 0; dy < kh; ++dy) {
        for (int dx = 0; dx < kw; ++dx) {
          Tap<T, kVec> tap;
          load_tap(tap, x, image, h0 + dy, w0 + dx, H, W, C, c);
          take(tap, dy * kw + dx, best, best_slot);
        }
      }
    }
    const Index o = ((Index)row * OW + ow) * C + c;
    store_pooled<kVec>(out + o, best);
    store_slots<kVec>(slot + o, best_slot);
  }
}

// A window's cotangent, kVec channels as loaded, kept as raw bits: the
// scatter route stores them unchanged (NaN payloads and -0.0 included) in
// the lanes whose slot names a position, and +0 (all bits clear) in the
// others.
template <typename T, int kVec>
struct Routed;

// Two bf16 lanes of one word: the half of lane 2j is the low one.
__device__ __forceinline__ unsigned lane_mask(bool lo, bool hi) {
  return (lo ? 0x0000ffffu : 0u) | (hi ? 0xffff0000u : 0u);
}

template <>
struct Routed<__nv_bfloat16, 8> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void store(__nv_bfloat16* p, const int* sl,
                                        int s) const {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(u.x & lane_mask(sl[0] == s, sl[1] == s),
                   u.y & lane_mask(sl[2] == s, sl[3] == s),
                   u.z & lane_mask(sl[4] == s, sl[5] == s),
                   u.w & lane_mask(sl[6] == s, sl[7] == s));
  }
  __device__ __forceinline__ static void zero(__nv_bfloat16* p) {
    *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
  }
};

template <>
struct Routed<float, 8> {
  uint4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const uint4*>(p)[0];
    b = reinterpret_cast<const uint4*>(p)[1];
  }
  __device__ __forceinline__ void store(float* p, const int* sl,
                                        int s) const {
    uint4* q = reinterpret_cast<uint4*>(p);
    q[0] = make_uint4(sl[0] == s ? a.x : 0u, sl[1] == s ? a.y : 0u,
                      sl[2] == s ? a.z : 0u, sl[3] == s ? a.w : 0u);
    q[1] = make_uint4(sl[4] == s ? b.x : 0u, sl[5] == s ? b.y : 0u,
                      sl[6] == s ? b.z : 0u, sl[7] == s ? b.w : 0u);
  }
  __device__ __forceinline__ static void zero(float* p) {
    uint4* q = reinterpret_cast<uint4*>(p);
    q[0] = q[1] = make_uint4(0u, 0u, 0u, 0u);
  }
};

template <>
struct Routed<__nv_bfloat16, 1> {
  unsigned short h;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    h = *reinterpret_cast<const unsigned short*>(p);
  }
  __device__ __forceinline__ void store(__nv_bfloat16* p, const int* sl,
                                        int s) const {
    *reinterpret_cast<unsigned short*>(p) =
        sl[0] == s ? h : (unsigned short)0;
  }
  __device__ __forceinline__ static void zero(__nv_bfloat16* p) {
    *reinterpret_cast<unsigned short*>(p) = 0;
  }
};

template <>
struct Routed<float, 1> {
  unsigned u;
  __device__ __forceinline__ void load(const float* p) {
    u = *reinterpret_cast<const unsigned*>(p);
  }
  __device__ __forceinline__ void store(float* p, const int* sl,
                                        int s) const {
    *reinterpret_cast<unsigned*>(p) = sl[0] == s ? u : 0u;
  }
  __device__ __forceinline__ static void zero(float* p) {
    *reinterpret_cast<unsigned*>(p) = 0u;
  }
};

// The scatter route, for windows that do not overlap (sh == kh, sw == kw).
// KH = KW = 0: the window is (kh, kw) at run time.
template <typename T, typename Index, int kVec, int KH, int KW>
__global__ void __launch_bounds__(kFwdThreads)
    pool_bwd_scatter_kernel(const T* __restrict__ g,
                            const int32_t* __restrict__ slot,
                            T* __restrict__ dx, int H, int W, int C, int kh,
                            int kw, int plh, int plw, int OH, int OW,
                            int rows) {
  if constexpr (KH > 0) {
    kh = KH;
    kw = KW;
  }
  const int groups = C / kVec;
  const int col = blockIdx.x * kFwdThreads + threadIdx.x;
  if (col >= OW * groups) return;
  const int ow = col / groups;
  const int c = (col - ow * groups) * kVec;
  const int w0 = ow * kw - plw;
  // The image columns this thread writes: its window's, and, in the last
  // window column, those right of it that no window covers.
  const int w_lo = max(w0, 0);
  const int w_win = min(w0 + kw, W);
  const int w_end = ow == OW - 1 ? W : w_win;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int b = row / OH;
    const int oh = row - b * OH;
    const int h0 = oh * kh - plh;
    const Index o = ((Index)row * OW + ow) * C + c;
    Routed<T, kVec> v;
    v.load(g + o);
    int sl[kVec];
    load_vec<kVec>(slot + o, sl);
    const Index image = (Index)b * H;
    auto at = [&](int ih, int iw) {
      return dx + ((image + ih) * W + iw) * C + c;
    };
    if constexpr (KH > 0) {
#pragma unroll
      for (int dy = 0; dy < KH; ++dy) {
        const int ih = h0 + dy;
        if ((unsigned)ih >= (unsigned)H) continue;
#pragma unroll
        for (int dx = 0; dx < KW; ++dx) {
          const int iw = w0 + dx;
          if ((unsigned)iw < (unsigned)W) v.store(at(ih, iw), sl, dy * KW + dx);
        }
      }
    } else {
      for (int dy = 0; dy < kh; ++dy) {
        const int ih = h0 + dy;
        if ((unsigned)ih >= (unsigned)H) continue;
        for (int dx = 0; dx < kw; ++dx) {
          const int iw = w0 + dx;
          if ((unsigned)iw < (unsigned)W) v.store(at(ih, iw), sl, dy * kw + dx);
        }
      }
    }
    // Uncovered tails: the rows below the last window row (over this
    // thread's columns, tail columns included), then the tail columns
    // beside this window's rows.
    const int h_win = min(h0 + kh, H);
    if (oh == OH - 1) {
      for (int ih = h_win; ih < H; ++ih) {
        for (int iw = w_lo; iw < w_end; ++iw) Routed<T, kVec>::zero(at(ih, iw));
      }
    }
    for (int ih = max(h0, 0); ih < h_win; ++ih) {
      for (int iw = w_win; iw < w_end; ++iw) Routed<T, kVec>::zero(at(ih, iw));
    }
  }
}

template <typename T, typename Index, int kVec, int KH, int KW>
int launch_scatter_as(const void* g, const void* slot, void* dx, int B, int H,
                      int W, int C, int kh, int kw, int plh, int plw, int OH,
                      int OW, cudaStream_t stream) {
  const int rows = B * OH;
  const int cols = OW * (C / kVec);
  const dim3 grid((cols + kFwdThreads - 1) / kFwdThreads,
                  rows < kFwdMaxGridY ? rows : kFwdMaxGridY);
  pool_bwd_scatter_kernel<T, Index, kVec, KH, KW>
      <<<grid, kFwdThreads, 0, stream>>>(
          static_cast<const T*>(g), static_cast<const int32_t*>(slot),
          static_cast<T*>(dx), H, W, C, kh, kw, plh, plw, OH, OW, rows);
  return (int)cudaGetLastError();
}

template <typename T, typename Index, int kVec>
int launch_scatter_window(const void* g, const void* slot, void* dx, int B,
                          int H, int W, int C, int kh, int kw, int plh,
                          int plw, int OH, int OW, cudaStream_t stream) {
  if (kh == 3 && kw == 3) {
    return launch_scatter_as<T, Index, kVec, 3, 3>(
        g, slot, dx, B, H, W, C, kh, kw, plh, plw, OH, OW, stream);
  }
  if (kh == 2 && kw == 2) {
    return launch_scatter_as<T, Index, kVec, 2, 2>(
        g, slot, dx, B, H, W, C, kh, kw, plh, plw, OH, OW, stream);
  }
  return launch_scatter_as<T, Index, kVec, 0, 0>(
      g, slot, dx, B, H, W, C, kh, kw, plh, plw, OH, OW, stream);
}

// The gather route's block and tile (pool_bwd_gather_kernel); ops/pool.py
// bwd_launch mirrors these numbers. A block's threads cover a tile of
// phase blocks (an sh x sw block of input pixels, the pixels whose
// covering windows lie in the same (hr + 1) x (hc + 1) windows) x a span
// of channel groups.
constexpr int kGatherThreads = 256;
constexpr int kGatherGroups = 8;       // channel groups a span
constexpr int kGatherTileCols = 8;     // phase-block columns of a tile
constexpr int kGatherStages = 2;
constexpr int kGatherBlocksPerSm = 3;  // __launch_bounds__ minimum
constexpr int kGatherMaxGridY = 65535;
constexpr int kSms = 132;              // an H100 SXM
constexpr int kSmSharedBytes = 233472;
constexpr int kBlockReservedBytes = 1024;
constexpr int kMaxBlockSharedBytes = 232448;
constexpr int kGatherStageBudget =
    kSmSharedBytes / kGatherBlocksPerSm - kBlockReservedBytes;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// How pool_bwd_gather_kernel runs a problem. Phase block (m, n) holds the
// padded rows m * sh .. m * sh + sh - 1 and columns n * sw .. (the input
// pixel (ih, iw) lies in block ((ih + plh) / sh, (iw + plw) / sw)); its
// pixels are covered only by windows (oh, ow) with oh in [m - hr, m] and
// ow in [n - hc, n], hr = ceil(kh / sh) - 1, hc = ceil(kw / sw) - 1. The
// blocks of the image, rows m_lo .. and columns n_lo .., go in tiles of tr
// x tc blocks; thread t of a block owns block t / cgs of the tile and
// channel group t % cgs of its span. A stage holds the tile's windows
// with their halo, (tr + hr) x (tc + hc), the span's cotangent (g_bytes,
// rounded up to 16) and then its int32 slots. Where even a 1 x 1 tile's
// stage would not fit a block, nothing is staged (staged = 0) and the
// windows are read from global memory.
struct GatherPlan {
  int cgs, spans, hr, hc, m_lo, n_lo, block_rows, block_cols, tr, tc,
      row_tiles, col_tiles, staged, g_bytes, stage_bytes, smem, grid_x,
      grid_y;
};

GatherPlan gather_plan(int B, int H, int W, int C, int kh, int kw, int sh,
                       int sw, int plh, int plw, int vec, int elem_bytes) {
  GatherPlan p = {};
  const int groups = C / vec;
  p.cgs = groups < kGatherGroups ? groups : kGatherGroups;
  p.spans = cdiv(groups, p.cgs);
  p.hr = cdiv(kh, sh) - 1;
  p.hc = cdiv(kw, sw) - 1;
  p.m_lo = plh / sh;
  p.n_lo = plw / sw;
  p.block_rows = (plh + H - 1) / sh - p.m_lo + 1;
  p.block_cols = (plw + W - 1) / sw - p.n_lo + 1;
  p.tc = p.block_cols < kGatherTileCols ? p.block_cols : kGatherTileCols;
  p.tr = kGatherThreads / p.cgs / p.tc;
  if (p.tr > p.block_rows) p.tr = p.block_rows;
  // The tile shrinks (rows, then columns) until two stages fit a third of
  // an SM's shared memory.
  int64_t g_bytes, stage;
  for (;;) {
    const int64_t elems =
        (int64_t)(p.tr + p.hr) * (p.tc + p.hc) * p.cgs * vec;
    g_bytes = (elems * elem_bytes + 15) / 16 * 16;
    stage = g_bytes + elems * 4;
    if (kGatherStages * stage <= kGatherStageBudget) break;
    if (p.tr > 1) {
      p.tr = cdiv(p.tr, 2);
    } else if (p.tc > 1) {
      p.tc = cdiv(p.tc, 2);
    } else {
      break;
    }
  }
  p.staged = kGatherStages * stage <= kMaxBlockSharedBytes;
  if (p.staged) {
    p.g_bytes = (int)g_bytes;
    p.stage_bytes = (int)stage;
    p.smem = kGatherStages * (int)stage;
  }
  p.row_tiles = cdiv(p.block_rows, p.tr);
  p.col_tiles = cdiv(p.block_cols, p.tc);
  p.grid_x = p.col_tiles * p.spans;
  int per_sm = kSmSharedBytes / (p.smem + kBlockReservedBytes);
  if (per_sm > kGatherBlocksPerSm) per_sm = kGatherBlocksPerSm;
  int64_t grid_y = (int64_t)kSms * per_sm / p.grid_x;
  if (grid_y < 1) grid_y = 1;
  if (grid_y > (int64_t)B * p.row_tiles) grid_y = (int64_t)B * p.row_tiles;
  if (grid_y > kGatherMaxGridY) grid_y = kGatherMaxGridY;
  p.grid_y = (int)grid_y;
  return p;
}

// 16 bytes from global to shared memory without passing through registers;
// src_bytes = 0 writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}
// Waits until at most n of this thread's newest copy groups are pending.
template <int n>
__device__ __forceinline__ void cp_async_wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// The gather route, for overlapping windows. kStem: the window is 3x3 with
// stride 2x2 (the Grasp2Vec stem's) at compile time; else (kh, kw, sh,
// sw) at run time. Blocks walk the tile rows blockIdx.y, + gridDim.y, ...
// of their tile column and channel span (blockIdx.x), the next tile's
// copies issued before this tile's adds.
template <typename T, typename Index, int kVec, bool kStem>
__global__ void __launch_bounds__(kGatherThreads, kGatherBlocksPerSm)
    pool_bwd_gather_kernel(const T* __restrict__ g,
                           const int32_t* __restrict__ slot,
                           T* __restrict__ dx, int B, int H, int W, int C,
                           int kh, int kw, int sh, int sw, int plh, int plw,
                           int OH, int OW, GatherPlan p) {
  extern __shared__ __align__(16) unsigned char gather_s[];
  if constexpr (kStem) {
    kh = kw = 3;
    sh = sw = 2;
  }
  const int hr = kStem ? 1 : p.hr;
  const int hc = kStem ? 1 : p.hc;
  const int groups = C / kVec;
  const int span = blockIdx.x / p.col_tiles;
  const int n0 = p.n_lo + (blockIdx.x - span * p.col_tiles) * p.tc;
  const int span_elems = p.cgs * kVec;
  const int wcols = p.tc + hc;
  const int windows = (p.tr + hr) * wcols;
  const int c_span = span * span_elems;  // the span's first channel
  const int tid = threadIdx.x;
  const int cg = tid % p.cgs;
  const int ur = tid / p.cgs / p.tc;
  const int uc = tid / p.cgs - ur * p.tc;
  const int c = c_span + cg * kVec;
  const bool live = ur < p.tr && span * p.cgs + cg < groups &&
                    n0 + uc < p.n_lo + p.block_cols;
  const Index tiles = (Index)B * p.row_tiles;

  // Stages tile row `row`'s windows: window (a, bc) of the stage is (m0 -
  // hr + a, n0 - hc + bc); outside the output it stages zeros, which no
  // add reads.
  auto stage = [&](Index row, int st) {
    const Index b = row / p.row_tiles;
    const int m0 = p.m_lo + (int)(row - b * p.row_tiles) * p.tr;
    T* gs = reinterpret_cast<T*>(gather_s + st * p.stage_bytes);
    int32_t* ss =
        reinterpret_cast<int32_t*>(gather_s + st * p.stage_bytes + p.g_bytes);
    auto at = [&](int w, int& oh, int& ow) {
      const int a = w / wcols;
      oh = m0 - hr + a;
      ow = n0 - hc + (w - a * wcols);
      return (((Index)b * OH + oh) * OW + ow) * C + c_span;
    };
    if constexpr (kVec == 8) {
      constexpr int kPer = 16 / sizeof(T);  // elements a 16-byte copy
      const int g_chunks = span_elems / kPer;
      for (int e = tid; e < windows * g_chunks; e += kGatherThreads) {
        const int w = e / g_chunks;
        const int k = e - w * g_chunks;
        int oh, ow;
        const Index o = at(w, oh, ow) + k * kPer;
        const bool ok = (unsigned)oh < (unsigned)OH &&
                        (unsigned)ow < (unsigned)OW &&
                        span * p.cgs + k * kPer / kVec < groups;
        cp_async16(gs + w * span_elems + k * kPer, ok ? g + o : g,
                   ok ? 16 : 0);
      }
      const int s_chunks = span_elems / 4;
      for (int e = tid; e < windows * s_chunks; e += kGatherThreads) {
        const int w = e / s_chunks;
        const int k = e - w * s_chunks;
        int oh, ow;
        const Index o = at(w, oh, ow) + 4 * k;
        const bool ok = (unsigned)oh < (unsigned)OH &&
                        (unsigned)ow < (unsigned)OW &&
                        span * p.cgs + 4 * k / kVec < groups;
        cp_async16(ss + w * span_elems + 4 * k, ok ? slot + o : slot,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < windows * span_elems; e += kGatherThreads) {
        const int w = e / span_elems;
        const int k = e - w * span_elems;
        int oh, ow;
        const Index o = at(w, oh, ow) + k;
        const bool ok = (unsigned)oh < (unsigned)OH &&
                        (unsigned)ow < (unsigned)OW &&
                        span * p.cgs + k < groups;
        if (ok) {
          gs[e] = g[o];
          ss[e] = slot[o];
        }
      }
    }
  };

  // The adds of tile row `row`: each live thread's sh x sw pixels, each
  // summing, from +0, the cotangents of the windows whose slot names it, in
  // ascending (oh, ow) order, rounded to T after every add; then one store
  // of its channels per pixel inside the image.
  auto gather = [&](Index row, int st) {
    const Index b = row / p.row_tiles;
    const int m = p.m_lo + (int)(row - b * p.row_tiles) * p.tr + ur;
    const int n = n0 + uc;
    if (!live || m >= p.m_lo + p.block_rows) return;
    // Window (oh, ow) = (m - hr + a, n - hc + bc) at offset base + a * rs +
    // bc * cs of gw and sl.
    const T* gw = g;
    const int32_t* sl_w = slot;
    Index base, rs, cs;
    if (kStem || p.staged) {
      gw = reinterpret_cast<const T*>(gather_s + st * p.stage_bytes);
      sl_w = reinterpret_cast<const int32_t*>(gather_s + st * p.stage_bytes +
                                              p.g_bytes);
      base = (ur * wcols + uc) * span_elems + cg * kVec;
      rs = wcols * span_elems;
      cs = span_elems;
    } else {
      base = (((Index)b * OH + m - hr) * OW + n - hc) * C + c;
      rs = (Index)OW * C;
      cs = C;
    }
    auto out = [&](int r, int q, const float* acc) {
      const int ih = m * sh + r - plh;
      const int iw = n * sw + q - plw;
      if ((unsigned)ih < (unsigned)H && (unsigned)iw < (unsigned)W) {
        store_vec<kVec>(dx + (((Index)b * H + ih) * W + iw) * C + c, acc);
      }
    };
    if constexpr (kStem) {
      // 2 x 2 pixels, 2 x 2 windows: each window's slots and cotangent read
      // once, added to the pixels it covers.
      float acc[4][kVec];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[i][j] = 0.f;
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int oh = m - 1 + a;
#pragma unroll
        for (int bc = 0; bc < 2; ++bc) {
          const int ow = n - 1 + bc;
          if ((unsigned)oh >= (unsigned)OH || (unsigned)ow >= (unsigned)OW) {
            continue;
          }
          const Index o = base + a * rs + bc * cs;
          int sl[kVec];
          float v[kVec];
          load_vec<kVec>(sl_w + o, sl);
          load_vec<kVec>(gw + o, v);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int dy = r + 2 * (1 - a);
              const int dxx = q + 2 * (1 - bc);
              if (dy >= 3 || dxx >= 3) continue;
#pragma unroll
              for (int i = 0; i < kVec; ++i) {
                if (sl[i] == dy * 3 + dxx) {
                  acc[2 * r + q][i] = round_to(acc[2 * r + q][i] + v[i], g);
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int q = 0; q < 2; ++q) out(r, q, acc[2 * r + q]);
      }
    } else {
      for (int r = 0; r < sh; ++r) {
        for (int q = 0; q < sw; ++q) {
          float acc[kVec];
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
          for (int a = 0; a <= hr; ++a) {
            const int oh = m - hr + a;
            const int dy = r + (hr - a) * sh;
            if (dy >= kh || (unsigned)oh >= (unsigned)OH) continue;
            for (int bc = 0; bc <= hc; ++bc) {
              const int ow = n - hc + bc;
              const int dxx = q + (hc - bc) * sw;
              if (dxx >= kw || (unsigned)ow >= (unsigned)OW) continue;
              const int s = dy * kw + dxx;
              const Index o = base + a * rs + bc * cs;
              int sl[kVec];
              load_vec<kVec>(sl_w + o, sl);
              bool any = false;
#pragma unroll
              for (int i = 0; i < kVec; ++i) any |= sl[i] == s;
              if (!any) continue;
              float v[kVec];
              load_vec<kVec>(gw + o, v);
#pragma unroll
              for (int i = 0; i < kVec; ++i) {
                if (sl[i] == s) acc[i] = round_to(acc[i] + v[i], g);
              }
            }
          }
          out(r, q, acc);
        }
      }
    }
  };

  const bool staged = kStem || p.staged;
  Index row = blockIdx.y;
  if (staged && row < tiles) stage(row, 0);
  cp_async_commit();
  for (int st = 0; row < tiles; row += gridDim.y, st ^= 1) {
    // The next tile's copies go out first; this tile's have landed once
    // at most the newest group is pending.
    if (staged && row + gridDim.y < tiles) stage(row + gridDim.y, st ^ 1);
    cp_async_commit();
    cp_async_wait_pending<1>();
    __syncthreads();
    gather(row, st);
    // Every thread is done with this stage before it is refilled.
    __syncthreads();
  }
  cp_async_wait_all();
}

template <typename T, typename Index, int kVec, bool kStem>
int launch_gather_as(const void* g, const void* slot, void* dx, int B, int H,
                     int W, int C, int kh, int kw, int sh, int sw, int plh,
                     int plw, int OH, int OW, cudaStream_t stream) {
  const GatherPlan p = gather_plan(B, H, W, C, kh, kw, sh, sw, plh, plw,
                                   kVec, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      pool_bwd_gather_kernel<T, Index, kVec, kStem>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  pool_bwd_gather_kernel<T, Index, kVec, kStem>
      <<<dim3(p.grid_x, p.grid_y), kGatherThreads, p.smem, stream>>>(
          static_cast<const T*>(g), static_cast<const int32_t*>(slot),
          static_cast<T*>(dx), B, H, W, C, kh, kw, sh, sw, plh, plw, OH, OW,
          p);
  return (int)cudaGetLastError();
}

template <typename T, typename Index, int kVec>
int launch_bwd_route(const void* g, const void* slot, void* dx, int B, int H,
                     int W, int C, int kh, int kw, int sh, int sw, int plh,
                     int plw, int OH, int OW, bool scatter, bool templated,
                     cudaStream_t stream) {
  if (scatter) {
    return launch_scatter_window<T, Index, kVec>(g, slot, dx, B, H, W, C, kh,
                                                 kw, plh, plw, OH, OW, stream);
  }
  if (templated) {
    return launch_gather_as<T, Index, kVec, true>(
        g, slot, dx, B, H, W, C, kh, kw, sh, sw, plh, plw, OH, OW, stream);
  }
  return launch_gather_as<T, Index, kVec, false>(
      g, slot, dx, B, H, W, C, kh, kw, sh, sw, plh, plw, OH, OW, stream);
}

// scatter, vec, wide and templated are the caller's launch choice
// (ops/pool.py bwd_launch); it must be the one this function makes.
template <typename T>
int launch_bwd(const void* g, const void* slot, void* dx, int B, int H,
               int W, int C, int kh, int kw, int sh, int sw, int plh,
               int plw, int OH, int OW, int scatter, int vec, int wide,
               int templated, cudaStream_t stream) {
  const int64_t limit = (int64_t)1 << kNarrowIndexBits;
  const bool disjoint = sh == kh && sw == kw;
  const bool vector = C % kFwdVec == 0 && aligned16(g) && aligned16(slot) &&
                      aligned16(dx);
  const bool narrow =
      (int64_t)B * H * W * C < limit && (int64_t)B * OH * OW * C < limit;
  // The windows with an instantiation of their own: the scatter route's
  // fixed windows, and the gather route's 3x3 at stride 2.
  const bool fixed = disjoint ? fixed_window(kh, kw)
                              : kh == 3 && kw == 3 && sh == 2 && sw == 2;
  if (scatter != (disjoint ? 1 : 0) || vec != (vector ? kFwdVec : 1) ||
      wide != (narrow ? 0 : 1) || templated != (fixed ? 1 : 0) ||
      (disjoint && ((int64_t)B * OH >= limit || (int64_t)OW * C >= limit))) {
    return (int)cudaErrorInvalidValue;
  }
  if (vector && narrow) {
    return launch_bwd_route<T, int32_t, kFwdVec>(g, slot, dx, B, H, W, C, kh,
                                                 kw, sh, sw, plh, plw, OH, OW,
                                                 disjoint, fixed, stream);
  }
  if (vector) {
    return launch_bwd_route<T, int64_t, kFwdVec>(g, slot, dx, B, H, W, C, kh,
                                                 kw, sh, sw, plh, plw, OH, OW,
                                                 disjoint, fixed, stream);
  }
  if (narrow) {
    return launch_bwd_route<T, int32_t, 1>(g, slot, dx, B, H, W, C, kh, kw,
                                           sh, sw, plh, plw, OH, OW, disjoint,
                                           fixed, stream);
  }
  return launch_bwd_route<T, int64_t, 1>(g, slot, dx, B, H, W, C, kh, kw, sh,
                                         sw, plh, plw, OH, OW, disjoint, fixed,
                                         stream);
}

template <typename T, typename Index, int kVec, int KH, int KW>
int launch_fwd_as(const void* x, void* out, void* slot, int B, int H, int W,
                  int C, int kh, int kw, int sh, int sw, int plh, int plw,
                  int OH, int OW, cudaStream_t stream) {
  const int rows = B * OH;
  const int cols = OW * (C / kVec);
  const dim3 grid((cols + kFwdThreads - 1) / kFwdThreads,
                  rows < kFwdMaxGridY ? rows : kFwdMaxGridY);
  pool_fwd_kernel<T, Index, kVec, KH, KW><<<grid, kFwdThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<int32_t*>(slot), H, W, C, kh, kw, sh, sw, plh, plw, OH, OW,
      rows);
  return (int)cudaGetLastError();
}

template <typename T, typename Index, int kVec>
int launch_fwd_window(const void* x, void* out, void* slot, int B, int H,
                      int W, int C, int kh, int kw, int sh, int sw, int plh,
                      int plw, int OH, int OW, cudaStream_t stream) {
  if (kh == 3 && kw == 3) {
    return launch_fwd_as<T, Index, kVec, 3, 3>(x, out, slot, B, H, W, C, kh,
                                               kw, sh, sw, plh, plw, OH, OW,
                                               stream);
  }
  if (kh == 2 && kw == 2) {
    return launch_fwd_as<T, Index, kVec, 2, 2>(x, out, slot, B, H, W, C, kh,
                                               kw, sh, sw, plh, plw, OH, OW,
                                               stream);
  }
  return launch_fwd_as<T, Index, kVec, 0, 0>(x, out, slot, B, H, W, C, kh,
                                             kw, sh, sw, plh, plw, OH, OW,
                                             stream);
}

// vec, wide and templated are the caller's launch choice (ops/pool.py
// fwd_launch); it must be the one this function makes.
template <typename T>
int launch_fwd(const void* x, void* out, void* slot, int B, int H, int W,
               int C, int kh, int kw, int sh, int sw, int plh, int plw,
               int OH, int OW, int vec, int wide, int templated,
               cudaStream_t stream) {
  const int64_t limit = (int64_t)1 << kNarrowIndexBits;
  const bool vector = C % kFwdVec == 0 && aligned16(x) && aligned16(out) &&
                      aligned16(slot);
  const bool narrow =
      (int64_t)B * H * W * C < limit && (int64_t)B * OH * OW * C < limit;
  if (vec != (vector ? kFwdVec : 1) || wide != (narrow ? 0 : 1) ||
      templated != (fixed_window(kh, kw) ? 1 : 0) ||
      (int64_t)B * OH >= limit || (int64_t)OW * C >= limit) {
    return (int)cudaErrorInvalidValue;
  }
  if (vector && narrow) {
    return launch_fwd_window<T, int32_t, kFwdVec>(
        x, out, slot, B, H, W, C, kh, kw, sh, sw, plh, plw, OH, OW, stream);
  }
  if (vector) {
    return launch_fwd_window<T, int64_t, kFwdVec>(
        x, out, slot, B, H, W, C, kh, kw, sh, sw, plh, plw, OH, OW, stream);
  }
  if (narrow) {
    return launch_fwd_window<T, int32_t, 1>(x, out, slot, B, H, W, C, kh, kw,
                                            sh, sw, plh, plw, OH, OW, stream);
  }
  return launch_fwd_window<T, int64_t, 1>(x, out, slot, B, H, W, C, kh, kw,
                                          sh, sw, plh, plw, OH, OW, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. vec (8 or 1 channels a thread), wide
// (64-bit offsets) and templated (a window with its own instantiation) are
// the launch choice, which must be launch_fwd's. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another choice.
int t2r_pool_fwd(const void* x, void* out, void* slot, int dtype, int B,
                 int H, int W, int C, int kh, int kw, int sh, int sw, int plh,
                 int plw, int OH, int OW, int vec, int wide, int templated,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_fwd<float>(x, out, slot, B, H, W, C, kh, kw, sh, sw, plh,
                             plw, OH, OW, vec, wide, templated, s);
  }
  if (dtype == 1) {
    return launch_fwd<__nv_bfloat16>(x, out, slot, B, H, W, C, kh, kw, sh, sw,
                                     plh, plw, OH, OW, vec, wide, templated,
                                     s);
  }
  return (int)cudaErrorInvalidValue;
}

// g: [B, OH, OW, C] in dtype, slot: int32 of the same shape, dx:
// [B, H, W, C] in dtype. scatter (the non-overlapping route), vec (8 or 1
// channels a thread), wide (64-bit offsets) and templated (a window with
// its own instantiation) are the launch choice, which must be launch_bwd's.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for another choice.
int t2r_pool_bwd(const void* g, const void* slot, void* dx, int dtype, int B,
                 int H, int W, int C, int kh, int kw, int sh, int sw, int plh,
                 int plw, int OH, int OW, int scatter, int vec, int wide,
                 int templated, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_bwd<float>(g, slot, dx, B, H, W, C, kh, kw, sh, sw, plh,
                             plw, OH, OW, scatter, vec, wide, templated, s);
  }
  if (dtype == 1) {
    return launch_bwd<__nv_bfloat16>(g, slot, dx, B, H, W, C, kh, kw, sh, sw,
                                     plh, plw, OH, OW, scatter, vec, wide,
                                     templated, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* t2r_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
