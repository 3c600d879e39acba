// Flash attention on [B, T, H, D] tensors: forward (out, logsumexp), and the
// FlashAttention-2 backward as two kernels, dq and dk/dv.
//
// Replaces: tensor2robot_tpu/ops/flash_attention.py
//   flash_fwd  <- _fwd_kernel (staged, :100) and _fwd_kernel_streamed (:138)
//   flash_dq   <- _dq_kernel (:240) and _dq_kernel_streamed (:172)
//   flash_dkv  <- _dkv_kernel (:268) and _dkv_kernel_streamed (:202)
// The TPU package has two variants of each because staging a whole
// sequence's K/V in a core's VMEM stops fitting at long T. A kernel here
// never stages the whole sequence: in every regime it walks K/V (or Q) in
// 64-row tiles through shared memory, which is the streamed kernels'
// structure, and it shortens the causal loop at the diagonal tile, as the
// staged kernels do. One kernel per function covers both regimes.
//
// Semantics, term for term those of the TPU kernels (_scores,
// _online_softmax_step, _ds_block):
//   * masked scores are -1e30, never -inf; the online-softmax subtrahend is
//     clamped to max(m_new, -0.5e30), so a row that has seen only masked
//     keys keeps p = 0; l is clamped to 1e-30 before the divide and
//     lse = m + log(l);
//   * the forward scales the float32 scores q.k by 1/sqrt(D) (the TPU
//     kernel scales the float32 q: the same product but for one rounding);
//     the backward scales the raw q.k scores, and again dq and dk at the
//     end;
//   * p = exp(s - lse), ds = p * (dO.v - delta) with delta = rowsum(dO*O)
//     computed by the caller;
//   * inputs are float32 or bfloat16; everything accumulates in float32 and
//     rounds once to the input dtype on the way out, except that the
//     forward's tensor-core route rounds p to bfloat16 for P.V (l sums the
//     float32 p, so lse is unaffected).
// Rows past T (a ragged last tile) load as zeros and are masked like
// causally hidden keys; they are never stored.
//
// Layout: q, k, v, out, dO, dq, dk, dv are contiguous [B, T, H, D] and are
// read through their strides (row t of head h of batch b starts at
// ((b*T + t)*H + h)*D), so no head fold copy is made. lse and delta are
// float32 [B*H, T].
//
// What bounds it on an H100: at the SNAIL shapes (D = 8 and 64, float32)
// and at short T, bytes and latency; at long T, the O(T^2 D) operations.
//
// The forward has two routes, chosen by fwd_route and fwd_rows below and
// mirrored on the host by ops/flash_attention.fwd_plan (the entry point
// refuses a plan that differs):
//   * mma (bfloat16, D % 16 == 0, 16-byte aligned operands): FlashAttention-2
//     on the tensor cores, mma.sync m16n8k16 bf16 with float32 sums. Each
//     of a block's 4 warps owns 16 q rows of its 64; the q tile goes through
//     shared memory once into registers as A fragments (ldmatrix); K and V
//     tiles of 64 rows come by 16-byte cp.async into a two-stage ring, tile
//     kb + 1 in flight under tile kb's math, rows padded by 16 bytes so
//     neither the copies nor ldmatrix conflict on banks; S = Q.K^T with K
//     as the col operand (ldmatrix, no transpose) stays in registers, is
//     scaled and masked in float32 and goes through the online softmax with
//     quad shuffles, in base 2 (the scale carries log2(e), so a score costs
//     one MUFU.EX2; lse = m ln 2 + log l); P is rounded to bf16 in
//     registers (the C fragment of m16n8k16 is its A fragment) and
//     multiplied with V read by ldmatrix.trans: no shared-memory round trip
//     and one barrier a tile; the output leaves through the warp's own rows
//     of the q tile in 16-byte stores.
//   * cuda_cores (float32 always: its 2e-5 bar rules out TF32; bfloat16
//     with other head dims or unaligned operands): 256 threads, q tiles of
//     16, 32 or 64 rows planned per shape so the grid covers the SMs, the
//     same two-stage ring of 64-row K/V tiles (16-byte cp.async for aligned
//     float32, element loads otherwise), each thread 1, 2 or 4 rows by 4
//     keys of the score tile, P through shared memory, and at D = 8 the two
//     halves of a row's 16 lanes split the keys of P.V so every lane works.
// Both launch one block per (q tile, B*H), the heaviest causal q tiles
// first. Each output element has exactly one writer and the loops run in a
// fixed order: no atomics, and a kernel run twice agrees bit for bit.
// What bounds the mma route on an H100 is the issue of its mma.sync and
// softmax instructions, which one warp runs in turn (PERF.md records the
// times); wgmma, TMA, warp specialisation and a persistent grid are later
// work.
//
// The backward kernels run on the CUDA cores in float32 (67 TFLOP/s peak,
// against 989 TFLOP/s bf16 on the tensor cores): one 256-thread block per
// (64-row tile, B*H); the block's own tile and the streamed tiles sit in
// shared memory as float32 (the streamed operand transposed, so a 16-byte
// read gives a thread its 4 columns of scores); each thread owns a 4x4
// block of the 64x64 score tile and, for the output, 4 rows by ceil(D/16)
// columns strided by 16. Row maxima and sums reduce across the 16 threads
// of a row with warp shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // rows of every K/V tile (and dq/dkv tile)
constexpr int kThreads = 256;  // 16 x 16 threads on the CUDA cores
constexpr float kNegInf = -1e30f;
// The forward's plan (mirrored by ops/flash_attention.fwd_plan).
constexpr int kRouteCudaCores = 0;
constexpr int kRouteMma = 1;
constexpr int kStages = 2;       // K/V tiles in shared memory: this and next
constexpr int kSms = 132;        // H100 SXM
constexpr int kBlocksPerSm = 2;  // a plan's grid aims at this many per SM
constexpr int kMmaWarps = 4;     // 64 q rows a block on the tensor cores
constexpr int kMmaPad = 8;       // bf16 (16 bytes) after each shared row
constexpr int kCorePad = 4;      // floats (16 bytes) after each shared row
constexpr int kPStride = kTile + 2;  // floats per shared row of P

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sum and max over the 16 lanes that hold one row (lanes 0-15 or 16-31).
__device__ __forceinline__ float row_max(float x) {
  for (int offset = 8; offset > 0; offset >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, offset));
  }
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
  for (int offset = 8; offset > 0; offset >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, offset);
  }
  return x;
}

struct Geometry {
  int seq;        // T
  int heads;      // H
  int dim;        // D
  int64_t base;   // offset of (b, t=0, h, d=0)
  int64_t row;    // H * D, the stride between consecutive t
};

__device__ __forceinline__ Geometry head_geometry(int bh, int seq, int heads,
                                                  int dim) {
  const int b = bh / heads;
  const int h = bh - b * heads;
  Geometry g;
  g.seq = seq;
  g.heads = heads;
  g.dim = dim;
  g.row = (int64_t)heads * dim;
  g.base = ((int64_t)b * seq * heads + h) * dim;
  return g;
}

// The backward kernels' head: blockIdx.y.
__device__ __forceinline__ Geometry geometry(int seq, int heads, int dim) {
  return head_geometry(blockIdx.y, seq, heads, dim);
}

// Tile rows [row0, row0 + 64) of a [B, T, H, D] tensor into shared memory
// as float32 times `mul`, rows past T as zeros. `transposed` stores element
// (r, c) at dst[c * 64 + r], else at dst[r * D + c].
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          const Geometry& g, int row0,
                                          float mul, bool transposed,
                                          float* __restrict__ dst) {
  const int d = g.dim;
  for (int e = threadIdx.x; e < kTile * d; e += kThreads) {
    const int r = e / d;
    const int c = e - r * d;
    const int t = row0 + r;
    const float value =
        t < g.seq ? to_f32(src[g.base + (int64_t)t * g.row + c]) * mul : 0.f;
    dst[transposed ? c * kTile + r : e] = value;
  }
}

// Rows [row0, row0 + 64) of a float32 [B*H, T] vector, rows past T as 0.
__device__ __forceinline__ void load_row_stat(const float* __restrict__ src,
                                              int seq, int row0,
                                              float* __restrict__ dst) {
  if (threadIdx.x < kTile) {
    const int t = row0 + threadIdx.x;
    dst[threadIdx.x] =
        t < seq ? src[(int64_t)blockIdx.y * seq + t] : 0.f;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int seq,
                                        int causal) {
  return qpos < seq && kpos < seq && (!causal || qpos >= kpos);
}

// ----------------------------------------------- asynchronous copies, mma

__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory without passing through registers;
// src_bytes = 0 writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_address(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives, of each matrix, row l / 4, columns 2 (l % 4) and
// 2 (l % 4) + 1 (.trans: column l / 4, rows 2 (l % 4) and 2 (l % 4) + 1).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_address(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_address(p)));
}

// d += a * b for one 16x8 tile, 16 deep: bf16 inputs, float32 sums.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 in one register, the first in the low half
// (the lower column of a fragment).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The q tile of block `block` of a forward grid over nq q tiles and bh
// heads: tile-major, so under the causal mask the heaviest tiles (the
// last, which see the most keys) of every head launch first.
__device__ __forceinline__ int fwd_q_tile(int block, int nq, int bh,
                                          int causal) {
  const int rank = block / bh;
  return causal ? nq - 1 - rank : rank;
}

// ------------------------------------------------- forward, CUDA cores

// Thread (ty, tx) of 16 x 16 owns rows ty * RQ + i of the q tile (16 * RQ
// rows) and keys tx + 16 j (j < 4) of each 64-key score tile. In P.V the
// 16 lanes of a row split into KS groups of 16 / KS lanes: lane tx takes
// columns tx % (16 / KS) + (16 / KS) c (c < DC) and keys KS m + tx / (16 /
// KS); with KS = 2 (D = 8) the two partial sums meet once at the end.
template <typename T, int RQ, int KS, int DC>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int seq, int heads, int dim,
                     int causal, float scale, int async_copy) {
  constexpr int kRows = 16 * RQ;
  constexpr int kLanes = 16 / KS;
  const int stride = dim + kCorePad;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                           // [kRows][stride]
  float* ks = qs + kRows * stride;            // [kStages][64][stride]
  float* vs = ks + kStages * kTile * stride;  // [kStages][64][stride]
  float* ps = vs + kStages * kTile * stride;  // [kRows][kPStride], p
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int nq = (seq + kRows - 1) / kRows;
  const int heads_total = gridDim.x / nq;  // B * H
  const int bh = blockIdx.x % heads_total;
  const Geometry g = head_geometry(bh, seq, heads, dim);
  const int q0 = fwd_q_tile(blockIdx.x, nq, heads_total, causal) * kRows;

  // Rows [r0, r0 + rows) of an operand into shared rows of `stride`
  // floats, rows past T as zeros: 16-byte cp.async where the operands are
  // aligned float32, else element loads converted to float32.
  auto stage = [&](const T* src, int r0, int rows, float* dst) {
    if (sizeof(T) == sizeof(float) && async_copy) {
      const int chunks = dim >> 2;
      for (int c = threadIdx.x; c < rows * chunks; c += kThreads) {
        const int r = c / chunks;
        const int col = (c - r * chunks) << 2;
        const int t = r0 + r;
        const bool live = t < seq;
        cp_async16(dst + r * stride + col,
                   src + g.base + (int64_t)(live ? t : 0) * g.row + col,
                   live ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < rows * dim; e += kThreads) {
        const int r = e / dim;
        const int c = e - r * dim;
        const int t = r0 + r;
        dst[r * stride + c] =
            t < seq ? to_f32(src[g.base + (int64_t)t * g.row + c]) : 0.f;
      }
    }
  };

  const int nk = (seq + kTile - 1) / kTile;
  // Causal: only key tiles at or before this q tile's diagonal contribute.
  const int nk_eff = causal ? min((q0 + kRows + kTile - 1) / kTile, nk) : nk;
  stage(q, q0, kRows, qs);
  stage(k, 0, kTile, ks);
  stage(v, 0, kTile, vs);
  if (async_copy) cp_async_commit();

  float m[RQ], l[RQ], acc[RQ][DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  const int col0 = tx % kLanes;
  const int part = tx / kLanes;

  for (int kb = 0; kb < nk_eff; ++kb) {
    if (async_copy) cp_async_wait_all();
    __syncthreads();  // tile kb is in; every thread is done with tile kb - 1
    if (kb + 1 < nk_eff) {
      const int next = ((kb + 1) & 1) * kTile * stride;
      stage(k, (kb + 1) * kTile, kTile, ks + next);
      stage(v, (kb + 1) * kTile, kTile, vs + next);
      if (async_copy) cp_async_commit();
    }
    const int k0 = kb * kTile;
    const float* kst = ks + (kb & 1) * kTile * stride;
    const float* vst = vs + (kb & 1) * kTile * stride;

    float s[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 2
    for (int d = 0; d < dim; d += 4) {
      float4 qv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(
            &qs[(ty * RQ + i) * stride + d]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(&kst[(tx + 16 * j) * stride + d]);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv.x, a);
          a = fmaf(qv[i].y, kv.y, a);
          a = fmaf(qv[i].z, kv.z, a);
          s[i][j] = fmaf(qv[i].w, kv.w, a);
        }
      }
    }

    // Only a tile past T or across the diagonal needs the mask.
    const bool edge = k0 + kTile > seq || (causal && k0 + kTile - 1 > q0);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qpos = q0 + ty * RQ + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float sc = s[i][j] * scale;
        if (edge && !visible(qpos, k0 + tx + 16 * j, seq, causal)) {
          sc = kNegInf;
        }
        s[i][j] = sc;
        mx = fmaxf(mx, sc);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      // Rows with every key masked so far have m_new == -1e30: clamp the
      // subtrahend so exp(-1e30 - m_new) stays 0 instead of exp(0) = 1.
      const float m_sub = fmaxf(m_new, 0.5f * kNegInf);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_sub);
        ps[(ty * RQ + i) * kPStride + tx + 16 * j] = p;
        psum += p;
      }
      const float corr = expf(m[i] - m_sub);
      l[i] = l[i] * corr + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // p of the tile is in

#pragma unroll 8
    for (int key = part; key < kTile; key += KS) {
      float p[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) p[i] = ps[(ty * RQ + i) * kPStride + key];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = col0 + kLanes * c;
        if (d < dim) {
          const float vv = vst[key * stride + d];
#pragma unroll
          for (int i = 0; i < RQ; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }

  if (KS > 1) {
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], kLanes);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int t = q0 + ty * RQ + i;
    if (t >= seq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    if (part == 0) {
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = col0 + kLanes * c;
        if (d < dim) {
          out[g.base + (int64_t)t * g.row + d] = from_f32<T>(acc[i][c] / li);
        }
      }
    }
    if (tx == 0) lse[(int64_t)bh * seq + t] = m[i] + logf(li);
  }
}

// ------------------------------------------------ forward, tensor cores

// Warp w owns q rows q0 + 16 w ... + 15; lane l holds fragment rows
// l / 4 and l / 4 + 8 and column pair l % 4 of every 16 x 8 tile.
template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ lse, int seq, int heads,
                         int causal, float scale) {
  constexpr int kBlockThreads = kMmaWarps * 32;
  constexpr int kRows = 16 * kMmaWarps;
  constexpr int kStride = D + kMmaPad;  // bf16 per shared row
  constexpr int kChunks = D / 8;        // 16-byte chunks per row
  constexpr int kKSteps = D / 16;       // k16 steps of Q.K^T
  constexpr int kDTiles = D / 8;        // n8 tiles of the output
  extern __shared__ uint4 smem_mma[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* ks = qs + kRows * kStride;            // [kStages][64][kStride]
  __nv_bfloat16* vs = ks + kStages * kTile * kStride;  // [kStages][64][kStride]

  const int nq = (seq + kRows - 1) / kRows;
  const int heads_total = gridDim.x / nq;  // B * H
  const int bh = blockIdx.x % heads_total;
  const Geometry g = head_geometry(bh, seq, heads, D);
  const int q0 = fwd_q_tile(blockIdx.x, nq, heads_total, causal) * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int fr = lane >> 2;       // fragment row (and fr + 8)
  const int fc = 2 * (lane & 3);  // fragment column pair
  const int wrow = q0 + 16 * warp;
  const float scale_log2 = scale * kLog2e;

  // Rows [r0, r0 + rows) of an operand into shared rows of kStride, 16
  // bytes a copy; rows past T are zero-filled and read nothing.
  auto stage = [&](const __nv_bfloat16* src, int r0, int rows,
                   __nv_bfloat16* dst) {
    for (int c = threadIdx.x; c < rows * kChunks; c += kBlockThreads) {
      const int r = c / kChunks;
      const int col = (c - r * kChunks) * 8;
      const int t = r0 + r;
      const bool live = t < seq;
      cp_async16(dst + r * kStride + col,
                 src + g.base + (int64_t)(live ? t : 0) * g.row + col,
                 live ? 16 : 0);
    }
  };

  const int nk = (seq + kTile - 1) / kTile;
  const int nk_eff = causal ? min((q0 + kRows + kTile - 1) / kTile, nk) : nk;
  stage(q, q0, kRows, qs);
  stage(k, 0, kTile, ks);
  stage(v, 0, kTile, vs);
  cp_async_commit();

  unsigned qf[kKSteps][4];
  float o[kDTiles][4];
#pragma unroll
  for (int t = 0; t < kDTiles; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int kb = 0; kb < nk_eff; ++kb) {
    cp_async_wait_all();
    __syncthreads();  // tile kb is in; every warp is done with tile kb - 1
    if (kb + 1 < nk_eff) {
      const int next = ((kb + 1) & 1) * kTile * kStride;
      stage(k, (kb + 1) * kTile, kTile, ks + next);
      stage(v, (kb + 1) * kTile, kTile, vs + next);
      cp_async_commit();
    }
    if (kb == 0) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        ldmatrix_x4(qf[kk], qs + (16 * warp + (lane & 15)) * kStride +
                                16 * kk + 8 * (lane >> 4));
      }
    }
    const int k0 = kb * kTile;
    // Causal: a tile wholly right of this warp's last row leaves m, l and
    // o as they are (p = 0, corr = 1, or 0 on zero sums): skip its math.
    if (causal && k0 > wrow + 15) continue;
    const __nv_bfloat16* kst = ks + (kb & 1) * kTile * kStride;
    const __nv_bfloat16* vst = vs + (kb & 1) * kTile * kStride;

    // S = Q.K^T, 16 x 64 a warp: n8 tile j holds keys 8 j ... 8 j + 7.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        // Matrices: keys 16 jp + {0..7, 0..7, 8..15, 8..15}, dims
        // 16 kk + {0..7, 8..15, 0..7, 8..15}: b0, b1 of tiles 2 jp, 2 jp + 1.
        unsigned r[4];
        ldmatrix_x4(r, kst +
                           (16 * jp + 8 * (lane >> 4) + (lane & 7)) * kStride +
                           16 * kk + 8 * ((lane >> 3) & 1));
        mma_bf16_16816(s[2 * jp], qf[kk], r[0], r[1]);
        mma_bf16_16816(s[2 * jp + 1], qf[kk], r[2], r[3]);
      }
    }

    // Scale (by 1/sqrt(D) log2(e): the softmax runs in base 2, one
    // MUFU.EX2 a score) and mask in float32 (only a tile past T or across
    // this warp's diagonal needs the mask), then the online softmax over
    // the 4 lanes of each row.
    const bool edge = k0 + kTile > seq || (causal && k0 + kTile - 1 > wrow);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sc = s[j][e] * scale_log2;
        if (edge) {
          const int kpos = k0 + 8 * j + fc + (e & 1);
          const int qpos = wrow + fr + 8 * (e >> 1);
          if (kpos >= seq || (causal && kpos > qpos)) sc = kNegInf;
        }
        s[j][e] = sc;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float m_sub = fmaxf(m_new, 0.5f * kNegInf);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const float p = exp2f(s[j][e] - m_sub);
          s[j][e] = p;
          psum += p;
        }
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      const float corr = exp2f(m[h] - m_sub);
      l[h] = l[h] * corr + psum;
      m[h] = m_new;
#pragma unroll
      for (int t = 0; t < kDTiles; ++t) {
        o[t][2 * h] *= corr;
        o[t][2 * h + 1] *= corr;
      }
    }

    // O += P.V: P in bf16 from the S fragments, 16 keys a step; V as the
    // col operand by ldmatrix.trans (matrices: keys 16 kk + {0..7, 8..15,
    // 0..7, 8..15}, dims 16 dp + {0..7, 0..7, 8..15, 8..15}).
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        unsigned r[4];
        ldmatrix_x4_trans(
            r, vst + (16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7)) * kStride +
                   16 * dp + 8 * (lane >> 4));
        mma_bf16_16816(o[2 * dp], a, r[0], r[1]);
        mma_bf16_16816(o[2 * dp + 1], a, r[2], r[3]);
      }
    }
  }

  // The warp's 16 rows, normalised and rounded, through its own rows of the
  // q tile (no other warp reads them) into 16-byte row-contiguous stores.
  __nv_bfloat16* os = qs + 16 * warp * kStride;
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float li = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int t = 0; t < kDTiles; ++t) {
      *reinterpret_cast<unsigned*>(os + (fr + 8 * h) * kStride + 8 * t + fc) =
          pack_bf16(o[t][2 * h] / li, o[t][2 * h + 1] / li);
    }
    const int row = wrow + fr + 8 * h;
    if ((lane & 3) == 0 && row < seq) {
      lse[(int64_t)bh * seq + row] = m[h] * kLn2 + logf(li);
    }
  }
  __syncwarp();
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * 8;
    const int t = wrow + r;
    if (t < seq) {
      *reinterpret_cast<uint4*>(out + g.base + (int64_t)t * g.row + col) =
          *reinterpret_cast<const uint4*>(os + r * kStride + col);
    }
  }
}

// ------------------------------------------------------------------ dq

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int seq, int heads, int dim, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                  // [64][D], raw q
  float* dos = qs + kTile * dim;     // [64][D], dO
  float* kt = dos + kTile * dim;     // [D][64], k transposed (scores)
  float* ks = kt + dim * kTile;      // [64][D], k (dq += ds k)
  float* vt = ks + kTile * dim;      // [D][64], v transposed (dO v^T)
  float* dss = vt + dim * kTile;     // [64][64], ds of the current tile
  float* lse_s = dss + kTile * kTile;
  float* delta_s = lse_s + kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const Geometry g = geometry(seq, heads, dim);
  const int qb = blockIdx.x;
  const int q0 = qb * kTile;

  load_tile(q, g, q0, 1.f, false, qs);
  load_tile(dout, g, q0, 1.f, false, dos);
  load_row_stat(lse, seq, q0, lse_s);
  load_row_stat(delta, seq, q0, delta_s);

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int nk = (seq + kTile - 1) / kTile;
  const int nk_eff = causal ? min(qb + 1, nk) : nk;
  for (int kb = 0; kb < nk_eff; ++kb) {
    const int k0 = kb * kTile;
    __syncthreads();
    load_tile(k, g, k0, 1.f, true, kt);
    load_tile(k, g, k0, 1.f, false, ks);
    load_tile(v, g, k0, 1.f, true, vt);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    }
    for (int d = 0; d < dim; ++d) {
      const float4 kk = *reinterpret_cast<const float4*>(&kt[d * kTile + tx * 4]);
      const float4 vv = *reinterpret_cast<const float4*>(&vt[d * kTile + tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = qs[(ty * 4 + i) * dim + d];
        const float ov = dos[(ty * 4 + i) * dim + d];
        s[i][0] += qv * kk.x;
        s[i][1] += qv * kk.y;
        s[i][2] += qv * kk.z;
        s[i][3] += qv * kk.w;
        dp[i][0] += ov * vv.x;
        dp[i][1] += ov * vv.y;
        dp[i][2] += ov * vv.z;
        dp[i][3] += ov * vv.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float sc = s[i][j] * scale;
        if (!visible(q0 + r, k0 + tx * 4 + j, seq, causal)) sc = kNegInf;
        const float p = expf(sc - lse_s[r]);
        dss[r * kTile + tx * 4 + j] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();

    for (int c = 0; c < kTile; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dss[(ty * 4 + i) * kTile + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const int d = tx + 16 * cc;
        if (d < dim) {
          const float kv = ks[c * dim + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][cc] += ds[i] * kv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= seq) continue;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      const int d = tx + 16 * cc;
      if (d < dim) dq[g.base + (int64_t)t * g.row + d] = from_f32<T>(acc[i][cc] * scale);
    }
  }
}

// ---------------------------------------------------------------- dk/dv

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int seq, int heads, int dim,
                     int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ks = smem;                  // [64][D], this block's keys
  float* vs = ks + kTile * dim;      // [64][D], this block's values
  float* qt = vs + kTile * dim;      // [D][64], q transposed (scores)
  float* qs = qt + dim * kTile;      // [64][D], q (dk += ds^T q)
  float* dot = qs + kTile * dim;     // [D][64], dO transposed (v dO^T)
  float* dos = dot + dim * kTile;    // [64][D], dO (dv += p^T dO)
  float* pt = dos + kTile * dim;     // [64 keys][64 queries], p^T
  float* dst = pt + kTile * kTile;   // [64 keys][64 queries], ds^T
  float* lse_s = dst + kTile * kTile;
  float* delta_s = lse_s + kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const Geometry g = geometry(seq, heads, dim);
  const int kb = blockIdx.x;
  const int k0 = kb * kTile;

  load_tile(k, g, k0, 1.f, false, ks);
  load_tile(v, g, k0, 1.f, false, vs);

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  }

  const int nq = (seq + kTile - 1) / kTile;
  // Causal: only q tiles at or after this k tile's diagonal contribute.
  const int start = causal ? kb : 0;
  for (int qb = start; qb < nq; ++qb) {
    const int q0 = qb * kTile;
    __syncthreads();
    load_tile(q, g, q0, 1.f, true, qt);
    load_tile(q, g, q0, 1.f, false, qs);
    load_tile(dout, g, q0, 1.f, true, dot);
    load_tile(dout, g, q0, 1.f, false, dos);
    load_row_stat(lse, seq, q0, lse_s);
    load_row_stat(delta, seq, q0, delta_s);
    __syncthreads();

    // Thread (ty, tx): keys ty*4 + i, queries tx*4 + j.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    }
    for (int d = 0; d < dim; ++d) {
      const float4 qq = *reinterpret_cast<const float4*>(&qt[d * kTile + tx * 4]);
      const float4 oo = *reinterpret_cast<const float4*>(&dot[d * kTile + tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float kv = ks[(ty * 4 + i) * dim + d];
        const float vv = vs[(ty * 4 + i) * dim + d];
        s[i][0] += kv * qq.x;
        s[i][1] += kv * qq.y;
        s[i][2] += kv * qq.z;
        s[i][3] += kv * qq.w;
        dp[i][0] += vv * oo.x;
        dp[i][1] += vv * oo.y;
        dp[i][2] += vv * oo.z;
        dp[i][3] += vv * oo.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx * 4 + j;
        float sc = s[i][j] * scale;
        if (!visible(q0 + r, k0 + c, seq, causal)) sc = kNegInf;
        const float p = expf(sc - lse_s[r]);
        pt[c * kTile + r] = p;
        dst[c * kTile + r] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();

    for (int r = 0; r < kTile; ++r) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = pt[(ty * 4 + i) * kTile + r];
        ds[i] = dst[(ty * 4 + i) * kTile + r];
      }
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const int d = tx + 16 * cc;
        if (d < dim) {
          const float ov = dos[r * dim + d];
          const float qv = qs[r * dim + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][cc] += p[i] * ov;
            dk_acc[i][cc] += ds[i] * qv;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty * 4 + i;
    if (t >= seq) continue;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      const int d = tx + 16 * cc;
      if (d < dim) {
        const int64_t at = g.base + (int64_t)t * g.row + d;
        dk[at] = from_f32<T>(dk_acc[i][cc] * scale);
        dv[at] = from_f32<T>(dv_acc[i][cc]);
      }
    }
  }
}

// ------------------------------------------------------------ launchers

// Shared memory of each kernel in bytes, for head dim `dim` and, in the
// forward, q tiles of `rows`.
size_t fwd_smem(int dim, int rows) {
  return sizeof(float) *
         ((size_t)(rows + 2 * kStages * kTile) * (dim + kCorePad) +
          (size_t)rows * kPStride);
}
size_t fwd_mma_smem(int dim, int rows) {
  return sizeof(__nv_bfloat16) * (size_t)(rows + 2 * kStages * kTile) *
         (dim + kMmaPad);
}
size_t dq_smem(int dim) {
  return sizeof(float) * (5 * kTile * dim + kTile * kTile + 2 * kTile);
}
size_t dkv_smem(int dim) {
  return sizeof(float) * (6 * kTile * dim + 2 * kTile * kTile + 2 * kTile);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  // Above 48 KB a kernel takes dynamic shared memory only after opting in.
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The forward's route: the tensor cores for bfloat16 with D a multiple of
// 16 and 16-byte aligned operands, else the CUDA cores.
int fwd_route(int dtype, int dim, bool aligned) {
  return dtype == 1 && dim % 16 == 0 && aligned ? kRouteMma : kRouteCudaCores;
}

// The forward's q-tile rows: 64 (kMmaWarps warps) on the tensor cores; on
// the CUDA cores the tallest of 64 and 32 rows that gives kBlocksPerSm
// blocks an SM, else 16.
int fwd_rows(int route, int bh, int seq) {
  const int64_t want = (int64_t)kBlocksPerSm * kSms;
  auto blocks = [&](int rows) {
    return (int64_t)bh * ((seq + rows - 1) / rows);
  };
  if (route == kRouteMma) return 16 * kMmaWarps;
  if (blocks(64) >= want) return 64;
  if (blocks(32) >= want) return 32;
  return 16;
}

struct Launch {
  int batch, seq, heads, dim, causal;
  float scale;
  cudaStream_t stream;
  dim3 grid() const {
    return dim3((seq + kTile - 1) / kTile, batch * heads);
  }
  // The forward's grid: one block per (q tile of `rows`, B*H), tile-major.
  dim3 fwd_grid(int rows) const {
    return dim3((unsigned)(((seq + rows - 1) / rows) * batch * heads));
  }
};

template <typename T, int RQ, int KS, int DC>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        const Launch& a, bool async_copy) {
  const size_t smem = fwd_smem(a.dim, 16 * RQ);
  auto kernel = flash_fwd_kernel<T, RQ, KS, DC>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.fwd_grid(16 * RQ), kThreads, smem, a.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), a.seq, a.heads, a.dim, a.causal, a.scale,
      (int)async_copy);
  return (int)cudaGetLastError();
}

// KS = 2 key groups at D = 8, else 1; DC = columns a lane.
template <typename T, int RQ>
int fwd_dim(const void* q, const void* k, const void* v, void* out,
            void* lse, const Launch& a, bool async_copy) {
  if (a.dim == 8) return fwd<T, RQ, 2, 1>(q, k, v, out, lse, a, async_copy);
#define T2R_FWD_CASE(DC) \
  case DC: return fwd<T, RQ, 1, DC>(q, k, v, out, lse, a, async_copy);
  switch ((a.dim + 15) / 16) {
    T2R_FWD_CASE(1)
    T2R_FWD_CASE(2)
    T2R_FWD_CASE(3)
    T2R_FWD_CASE(4)
    T2R_FWD_CASE(5)
    T2R_FWD_CASE(6)
    T2R_FWD_CASE(7)
    T2R_FWD_CASE(8)
  }
#undef T2R_FWD_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int fwd_cuda_cores(const void* q, const void* k, const void* v, void* out,
                   void* lse, const Launch& a, int rows, bool async_copy) {
  switch (rows) {
    case 16: return fwd_dim<T, 1>(q, k, v, out, lse, a, async_copy);
    case 32: return fwd_dim<T, 2>(q, k, v, out, lse, a, async_copy);
    case 64: return fwd_dim<T, 4>(q, k, v, out, lse, a, async_copy);
  }
  return (int)cudaErrorInvalidValue;
}

template <int D>
int fwd_mma(const void* q, const void* k, const void* v, void* out, void* lse,
            const Launch& a) {
  const size_t smem = fwd_mma_smem(D, 16 * kMmaWarps);
  auto kernel = flash_fwd_mma_kernel<D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.fwd_grid(16 * kMmaWarps), kMmaWarps * 32, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), a.seq,
      a.heads, a.causal, a.scale);
  return (int)cudaGetLastError();
}

int fwd_tensor_cores(const void* q, const void* k, const void* v, void* out,
                     void* lse, const Launch& a) {
#define T2R_MMA_CASE(D) \
  case D: return fwd_mma<D>(q, k, v, out, lse, a);
  switch (a.dim) {
    T2R_MMA_CASE(16)
    T2R_MMA_CASE(32)
    T2R_MMA_CASE(48)
    T2R_MMA_CASE(64)
    T2R_MMA_CASE(80)
    T2R_MMA_CASE(96)
    T2R_MMA_CASE(112)
    T2R_MMA_CASE(128)
  }
#undef T2R_MMA_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T, int DC>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dq_out, const Launch& a) {
  const size_t smem = dq_smem(a.dim);
  auto kernel = flash_dq_kernel<T, DC>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.grid(), kThreads, smem, a.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq_out), a.seq, a.heads, a.dim, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int DC>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv,
        const Launch& a) {
  const size_t smem = dkv_smem(a.dim);
  auto kernel = flash_dkv_kernel<T, DC>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.grid(), kThreads, smem, a.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), a.seq, a.heads, a.dim,
      a.causal, a.scale);
  return (int)cudaGetLastError();
}

// Calls fn.template operator()<T, DC>() for the dtype code and head dim:
// DC = ceil(D / 16) output columns per thread.
template <typename Fn>
int dispatch(int dtype, int dim, Fn fn) {
  if (dim < 8 || dim > 128 || dim % 8 != 0) return (int)cudaErrorInvalidValue;
  const int dc = (dim + 15) / 16;
#define T2R_FLASH_CASE(T)                              \
  switch (dc) {                                        \
    case 1: return fn.template operator()<T, 1>();     \
    case 2: return fn.template operator()<T, 2>();     \
    case 3: return fn.template operator()<T, 3>();     \
    case 4: return fn.template operator()<T, 4>();     \
    case 5: return fn.template operator()<T, 5>();     \
    case 6: return fn.template operator()<T, 6>();     \
    case 7: return fn.template operator()<T, 7>();     \
    default: return fn.template operator()<T, 8>();    \
  }
  if (dtype == 0) {
    T2R_FLASH_CASE(float)
  }
  if (dtype == 1) {
    T2R_FLASH_CASE(__nv_bfloat16)
  }
#undef T2R_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

struct DqFn {
  const void *q, *k, *v, *dout, *lse, *delta;
  void* dq_out;
  Launch a;
  template <typename T, int DC>
  int operator()() const {
    return dq<T, DC>(q, k, v, dout, lse, delta, dq_out, a);
  }
};

struct DkvFn {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dk, *dv;
  Launch a;
  template <typename T, int DC>
  int operator()() const {
    return dkv<T, DC>(q, k, v, dout, lse, delta, dk, dv, a);
  }
};

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v, out: contiguous [B, T, H, D]
// in dtype; lse: float32 [B*H, T]. route (0 = CUDA cores, 1 = tensor
// cores) and rows (the q tile) are the host planner's, which must be
// fwd_route's and fwd_rows' choice: any other plan returns
// cudaErrorInvalidValue and launches nothing. Returns cudaGetLastError().
int t2r_flash_fwd(const void* q, const void* k, const void* v, void* out,
                  void* lse, int dtype, int B, int T, int H, int D,
                  int causal, float scale, int route, int rows,
                  void* stream) {
  if (D < 8 || D > 128 || D % 8 != 0 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool aligned =
      aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);
  const int want = fwd_route(dtype, D, aligned);
  if (route != want || rows != fwd_rows(want, B * H, T)) {
    return (int)cudaErrorInvalidValue;
  }
  const Launch a{B, T, H, D, causal, scale,
                 static_cast<cudaStream_t>(stream)};
  if (route == kRouteMma) return fwd_tensor_cores(q, k, v, out, lse, a);
  if (dtype == 0) {
    return fwd_cuda_cores<float>(q, k, v, out, lse, a, rows, aligned);
  }
  return fwd_cuda_cores<__nv_bfloat16>(q, k, v, out, lse, a, rows, false);
}

// dout, dq: [B, T, H, D] in dtype; lse, delta: float32 [B*H, T].
int t2r_flash_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int dtype, int B, int T, int H, int D, int causal,
                 float scale, void* stream) {
  const Launch a{B, T, H, D, causal, scale,
                 static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, DqFn{q, k, v, dout, lse, delta, dq, a});
}

// dk, dv: [B, T, H, D] in dtype.
int t2r_flash_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int dtype, int B, int T, int H, int D,
                  int causal, float scale, void* stream) {
  const Launch a{B, T, H, D, causal, scale,
                 static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, DkvFn{q, k, v, dout, lse, delta, dk, dv, a});
}

const char* t2r_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
