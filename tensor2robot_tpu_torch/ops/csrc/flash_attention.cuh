// Flash attention on [B, T, H, D] tensors: what the forward
// (flash_attention.cu: out and logsumexp) and the FlashAttention-2 backward
// (flash_attention_bwd.cu: dq and dk/dv, two kernels) share. The plans'
// constants, the head geometry and the causal mask, the asynchronous
// copies, the mma.sync fragments and the launch helpers. Each source builds
// into a library of its own (ops/_build.py, one nvcc each, in parallel) and
// includes this header once; the build's cache key covers it.
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
//     tensor-core routes round the scores' second operands to bfloat16: p
//     for P.V in the forward (l sums the float32 p, so lse is unaffected),
//     dS for dS.K, P^T and dS^T for P^T.dO and dS^T.Q in the backward.
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

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // rows of every streamed tile
constexpr int kThreads = 256;  // 16 x 16 threads on the CUDA cores
constexpr float kNegInf = -1e30f;
// The plans (mirrored by ops/flash_attention.fwd_plan and bwd_plan).
constexpr int kRouteCudaCores = 0;
constexpr int kRouteMma = 1;
constexpr int kStages = 2;       // K/V tiles in shared memory: this and next
constexpr int kSms = 132;        // H100 SXM
constexpr int kBlocksPerSm = 2;  // a plan's grid aims at this many per SM
constexpr int kMmaWarps = 4;     // 64 q rows a block on the tensor cores
constexpr int kMmaPad = 8;       // bf16 (16 bytes) after each shared row
constexpr int kCorePad = 4;      // floats (16 bytes) after each shared row
constexpr int kPStride = kTile + 2;  // floats per shared row of P

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

// ------------------------------------------------------------ staging

// Element i of a float32 or (bf16 != 0) bfloat16 tensor, as float32.
__device__ __forceinline__ float load_f32(const void* src, int64_t i,
                                          int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(src)[i])
              : static_cast<const float*>(src)[i];
}

// Rows [r0, r0 + rows) of a [B, T, H, D] operand into shared rows of
// `stride` floats, rows past T as zeros: 16-byte cp.async where the
// operands are aligned float32, else element loads converted to float32.
__device__ __forceinline__ void stage_core(const void* __restrict__ src,
                                           const Geometry& g, int r0,
                                           int rows, int stride, float* dst,
                                           int bf16, int async_copy) {
  const int dim = g.dim;
  if (async_copy) {
    const float* s = static_cast<const float*>(src);
    const int chunks = dim >> 2;
    for (int c = threadIdx.x; c < rows * chunks; c += kThreads) {
      const int r = c / chunks;
      const int col = (c - r * chunks) << 2;
      const int t = r0 + r;
      const bool live = t < g.seq;
      cp_async16(dst + r * stride + col,
                 s + g.base + (int64_t)(live ? t : 0) * g.row + col,
                 live ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * dim; e += kThreads) {
      const int r = e / dim;
      const int c = e - r * dim;
      const int t = r0 + r;
      dst[r * stride + c] =
          t < g.seq ? load_f32(src, g.base + (int64_t)t * g.row + c, bf16)
                    : 0.f;
    }
  }
}

// Rows [r0, r0 + rows) of a bfloat16 operand into shared rows of D + kMmaPad,
// 16 bytes a copy, by the kMmaWarps warps of a tensor-core block; rows past
// T are zero-filled and read nothing.
template <int D>
__device__ __forceinline__ void stage_mma(const __nv_bfloat16* __restrict__ src,
                                          const Geometry& g, int r0, int rows,
                                          __nv_bfloat16* dst) {
  constexpr int kStride = D + kMmaPad;
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < rows * kChunks; c += kMmaWarps * 32) {
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * 8;
    const int t = r0 + r;
    const bool live = t < g.seq;
    cp_async16(dst + r * kStride + col,
               src + g.base + (int64_t)(live ? t : 0) * g.row + col,
               live ? 16 : 0);
  }
}

// acc + a.b, four FMAs in a fixed order.
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The q tile of block `block` of a grid over nq q tiles and bh heads (the
// forward's and dq's): tile-major, so under the causal mask the heaviest
// tiles (the last, which see the most keys) of every head launch first.
__device__ __forceinline__ int fwd_q_tile(int block, int nq, int bh,
                                          int causal) {
  const int rank = block / bh;
  return causal ? nq - 1 - rank : rank;
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

struct Launch {
  int batch, seq, heads, dim, causal;
  float scale;
  cudaStream_t stream;
  // Every kernel's grid: one block per (tile of `rows`, B*H), tile-major.
  dim3 grid(int rows) const {
    return dim3((unsigned)(((seq + rows - 1) / rows) * batch * heads));
  }
};

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace
