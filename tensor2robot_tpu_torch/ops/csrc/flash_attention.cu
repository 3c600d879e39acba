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
//   * the forward scales q by 1/sqrt(D) before q.k; the backward scales the
//     raw q.k scores, and again dq and dk at the end;
//   * p = exp(s - lse), ds = p * (dO.v - delta) with delta = rowsum(dO*O)
//     computed by the caller;
//   * inputs are float32 or bfloat16; everything accumulates in float32 and
//     rounds once to the input dtype on the way out.
// Rows past T (a ragged last tile) load as zeros and are masked like
// causally hidden keys; they are never stored.
//
// Layout: q, k, v, out, dO, dq, dk, dv are contiguous [B, T, H, D] and are
// read through their strides (row t of head h of batch b starts at
// ((b*T + t)*H + h)*D), so no head fold copy is made. lse and delta are
// float32 [B*H, T].
//
// What bounds it on an H100: at the SNAIL shapes (D = 8 and 64) and at
// short T, bytes and launch latency; at long T, the O(T^2 D) operations.
// This first version runs those operations on the CUDA cores in float32
// (67 TFLOP/s peak, against 989 TFLOP/s bf16 on the tensor cores), so it is
// slow at long T by design; wgmma, TMA and warp specialisation are later
// work. Design, per kernel: one 256-thread block per (64-row tile, B*H);
// the block's own tile and the streamed tiles sit in shared memory as
// float32 (the streamed operand transposed, so a 16-byte read gives a
// thread its 4 columns of scores); each thread owns a 4x4 block of the
// 64x64 score tile and, for the output, 4 rows by ceil(D/16) columns
// strided by 16. Row maxima and sums reduce across the 16 threads of a row
// with warp shuffles. Each output element has exactly one writer and the
// loops run in a fixed order: no atomics, and a kernel run twice agrees
// bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // rows of every q and k/v tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ Geometry geometry(int seq, int heads, int dim) {
  const int bh = blockIdx.y;
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

// ------------------------------------------------------------- forward

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int seq, int heads, int dim,
                     int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                  // [64][D], q * scale
  float* kt = qs + kTile * dim;      // [D][64], k transposed
  float* vs = kt + dim * kTile;      // [64][D]
  float* ps = vs + kTile * dim;      // [64][64], p of the current tile
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const Geometry g = geometry(seq, heads, dim);
  const int qb = blockIdx.x;
  const int q0 = qb * kTile;

  load_tile(q, g, q0, scale, false, qs);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int nk = (seq + kTile - 1) / kTile;
  // Causal: only key tiles at or before this q tile's diagonal contribute.
  const int nk_eff = causal ? min(qb + 1, nk) : nk;
  for (int kb = 0; kb < nk_eff; ++kb) {
    const int k0 = kb * kTile;
    __syncthreads();  // the previous tile's kt/vs/ps reads are done
    load_tile(k, g, k0, 1.f, true, kt);
    load_tile(v, g, k0, 1.f, false, vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
    for (int d = 0; d < dim; ++d) {
      const float4 kk = *reinterpret_cast<const float4*>(&kt[d * kTile + tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = qs[(ty * 4 + i) * dim + d];
        s[i][0] += qv * kk.x;
        s[i][1] += qv * kk.y;
        s[i][2] += qv * kk.z;
        s[i][3] += qv * kk.w;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!visible(qpos, k0 + tx * 4 + j, seq, causal)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      // Rows with every key masked so far have m_new == -1e30: clamp the
      // subtrahend so exp(-1e30 - m_new) stays 0 instead of exp(0) = 1.
      const float m_sub = fmaxf(m_new, 0.5f * kNegInf);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_sub);
        ps[(ty * 4 + i) * kTile + tx * 4 + j] = p;
        psum += p;
      }
      const float corr = expf(m[i] - m_sub);
      l[i] = l[i] * corr + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < kTile; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * kTile + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const int d = tx + 16 * cc;
        if (d < dim) {
          const float vv = vs[c * dim + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][cc] += p[i] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= seq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      const int d = tx + 16 * cc;
      if (d < dim) out[g.base + (int64_t)t * g.row + d] = from_f32<T>(acc[i][cc] / li);
    }
    if (tx == 0) lse[(int64_t)blockIdx.y * seq + t] = m[i] + logf(li);
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

// Shared memory of each kernel, in floats, for head dim `dim`.
size_t fwd_smem(int dim) { return sizeof(float) * (3 * kTile * dim + kTile * kTile); }
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

struct Launch {
  int batch, seq, heads, dim, causal;
  float scale;
  cudaStream_t stream;
  dim3 grid() const {
    return dim3((seq + kTile - 1) / kTile, batch * heads);
  }
};

template <typename T, int DC>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        const Launch& a) {
  const size_t smem = fwd_smem(a.dim);
  auto kernel = flash_fwd_kernel<T, DC>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.grid(), kThreads, smem, a.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), a.seq, a.heads, a.dim, a.causal, a.scale);
  return (int)cudaGetLastError();
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

struct FwdFn {
  const void *q, *k, *v;
  void *out, *lse;
  Launch a;
  template <typename T, int DC>
  int operator()() const { return fwd<T, DC>(q, k, v, out, lse, a); }
};

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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v, out: contiguous [B, T, H, D]
// in dtype; lse: float32 [B*H, T]. Returns cudaGetLastError().
int t2r_flash_fwd(const void* q, const void* k, const void* v, void* out,
                  void* lse, int dtype, int B, int T, int H, int D,
                  int causal, float scale, void* stream) {
  const Launch a{B, T, H, D, causal, scale,
                 static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, FwdFn{q, k, v, out, lse, a});
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
