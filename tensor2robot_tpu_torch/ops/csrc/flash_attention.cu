// Flash attention's forward on [B, T, H, D] tensors: out and the float32
// logsumexp. The semantics, the layout and the helpers it shares with the
// backward (flash_attention_bwd.cu) are in flash_attention.cuh.
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

#include "flash_attention.cuh"

namespace {

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

  const int nk = (seq + kTile - 1) / kTile;
  // Causal: only key tiles at or before this q tile's diagonal contribute.
  const int nk_eff = causal ? min((q0 + kRows + kTile - 1) / kTile, nk) : nk;
  const int bf16 = sizeof(T) == sizeof(__nv_bfloat16);
  stage_core(q, g, q0, kRows, stride, qs, bf16, async_copy);
  stage_core(k, g, 0, kTile, stride, ks, bf16, async_copy);
  stage_core(v, g, 0, kTile, stride, vs, bf16, async_copy);
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
      stage_core(k, g, (kb + 1) * kTile, kTile, stride, ks + next, bf16,
                 async_copy);
      stage_core(v, g, (kb + 1) * kTile, kTile, stride, vs + next, bf16,
                 async_copy);
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
        for (int i = 0; i < RQ; ++i) s[i][j] = dot4(qv[i], kv, s[i][j]);
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

  const int nk = (seq + kTile - 1) / kTile;
  const int nk_eff = causal ? min((q0 + kRows + kTile - 1) / kTile, nk) : nk;
  stage_mma<D>(q, g, q0, kRows, qs);
  stage_mma<D>(k, g, 0, kTile, ks);
  stage_mma<D>(v, g, 0, kTile, vs);
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
      stage_mma<D>(k, g, (kb + 1) * kTile, kTile, ks + next);
      stage_mma<D>(v, g, (kb + 1) * kTile, kTile, vs + next);
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

template <typename T, int RQ, int KS, int DC>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        const Launch& a, bool async_copy) {
  const size_t smem = fwd_smem(a.dim, 16 * RQ);
  auto kernel = flash_fwd_kernel<T, RQ, KS, DC>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.grid(16 * RQ), kThreads, smem, a.stream>>>(
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
  kernel<<<a.grid(16 * kMmaWarps), kMmaWarps * 32, smem, a.stream>>>(
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

const char* t2r_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
