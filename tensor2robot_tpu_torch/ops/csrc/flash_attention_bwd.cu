// Flash attention's FlashAttention-2 backward on [B, T, H, D] tensors: dq
// and dk/dv from the forward's logsumexp and delta = rowsum(dO * O). The
// semantics, the layout and the helpers it shares with the forward
// (flash_attention.cu) are in flash_attention.cuh.
//
// The backward (dq in a q-tile grid, dk/dv in a key-tile grid, so every
// output element has one writer and no atomics) takes the forward's routes,
// chosen by fwd_route and bwd_rows and mirrored on the host by
// ops/flash_attention.bwd_plan (both entry points refuse a plan that
// differs):
//   * mma: flash_dq_mma_kernel and flash_dkv_mma_kernel, 4 warps of 16 rows
//     (q rows for dq, key rows for dk/dv) whose operands (Q and dO, or K and
//     V) sit in shared memory and enter mma.sync m16n8k16 as ldmatrix A
//     fragments; the streamed 64-row tiles (K and V, or Q and dO with their
//     lse and delta) come by cp.async through the forward's two-stage ring.
//     S and dP (or S^T and dP^T) stay in float32 registers; p = 2^(s scale
//     log2 e - lse log2 e); dS = p (dP - delta) and, for dk/dv, P^T are
//     rounded to bf16 in registers as the A fragments of the second products
//     (dQ += dS.K, dV += P^T.dO, dK += dS^T.Q), whose col operand comes by
//     ldmatrix.trans: no score tile passes through shared memory. dq runs
//     its heaviest causal q tile first, dk/dv its key tile 0 first (every q
//     tile sees it).
//   * cuda_cores (float32, the SNAIL paths; bfloat16 with other head dims or
//     unaligned operands): 256 threads, tiles of 16, 32 or 64 rows planned
//     per shape so the grid covers the SMs and two blocks share an SM, each
//     operand staged once as float32 (16-byte cp.async for aligned float32,
//     the next streamed tile in flight), each thread 1, 2 or 4 rows by 4
//     columns of the score tile, dS (and P^T) through shared memory, and at
//     D = 8 the two halves of a row's 16 lanes split the keys (or queries)
//     of the second products.
// What bounds them on an H100: at the SNAIL shapes the latency of the
// causal loop's tiles in sequence; at long T the rate at which a warp
// issues its mma.sync and exponentials in turn (PERF.md records the
// times).

#include "flash_attention.cuh"

namespace {

// The backward's CUDA-core plan takes 32- or 64-row tiles only where two
// blocks (each with its 1 KB reserve) fit an H100 SM's 228 KB of shared
// memory.
constexpr int kTwoBlockSmem = 113 * 1024;

// ------------------------------------------------------ backward, shared

// Element i of a float32 or (bf16 != 0) bfloat16 tensor, from float32.
__device__ __forceinline__ void store_f32(void* dst, int64_t i, float x,
                                          int bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(dst)[i] = __float2bfloat16(x);
  } else {
    static_cast<float*>(dst)[i] = x;
  }
}

// 4 bytes from global to shared memory by cp.async; src_bytes = 0 writes a
// zero and reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_address(dst)),
               "l"(src), "r"(src_bytes));
}

// Rows [r0, r0 + rows) of a float32 [B*H, T] statistic (lse, delta) of head
// bh into shared memory by 4-byte cp.async, rows past T as zeros; `threads`
// threads share the copies.
__device__ __forceinline__ void stage_stat(const float* __restrict__ src,
                                           int bh, int seq, int r0, int rows,
                                           int threads, float* dst) {
  for (int r = threadIdx.x; r < rows; r += threads) {
    const int t = r0 + r;
    const bool live = t < seq;
    cp_async4(dst + r, src + (int64_t)bh * seq + (live ? t : 0),
              live ? 4 : 0);
  }
}

// ------------------------------------------------------ dq, CUDA cores

// Thread (ty, tx) of 16 x 16 owns q rows ty * RQ + i of the q tile (16 * RQ
// rows) and keys tx + 16 j (j < 4) of each 64-key tile in S = Q.K^T and
// dP = dO.V^T; dS goes through shared memory, and in dQ += dS.K the 16
// lanes of a row split into KS groups as in flash_fwd_kernel. The launch
// bounds state the plan's two blocks an SM: without them ptxas held the
// SNAIL instantiations to 64 registers and spilled.
template <int RQ, int KS, int DC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    flash_dq_kernel(const void* __restrict__ q, const void* __restrict__ k,
                    const void* __restrict__ v, const void* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, void* __restrict__ dq,
                    int seq, int heads, int dim, int causal, float scale,
                    int bf16, int async_copy) {
  constexpr int kRows = 16 * RQ;
  constexpr int kLanes = 16 / KS;
  const int stride = dim + kCorePad;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                            // [kRows][stride]
  float* dos = qs + kRows * stride;            // [kRows][stride]
  float* ks = dos + kRows * stride;            // [kStages][64][stride]
  float* vs = ks + kStages * kTile * stride;   // [kStages][64][stride]
  float* dss = vs + kStages * kTile * stride;  // [kRows][kPStride], dS
  float* lse_s = dss + kRows * kPStride;       // [kRows]
  float* delta_s = lse_s + kRows;              // [kRows]
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int nq = (seq + kRows - 1) / kRows;
  const int heads_total = gridDim.x / nq;  // B * H
  const int bh = blockIdx.x % heads_total;
  const Geometry g = head_geometry(bh, seq, heads, dim);
  const int q0 = fwd_q_tile(blockIdx.x, nq, heads_total, causal) * kRows;
  const int nk = (seq + kTile - 1) / kTile;
  const int nk_eff = causal ? min((q0 + kRows + kTile - 1) / kTile, nk) : nk;

  stage_core(q, g, q0, kRows, stride, qs, bf16, async_copy);
  stage_core(dout, g, q0, kRows, stride, dos, bf16, async_copy);
  stage_stat(lse, bh, seq, q0, kRows, kThreads, lse_s);
  stage_stat(delta, bh, seq, q0, kRows, kThreads, delta_s);
  stage_core(k, g, 0, kTile, stride, ks, bf16, async_copy);
  stage_core(v, g, 0, kTile, stride, vs, bf16, async_copy);
  cp_async_commit();

  float acc[RQ][DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  const int col0 = tx % kLanes;
  const int part = tx / kLanes;

  for (int kb = 0; kb < nk_eff; ++kb) {
    cp_async_wait_all();
    __syncthreads();  // tile kb is in; every thread is done with tile kb - 1
    if (kb + 1 < nk_eff) {
      const int next = ((kb + 1) & 1) * kTile * stride;
      stage_core(k, g, (kb + 1) * kTile, kTile, stride, ks + next, bf16,
                 async_copy);
      stage_core(v, g, (kb + 1) * kTile, kTile, stride, vs + next, bf16,
                 async_copy);
      cp_async_commit();
    }
    const int k0 = kb * kTile;
    const float* kst = ks + (kb & 1) * kTile * stride;
    const float* vst = vs + (kb & 1) * kTile * stride;

    float s[RQ][4], dp[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    }
#pragma unroll 2
    for (int d = 0; d < dim; d += 4) {
      float4 qv[RQ], ov[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(
            &qs[(ty * RQ + i) * stride + d]);
        ov[i] = *reinterpret_cast<const float4*>(
            &dos[(ty * RQ + i) * stride + d]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(&kst[(tx + 16 * j) * stride + d]);
        const float4 vv =
            *reinterpret_cast<const float4*>(&vst[(tx + 16 * j) * stride + d]);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          s[i][j] = dot4(qv[i], kv, s[i][j]);
          dp[i][j] = dot4(ov[i], vv, dp[i][j]);
        }
      }
    }

    // p = exp(s scale - lse), 0 where masked (only a tile past T or across
    // the diagonal needs the mask); ds = p (dp - delta).
    const bool edge = k0 + kTile > seq || (causal && k0 + kTile - 1 > q0);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + 16 * j;
        float p = expf(s[i][j] * scale - lse_s[r]);
        if (edge && !visible(q0 + r, k0 + key, seq, causal)) p = 0.f;
        dss[r * kPStride + key] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();  // ds of the tile is in

    // Keys past T and, causal, right of the tile's last row have ds = 0:
    // the sum skips them.
    const int keys = min(min(kTile, seq - k0),
                         causal ? q0 + kRows - k0 : kTile);
#pragma unroll 8
    for (int key = part; key < keys; key += KS) {
      float ds[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) ds[i] = dss[(ty * RQ + i) * kPStride + key];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = col0 + kLanes * c;
        if (d < dim) {
          const float kv = kst[key * stride + d];
#pragma unroll
          for (int i = 0; i < RQ; ++i) acc[i][c] = fmaf(ds[i], kv, acc[i][c]);
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
  if (part != 0) return;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int t = q0 + ty * RQ + i;
    if (t >= seq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = col0 + kLanes * c;
      if (d < dim) {
        store_f32(dq, g.base + (int64_t)t * g.row + d, acc[i][c] * scale,
                  bf16);
      }
    }
  }
}

// --------------------------------------------------- dk/dv, CUDA cores

// Thread (ty, tx) of 16 x 16 owns key rows ty * RK + i of the key tile
// (16 * RK rows) and queries tx + 16 j (j < 4) of each 64-row q tile in
// S^T = K.Q^T and dP^T = V.dO^T; P^T and dS^T go through shared memory, and
// in dV += P^T.dO and dK += dS^T.Q the 16 lanes of a row split into KS
// groups over the queries.
template <int RK, int KS, int DC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    flash_dkv_kernel(const void* __restrict__ q, const void* __restrict__ k,
                     const void* __restrict__ v,
                     const void* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, void* __restrict__ dk,
                     void* __restrict__ dv, int seq, int heads, int dim,
                     int causal, float scale, int bf16, int async_copy) {
  constexpr int kRows = 16 * RK;
  constexpr int kLanes = 16 / KS;
  const int stride = dim + kCorePad;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ks = smem;                             // [kRows][stride]
  float* vs = ks + kRows * stride;              // [kRows][stride]
  float* qs = vs + kRows * stride;              // [kStages][64][stride]
  float* dos = qs + kStages * kTile * stride;   // [kStages][64][stride]
  float* pt = dos + kStages * kTile * stride;   // [kRows][kPStride], P^T
  float* dst = pt + kRows * kPStride;           // [kRows][kPStride], dS^T
  float* lse_s = dst + kRows * kPStride;        // [kStages][64]
  float* delta_s = lse_s + kStages * kTile;     // [kStages][64]
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int nk = (seq + kRows - 1) / kRows;
  const int heads_total = gridDim.x / nk;  // B * H
  const int bh = blockIdx.x % heads_total;
  const Geometry g = head_geometry(bh, seq, heads, dim);
  // Key tiles launch in ascending order: under the causal mask tile 0,
  // which every q tile sees, is the heaviest.
  const int k0 = (blockIdx.x / heads_total) * kRows;
  const int nq = (seq + kTile - 1) / kTile;
  // Causal: only q tiles at or after this key tile's diagonal contribute.
  const int first = causal ? k0 / kTile : 0;

  auto stage_q_tile = [&](int qb, int buf) {
    stage_core(q, g, qb * kTile, kTile, stride, qs + buf * kTile * stride,
               bf16, async_copy);
    stage_core(dout, g, qb * kTile, kTile, stride,
               dos + buf * kTile * stride, bf16, async_copy);
    stage_stat(lse, bh, seq, qb * kTile, kTile, kThreads,
               lse_s + buf * kTile);
    stage_stat(delta, bh, seq, qb * kTile, kTile, kThreads,
               delta_s + buf * kTile);
  };
  stage_core(k, g, k0, kRows, stride, ks, bf16, async_copy);
  stage_core(v, g, k0, kRows, stride, vs, bf16, async_copy);
  stage_q_tile(first, 0);
  cp_async_commit();

  float dk_acc[RK][DC], dv_acc[RK][DC];
#pragma unroll
  for (int i = 0; i < RK; ++i) {
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  }
  const int col0 = tx % kLanes;
  const int part = tx / kLanes;

  for (int qb = first; qb < nq; ++qb) {
    const int buf = (qb - first) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile qb is in; every thread is done with tile qb - 1
    if (qb + 1 < nq) {
      stage_q_tile(qb + 1, buf ^ 1);
      cp_async_commit();
    }
    const int q0 = qb * kTile;
    const float* qst = qs + buf * kTile * stride;
    const float* dost = dos + buf * kTile * stride;
    const float* lst = lse_s + buf * kTile;
    const float* dlt = delta_s + buf * kTile;

    float s[RK][4], dp[RK][4];
#pragma unroll
    for (int i = 0; i < RK; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    }
#pragma unroll 2
    for (int d = 0; d < dim; d += 4) {
      float4 kv[RK], vv[RK];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        kv[i] = *reinterpret_cast<const float4*>(
            &ks[(ty * RK + i) * stride + d]);
        vv[i] = *reinterpret_cast<const float4*>(
            &vs[(ty * RK + i) * stride + d]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&qst[(tx + 16 * j) * stride + d]);
        const float4 ov = *reinterpret_cast<const float4*>(
            &dost[(tx + 16 * j) * stride + d]);
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          s[i][j] = dot4(kv[i], qv, s[i][j]);
          dp[i][j] = dot4(vv[i], ov, dp[i][j]);
        }
      }
    }

    // Only a tile past T (whose lse and delta were not loaded) or across
    // the diagonal needs the mask.
    const bool edge = q0 + kTile > seq || (causal && k0 + kRows - 1 > q0);
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const int r = ty * RK + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        float p = expf(s[i][j] * scale - lst[col]);
        if (edge && !visible(q0 + col, k0 + r, seq, causal)) p = 0.f;
        pt[r * kPStride + col] = p;
        dst[r * kPStride + col] = p * (dp[i][j] - dlt[col]);
      }
    }
    __syncthreads();  // p^T and ds^T of the tile are in

    // Queries past T and, causal, before the tile's first key have p^T =
    // ds^T = 0: the sums skip them.
    const int r_end = min(kTile, seq - q0);
#pragma unroll 8
    for (int r = (causal ? max(k0 - q0, 0) : 0) + part; r < r_end; r += KS) {
      float p[RK], ds[RK];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        p[i] = pt[(ty * RK + i) * kPStride + r];
        ds[i] = dst[(ty * RK + i) * kPStride + r];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = col0 + kLanes * c;
        if (d < dim) {
          const float ov = dost[r * stride + d];
          const float qv = qst[r * stride + d];
#pragma unroll
          for (int i = 0; i < RK; ++i) {
            dv_acc[i][c] = fmaf(p[i], ov, dv_acc[i][c]);
            dk_acc[i][c] = fmaf(ds[i], qv, dk_acc[i][c]);
          }
        }
      }
    }
  }

  if (KS > 1) {
#pragma unroll
    for (int i = 0; i < RK; ++i) {
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dk_acc[i][c] += __shfl_xor_sync(0xffffffffu, dk_acc[i][c], kLanes);
        dv_acc[i][c] += __shfl_xor_sync(0xffffffffu, dv_acc[i][c], kLanes);
      }
    }
  }
  if (part != 0) return;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int t = k0 + ty * RK + i;
    if (t >= seq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = col0 + kLanes * c;
      if (d < dim) {
        const int64_t at = g.base + (int64_t)t * g.row + d;
        store_f32(dk, at, dk_acc[i][c] * scale, bf16);
        store_f32(dv, at, dv_acc[i][c], bf16);
      }
    }
  }
}

// ---------------------------------------------------- dq, tensor cores

// Warp w owns q rows q0 + 16 w ... + 15, lane l fragment rows l / 4 and
// l / 4 + 8 and column pair l % 4, as in flash_fwd_mma_kernel. Per 64-key
// tile: S = Q.K^T and dP = dO.V^T with K and V as col operands (ldmatrix),
// Q and dO A fragments read from the block's shared rows; P and dS in
// float32 registers; dS, rounded to bf16, is the A fragment of dQ += dS.K
// with K read by ldmatrix.trans.
template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
    flash_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int seq, int heads,
                        int causal, float scale) {
  constexpr int kRows = 16 * kMmaWarps;
  constexpr int kStride = D + kMmaPad;  // bf16 per shared row
  constexpr int kChunks = D / 8;        // 16-byte chunks per row
  constexpr int kKSteps = D / 16;       // k16 steps of Q.K^T
  constexpr int kDTiles = D / 8;        // n8 tiles of dq
  extern __shared__ uint4 smem_mma[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* dos = qs + kRows * kStride;           // [64][kStride]
  __nv_bfloat16* ks = dos + kRows * kStride;           // [kStages][64][kStride]
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
  stage_mma<D>(dout, g, q0, kRows, dos);
  stage_mma<D>(k, g, 0, kTile, ks);
  stage_mma<D>(v, g, 0, kTile, vs);
  cp_async_commit();

  // lse (times log2 e, so p = 2^(s scale log2 e - lse log2 e) costs one
  // FFMA and one MUFU.EX2) and delta of the lane's rows; 0 past T.
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow + fr + 8 * h;
    const bool live = row < seq;
    lse2[h] = live ? lse[(int64_t)bh * seq + row] * kLog2e : 0.f;
    dlt[h] = live ? delta[(int64_t)bh * seq + row] : 0.f;
  }
  float acc[kDTiles][4];
#pragma unroll
  for (int t = 0; t < kDTiles; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  }

  for (int kb = 0; kb < nk_eff; ++kb) {
    cp_async_wait_all();
    __syncthreads();  // tile kb is in; every warp is done with tile kb - 1
    if (kb + 1 < nk_eff) {
      const int next = ((kb + 1) & 1) * kTile * kStride;
      stage_mma<D>(k, g, (kb + 1) * kTile, kTile, ks + next);
      stage_mma<D>(v, g, (kb + 1) * kTile, kTile, vs + next);
      cp_async_commit();
    }
    const int k0 = kb * kTile;
    // Causal: a tile wholly right of this warp's last row adds nothing.
    if (causal && k0 > wrow + 15) continue;
    const __nv_bfloat16* kst = ks + (kb & 1) * kTile * kStride;
    const __nv_bfloat16* vst = vs + (kb & 1) * kTile * kStride;

    // S = Q.K^T and dP = dO.V^T, 16 x 64 a warp: n8 tile j holds keys
    // 8 j ... 8 j + 7.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      unsigned qa[4], oa[4];
      const int a_at = (16 * warp + (lane & 15)) * kStride + 16 * kk +
                       8 * (lane >> 4);
      ldmatrix_x4(qa, qs + a_at);
      ldmatrix_x4(oa, dos + a_at);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        // Matrices: keys 16 jp + {0..7, 0..7, 8..15, 8..15}, dims
        // 16 kk + {0..7, 8..15, 0..7, 8..15}: b0, b1 of tiles 2 jp, 2 jp + 1.
        const int b_at = (16 * jp + 8 * (lane >> 4) + (lane & 7)) * kStride +
                         16 * kk + 8 * ((lane >> 3) & 1);
        unsigned r[4];
        ldmatrix_x4(r, kst + b_at);
        mma_bf16_16816(s[2 * jp], qa, r[0], r[1]);
        mma_bf16_16816(s[2 * jp + 1], qa, r[2], r[3]);
        ldmatrix_x4(r, vst + b_at);
        mma_bf16_16816(dp[2 * jp], oa, r[0], r[1]);
        mma_bf16_16816(dp[2 * jp + 1], oa, r[2], r[3]);
      }
    }

    // ds = p (dp - delta) in float32, in place of s; p = 0 where masked
    // (only a tile past T or across this warp's diagonal needs the mask).
    const bool edge = k0 + kTile > seq || (causal && k0 + kTile - 1 > wrow);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = exp2f(fmaf(s[j][e], scale_log2, -lse2[h]));
        if (edge) {
          const int kpos = k0 + 8 * j + fc + (e & 1);
          const int qpos = wrow + fr + 8 * h;
          if (kpos >= seq || (causal && kpos > qpos)) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - dlt[h]);
      }
    }

    // dQ += dS.K: dS in bf16 from the fragments, 16 keys a step; K as the
    // col operand by ldmatrix.trans (matrices: keys 16 kk + {0..7, 8..15,
    // 0..7, 8..15}, dims 16 dp + {0..7, 0..7, 8..15, 8..15}).
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp2 = 0; dp2 < kDTiles / 2; ++dp2) {
        unsigned r[4];
        ldmatrix_x4_trans(
            r, kst + (16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7)) * kStride +
                   16 * dp2 + 8 * (lane >> 4));
        mma_bf16_16816(acc[2 * dp2], a, r[0], r[1]);
        mma_bf16_16816(acc[2 * dp2 + 1], a, r[2], r[3]);
      }
    }
  }

  // dq x scale through the warp's own rows of the q tile (no other warp
  // reads them) into 16-byte row-contiguous stores.
  __nv_bfloat16* os = qs + 16 * warp * kStride;
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int t = 0; t < kDTiles; ++t) {
      *reinterpret_cast<unsigned*>(os + (fr + 8 * h) * kStride + 8 * t + fc) =
          pack_bf16(acc[t][2 * h] * scale, acc[t][2 * h + 1] * scale);
    }
  }
  __syncwarp();
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * 8;
    const int t = wrow + r;
    if (t < seq) {
      *reinterpret_cast<uint4*>(dq + g.base + (int64_t)t * g.row + col) =
          *reinterpret_cast<const uint4*>(os + r * kStride + col);
    }
  }
}

// ------------------------------------------------- dk/dv, tensor cores

// Warp w owns key rows k0 + 16 w ... + 15. Per 64-row q tile: S^T = K.Q^T
// and dP^T = V.dO^T with Q and dO as col operands (ldmatrix), K and V A
// fragments read from the block's shared rows; P^T and dS^T in float32
// registers, lse and delta indexed by the fragment's column (the query);
// both, rounded to bf16, are the A fragments of dV += P^T.dO and
// dK += dS^T.Q with dO and Q read by ldmatrix.trans.
template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
    flash_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int seq, int heads,
                         int causal, float scale) {
  constexpr int kRows = 16 * kMmaWarps;
  constexpr int kStride = D + kMmaPad;
  constexpr int kChunks = D / 8;
  constexpr int kKSteps = D / 16;
  constexpr int kDTiles = D / 8;
  extern __shared__ uint4 smem_mma[];
  // K and V [64][kStride]; the ring of Q and dO [kStages][64][kStride];
  // the ring's lse and delta, float32 [kStages][64].
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* vs = ks + kRows * kStride;
  __nv_bfloat16* qs = vs + kRows * kStride;
  __nv_bfloat16* dos = qs + kStages * kTile * kStride;
  float* lse_s = reinterpret_cast<float*>(dos + kStages * kTile * kStride);
  float* delta_s = lse_s + kStages * kTile;

  const int nk = (seq + kRows - 1) / kRows;
  const int heads_total = gridDim.x / nk;  // B * H
  const int bh = blockIdx.x % heads_total;
  const Geometry g = head_geometry(bh, seq, heads, D);
  // Ascending key tiles: under the causal mask tile 0 is the heaviest.
  const int k0 = (blockIdx.x / heads_total) * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int fr = lane >> 2;
  const int fc = 2 * (lane & 3);
  const int wkey = k0 + 16 * warp;
  const float scale_log2 = scale * kLog2e;
  const int nq = (seq + kTile - 1) / kTile;
  // Causal: only q tiles at or after this key tile's diagonal contribute.
  const int first = causal ? k0 / kTile : 0;

  auto stage_q_tile = [&](int qb, int buf) {
    stage_mma<D>(q, g, qb * kTile, kTile, qs + buf * kTile * kStride);
    stage_mma<D>(dout, g, qb * kTile, kTile, dos + buf * kTile * kStride);
    stage_stat(lse, bh, seq, qb * kTile, kTile, kMmaWarps * 32,
               lse_s + buf * kTile);
    stage_stat(delta, bh, seq, qb * kTile, kTile, kMmaWarps * 32,
               delta_s + buf * kTile);
  };
  stage_mma<D>(k, g, k0, kRows, ks);
  stage_mma<D>(v, g, k0, kRows, vs);
  stage_q_tile(first, 0);
  cp_async_commit();

  float dk_acc[kDTiles][4], dv_acc[kDTiles][4];
#pragma unroll
  for (int t = 0; t < kDTiles; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[t][e] = dv_acc[t][e] = 0.f;
  }

  for (int qb = first; qb < nq; ++qb) {
    const int buf = (qb - first) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile qb is in; every warp is done with tile qb - 1
    if (qb + 1 < nq) {
      stage_q_tile(qb + 1, buf ^ 1);
      cp_async_commit();
    }
    const int q0 = qb * kTile;
    const __nv_bfloat16* qst = qs + buf * kTile * kStride;
    const __nv_bfloat16* dost = dos + buf * kTile * kStride;
    const float* lst = lse_s + buf * kTile;
    const float* dlst = delta_s + buf * kTile;

    // S^T = K.Q^T and dP^T = V.dO^T, 16 keys x 64 queries a warp: n8 tile
    // j holds queries 8 j ... 8 j + 7.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      unsigned ka[4], va[4];
      const int a_at = (16 * warp + (lane & 15)) * kStride + 16 * kk +
                       8 * (lane >> 4);
      ldmatrix_x4(ka, ks + a_at);
      ldmatrix_x4(va, vs + a_at);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        const int b_at = (16 * jp + 8 * (lane >> 4) + (lane & 7)) * kStride +
                         16 * kk + 8 * ((lane >> 3) & 1);
        unsigned r[4];
        ldmatrix_x4(r, qst + b_at);
        mma_bf16_16816(s[2 * jp], ka, r[0], r[1]);
        mma_bf16_16816(s[2 * jp + 1], ka, r[2], r[3]);
        ldmatrix_x4(r, dost + b_at);
        mma_bf16_16816(dp[2 * jp], va, r[0], r[1]);
        mma_bf16_16816(dp[2 * jp + 1], va, r[2], r[3]);
      }
    }

    // p^T in place of s, ds^T = p^T (dp^T - delta) in place of dp, in
    // float32; p^T = 0 where masked and past T, whose lse and delta were
    // not loaded (only a tile past T or across this warp's diagonal needs
    // the mask).
    const bool edge = q0 + kTile > seq || (causal && wkey + 15 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lst + 8 * j + fc);
      const float2 d2 = *reinterpret_cast<const float2*>(dlst + 8 * j + fc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l = (e & 1) ? l2.y : l2.x;
        float p = exp2f(fmaf(s[j][e], scale_log2, -l * kLog2e));
        if (edge) {
          const int qpos = q0 + 8 * j + fc + (e & 1);
          const int kpos = wkey + fr + 8 * (e >> 1);
          if (qpos >= seq || (causal && kpos > qpos)) p = 0.f;
        }
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - ((e & 1) ? d2.y : d2.x));
      }
    }

    // dV += P^T.dO and dK += dS^T.Q: 16 queries a step; dO and Q as the
    // col operand by ldmatrix.trans (matrices: queries 16 kk + {0..7,
    // 8..15, 0..7, 8..15}, dims 16 dp + {0..7, 0..7, 8..15, 8..15}).
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const unsigned da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int dp2 = 0; dp2 < kDTiles / 2; ++dp2) {
        const int b_at =
            (16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7)) * kStride +
            16 * dp2 + 8 * (lane >> 4);
        unsigned r[4];
        ldmatrix_x4_trans(r, dost + b_at);
        mma_bf16_16816(dv_acc[2 * dp2], pa, r[0], r[1]);
        mma_bf16_16816(dv_acc[2 * dp2 + 1], pa, r[2], r[3]);
        ldmatrix_x4_trans(r, qst + b_at);
        mma_bf16_16816(dk_acc[2 * dp2], da, r[0], r[1]);
        mma_bf16_16816(dk_acc[2 * dp2 + 1], da, r[2], r[3]);
      }
    }
  }

  // dk x scale and dv through the warp's own rows of the K and V tiles (no
  // other warp reads them) into 16-byte row-contiguous stores.
  __nv_bfloat16* ko = ks + 16 * warp * kStride;
  __nv_bfloat16* vo = vs + 16 * warp * kStride;
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int t = 0; t < kDTiles; ++t) {
      const int at = (fr + 8 * h) * kStride + 8 * t + fc;
      *reinterpret_cast<unsigned*>(ko + at) =
          pack_bf16(dk_acc[t][2 * h] * scale, dk_acc[t][2 * h + 1] * scale);
      *reinterpret_cast<unsigned*>(vo + at) =
          pack_bf16(dv_acc[t][2 * h], dv_acc[t][2 * h + 1]);
    }
  }
  __syncwarp();
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * 8;
    const int t = wkey + r;
    if (t < seq) {
      const int64_t at = g.base + (int64_t)t * g.row + col;
      *reinterpret_cast<uint4*>(dk + at) =
          *reinterpret_cast<const uint4*>(ko + r * kStride + col);
      *reinterpret_cast<uint4*>(dv + at) =
          *reinterpret_cast<const uint4*>(vo + r * kStride + col);
    }
  }
}

// A backward kernel's (dk/dv if dkv, else dq) with tiles of `rows` on
// `route`: the block's two operands (Q and dO, or K and V) and the ring of
// the two streamed ones, in bf16 on the tensor cores (dk/dv adds the
// ring's lse and delta), in float32 on the CUDA cores plus dS (dq) or P^T
// and dS^T (dk/dv) and the statistics.
size_t bwd_smem(bool dkv, int route, int dim, int rows) {
  const size_t operands = (size_t)(2 * rows + 2 * kStages * kTile);
  if (route == kRouteMma) {
    return sizeof(__nv_bfloat16) * operands * (dim + kMmaPad) +
           (dkv ? sizeof(float) * 2 * kStages * kTile : 0);
  }
  const size_t scores = (size_t)(dkv ? 2 : 1) * rows * kPStride;
  const size_t stats = dkv ? 2 * kStages * kTile : 2 * rows;
  return sizeof(float) * (operands * (dim + kCorePad) + scores + stats);
}

// The backward's tile rows: 64 (kMmaWarps warps) on the tensor cores; on
// the CUDA cores the tallest of 64 and 32 rows that gives kBlocksPerSm
// blocks an SM and lets two blocks share an SM's shared memory, else 16.
int bwd_rows(bool dkv, int route, int bh, int seq, int dim) {
  if (route == kRouteMma) return 16 * kMmaWarps;
  for (int rows = 64; rows >= 32; rows /= 2) {
    if ((int64_t)bh * ((seq + rows - 1) / rows) >=
            (int64_t)kBlocksPerSm * kSms &&
        bwd_smem(dkv, route, dim, rows) <= (size_t)kTwoBlockSmem) {
      return rows;
    }
  }
  return 16;
}

// The backward's operands.
struct Grads {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
};

template <int R, int KS, int DC>
int bwd_core(bool dkv, const Grads& p, const Launch& a, int bf16,
             int async_copy) {
  const size_t smem = bwd_smem(dkv, kRouteCudaCores, a.dim, 16 * R);
  const dim3 grid = a.grid(16 * R);
  if (dkv) {
    auto kernel = flash_dkv_kernel<R, KS, DC>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        p.q, p.k, p.v, p.dout, p.lse, p.delta, p.dk, p.dv, a.seq, a.heads,
        a.dim, a.causal, a.scale, bf16, async_copy);
  } else {
    auto kernel = flash_dq_kernel<R, KS, DC>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        p.q, p.k, p.v, p.dout, p.lse, p.delta, p.dq, a.seq, a.heads, a.dim,
        a.causal, a.scale, bf16, async_copy);
  }
  return (int)cudaGetLastError();
}

// KS = 2 query or key groups at D = 8, else 1; DC = columns a lane. The
// dtype is a kernel argument on the CUDA cores: it changes only how tiles
// are staged and results stored.
template <int R>
int bwd_core_dim(bool dkv, const Grads& p, const Launch& a, int bf16,
                 int async_copy) {
  if (a.dim == 8) return bwd_core<R, 2, 1>(dkv, p, a, bf16, async_copy);
#define T2R_BWD_CASE(DC) \
  case DC: return bwd_core<R, 1, DC>(dkv, p, a, bf16, async_copy);
  switch ((a.dim + 15) / 16) {
    T2R_BWD_CASE(1)
    T2R_BWD_CASE(2)
    T2R_BWD_CASE(3)
    T2R_BWD_CASE(4)
    T2R_BWD_CASE(5)
    T2R_BWD_CASE(6)
    T2R_BWD_CASE(7)
    T2R_BWD_CASE(8)
  }
#undef T2R_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

int bwd_cuda_cores(bool dkv, const Grads& p, const Launch& a, int rows,
                   int bf16, int async_copy) {
  switch (rows) {
    case 16: return bwd_core_dim<1>(dkv, p, a, bf16, async_copy);
    case 32: return bwd_core_dim<2>(dkv, p, a, bf16, async_copy);
    case 64: return bwd_core_dim<4>(dkv, p, a, bf16, async_copy);
  }
  return (int)cudaErrorInvalidValue;
}

template <int D>
int bwd_mma(bool dkv, const Grads& p, const Launch& a) {
  const size_t smem = bwd_smem(dkv, kRouteMma, D, 16 * kMmaWarps);
  const dim3 grid = a.grid(16 * kMmaWarps);
  auto bf = [](const void* x) {
    return static_cast<const __nv_bfloat16*>(x);
  };
  if (dkv) {
    auto kernel = flash_dkv_mma_kernel<D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kMmaWarps * 32, smem, a.stream>>>(
        bf(p.q), bf(p.k), bf(p.v), bf(p.dout), p.lse, p.delta,
        static_cast<__nv_bfloat16*>(p.dk), static_cast<__nv_bfloat16*>(p.dv),
        a.seq, a.heads, a.causal, a.scale);
  } else {
    auto kernel = flash_dq_mma_kernel<D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kMmaWarps * 32, smem, a.stream>>>(
        bf(p.q), bf(p.k), bf(p.v), bf(p.dout), p.lse, p.delta,
        static_cast<__nv_bfloat16*>(p.dq), a.seq, a.heads, a.causal,
        a.scale);
  }
  return (int)cudaGetLastError();
}

int bwd_tensor_cores(bool dkv, const Grads& p, const Launch& a) {
#define T2R_MMA_CASE(D) \
  case D: return bwd_mma<D>(dkv, p, a);
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

// The backward's entry: refuses a plan other than fwd_route's and
// bwd_rows', else launches dq or dk/dv on it.
int bwd(bool dkv, const Grads& p, int dtype, int B, int T, int H, int D,
        int causal, float scale, int route, int rows, bool aligned,
        void* stream) {
  if (D < 8 || D > 128 || D % 8 != 0 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int want = fwd_route(dtype, D, aligned);
  if (route != want || rows != bwd_rows(dkv, want, B * H, T, D)) {
    return (int)cudaErrorInvalidValue;
  }
  const Launch a{B, T, H, D, causal, scale,
                 static_cast<cudaStream_t>(stream)};
  if (route == kRouteMma) return bwd_tensor_cores(dkv, p, a);
  return bwd_cuda_cores(dkv, p, a, rows, dtype == 1,
                        dtype == 0 && aligned);
}

}  // namespace

extern "C" {

// dout, dq: [B, T, H, D] in dtype; lse, delta: float32 [B*H, T]. route and
// rows are the host planner's (ops/flash_attention.bwd_plan), which must be
// fwd_route's and bwd_rows' choice: any other plan returns
// cudaErrorInvalidValue and launches nothing.
int t2r_flash_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int dtype, int B, int T, int H, int D, int causal,
                 float scale, int route, int rows, void* stream) {
  const Grads p{q, k, v, dout, static_cast<const float*>(lse),
                static_cast<const float*>(delta), dq, nullptr, nullptr};
  return bwd(false, p, dtype, B, T, H, D, causal, scale, route, rows,
             aligned16(q) && aligned16(k) && aligned16(v) &&
                 aligned16(dout) && aligned16(dq),
             stream);
}

// dk, dv: [B, T, H, D] in dtype; the plan as for t2r_flash_dq.
int t2r_flash_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int dtype, int B, int T, int H, int D,
                  int causal, float scale, int route, int rows,
                  void* stream) {
  const Grads p{q, k, v, dout, static_cast<const float*>(lse),
                static_cast<const float*>(delta), nullptr, dk, dv};
  return bwd(true, p, dtype, B, T, H, D, causal, scale, route, rows,
             aligned16(q) && aligned16(k) && aligned16(v) &&
                 aligned16(dout) && aligned16(dk) && aligned16(dv),
             stream);
}

const char* t2r_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
