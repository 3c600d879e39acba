// Fused optimizer update: Adam or plain SGD, the EMA blend and the
// non-finite guard's select, in one elementwise pass over every parameter.
//
// Replaces: tensor2robot_tpu/ops/fused_update.py, _make_kernel (launched by
// _leaf_update <- apply_update, one pallas_call per parameter leaf).
//
// Arithmetic, term for term that of the TPU kernel (optax's order), in
// float32, with IEEE division and square root (no fast-math flags):
//   mu'  = (1-b1)*g + b1*mu
//   nu'  = (1-b2)*(g*g) + b2*nu
//   u    = (mu'/c1) / (sqrt(nu'/c2) + eps)         (Adam; SGD: u = g)
//   p'   = p - lr*u
//   ema' = ema*decay + p'*(1-decay)
// nvcc contracts a*b + c into one fused multiply-add, which moves the last
// bit against the CPU's separate multiply and add; the parity band (atol
// 1e-6, rtol 1e-5) is the JAX package's.
//
// The guard. `ok` is the one value that stays on the device: a byte the
// trainer's all-finite check wrote. When it is 0, no block writes anything,
// so every output keeps its input bit for bit: the select of old against
// new, without computing new.
//
// What bounds it on an H100: bytes. Each element reads p and g (and mu, nu,
// ema) once and writes p (and mu, nu, ema) once, a handful of operations
// per element: 36 bytes per element for Adam with the EMA, so the 1.24 M
// parameters of Grasping44 need 44.6 MB, 0.013 ms at 3.35 TB/s.
//
// Design. The TPU kernel ran one pallas_call per leaf over (1024, 128)
// blocks. Here one launch covers up to kMaxLeaves leaves, every path's
// parameters in one launch a step: the host entry packs a table of the
// leaves' pointers and sizes into the kernel's by-value arguments, with
// the prefix of each leaf's block count, and a block finds its leaf by a
// binary search over that prefix. The table is sized to Hopper's 32,764
// bytes of kernel parameters (CUDA 12.1 and later; 52 bytes a leaf). It is a
// __grid_constant__ parameter: the search and the pointer reads index it
// with a runtime leaf number, which, without the qualifier, may make
// nvcc copy the whole table into each thread's local memory (the build's
// ptxas report shows a 0-byte stack frame).
// Each thread moves four neighbouring elements, with 16-byte accesses
// where all of the leaf's pointers are 16-byte aligned. The scalars (lr,
// the bias corrections, the betas, eps and the decay) are passed by value:
// no upload, no per-leaf launch. A launch that a CUDA graph captures keeps
// its arguments for every replay, so there lr, c1 and c2, which follow the
// optimizer's count, come from a device buffer of three floats (rates) that
// the trainer fills before each replay; every thread reads the same three
// words. The Adam/SGD, EMA and guard switches are
// template parameters, so each of the 8 variants compiles to its own
// kernel without dead loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 512;
constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kPerBlock = kThreads * kVec;

struct Table {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* mu[kMaxLeaves];
  float* nu[kMaxLeaves];
  float* ema[kMaxLeaves];
  int64_t n[kMaxLeaves];
  int block_start[kMaxLeaves + 1];
  int n_leaves;
};

struct Scalars {
  float lr, c1, c2, b1, b2, one_minus_b1, one_minus_b2, eps, decay,
      one_minus_decay;
};

static_assert(sizeof(Table) + sizeof(Scalars) + 2 * sizeof(void*) <= 32764,
              "kernel arguments must stay within Hopper's 32,764 bytes");

template <bool kAdam, bool kEma>
__device__ __forceinline__ void update_one(const Scalars& s, float& p,
                                           float g, float& mu, float& nu,
                                           float& ema) {
  float u;
  if constexpr (kAdam) {
    mu = s.one_minus_b1 * g + s.b1 * mu;
    nu = s.one_minus_b2 * (g * g) + s.b2 * nu;
    u = (mu / s.c1) / (sqrtf(nu / s.c2) + s.eps);
  } else {
    u = g;
  }
  p = p - s.lr * u;
  if constexpr (kEma) {
    ema = ema * s.decay + p * s.one_minus_decay;
  }
}

template <bool kAdam, bool kEma, bool kGuard>
__global__ void __launch_bounds__(kThreads)
    fused_update_kernel(__grid_constant__ const Table t, Scalars s,
                        const unsigned char* ok, const float* rates) {
  if constexpr (kGuard) {
    if (*ok == 0) return;
  }
  if (rates != nullptr) {  // lr, c1, c2 from the device buffer
    s.lr = rates[0];
    s.c1 = rates[1];
    s.c2 = rates[2];
  }
  const int bid = blockIdx.x;
  // The leaf whose blocks hold this one: the last start <= bid.
  int lo = 0, hi = t.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.block_start[mid] <= bid) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int leaf = lo;
  const int64_t n = t.n[leaf];
  const int64_t base =
      (int64_t)(bid - t.block_start[leaf]) * kPerBlock +
      (int64_t)threadIdx.x * kVec;
  if (base >= n) return;
  float* p = t.p[leaf] + base;
  const float* g = t.g[leaf] + base;
  float* mu = kAdam ? t.mu[leaf] + base : nullptr;
  float* nu = kAdam ? t.nu[leaf] + base : nullptr;
  float* ema = kEma ? t.ema[leaf] + base : nullptr;

  uintptr_t bits = reinterpret_cast<uintptr_t>(t.p[leaf]) |
                   reinterpret_cast<uintptr_t>(t.g[leaf]);
  if constexpr (kAdam) {
    bits |= reinterpret_cast<uintptr_t>(t.mu[leaf]) |
            reinterpret_cast<uintptr_t>(t.nu[leaf]);
  }
  if constexpr (kEma) bits |= reinterpret_cast<uintptr_t>(t.ema[leaf]);
  if ((bits & 15) == 0 && base + kVec <= n) {
    float4 pv = *reinterpret_cast<float4*>(p);
    const float4 gv = *reinterpret_cast<const float4*>(g);
    float4 muv = make_float4(0.f, 0.f, 0.f, 0.f), nuv = muv, emav = muv;
    if constexpr (kAdam) {
      muv = *reinterpret_cast<float4*>(mu);
      nuv = *reinterpret_cast<float4*>(nu);
    }
    if constexpr (kEma) emav = *reinterpret_cast<float4*>(ema);
    update_one<kAdam, kEma>(s, pv.x, gv.x, muv.x, nuv.x, emav.x);
    update_one<kAdam, kEma>(s, pv.y, gv.y, muv.y, nuv.y, emav.y);
    update_one<kAdam, kEma>(s, pv.z, gv.z, muv.z, nuv.z, emav.z);
    update_one<kAdam, kEma>(s, pv.w, gv.w, muv.w, nuv.w, emav.w);
    *reinterpret_cast<float4*>(p) = pv;
    if constexpr (kAdam) {
      *reinterpret_cast<float4*>(mu) = muv;
      *reinterpret_cast<float4*>(nu) = nuv;
    }
    if constexpr (kEma) *reinterpret_cast<float4*>(ema) = emav;
    return;
  }
  const int count = n - base < kVec ? (int)(n - base) : kVec;
  for (int i = 0; i < count; ++i) {
    float pi = p[i], mui = 0.f, nui = 0.f, emai = 0.f;
    if constexpr (kAdam) {
      mui = mu[i];
      nui = nu[i];
    }
    if constexpr (kEma) emai = ema[i];
    update_one<kAdam, kEma>(s, pi, g[i], mui, nui, emai);
    p[i] = pi;
    if constexpr (kAdam) {
      mu[i] = mui;
      nu[i] = nui;
    }
    if constexpr (kEma) ema[i] = emai;
  }
}

template <bool kAdam, bool kEma, bool kGuard>
int launch(const Table& t, int blocks, const Scalars& s,
           const unsigned char* ok, const float* rates, cudaStream_t stream) {
  fused_update_kernel<kAdam, kEma, kGuard>
      <<<blocks, kThreads, 0, stream>>>(t, s, ok, rates);
  return (int)cudaGetLastError();
}

template <bool kAdam, bool kEma>
int launch_guard(bool guard, const Table& t, int blocks, const Scalars& s,
                 const unsigned char* ok, const float* rates,
                 cudaStream_t stream) {
  return guard ? launch<kAdam, kEma, true>(t, blocks, s, ok, rates, stream)
               : launch<kAdam, kEma, false>(t, blocks, s, ok, rates, stream);
}

}  // namespace

extern "C" {

// One launch over n_leaves (1..512) leaves. leaves: a HOST array of
// n_leaves rows of six int64 values: the device addresses of p, g, mu, nu
// and ema (0 where the variant does not read it) and the element count.
// Every tensor is float32 and dense, with one layout per leaf. adam, ema and
// guard are 0 or 1; ok is the device byte the guard reads (ignored without
// the guard); rates, when not null, is a device buffer of three floats (lr,
// c1, c2) that the kernel reads in place of the lr, c1 and c2 arguments.
// Returns cudaGetLastError().
int t2r_fused_update(const int64_t* leaves, int n_leaves, int adam, int ema,
                     int guard, const void* ok, const void* rates, float lr,
                     float c1, float c2,
                     float b1, float b2, float one_minus_b1,
                     float one_minus_b2, float eps, float decay,
                     float one_minus_decay, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves) {
    return (int)cudaErrorInvalidValue;
  }
  Table t;
  int64_t blocks = 0;
  for (int i = 0; i < n_leaves; ++i) {
    const int64_t* row = leaves + 6 * i;
    t.p[i] = reinterpret_cast<float*>(row[0]);
    t.g[i] = reinterpret_cast<const float*>(row[1]);
    t.mu[i] = reinterpret_cast<float*>(row[2]);
    t.nu[i] = reinterpret_cast<float*>(row[3]);
    t.ema[i] = reinterpret_cast<float*>(row[4]);
    t.n[i] = row[5];
    if (row[5] < 1) return (int)cudaErrorInvalidValue;
    t.block_start[i] = (int)blocks;
    blocks += (row[5] + kPerBlock - 1) / kPerBlock;
    if (blocks > ((int64_t)1 << 30)) return (int)cudaErrorInvalidValue;
  }
  t.block_start[n_leaves] = (int)blocks;
  t.n_leaves = n_leaves;
  const Scalars s{lr, c1, c2, b1, b2, one_minus_b1, one_minus_b2, eps,
                  decay, one_minus_decay};
  const unsigned char* okp = static_cast<const unsigned char*>(ok);
  const float* rp = static_cast<const float*>(rates);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool g = guard != 0;
  const int nb = (int)blocks;
  if (adam) {
    return ema ? launch_guard<true, true>(g, t, nb, s, okp, rp, st)
               : launch_guard<true, false>(g, t, nb, s, okp, rp, st);
  }
  return ema ? launch_guard<false, true>(g, t, nb, s, okp, rp, st)
             : launch_guard<false, false>(g, t, nb, s, okp, rp, st);
}

const char* t2r_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
