// Fused photometric pass: per image, brightness shift, contrast about the
// per-channel spatial mean, clip to [0, 1].
//
// Replaces: tensor2robot_tpu/ops/photometric.py, _fused_kernel (launched by
// fused_brightness_contrast <- random_brightness_contrast <-
// apply_photometric_image_distortions(use_fused_kernel=True)).
//
// Function (the TPU kernel's, in float32, written in the input's dtype):
//   x    = image + delta[b]
//   m_c  = sum over the H*W pixels of x in channel c, / (H*W)
//   out  = clip((x - m_c) * factor[b] + m_c, 0, 1)
// with no clip between brightness and contrast. Channels are interleaved
// along W*C ([B, H, W, C] read as [B, H*W*C]).
//
// What bounds it on an H100: bytes. It reads every image element and
// writes it once, a few operations per element. At QT-Opt's training shape,
// [32, 472, 472, 3] float32 (85.5 MB each way), 171.1 MB take 0.051 ms at
// 3.35 TB/s; this design reads the images twice, 256.6 MB or 0.077 ms.
//
// Design. The TPU kernel held a whole image in VMEM (one grid step per
// image). One image here is 2.67 MB, far more than a block's shared memory,
// and 32 images would fill 32 of the 132 SMs. So each image is cut into
// slices of a multiple of 768 elements, one block per (slice, image), in
// two kernels: the first sums each slice's x per channel into a float32
// partial [B, slices, C]; the second has every block add its image's
// partials in slice order (the same order in every block, so every block
// sees the same mean bit for bit), then applies the contrast and the clip
// to its slice. No float atomics: a run gives the same bits every time.
// A block has 192 threads moving four neighbouring elements each (16-byte
// accesses in float32, 8-byte in bfloat16) where the image allows it, so a
// block's stride of 768 elements is a multiple of C for C = 1..4 and each
// thread's four lanes keep their channels over the whole slice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 192;
constexpr int kWarps = kThreads / 32;

template <int kVec>
__device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (kVec == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    v[0] = *p;
  }
}
template <int kVec>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
  if constexpr (kVec == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __bfloat162float(h[i]);
  } else {
    v[0] = __bfloat162float(*p);
  }
}
template <int kVec>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}
template <int kVec>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
  if constexpr (kVec == 4) {
    uint2 u;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __float2bfloat16_rn(v[i]);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// Pass 1: per (slice, image) block, the per-channel sums of image + delta
// over the slice, in a fixed order, into partials[b, slice, c].
template <typename T, int kC, int kVec>
__global__ void __launch_bounds__(kThreads)
    photometric_sums_kernel(const T* __restrict__ images,
                            const float* __restrict__ delta,
                            float* __restrict__ partials, int64_t elements,
                            int64_t slice) {
  const int b = blockIdx.y;
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const T* image = images + (int64_t)b * elements;
  const float d = delta[b];
  const int64_t start = (int64_t)s * slice;
  const int64_t end = start + slice < elements ? start + slice : elements;
  float acc[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) acc[k] = 0.f;
  for (int64_t i = start + (int64_t)tid * kVec; i < end;
       i += (int64_t)kThreads * kVec) {
    float v[kVec];
    load<kVec>(image + i, v);
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] += v[k] + d;
  }
  // Lane k of this thread holds channel (tid * kVec + k) % kC throughout:
  // the slice start and the stride are multiples of kC.
  float sums[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    sums[c] = 0.f;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if ((tid * kVec + k) % kC == c) sums[c] += acc[k];
    }
  }
  __shared__ float warp_sums[kWarps][kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    float v = sums[c];
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, offset);
    }
    if ((tid & 31) == 0) warp_sums[tid >> 5][c] = v;
  }
  __syncthreads();
  if (tid < kC) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w][tid];
    partials[((int64_t)b * gridDim.x + s) * kC + tid] = total;
  }
}

// Pass 2: every block adds its image's partials in slice order into the
// channel means, then writes clip((x - m) * factor + m, 0, 1) over its slice.
template <typename T, int kC, int kVec>
__global__ void __launch_bounds__(kThreads)
    photometric_apply_kernel(const T* __restrict__ images,
                             const float* __restrict__ delta,
                             const float* __restrict__ factor,
                             const float* __restrict__ partials,
                             T* __restrict__ out, int64_t elements,
                             int64_t slice, float pixels) {
  const int b = blockIdx.y;
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  __shared__ float mean[kC];
  if (tid < kC) {
    float total = 0.f;
    const float* row = partials + (int64_t)b * gridDim.x * kC + tid;
    for (int j = 0; j < (int)gridDim.x; ++j) total += row[(int64_t)j * kC];
    mean[tid] = total / pixels;
  }
  __syncthreads();
  float m[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) m[k] = mean[(tid * kVec + k) % kC];
  const float d = delta[b];
  const float f = factor[b];
  const int64_t offset = (int64_t)b * elements;
  const int64_t start = (int64_t)s * slice;
  const int64_t end = start + slice < elements ? start + slice : elements;
  for (int64_t i = start + (int64_t)tid * kVec; i < end;
       i += (int64_t)kThreads * kVec) {
    float v[kVec];
    load<kVec>(images + offset + i, v);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float x = v[k] + d;
      const float y = (x - m[k]) * f + m[k];
      // Comparisons, not fminf/fmaxf, so a NaN passes through as in clip.
      v[k] = y < 0.f ? 0.f : (y > 1.f ? 1.f : y);
    }
    store<kVec>(out + offset + i, v);
  }
}

template <typename T, int kC, int kVec>
int launch(const void* images, const void* delta, const void* factor,
           void* partials, void* out, int B, int64_t elements, int64_t slice,
           int slices, int pixels, cudaStream_t stream) {
  const dim3 grid(slices, B);
  photometric_sums_kernel<T, kC, kVec><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(images), static_cast<const float*>(delta),
      static_cast<float*>(partials), elements, slice);
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return (int)first;
  photometric_apply_kernel<T, kC, kVec><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(images), static_cast<const float*>(delta),
      static_cast<const float*>(factor), static_cast<const float*>(partials),
      static_cast<T*>(out), elements, slice, (float)pixels);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

template <typename T, int kC>
int launch_c(const void* images, const void* delta, const void* factor,
             void* partials, void* out, int B, int64_t elements,
             int64_t slice, int slices, int pixels, cudaStream_t stream) {
  const int vec_bytes = 4 * (int)sizeof(T);
  if (elements % 4 == 0 && aligned(images, vec_bytes) &&
      aligned(out, vec_bytes)) {
    return launch<T, kC, 4>(images, delta, factor, partials, out, B,
                            elements, slice, slices, pixels, stream);
  }
  return launch<T, kC, 1>(images, delta, factor, partials, out, B, elements,
                          slice, slices, pixels, stream);
}

template <typename T>
int launch_t(int C, const void* images, const void* delta,
             const void* factor, void* partials, void* out, int B,
             int64_t elements, int64_t slice, int slices, int pixels,
             cudaStream_t stream) {
  switch (C) {
    case 1:
      return launch_c<T, 1>(images, delta, factor, partials, out, B,
                            elements, slice, slices, pixels, stream);
    case 2:
      return launch_c<T, 2>(images, delta, factor, partials, out, B,
                            elements, slice, slices, pixels, stream);
    case 3:
      return launch_c<T, 3>(images, delta, factor, partials, out, B,
                            elements, slice, slices, pixels, stream);
    case 4:
      return launch_c<T, 4>(images, delta, factor, partials, out, B,
                            elements, slice, slices, pixels, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// images, out: [B, H, W, C] contiguous in dtype (0 = float32, 1 =
// bfloat16), C in 1..4; delta, factor: float32 [B]; partials: float32
// scratch [B, slices, C]. pixels = H * W; slice (a multiple of 768) is the
// elements per block and slices = ceil(H * W * C / slice). Two launches on
// stream. Returns cudaGetLastError().
int t2r_photometric(const void* images, const void* delta,
                    const void* factor, void* partials, void* out, int dtype,
                    int B, int pixels, int C, int slice, int slices,
                    void* stream) {
  const int64_t elements = (int64_t)pixels * C;
  if (B < 1 || pixels < 1 || slice < 1 || slice % 768 != 0 || slices < 1 ||
      (int64_t)slice * (slices - 1) >= elements ||
      (int64_t)slice * slices < elements || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_t<float>(C, images, delta, factor, partials, out, B,
                           elements, slice, slices, pixels, s);
  }
  if (dtype == 1) {
    return launch_t<__nv_bfloat16>(C, images, delta, factor, partials, out,
                                   B, elements, slice, slices, pixels, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* t2r_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
