// residual_xent: r = onehot(labels) - softmax(logits) over (T, V) logits.
//
// Replaces the TPU kernel src/repro/kernels/residual_xent.py:
// residual_xent_kernel (Pallas passes _stats_kernel and _resid_kernel over
// (128, 512) tiles). This is GAL's per-round broadcast tensor at LM scale
// (gal_lm.compute_residual), with V up to 151936.
//
// Bound: bytes. Each element costs a handful of flops (max, exp, divide,
// compare) against 4-6 bytes of traffic, far below the ~20 flop/byte at
// which an H100's f32 rate would be the limit. The floor is one read of
// the logits, one write of the f32 residual and one read of the labels:
// T*V*(in_bytes + 4) + T*4 bytes, about 2.10 GB at T=2048, V=128256, f32 in.
//
// Design (simple and right first): one thread block per token row.
//   pass 1  each thread keeps an online (max, sumexp) over its strided
//           elements; warp shuffles, then shared memory, combine them.
//   pass 2  the row is read again and r = (col == label) - exp(x - m) / l
//           written (l clamped below at 1e-30 as the reference does).
// The second read of the row is the price of the two-pass design: a row of
// 128256 f32 logits (513 KB) does not stay in shared memory, and the
// blocks in flight overrun L2, so expect about 1.5x the byte floor. Holding
// the row in a cluster's distributed shared memory, fed by TMA, would read
// it once.
//
// Loads and stores go 4 elements at a time (16 bytes of f32, 8 of bf16)
// where the caller says the pointers are 16-byte aligned: a scalar head
// up to the first element index that is a multiple of 4, a vector body,
// and a scalar tail, so odd widths (51865, 300, 513) take the same path.
// A label outside [0, V) sets no one-hot column (the reference's -1
// padding convention).
//
// Plain C interface for ctypes: residual_xent_launch returns the
// cudaGetLastError() code of the launch; the wrapper raises on non-zero.

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 512;
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four consecutive elements from an address aligned to 4 elements.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  // bf16 is the top half of an f32: widening is a shift, exact.
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

__device__ __forceinline__ void online1(float& m, float& l, float x) {
  if (x > m) {
    l = l * expf(m - x) + 1.0f;
    m = x;
  } else {
    l += expf(x - m);
  }
}

__device__ __forceinline__ void online4(float& m, float& l, const float v[4]) {
  const float mx = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
  if (mx > m) {
    l *= expf(m - mx);
    m = mx;
  }
  l += expf(v[0] - m) + expf(v[1] - m) + expf(v[2] - m) + expf(v[3] - m);
}

__device__ __forceinline__ void combine(float& m, float& l, float m2,
                                        float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ void warp_combine(float& m, float& l) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    combine(m, l, m2, l2);
  }
}

// Combine every thread's (m, l) into the row's; all threads get the result.
__device__ __forceinline__ void block_stats(float& m, float& l) {
  __shared__ float warp_m[kThreads / 32], warp_l[kThreads / 32];
  __shared__ float row_m, row_l;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  warp_combine(m, l);
  if (lane == 0) {
    warp_m[warp] = m;
    warp_l[warp] = l;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    m = lane < n_warps ? warp_m[lane] : kNegInf;
    l = lane < n_warps ? warp_l[lane] : 0.0f;
    warp_combine(m, l);
    if (lane == 0) {
      row_m = m;
      row_l = l;
    }
  }
  __syncthreads();
  m = row_m;
  l = row_l;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
residual_xent_kernel(const T* __restrict__ logits,
                     const int32_t* __restrict__ labels,
                     float* __restrict__ out, int64_t V, int vec) {
  const int64_t row = blockIdx.x;
  const int64_t base = row * V;
  const T* x = logits + base;
  float* o = out + base;
  // head: scalar elements up to the first index of the flat (T*V) array
  // that is a multiple of 4; body: whole groups of 4; tail: the rest.
  int64_t head = vec ? ((4 - (base & 3)) & 3) : V;
  if (head > V) head = V;
  const int64_t n_vec = (V - head) / 4;
  const int64_t tail = head + 4 * n_vec;

  float m = kNegInf, l = 0.0f;
  for (int64_t i = threadIdx.x; i < head; i += blockDim.x)
    online1(m, l, to_f32(x[i]));
  for (int64_t j = threadIdx.x; j < n_vec; j += blockDim.x) {
    float v[4];
    load4(x + head + 4 * j, v);
    online4(m, l, v);
  }
  for (int64_t i = tail + threadIdx.x; i < V; i += blockDim.x)
    online1(m, l, to_f32(x[i]));
  block_stats(m, l);

  const float denom = fmaxf(l, 1e-30f);
  const int64_t label = labels[row];
  for (int64_t i = threadIdx.x; i < head; i += blockDim.x)
    o[i] = (i == label ? 1.0f : 0.0f) - expf(to_f32(x[i]) - m) / denom;
  for (int64_t j = threadIdx.x; j < n_vec; j += blockDim.x) {
    const int64_t c = head + 4 * j;
    float v[4];
    load4(x + c, v);
    float4 r;
    r.x = (c + 0 == label ? 1.0f : 0.0f) - expf(v[0] - m) / denom;
    r.y = (c + 1 == label ? 1.0f : 0.0f) - expf(v[1] - m) / denom;
    r.z = (c + 2 == label ? 1.0f : 0.0f) - expf(v[2] - m) / denom;
    r.w = (c + 3 == label ? 1.0f : 0.0f) - expf(v[3] - m) / denom;
    *reinterpret_cast<float4*>(o + c) = r;
  }
  for (int64_t i = tail + threadIdx.x; i < V; i += blockDim.x)
    o[i] = (i == label ? 1.0f : 0.0f) - expf(to_f32(x[i]) - m) / denom;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 logits, 1 = bfloat16 logits. labels: int32 (rows,).
// out: float32 (rows, V). vec: 1 when logits and out are 16-byte aligned.
int residual_xent_launch(const void* logits, int dtype, const void* labels,
                         void* out, long long rows, long long V, int vec,
                         void* stream) {
  if (rows <= 0 || V <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(rows));
  const auto* lab = static_cast<const int32_t*>(labels);
  auto* o = static_cast<float*>(out);
  if (dtype == 0) {
    residual_xent_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(logits), lab, o, V, vec);
  } else if (dtype == 1) {
    residual_xent_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), lab, o, V, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* residual_xent_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
