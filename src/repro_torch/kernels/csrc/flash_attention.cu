// flash_attention: forward-only GQA self-attention with an online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_kernel (Pallas body _flash_kernel, (128, 128) q/k tiles
// over a sequential key grid axis, f32 acc/m/l in VMEM scratch). It is the
// attention of make_prefill_step(cfg, flash=True): q (B, S, H, hd), k and v
// (B, S, KV, hd) in the reference's layout, out (B, S, H, hd) in q's dtype.
//
// What it computes, as the reference does:
//   * query head h of batch b reads KV head h / (H / KV);
//   * key j is visible to query i iff j < S, and (causal) i >= j, and
//     (window > 0) i - j < window. The masks use the sequence index, not
//     positions; the window is one-sided, so with causal == 0 every later
//     key is visible;
//   * scores (q . k) * hd^-0.5 in f32, running max / sumexp / p.v in f32,
//     out = acc / max(l, 1e-30) cast to q's dtype.
// The reference pads S to 128 and masks the padded keys; here each block
// masks its own ragged edge and nothing is padded in device memory. The
// reference masks key tiles past the causal limit or before the window;
// here they are skipped (the loop runs from the window's first tile to the
// causal limit), which gives the same result: those tiles add exp(-inf) = 0.
// Masked scores are -inf and the running max starts at the reference's
// NEG_INF (-1e30), finite: a row whose keys are all masked so far keeps
// m = -1e30, p = exp(-inf) = 0 and alpha = exp(0) = 1, so l and acc stay
// exactly 0 until its first visible key, and the diagonal key is always
// visible.
//
// Bound at the prefill shape (q (1, 32768, 32, 128), k/v (1, 32768, 8, 128)
// bf16, causal): operations. 4 * hd flops per visible (query, key) pair,
// 2 * H * hd * S * (S + 1) = 8.80e12 flop, 8.9 ms at 989 TFLOP/s dense
// bf16; the bytes (q, k, v read once, out written once) are 0.67 GB, 0.2 ms
// at 3.35 TB/s. So the work is tensor-core products, and the design puts
// both products on the tensor cores and keeps scores and probabilities in
// registers, never in device memory.
//
// Design (simple and right first; wgmma, TMA and warp specialisation are
// later work):
//   * one block of 4 warps per (batch * head, 64-query tile); each warp owns
//     16 query rows. Tiles are handed out heaviest first (the last query
//     tiles have the most causal keys), so the tail of the grid is short;
//   * 64-key K/V tiles staged in shared memory with 16-byte loads;
//   * bf16: q.k^T and p.v by mma.sync.m16n8k16 (bf16 in, f32 accumulate),
//     q held in registers as A fragments, V fed through ldmatrix.trans.
//     A bf16 product is exact in f32, so q.k^T matches the reference's f32
//     scores up to summation order. p is rounded to bf16 for p.v (the
//     accumulation stays f32, and l sums the unrounded p): a relative error
//     of at most 2^-9 per probability, inside the reference's own bf16
//     tolerance (3e-2);
//   * f32: both products by FMA in f32 (no TF32), for the reference's f32
//     tolerance (2e-5).
// hd is a template parameter: 64, 80 and 128, the zoo's head dims. 80 is
// not a power of two; mma tiles are 16 deep and 8 wide, so 80
// needs no padding at all, in device memory or in the kernel.
//
// q/k/v are read through the strides the caller gives, in elements, for
// the batch, sequence and head axes (the head_dim axis is contiguous), so
// the (B, S, heads, hd) layout needs no transpose copy. out is contiguous.
//
// Plain C interface for ctypes: flash_attention_launch returns the
// cudaGetLastError() code of the launch; the wrapper raises on non-zero.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;        // 4 warps
constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // keys per staged tile
constexpr float kNegInf = -1e30f;    // the reference's NEG_INF

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, H, KV;
  long long q_sb, q_ss, q_sh;        // strides in elements
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal;
  int window;                        // <= 0: no window
  float scale;
};

// The key tiles that a query tile [q0, q0 + kBQ) can see: [*kb0, *kb1).
__device__ __forceinline__ void key_range(const Params& p, int q0, int* kb0,
                                          int* kb1) {
  int end = p.S;
  if (p.causal) end = min(p.S, q0 + kBQ);
  int begin = 0;
  if (p.window > 0) begin = max(0, q0 - p.window + 1);
  *kb0 = (begin / kBK) * kBK;
  *kb1 = end;
}

// Whether some (query, key) pair of the tiles is masked.
__device__ __forceinline__ bool tile_needs_mask(const Params& p, int q0,
                                                int kb) {
  if (kb + kBK > p.S) return true;
  if (p.causal && kb + kBK - 1 > q0) return true;
  if (p.window > 0 && (q0 + kBQ - 1) - kb >= p.window) return true;
  return false;
}

__device__ __forceinline__ bool visible(const Params& p, int i, int j) {
  return j < p.S && (!p.causal || i >= j) &&
         (p.window <= 0 || i - j < p.window);
}

// ------------------------------------------------------------------ bf16
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col); f32 accumulators.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory, transposed: lanes 8m..8m+7 give
// the row addresses of matrix m, and register m receives it.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* smem_row) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const Params p) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kLd = HD + 8;        // smem row pitch: 16-byte aligned rows,
                                     // conflict-free fragment reads
  constexpr int kChunks = HD / 8;    // 16-byte chunks per row
  __shared__ alignas(16) __nv_bfloat16 Ks[kBK][kLd];
  __shared__ alignas(16) __nv_bfloat16 Vs[kBK][kLd];

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;

  const auto* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb +
                  h * p.q_sh;
  const auto* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb +
                  kvh * p.k_sh;
  const auto* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb +
                  kvh * p.v_sh;

  // this warp's 16 query rows as mma A fragments, one per 16-wide k step
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 + t4 * 2;
    const uint32_t* r0 = reinterpret_cast<const uint32_t*>(q + row0 * p.q_ss);
    const uint32_t* r1 = reinterpret_cast<const uint32_t*>(q + row1 * p.q_ss);
    qa[kk][0] = row0 < p.S ? r0[c / 2] : 0u;
    qa[kk][1] = row1 < p.S ? r1[c / 2] : 0u;
    qa[kk][2] = row0 < p.S ? r0[c / 2 + 4] : 0u;
    qa[kk][3] = row1 < p.S ? r1[c / 2 + 4] : 0u;
  }

  float m[2] = {kNegInf, kNegInf};   // running max of rows row0, row1
  float l[2] = {0.0f, 0.0f};         // this thread's share of the sumexp
  float acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.0f;

  int kb0, kb1;
  key_range(p, q0, &kb0, &kb1);
  for (int kb = kb0; kb < kb1; kb += kBK) {
    __syncthreads();                 // the previous tile is consumed
    for (int c = tid; c < kBK * kChunks; c += kThreads) {
      const int key = c / kChunks, ch = c % kChunks;
      const int j = kb + key;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (j < p.S) {
        kv = *reinterpret_cast<const uint4*>(k + j * p.k_ss + ch * 8);
        vv = *reinterpret_cast<const uint4*>(v + j * p.v_ss + ch * 8);
      }
      *reinterpret_cast<uint4*>(&Ks[key][ch * 8]) = kv;
      *reinterpret_cast<uint4*>(&Vs[key][ch * 8]) = vv;
    }
    __syncthreads();

    // scores: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      const __nv_bfloat16* krow = &Ks[nt * 8 + g][t4 * 2];
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_bf16(s[nt], qa[kk], b0, b1);
      }
    }
    const bool masked = tile_needs_mask(p, q0, kb);
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale;
        if (masked) {
          const int i = e < 2 ? row0 : row1;
          const int j = kb + nt * 8 + t4 * 2 + (e & 1);
          if (!visible(p, i, j)) x = -INFINITY;
        }
        s[nt][e] = x;
      }
    }

    // online softmax; the 4 threads of a quad share a row
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * rr], s[nt][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      const float alpha = expf(m[rr] - m_new);
      m[rr] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        const float p0 = expf(s[nt][2 * rr] - m_new);
        const float p1 = expf(s[nt][2 * rr + 1] - m_new);
        s[nt][2 * rr] = p0;
        s[nt][2 * rr + 1] = p1;
        sum += p0 + p1;
      }
      l[rr] = l[rr] * alpha + sum;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        acc[dt][2 * rr] *= alpha;
        acc[dt][2 * rr + 1] *= alpha;
      }
    }

    // p as A fragments: the accumulator layout of two adjacent n-tiles is
    // the A layout of one 16-deep k step
#pragma unroll
    for (int kp = 0; kp < kBK / 16; ++kp) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kp][0], s[2 * kp][1]);
      pa[1] = pack_bf16(s[2 * kp][2], s[2 * kp][3]);
      pa[2] = pack_bf16(s[2 * kp + 1][0], s[2 * kp + 1][1]);
      pa[3] = pack_bf16(s[2 * kp + 1][2], s[2 * kp + 1][3]);
      // lane -> row address of matrix lane / 8: keys kp*16 + (0 | 8) + r,
      // head_dim columns dt*8 (matrices 0, 1) and dt*8 + 8 (2, 3)
      const int mat = lane >> 3, r = lane & 7;
      const __nv_bfloat16* vrow =
          &Vs[kp * 16 + (mat & 1) * 8 + r][(mat >> 1) * 8];
#pragma unroll
      for (int dt = 0; dt < HD / 8; dt += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + dt * 8);
        mma_bf16(acc[dt], pa, vb[0], vb[1]);
        mma_bf16(acc[dt + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // full row sums over the quad, then out = acc / max(l, 1e-30)
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    l[rr] = fmaxf(l[rr], 1e-30f);
  }
  auto* o = static_cast<__nv_bfloat16*>(p.o);
  const long long o_ss = static_cast<long long>(p.H) * HD;
  __nv_bfloat16* o0 = o + (static_cast<long long>(b) * p.S + row0) * o_ss +
                      h * HD + t4 * 2;
  __nv_bfloat16* o1 = o0 + 8 * o_ss;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    if (row0 < p.S)
      *reinterpret_cast<uint32_t*>(o0 + dt * 8) =
          pack_bf16(acc[dt][0] / l[0], acc[dt][1] / l[0]);
    if (row1 < p.S)
      *reinterpret_cast<uint32_t*>(o1 + dt * 8) =
          pack_bf16(acc[dt][2] / l[1], acc[dt][3] / l[1]);
  }
}

// ------------------------------------------------------------------ f32
// Thread (ty, tx) = (tid / 8, tid % 8) owns query rows ty + 16 r (r < 4),
// keys tx + 8 c of each tile (c < 8) and head_dim columns tx + 8 c of the
// output. Shared memory (dynamic): Q [64][HD+1], K [64][HD+1], V [64][HD],
// P [64][65] floats; the +1 pitches keep the strided reads conflict-free.
template <int HD>
constexpr int f32_smem_bytes() {
  return static_cast<int>(sizeof(float)) *
         (2 * kBQ * (HD + 1) + kBK * HD + kBQ * (kBK + 1));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const Params p) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * (HD + 1);
  float* Vs = Ks + kBK * (HD + 1);
  float* Ps = Vs + kBK * HD;
  constexpr int kCols = HD / 8;

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb +
                   kvh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb +
                   kvh * p.v_sh;

  for (int c = tid; c < kBQ * HD; c += kThreads) {
    const int r = c / HD, d = c % HD, i = q0 + r;
    Qs[r * (HD + 1) + d] = i < p.S ? q[i * p.q_ss + d] : 0.0f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  }

  int kb0, kb1;
  key_range(p, q0, &kb0, &kb1);
  for (int kb = kb0; kb < kb1; kb += kBK) {
    __syncthreads();                 // the previous tile is consumed
    for (int c = tid; c < kBK * HD; c += kThreads) {
      const int key = c / HD, d = c % HD, j = kb + key;
      Ks[key * (HD + 1) + d] = j < p.S ? k[j * p.k_ss + d] : 0.0f;
      Vs[key * HD + d] = j < p.S ? v[j * p.v_ss + d] : 0.0f;
    }
    __syncthreads();

    float s[4][kBK / 8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < kBK / 8; ++c) s[r][c] = 0.0f;
    for (int d = 0; d < HD; ++d) {
      float qd[4], kd[kBK / 8];
#pragma unroll
      for (int r = 0; r < 4; ++r) qd[r] = Qs[(ty + 16 * r) * (HD + 1) + d];
#pragma unroll
      for (int c = 0; c < kBK / 8; ++c)
        kd[c] = Ks[(tx + 8 * c) * (HD + 1) + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kBK / 8; ++c)
          s[r][c] = fmaf(qd[r], kd[c], s[r][c]);
    }

    const bool masked = tile_needs_mask(p, q0, kb);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty + 16 * r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kBK / 8; ++c) {
        float x = s[r][c] * p.scale;
        if (masked && !visible(p, i, kb + tx + 8 * c)) x = -INFINITY;
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
      // the 8 threads of a row are lanes differing in their low 3 bits
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < kBK / 8; ++c) {
        const float pr = expf(s[r][c] - m_new);
        Ps[(ty + 16 * r) * (kBK + 1) + tx + 8 * c] = pr;
        sum += pr;
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();                 // P is complete

    for (int key = 0; key < kBK; ++key) {
      float vd[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vd[c] = Vs[key * HD + tx + 8 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float pr = Ps[(ty + 16 * r) * (kBK + 1) + key];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pr, vd[c], acc[r][c]);
      }
    }
  }

  float* o = static_cast<float*>(p.o);
  const long long o_ss = static_cast<long long>(p.H) * HD;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    lr += __shfl_xor_sync(0xffffffffu, lr, 4);
    lr = fmaxf(lr, 1e-30f);
    const int i = q0 + ty + 16 * r;
    if (i < p.S) {
      float* orow = o + (static_cast<long long>(b) * p.S + i) * o_ss + h * HD;
#pragma unroll
      for (int c = 0; c < kCols; ++c) orow[tx + 8 * c] = acc[r][c] / lr;
    }
  }
}

template <int HD>
cudaError_t launch_hd(const Params& p, int dtype, dim3 grid, cudaStream_t s) {
  if (dtype == 1) {
    flash_fwd_bf16<HD><<<grid, kThreads, 0, s>>>(p);
    return cudaGetLastError();
  }
  constexpr int bytes = f32_smem_bytes<HD>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  flash_fwd_f32<HD><<<grid, kThreads, bytes, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike). Strides are in
// elements; the head_dim axis of q, k, v is contiguous and out is a
// contiguous (B, S, H, hd). window <= 0: no window. Returns a cudaError_t.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int dtype, int B, int S, int H, int KV,
                           int hd, long long q_sb, long long q_ss,
                           long long q_sh, long long k_sb, long long k_ss,
                           long long k_sh, long long v_sb, long long v_ss,
                           long long v_sh, int causal, int window,
                           float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, out, S, H, KV, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                 v_sb, v_ss, v_sh, causal, window, scale};
  const dim3 grid(static_cast<unsigned>(B) * static_cast<unsigned>(H),
                  static_cast<unsigned>((S + kBQ - 1) / kBQ));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 64: err = launch_hd<64>(p, dtype, grid, s); break;
    case 80: err = launch_hd<80>(p, dtype, grid, s); break;
    case 128: err = launch_hd<128>(p, dtype, grid, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
