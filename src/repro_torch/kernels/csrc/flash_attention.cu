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
// at 3.35 TB/s. So the work is tensor-core products, and every design puts
// both products on the tensor cores and keeps scores and probabilities in
// registers, never in device memory.
//
// Three designs, by (dtype, hd); flash_attention_design names the one a
// launch takes:
//
// "tma-wgmma-ws" (bf16, hd 64 and 128: every ported config). Hopper's own
// shape for a product-bound kernel:
//   * one block of 3 warpgroups per (batch * head, 128-query tile), tiles
//     handed out heaviest first with the heads varying fastest, so the
//     query heads that share a KV head, and neighbouring tiles, read K/V
//     from L2 at the same time;
//   * warpgroup 0 is the producer: it gives up registers (setmaxnreg) and
//     one thread issues TMA loads: the 128 x hd Q tile once, then 128-key
//     K and V tiles into a ring of stages (2 at hd 128, 3 at hd 64) with a
//     full mbarrier each for K and for V (q.k^T starts before V lands) and
//     an empty mbarrier per stage. TMA boxes are 128 rows x 64 columns
//     (128 bytes, one swizzle span) with 128-byte swizzle; rows past S
//     arrive as zeros;
//   * warpgroups 1 and 2 are consumers, 64 query rows each, with 240
//     registers a thread. s = q.k^T is one wgmma m64n128k16 per 16 of hd,
//     both operands K-major in shared memory; the softmax runs in
//     registers in the log2 domain (scores scaled by hd^-0.5 * log2(e) in
//     one FMA, ex2.approx), masking only the tiles that hold a masked
//     pair; o += p.v is one wgmma m64n{hd}k16 per 16 keys with p as the A
//     operand straight from the registers of s (the f32 accumulator of
//     two adjacent 8-key columns, packed to bf16 pairs, is the A fragment)
//     and V as an MN-major B operand (transpose-B), read where TMA left it.
//     p is rounded to bf16 for p.v (l sums the unrounded p): a relative
//     error of at most 2^-9 per probability, inside the reference's bf16
//     tolerance (3e-2);
//   * the softmax is hidden under the products twice over (FA3's two
//     overlaps): inside a consumer, tile i's q.k^T and tile i-1's p.v are
//     issued together and the softmax of tile i waits only for the first;
//     between the consumers, named barriers let each issue its products
//     only after the other has issued its own (ping-pong), so one
//     warpgroup's softmax runs while the other's products do. K is
//     released as soon as s is computed, V after p.v, each on its own
//     empty barrier.
// "mma-sync" (bf16, hd 80; zamba2's head_dim, not a ported config yet):
//   * one block of 4 warps per (batch * head, 64-query tile); 64-key K/V
//     tiles staged in shared memory with 16-byte loads; q.k^T and p.v by
//     mma.sync.m16n8k16, q held in registers as A fragments, V fed through
//     ldmatrix.trans. 80 is 5 k-steps of 16 and 10 n-tiles of 8, so it
//     needs no padding. An 80-column row is 160 bytes, wider than the
//     128-byte swizzle span, so the TMA design would need its own box
//     layout for it.
// "fma" (f32, hd 64, 80, 128): the same tiling as "mma-sync", both
//   products by FMA in f32 (no TF32), for the reference's f32 tolerance.
//
// q/k/v are read through the strides the caller gives, in elements, for
// the batch, sequence and head axes (the head_dim axis is contiguous), so
// the (B, S, heads, hd) layout needs no transpose copy: the TMA design
// encodes them into 4-D tensor maps {hd, heads, S, B} on the host. TMA
// asks for a 16-byte-aligned base and strides that are multiples of 16
// bytes, which the wrapper requires of every bf16 input. out is
// contiguous.
//
// Plain C interface for ctypes: flash_attention_launch returns the
// cudaGetLastError() code of the launch (or of the tensor-map encoding);
// the wrapper raises on non-zero. cuTensorMapEncodeTiled is looked up at
// run time through the CUDA runtime's entry-point query, so nothing is
// linked beyond the runtime.

#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

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

// The key tiles of BK keys that query rows [q0, q0 + BQ) can see:
// [*kb0, *kb1), kb0 a multiple of BK.
template <int BQ, int BK>
__device__ __forceinline__ void key_range(const Params& p, int q0, int* kb0,
                                          int* kb1) {
  int end = p.S;
  if (p.causal) end = min(p.S, q0 + BQ);
  int begin = 0;
  if (p.window > 0) begin = max(0, q0 - p.window + 1);
  *kb0 = (begin / BK) * BK;
  *kb1 = end;
}

// Whether some (query, key) pair of rows [q0, q0 + BQ) and keys
// [kb, kb + BK) is masked.
template <int BQ, int BK>
__device__ __forceinline__ bool tile_needs_mask(const Params& p, int q0,
                                                int kb) {
  if (kb + BK > p.S) return true;
  if (p.causal && kb + BK - 1 > q0) return true;
  if (p.window > 0 && (q0 + BQ - 1) - kb >= p.window) return true;
  return false;
}

__device__ __forceinline__ bool visible(const Params& p, int i, int j) {
  return j < p.S && (!p.causal || i >= j) &&
         (p.window <= 0 || i - j < p.window);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------- "mma-sync" and "fma" designs
constexpr int kThreads = 128;        // 4 warps
constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // keys per staged tile

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
  key_range<kBQ, kBK>(p, q0, &kb0, &kb1);
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
    const bool masked = tile_needs_mask<kBQ, kBK>(p, q0, kb);
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
  key_range<kBQ, kBK>(p, q0, &kb0, &kb1);
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

    const bool masked = tile_needs_mask<kBQ, kBK>(p, q0, kb);
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

// ---------------------------------------------------- "tma-wgmma-ws" design
constexpr int kWsThreads = 384;      // producer + 2 consumer warpgroups
constexpr int kWsBQ = 128;           // query rows per block, 64 a consumer
constexpr int kWsBK = 128;           // keys per ring stage
constexpr int kBoxCols = 64;         // bf16 columns of a TMA box: 128 bytes
constexpr int kBoxBytes = 128 * 128; // a box: 128 rows x 128 bytes

template <int HD>
struct WsShape {
  static_assert(HD == 64 || HD == 128, "the TMA boxes tile hd 64 and 128");
  static constexpr int kBoxes = HD / kBoxCols;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;  // Q, K or V tile
  static constexpr int kStages = HD == 128 ? 2 : 3;
  // Q, the K stages, the V stages, then the mbarriers: Q full; K full, V
  // full, K empty and V empty per stage
  static constexpr int kBarOffset = kTileBytes * (1 + 2 * kStages);
  static constexpr int kSmemBytes =
      kBarOffset + 8 * (1 + 4 * kStages) + 1024;  // + room to align to 1 KB
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Waits until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory; completes on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory operand with 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFFu) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads of wgmma accumulators above the
// wait that makes them valid.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 128, f32) (+)= a (64 x 16, smem) * b (16 x 128, smem); both
// K-major. accumulate == 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, f32) += a (64 x 16, registers) * b (16 x 128, smem,
// MN-major: transpose-B).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += a (64 x 16, registers) * b (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n64(d, a, db);
}

// The online softmax's state of a consumer thread's two rows.
struct RowState {
  float m0 = kNegInf, m1 = kNegInf;   // running max (raw scores)
  float l0 = 0.0f, l1 = 0.0f;         // this thread's share of the sumexp
};

// One consumer warpgroup's online softmax over a 128-key tile, in the
// log2 domain. s[4 j + e] holds row (e < 2 ? row0 : row1), key
// kb + 8 j + 2 t4 + (e & 1); on return it holds p = exp(score - m), with
// m, l updated and the factor alpha that rescales the rows' accumulators.
__device__ __forceinline__ void softmax_tile(float (&s)[64], RowState& r,
                                             const Params& p, float c,
                                             int qw0, int kb, int row0,
                                             int t4, float* alpha0,
                                             float* alpha1) {
  const int row1 = row0 + 8;
  if (tile_needs_mask<64, kWsBK>(p, qw0, kb)) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!visible(p, e < 2 ? row0 : row1, kb + 8 * j + 2 * t4 + (e & 1)))
          s[4 * j + e] = -INFINITY;
      }
    }
  }
  // the 4 threads of a quad share a row
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(r.m0, mx0), mn1 = fmaxf(r.m1, mx1);
  *alpha0 = ex2((r.m0 - mn0) * c);
  *alpha1 = ex2((r.m1 - mn1) * c);
  r.m0 = mn0;
  r.m1 = mn1;
  const float mc0 = mn0 * c, mc1 = mn1 * c;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], c, -mc0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], c, -mc0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], c, -mc1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], c, -mc1));
    sum0 += s[4 * j] + s[4 * j + 1];
    sum1 += s[4 * j + 2] + s[4 * j + 3];
  }
  r.l0 = r.l0 * *alpha0 + sum0;
  r.l1 = r.l1 * *alpha1 + sum1;
}

// p as the A operand of p.v: the accumulator of two adjacent 8-key
// columns is the A fragment of one 16-key k-step.
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_ws(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const Params p) {
  using W = WsShape<HD>;
  constexpr int kStages = W::kStages;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1 KB: the boxes start on 1 KB bounds
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + W::kTileBytes;                 // stage st at
  const uint32_t v_s = k_s + kStages * W::kTileBytes;       // + st * tile
  const uint32_t q_full = q_s + W::kBarOffset;
  const uint32_t k_full = q_full + 8;                       // + 8 * st
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWsBQ;   // heaviest first
  int kb0, kb1;
  key_range<kWsBQ, kWsBK>(p, q0, &kb0, &kb1);
  const int n_tiles = (kb1 - kb0 + kWsBK - 1) / kWsBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, 8);  // one arrival per consumer warp
      mbar_init(v_empty + 8 * st, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // One branch per role to the end of the kernel, so that setmaxnreg
  // holds: 128 x 24 + 256 x 240 = 64,512 of the SM's 65,536 registers.
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, W::kTileBytes);
      for (int box = 0; box < W::kBoxes; ++box)
        tma_load(q_s + box * kBoxBytes, &tq, q_full, box * kBoxCols, h, q0,
                 b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const uint32_t free_parity = ((i / kStages) & 1) ^ 1;
        const int kb = kb0 + i * kWsBK;
        const uint32_t kf = k_full + 8 * st, vf = v_full + 8 * st;
        mbar_wait(k_empty + 8 * st, free_parity);
        mbar_expect_tx(kf, W::kTileBytes);
        for (int box = 0; box < W::kBoxes; ++box)
          tma_load(k_s + st * W::kTileBytes + box * kBoxBytes, &tk, kf,
                   box * kBoxCols, kvh, kb, b);
        mbar_wait(v_empty + 8 * st, free_parity);
        mbar_expect_tx(vf, W::kTileBytes);
        for (int box = 0; box < W::kBoxes; ++box)
          tma_load(v_s + st * W::kTileBytes + box * kBoxBytes, &tv, vf,
                   box * kBoxCols, kvh, kb, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = threadIdx.x / 128 - 1;         // consumer 0 or 1
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int qw0 = q0 + cw * 64;                 // its first query row
    const int row0 = qw0 + warp * 16 + g, row1 = row0 + 8;
    const float c = p.scale * 1.4426950408889634f;   // hd^-0.5 * log2(e)
    // its 64 rows of each Q box
    const uint32_t q_rows = q_s + cw * 64 * 128;

    // s = q.k^T of tile i: Q and K both K-major, rows of 128 bytes, 8-row
    // groups 1 KB apart, a 16-column k-step 32 bytes on, a box per 64
    auto issue_s = [&](float (&s)[64], int i) {
      const uint32_t kt = k_s + (i % kStages) * W::kTileBytes;
      mbar_wait(k_full + 8 * (i % kStages), (i / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n128(s, sw128_desc(q_rows + off, 16, 1024),
                      sw128_desc(kt + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // o += p.v of tile i: V is keys x hd with hd contiguous, an MN-major
    // B operand; 8-key groups 1 KB apart, 64-column boxes kBoxBytes
    // apart, a 16-key k-step 2 KB on
    auto issue_pv = [&](float (&o)[HD / 2], const uint32_t (&pa)[8][4],
                        int i) {
      const uint32_t vt = v_s + (i % kStages) * W::kTileBytes;
      mbar_wait(v_full + 8 * (i % kStages), (i / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs<HD>(o, pa[kk], sw128_desc(vt + kk * 2048, kBoxBytes, 1024));
      wgmma_commit();
    };
    // ping-pong: consumer cw issues its products after bar.sync on named
    // barrier 1 + cw (0 is __syncthreads'), which the other consumer
    // arrives at once it has issued its own
    auto my_turn = [&]() {
      asm volatile("bar.sync %0, 256;\n" :: "r"(1 + cw) : "memory");
    };
    auto your_turn = [&]() {
      asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - cw) : "memory");
    };
    auto release = [&](uint32_t empty, int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (i % kStages));
    };

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
    RowState rows;
    float s[64], alpha0, alpha1;
    uint32_t pa[8][4];
    auto rescale_o = [&]() {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= alpha0;
        o[4 * j + 1] *= alpha0;
        o[4 * j + 2] *= alpha1;
        o[4 * j + 3] *= alpha1;
      }
    };

    mbar_wait(q_full, 0);
    if (cw == 1) your_turn();                     // consumer 0 goes first
    my_turn();
    issue_s(s, 0);
    your_turn();
    wgmma_wait<0>();
    fence_regs(s);
    release(k_empty, 0);
    softmax_tile(s, rows, p, c, qw0, kb0, row0, t4, &alpha0, &alpha1);
    pack_p(s, pa);
    // tile i's q.k^T runs on the tensor cores while tile i - 1's p.v
    // queues behind it and tile i's softmax waits only for the first
    for (int i = 1; i < n_tiles; ++i) {
      my_turn();
      issue_s(s, i);
      issue_pv(o, pa, i - 1);
      your_turn();
      wgmma_wait<1>();                            // s of tile i is done
      fence_regs(s);
      release(k_empty, i);
      softmax_tile(s, rows, p, c, qw0, kb0 + i * kWsBK, row0, t4,
                   &alpha0, &alpha1);
      wgmma_wait<0>();                            // p.v of tile i - 1 too
      fence_regs(o);
      release(v_empty, i - 1);
      rescale_o();
      pack_p(s, pa);
    }
    my_turn();
    issue_pv(o, pa, n_tiles - 1);
    if (cw == 0) your_turn();      // consumer 1's last turn has no successor
    wgmma_wait<0>();
    fence_regs(o);
    release(v_empty, n_tiles - 1);

    // full row sums over the quad, then out = acc / max(l, 1e-30)
    float l0 = rows.l0, l1 = rows.l1;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    l0 = fmaxf(l0, 1e-30f);
    l1 = fmaxf(l1, 1e-30f);
    auto* out = static_cast<__nv_bfloat16*>(p.o);
    const long long o_ss = static_cast<long long>(p.H) * HD;
    __nv_bfloat16* o0 = out +
                        (static_cast<long long>(b) * p.S + row0) * o_ss +
                        h * HD + t4 * 2;
    __nv_bfloat16* o1 = o0 + 8 * o_ss;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (row0 < p.S)
        *reinterpret_cast<uint32_t*>(o0 + j * 8) =
            pack_bf16(o[4 * j] / l0, o[4 * j + 1] / l0);
      if (row1 < p.S)
        *reinterpret_cast<uint32_t*>(o1 + j * 8) =
            pack_bf16(o[4 * j + 2] / l1, o[4 * j + 3] / l1);
    }
  }
}

// ------------------------------------------------------------------ host
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (B, S, heads, hd) bf16 operand read through its element strides, as a
// 4-D tensor map {hd, heads, S, B} of 128-row x 64-column boxes with
// 128-byte swizzle. A stride over an axis of extent 1 is never used; it is
// given the contiguous value, which TMA always takes.
cudaError_t encode_operand(CUtensorMap* map, const void* base, int B, int S,
                           int heads, int hd, long long sb, long long ss,
                           long long sh) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const long long elems[3] = {sh, ss, sb};
  cuuint64_t strides[3];
  cuuint64_t dense = static_cast<cuuint64_t>(hd) * 2;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] == 1 ? dense
                                  : static_cast<cuuint64_t>(elems[i]) * 2;
    dense = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {kBoxCols, 1, 128, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One block per (batch * head, tile of `rows` queries): the grid's x
// extent is B * H, its y extent the query tiles, at most 65535. Returns
// false where the input exceeds it.
bool grid_of(const Params& p, int B, int rows, dim3* grid) {
  const long long bh = static_cast<long long>(B) * p.H;
  const long long tiles = (static_cast<long long>(p.S) + rows - 1) / rows;
  if (bh >= (1LL << 31) || tiles > 65535) return false;
  *grid = dim3(static_cast<unsigned>(bh), static_cast<unsigned>(tiles));
  return true;
}

template <int HD>
cudaError_t launch_ws(const Params& p, int B, cudaStream_t s) {
  dim3 grid;
  if (!grid_of(p, B, kWsBQ, &grid)) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t err =
      encode_operand(&tq, p.q, B, p.S, p.H, HD, p.q_sb, p.q_ss, p.q_sh);
  if (err == cudaSuccess)
    err = encode_operand(&tk, p.k, B, p.S, p.KV, HD, p.k_sb, p.k_ss, p.k_sh);
  if (err == cudaSuccess)
    err = encode_operand(&tv, p.v, B, p.S, p.KV, HD, p.v_sb, p.v_ss, p.v_sh);
  if (err != cudaSuccess) return err;
  constexpr int bytes = WsShape<HD>::kSmemBytes;
  err = cudaFuncSetAttribute(
      flash_fwd_ws<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  flash_fwd_ws<HD><<<grid, kWsThreads, bytes, s>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

cudaError_t launch_mma_sync_hd80(const Params& p, int B, cudaStream_t s) {
  dim3 grid;
  if (!grid_of(p, B, kBQ, &grid)) return cudaErrorInvalidValue;
  flash_fwd_bf16<80><<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_fma(const Params& p, int B, cudaStream_t s) {
  dim3 grid;
  if (!grid_of(p, B, kBQ, &grid)) return cudaErrorInvalidValue;
  constexpr int bytes = f32_smem_bytes<HD>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  flash_fwd_f32<HD><<<grid, kThreads, bytes, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The design a launch with this dtype (0 = float32, 1 = bfloat16) and
// head_dim takes, or nullptr where there is none.
const char* flash_attention_design(int dtype, int hd) {
  if (hd != 64 && hd != 80 && hd != 128) return nullptr;
  if (dtype == 0) return "fma";
  if (dtype != 1) return nullptr;
  return hd == 80 ? "mma-sync" : "tma-wgmma-ws";
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike). Strides are in
// elements; the head_dim axis of q, k, v is contiguous and out is a
// contiguous (B, S, H, hd). window <= 0: no window. Returns a cudaError_t:
// cudaErrorInvalidValue where no design takes the input or it exceeds the
// grid of the design it takes.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int dtype, int B, int S, int H, int KV,
                           int hd, long long q_sb, long long q_ss,
                           long long q_sh, long long k_sb, long long k_ss,
                           long long k_sh, long long v_sb, long long v_ss,
                           long long v_sh, int causal, int window,
                           float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || flash_attention_design(dtype, hd) == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, out, S, H, KV, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                 v_sb, v_ss, v_sh, causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1 && hd == 128) err = launch_ws<128>(p, B, s);
  else if (dtype == 1 && hd == 64) err = launch_ws<64>(p, B, s);
  else if (dtype == 1) err = launch_mma_sync_hd80(p, B, s);
  else if (hd == 64) err = launch_fma<64>(p, B, s);
  else if (hd == 80) err = launch_fma<80>(p, B, s);
  else err = launch_fma<128>(p, B, s);
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
