// GQA flash attention, forward only, on Hopper's tensor cores as 3xTF32
// (sm_90a): fp32 prefill at every head_dim, bf16 prefill at head_dim 32.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:_kernel (launched
// by flash_attention, the Pallas call over a (batch, q head, q block, kv
// block) grid with the kv axis sequential) for the calls the wrapper
// (repro_torch/kernels/flash_attention.py:_variant, "tf32x3") sends here:
// every prefill (Sq > 1) in fp32, and bf16 prefill at H = 32. bf16 prefill
// at (H, Hv) in {(64, 64), (128, 128), (256, 256), (192, 128), (112, 112)}
// goes to flash_attention_sm90.cu and every Sq = 1 call to
// flash_attention_decode.cu; launched directly, this kernel takes any Sq >=
// 1 in either dtype at (H, Hv) in {(32, 32), (64, 64), (112, 112), (128,
// 128), (256, 256), (192, 128)}. (192, 128) is deepseek-v2-lite-16b's MLA
// prefill in its expanded form (q and k 128 nope + 64 rope columns, v
// 128), and (112, 112) zamba2-7b's shared attention block, which the
// card-vs-CPU parities run in fp32.
//
//   o[b, i, n] = softmax_j(scale * q[b, i, n] . k[b, j, n / G]) v[b, j, n / G]
//
// over the kv positions j that the masks leave: j < k_len; j <= i +
// q_offset when causal; j > i + q_offset - window when window > 0.
// q (B, Sq, N, H), k (B, Sk, K, H), v (B, Sk, K, Hv), G = N / K; o (B, Sq,
// N, Hv) in q's dtype. As the
// TPU kernel: q is scaled in fp32 before the product, masked scores are
// -1e30 (not -inf), each kv tile rescales the running sum and accumulator
// by exp(m_old - m_new), and the output is acc / max(l, 1e-30).
//
// What bounds it on an H100: operations. A (query, key) pair that the masks
// leave costs 2 H + 2 Hv flops per q head (S = Q K^T and P V); as 3xTF32 each
// product runs three times on the tensor cores, 3 x 4 H flops against
// TF32's 495 TFLOP/s: at (1, 4096, 24/8, 128) causal 0.625 ms, against
// 0.03 ms of bytes and 1.54 ms for any kernel held to the fp32 cores'
// 67 TFLOP/s.
//
// Why 3xTF32: fp32 reaches the tensor cores only as TF32, whose 10-bit
// mantissa misses the fp32 bound of 3e-5 (about 2e-4 to 5e-4 on attention
// outputs), which is why the port keeps TF32 off. Each operand x is split
// into hi = tf32(x) and lo = tf32(x - hi) (rounded as cvt.rna: to nearest,
// ties away from zero), and lo·hi + hi·lo + hi·hi is accumulated in fp32,
// small terms first; the dropped lo·lo is about 2^-22 of the product, so
// the result is fp32-accurate. bf16 inputs are exact in TF32 (their lo is 0), so K's and
// V's lo products are skipped for them; q and p are fp32 and keep theirs.
//
// Why mma.sync and not wgmma: tf32 wgmma takes both shared-memory operands
// K-major only, so P V would need V transposed into shared memory, and the
// lo halves of K and V staged there beside the hi halves, doubling shared
// memory. mma.sync m16n8k8 reads its fragments from registers, so each
// thread splits what it loads. wgmma is a later lever if the numbers call
// for it.
//
// The design:
// - One block per (batch, kv head, tile of BM flattened (query, q head of
//   the group) rows): row t is (query t / G, q head kvh * G + t % G), so
//   the G q heads that share a kv head share each K/V tile. Each warp owns
//   16 rows, one m16 tile. Blocks are taken heaviest first (the last q rows
//   see the most keys under the causal mask), so the last wave is short.
// - Q is loaded once, scaled in fp32, into shared memory in the A
//   fragment's order, so a warp reads a k-step's fragment with one 16-byte
//   load per lane. K and V come in tiles of BN keys through a two-stage
//   ring filled by 16-byte cp.async: tile k + 1 is in flight while tile k
//   is consumed. Keys at or past k_len and rows past Sq * G are zero-filled,
//   so padded V rows are 0 as the TPU kernel pads them. Rows of K are
//   H + 8 elements apart and rows of V Hv + 4 (fp32) or Hv + 8 (bf16), so
//   the fragment loads below hit 32 distinct banks.
// - S = Q K^T: within each 8-wide k-step, k-index t reads h = 2t and
//   k-index t + 4 reads h = 2t + 1 (in A and B alike, so the sum is the
//   same), which makes B's two elements, K[g][2t] and K[g][2t + 1], one
//   8-byte (fp32) or 4-byte (bf16) load.
// - Masks and the online softmax work on the accumulator fragment: a thread
//   holds rows g and g + 8 and keys 2t, 2t + 1 of each n8 tile; the row max
//   is reduced over the 4 lanes that share a row, the row sum stays per
//   thread until the epilogue. Kv tiles the masks wholly exclude for the
//   block are never loaded, tiles they wholly exclude for a warp's rows are
//   skipped by that warp, and tiles wholly inside the masks skip the
//   per-element mask.
// - O += P V with no shuffles: the S fragment of keys 8j .. 8j + 7 is P's
//   A fragment for k-step j, reading key 2t as k-index t and key 2t + 1 as
//   t + 4; V's B fragment takes the same keys, V[2t][g] and V[2t + 1][g].
// - O's fragment, 16 x Hv fp32 a warp, is Hv / 2 registers a thread. At
//   H = 64 and 128 a block is 128 rows (8 warps) with 64-key tiles, one
//   block an SM (capped at 128 registers for two, H = 64 spilled). At
//   H = 256 it is 64 rows (4 warps) with 32-key tiles: 128 rows of Q and
//   two stages of K and V would not fit in 227 KB. At (192, 128) it is 128
//   rows with 32-key tiles: Q 96 KB and two stages of K (25 KB each) and V
//   (16.5 KB each) in fp32, 179 KB. At (112, 112) it is 64 rows (4 warps)
//   with 32-key tiles, as every H that is neither 64 nor 128: 14 k8 steps
//   of S, O 56 registers a thread, 87 KB in fp32. At H = 32 it is 64 rows
//   with 32-key tiles, four blocks an SM within 128 registers: the reduced
//   configs' calls are a few dozen to a thousand blocks, and smaller blocks
//   spread them over more SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "kernel_attrs.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int H, int HV>
struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr bool SQUARE_MID = H == HV && (H == 64 || H == 128);
  static constexpr int WARPS = SQUARE_MID || H != HV ? 8 : 4;
  static constexpr int MIN_BLOCKS = H == 32 ? 4 : 1;  // blocks an SM, for the register cap
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BM = 16 * WARPS;       // flattened rows a block
  static constexpr int BN = SQUARE_MID ? 64 : 32;  // keys a K/V tile
  static constexpr int KS = H + 8;            // K row stride, elements
  static constexpr int VS = F32 ? HV + 4 : HV + 8;  // V row stride, elements
  static constexpr int VE = 16 / (int)sizeof(T);  // elements a 16-byte copy
  static constexpr int Q_BYTES = BM * H * 4;
  static constexpr int K_TILE = BN * KS;      // elements
  static constexpr int V_TILE = BN * VS;
  static constexpr int SMEM = Q_BYTES + 2 * (K_TILE + V_TILE) * (int)sizeof(T);
  static constexpr int NT = BN / 8;           // n8 tiles of S, k-steps of P V
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; with valid false the 16 bytes are
// zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), for every finite x short of fp32's overflow: add half of the
// 13 dropped bits' range to the magnitude's bits and clear them. ptxas
// expands cvt.rna.tf32.f32 into a compare and select around this same add
// and mask, and the kernel ran slower with it.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32; x - hi is exact in fp32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d (16 x 8 fp32) += a (16 x 8 tf32, row) * b (8 x 8 tf32, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of global T at p as floats
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 two;
    *reinterpret_cast<uint32_t*>(&two) = w[i];
    const float2 f = __bfloat1622float2(two);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// shared-memory fragment loads: two neighbouring elements, and one
__device__ __forceinline__ float2 ld_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Offset in Q's shared tile of element (row r, column h): warp r / 16's
// A fragment of k-step h / 8, lane 4 (r % 8) + (h % 8) / 2, register
// (r % 16) / 8 + 2 (h % 2).
template <int H>
__device__ __forceinline__ int q_slot(int r, int h) {
  return (((r >> 4) * (H / 8) + (h >> 3)) * 32 + 4 * (r & 7) + ((h & 7) >> 1)) * 4 +
         ((r >> 3) & 1) + 2 * (h & 1);
}

template <typename T, int H, int HV>
__global__ void __launch_bounds__(Cfg<T, H, HV>::THREADS, Cfg<T, H, HV>::MIN_BLOCKS)
flash_tf32x3_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, int Sq, int Sk, int N, int K, int causal, int window,
                    long long q_offset, int k_len, float scale) {
  using C = Cfg<T, H, HV>;
  constexpr int BM = C::BM, BN = C::BN, NT = C::NT;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [warp][k-step][lane][4], scaled
  T* Ks = reinterpret_cast<T*>(reinterpret_cast<char*>(smem4) + C::Q_BYTES);  // 2 stages
  T* Vs = Ks + 2 * C::K_TILE;                                                 // 2 stages

  // blocks heaviest first: the q block index runs slowest, in reverse
  const int G = N / K;
  const long long lin =
      blockIdx.x + (long long)gridDim.x * (blockIdx.y + (long long)gridDim.y * blockIdx.z);
  const long long per = (long long)gridDim.y * gridDim.z;
  const int qblk = gridDim.x - 1 - (int)(lin / per);
  const int kvh = (int)(lin % per) % K, b = (int)(lin % per) / K;

  const int tid = threadIdx.x;
  const long long rows_total = (long long)Sq * G;
  const long long row0 = (long long)qblk * BM;
  const long long row_end = row0 + BM < rows_total ? row0 + BM : rows_total;

  // kv range the block's rows can see
  const long long q_lo = q_offset + row0 / G;
  const long long q_hi = q_offset + (row_end - 1) / G;
  long long j_hi = (long long)k_len - 1;
  if (causal && q_hi < j_hi) j_hi = q_hi;
  long long j_lo = 0;
  if (window > 0 && q_lo - window + 1 > j_lo) j_lo = q_lo - window + 1;
  const long long kt0 = (j_lo / BN) * BN;
  const int n_tiles = j_hi < kt0 ? 0 : (int)((j_hi - kt0) / BN + 1);

  auto load_kv = [&](int stage, long long kt) {
    constexpr int U = H / C::VE, UV = HV / C::VE;  // 16-byte units a k row, a v row
    T* ks = Ks + stage * C::K_TILE;
    T* vs = Vs + stage * C::V_TILE;
    for (int e = tid; e < BN * U; e += C::THREADS) {
      const int j = e / U, u = e % U;
      const long long kp = kt + j;
      const bool ok = kp < k_len;
      const long long off = ok ? (((long long)b * Sk + kp) * K + kvh) * H + u * C::VE : 0;
      cp_async16(smem_u32(ks + j * C::KS + u * C::VE), k + off, ok);
      if constexpr (H == HV)  // one walk for both
        cp_async16(smem_u32(vs + j * C::VS + u * C::VE), v + off, ok);
    }
    if constexpr (H != HV) {
      for (int e = tid; e < BN * UV; e += C::THREADS) {
        const int j = e / UV, u = e % UV;
        const long long kp = kt + j;
        const bool ok = kp < k_len;
        const long long off = ok ? (((long long)b * Sk + kp) * K + kvh) * HV + u * C::VE : 0;
        cp_async16(smem_u32(vs + j * C::VS + u * C::VE), v + off, ok);
      }
    }
  };
  if (n_tiles > 0) load_kv(0, kt0);
  cp_async_commit();

  // Q once, scaled in fp32, in fragment order; rows past Sq * G are zeros
  for (int e = tid * C::VE; e < BM * H; e += C::THREADS * C::VE) {
    const int r = e / H, h = e % H;
    const long long t = row0 + r;
    float x[C::VE];
    if (t < rows_total) {
      load16(q + (((long long)b * Sq + t / G) * N + (long long)kvh * G + t % G) * H + h, x);
    } else {
#pragma unroll
      for (int c = 0; c < C::VE; ++c) x[c] = 0.0f;
    }
#pragma unroll
    for (int c = 0; c < C::VE; ++c) Qs[q_slot<H>(r, h + c)] = x[c] * scale;
  }

  // this thread's rows: lane l of warp w holds rows 16 w + l / 4 and
  // 16 w + l / 4 + 8 of the block, and of each 8-key group the keys
  // 2 (l % 4) and + 1
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const long long wrow0 = row0 + 16 * warp;
  const bool w_active = wrow0 < rows_total;
  const long long wrow_end = wrow0 + 16 < rows_total ? wrow0 + 16 : rows_total;
  const long long wq_lo = q_offset + wrow0 / G;
  const long long wq_hi = w_active ? q_offset + (wrow_end - 1) / G : wq_lo;
  const long long t_r[2] = {wrow0 + g, wrow0 + g + 8};
  const long long qpos[2] = {q_offset + t_r[0] / G, q_offset + t_r[1] / G};
  const float* qw = Qs + warp * (H / 8) * 128;

  float acc[HV / 8][4];
#pragma unroll
  for (int n = 0; n < HV / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};

  for (int it = 0; it < n_tiles; ++it) {
    const long long kt = kt0 + (long long)it * BN;
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_kv(stage ^ 1, kt + BN);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile it have landed
    __syncthreads();     // everyone's, and Q

    const bool skip = (causal && kt > wq_hi) || (window > 0 && kt + BN - 1 <= wq_lo - window);
    if (w_active && !skip) {
      const T* ks = Ks + stage * C::K_TILE;
      const T* vs = Vs + stage * C::V_TILE;

      // S = Q K^T; s[j][c]: row g + 8 (c / 2), key kt + 8 j + 2 t4 + c % 2
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < H / 8; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(qw + kk * 128 + lane * 4);
        uint32_t ah[4], al[4];
        split(a.x, ah[0], al[0]);
        split(a.y, ah[1], al[1]);
        split(a.z, ah[2], al[2]);
        split(a.w, ah[3], al[3]);
        const T* kr = ks + g * C::KS + 8 * kk + 2 * t4;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 bk = ld_pair(kr + 8 * j * C::KS);
          if constexpr (C::F32) {
            uint32_t bh0, bl0, bh1, bl1;
            split(bk.x, bh0, bl0);
            split(bk.y, bh1, bl1);
            mma(s[j], al, bh0, bh1);
            mma(s[j], ah, bl0, bl1);
            mma(s[j], ah, bh0, bh1);
          } else {  // bf16 is exact in TF32: K's lo is 0
            const uint32_t b0 = __float_as_uint(bk.x), b1 = __float_as_uint(bk.y);
            mma(s[j], al, b0, b1);
            mma(s[j], ah, b0, b1);
          }
        }
      }

      const bool full = kt + BN <= k_len && (!causal || kt + BN - 1 <= wq_lo) &&
                        (window <= 0 || kt > wq_hi - window);
      if (!full) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const long long kp = kt + 8 * j + 2 * t4 + (c & 1);
            const long long qp = qpos[c >> 1];
            bool ok = kp < k_len;
            if (causal) ok = ok && qp >= kp;
            if (window > 0) ok = ok && kp > qp - window;
            if (!ok) s[j][c] = kNeg;
          }
        }
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNeg;
#pragma unroll
        for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        alpha[h] = exp2f((m[h] - m_new) * kLog2e);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = s[j][2 * h + c];
            x = exp2f((x - m_new) * kLog2e);
            sum += x;
          }
        }
        l[h] = l[h] * alpha[h] + sum;
        m[h] = m_new;
      }
#pragma unroll
      for (int n = 0; n < HV / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }

      // O += P V; k-step j is keys kt + 8 j .. + 7, key 2 t4 as k-index t4
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t ph[4], pl[4];
        split(s[j][0], ph[0], pl[0]);
        split(s[j][2], ph[1], pl[1]);
        split(s[j][1], ph[2], pl[2]);
        split(s[j][3], ph[3], pl[3]);
        const T* vr = vs + (8 * j + 2 * t4) * C::VS + g;
#pragma unroll
        for (int n = 0; n < HV / 8; ++n) {
          const float v0 = ld1(vr + 8 * n), v1 = ld1(vr + C::VS + 8 * n);
          if constexpr (C::F32) {
            uint32_t bh0, bl0, bh1, bl1;
            split(v0, bh0, bl0);
            split(v1, bh1, bl1);
            mma(acc[n], pl, bh0, bh1);
            mma(acc[n], ph, bl0, bl1);
            mma(acc[n], ph, bh0, bh1);
          } else {  // V's lo is 0
            const uint32_t b0 = __float_as_uint(v0), b1 = __float_as_uint(v1);
            mma(acc[n], pl, b0, b1);
            mma(acc[n], ph, b0, b1);
          }
        }
      }
    }
    __syncthreads();  // stage `stage` is free for the load of tile it + 2
  }
  cp_async_wait<0>();

  if (!w_active) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(kFull, lt, 1);
    lt += __shfl_xor_sync(kFull, lt, 2);
    const long long t = t_r[h];
    if (t >= rows_total) continue;
    const float denom = fmaxf(lt, 1e-30f);
    T* orow = o + (((long long)b * Sq + t / G) * N + (long long)kvh * G + t % G) * HV + 2 * t4;
#pragma unroll
    for (int n = 0; n < HV / 8; ++n)
      store2(orow + 8 * n, acc[n][2 * h] / denom, acc[n][2 * h + 1] / denom);
  }
}

// above 48 KB needs the opt-in: once per instance, before its first launch
// (and before its attributes are read)
template <typename T, int H, int HV>
cudaError_t opt_in() {
  using C = Cfg<T, H, HV>;
  static_assert(C::SMEM <= 232448, "shared memory over the 227 KB a block may have");
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_tf32x3_kernel<T, H, HV>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  return cudaSuccess;
}

template <typename T, int H, int HV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Sk, int N, int K, int causal, int window, long long q_offset,
                   int k_len, float scale, cudaStream_t stream) {
  using C = Cfg<T, H, HV>;
  const cudaError_t e = opt_in<T, H, HV>();
  if (e != cudaSuccess) return e;
  const long long rows = (long long)Sq * (N / K);
  const dim3 grid((unsigned)((rows + C::BM - 1) / C::BM), (unsigned)K, (unsigned)B);
  flash_tf32x3_kernel<T, H, HV><<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, N, K, causal, window, q_offset, k_len, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int H, int Hv, const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Sk, int N, int K, int causal, int window,
                     long long q_offset, int k_len, float scale, cudaStream_t stream) {
  if (H == 192 && Hv == 128)
    return launch<T, 192, 128>(q, k, v, o, B, Sq, Sk, N, K, causal, window, q_offset, k_len,
                               scale, stream);
  if (H != Hv) return cudaErrorInvalidValue;
  switch (H) {
    case 32:
      return launch<T, 32, 32>(q, k, v, o, B, Sq, Sk, N, K, causal, window, q_offset, k_len, scale, stream);
    case 64:
      return launch<T, 64, 64>(q, k, v, o, B, Sq, Sk, N, K, causal, window, q_offset, k_len, scale, stream);
    case 112:
      return launch<T, 112, 112>(q, k, v, o, B, Sq, Sk, N, K, causal, window, q_offset, k_len, scale, stream);
    case 128:
      return launch<T, 128, 128>(q, k, v, o, B, Sq, Sk, N, K, causal, window, q_offset, k_len, scale, stream);
    case 256:
      return launch<T, 256, 256>(q, k, v, o, B, Sq, Sk, N, K, causal, window, q_offset, k_len, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// an instance's attributes, read after its opt-in as its launch makes it
template <typename T, int H, int HV>
cudaError_t instance_attrs(long long* out) {
  const cudaError_t e = opt_in<T, H, HV>();
  if (e != cudaSuccess) return e;
  return kernel_attrs(flash_tf32x3_kernel<T, H, HV>, Cfg<T, H, HV>::SMEM, out);
}

template <typename T>
cudaError_t attrs(int H, int Hv, long long* out) {
  if (H == 192 && Hv == 128) return instance_attrs<T, 192, 128>(out);
  if (H != Hv) return cudaErrorInvalidValue;
  switch (H) {
    case 32:
      return instance_attrs<T, 32, 32>(out);
    case 64:
      return instance_attrs<T, 64, 64>(out);
    case 112:
      return instance_attrs<T, 112, 112>(out);
    case 128:
      return instance_attrs<T, 128, 128>(out);
    case 256:
      return instance_attrs<T, 256, 256>(out);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// is_bf16: 0 for fp32 q/k/v/o, 1 for bf16. q and k (.., H), v and o (..,
// Hv); pointers 16-byte aligned and contiguous; (H, Hv) in {(32, 32), (64,
// 64), (112, 112), (128, 128), (256, 256), (192, 128)} (else
// cudaErrorInvalidValue);
// N % K == 0 (the wrapper checks).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                               int Sq, int Sk, int N, int K, int H, int Hv, int is_bf16,
                               int causal, int window, long long q_offset, int k_len,
                               float scale, cudaStream_t stream) {
  if ((long long)B * Sq * N == 0) return (int)cudaGetLastError();
  const cudaError_t e =
      is_bf16 ? dispatch<__nv_bfloat16>(H, Hv, q, k, v, o, B, Sq, Sk, N, K, causal, window,
                                        q_offset, k_len, scale, stream)
              : dispatch<float>(H, Hv, q, k, v, o, B, Sq, Sk, N, K, causal, window, q_offset,
                                k_len, scale, stream);
  return (int)e;
}

// The attributes of the instance (H, Hv) for dtype (is_bf16), as
// kernel_attrs.cuh reports them (out[6]: registers, local bytes, static
// shared bytes, the most threads a block, the dynamic shared bytes its
// launch passes and the opt-in), after the opt-in its launch makes.
extern "C" int flash_attention_attrs(int H, int Hv, int is_bf16, long long* out) {
  return (int)(is_bf16 ? attrs<__nv_bfloat16>(H, Hv, out) : attrs<float>(H, Hv, out));
}
