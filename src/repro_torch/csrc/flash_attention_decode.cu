// GQA flash attention at decode (one query per sequence), forward only, for
// Hopper (sm_90a): split the kv axis across blocks, then merge the partial
// softmax states.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:_kernel (launched
// by flash_attention, the Pallas call over a (batch, q head, q block, kv
// block) grid with the kv axis sequential) for Sq = 1.
//
//   o[b, n] = softmax_j(scale * q[b, n] . k[b, j, n / G]) v[b, j, n / G]
//
// q (B, 1, N, H), k and v (B, Sk, K, H), G = N / K, fp32 or bf16; o in q's
// dtype. With one query at qpos = q_offset the keys the masks leave are one
// range, [j_lo, j_hi]: j_hi = k_len - 1, or min(k_len - 1, qpos) when causal;
// j_lo = max(0, qpos - window + 1) when window > 0, else 0. Every key inside
// it is visible and none outside it is read, so no per-key mask is needed
// (qpos >= k_len attends the whole cache). The TPU kernel's constants stay:
// running maxima start at -1e30, and the output is acc / max(l, 1e-30), so a
// row with no visible key gets 0, as the TPU kernel gives when it reaches no
// kv block.
//
// What bounds it on an H100: reading the kv rows of the range once (bytes);
// the arithmetic is 4 H flops per key and q head against 4 H bytes (bf16).
//
// What the design does about it:
// - Pass 1, grid (splits, K * ceil(G / GT), B): block (s, kv head, b) walks
//   keys [j_lo + s * chunk, j_lo + (s + 1) * chunk) of the range, so a long
//   cache fills the card with B * K * splits blocks (the host picks chunk and
//   splits, kernels/flash_attention._decode_plan). The block's GT <= 8 q
//   heads share each K/V row it reads (GQA costs no extra reads), their
//   scaled q rows held in registers in fp32.
// - A key row is read by a group of LPK lanes with 16-byte loads (LPK = H
//   elements / 8 for bf16, / 4 for fp32, rounded up to a power of two, at
//   most 32); the dot product is reduced by xor shuffles within the group,
//   which need LPK to be a power of two that divides 32. At H = 112
//   (zamba2-7b's shared attention block) a row is 14 loads in bf16 and 28
//   in fp32: LPK is 16 and 32, and the lanes past the row's last load are
//   idle (they load nothing, hold zeros and add zeros to the sums). The
//   warps and lane groups take interleaved keys, and each lane issues the
//   loads of U keys before it uses any, so many loads are in flight per
//   thread.
// - Each lane group keeps its own online softmax per row (scores in the
//   log2 domain, q pre-scaled by scale * log2 e); at the end the groups of a
//   warp merge by shuffles and the warps through shared memory, in a fixed
//   order.
// - With one split, pass 1 writes the output. Otherwise it writes the
//   unnormalised partials (m, l, acc[H]) in fp32 to the workspace, and pass
//   2, one warp per (b, q head), merges them in split order:
//   m* = max m_s, l = sum l_s 2^(m_s - m*), o = sum acc_s 2^(m_s - m*) /
//   max(l, 1e-30). Every order is fixed, so results repeat bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRows = 8;  // q heads per block

constexpr int pow2_ceil(int n) { return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2); }

template <typename T, int H, int GT>
struct Layout {
  static constexpr int VE = 16 / (int)sizeof(T);                // elements per 16-byte load
  static constexpr int UNITS = H / VE;                          // 16-byte loads per row
  static constexpr int LPK = UNITS < 32 ? pow2_ceil(UNITS) : 32;  // lanes per key row
  static constexpr int PIECES = (UNITS + LPK - 1) / LPK;        // 16-byte loads per row and lane
  static constexpr bool IDLE = PIECES * LPK != UNITS;           // some lanes load nothing
  static constexpr int EPL = PIECES * VE;                       // elements per lane
  static constexpr int KPW = 32 / LPK;                          // keys per warp at once
  static constexpr int U = GT >= 8 ? 2 : (GT >= 4 ? 4 : 8);     // keys per lane in flight
  static constexpr int STEP = kWarps * KPW * U;                 // keys per block step
  static_assert(H % VE == 0 && (IDLE ? PIECES == 1 : UNITS % LPK == 0), "no lane map for H");
  // whether load p of lane gl holds columns of the row
  static __device__ __forceinline__ bool holds(int p, int gl) {
    return !IDLE || p * LPK + gl < UNITS;
  }
};

__device__ __forceinline__ void unpack(const uint4& x, float* out, float) {
  out[0] = __uint_as_float(x.x);
  out[1] = __uint_as_float(x.y);
  out[2] = __uint_as_float(x.z);
  out[3] = __uint_as_float(x.w);
}

__device__ __forceinline__ void unpack(const uint4& x, float* out, __nv_bfloat16) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// the visible key range of a query at qpos (empty when j_lo > j_hi)
__device__ __forceinline__ void key_range(int causal, int window, long long qpos, int k_len,
                                          long long* j_lo, long long* j_hi) {
  *j_hi = (long long)k_len - 1;
  if (causal && qpos < *j_hi) *j_hi = qpos;
  *j_lo = 0;
  if (window > 0 && qpos - window + 1 > 0) *j_lo = qpos - window + 1;
}

template <typename T, int H, int GT>
__global__ void __launch_bounds__(kThreads)
flash_decode_split(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   T* __restrict__ o, float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                   int Sk, int N, int K, int causal, int window, long long q_offset, int k_len,
                   float scale_log2, int chunk, int splits) {
  using L = Layout<T, H, GT>;
  __shared__ float sm_acc[kWarps][GT][H];
  __shared__ float sm_m[kWarps][GT], sm_l[kWarps][GT];

  const int G = N / K;
  const int groups = (G + GT - 1) / GT;
  const int s = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / groups, g0 = (blockIdx.y % groups) * GT;
  const int rows = G - g0 < GT ? G - g0 : GT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / L::LPK, gl = lane % L::LPK;

  long long j_lo, j_hi;
  key_range(causal, window, q_offset, k_len, &j_lo, &j_hi);
  const long long s0 = j_lo + (long long)s * chunk;
  const long long s1 = s0 + chunk - 1 < j_hi ? s0 + chunk - 1 : j_hi;

  // this lane's columns of each q row, scaled into the log2 domain
  float qr[GT][L::EPL];
#pragma unroll
  for (int r = 0; r < GT; ++r) {
#pragma unroll
    for (int p = 0; p < L::PIECES; ++p) {
      float x[L::VE];
      if (r < rows && L::holds(p, gl)) {
        const T* src = q + ((long long)b * N + (long long)kvh * G + g0 + r) * H +
                       p * L::LPK * L::VE + gl * L::VE;
        unpack(*reinterpret_cast<const uint4*>(src), x, T());
      } else {
#pragma unroll
        for (int e = 0; e < L::VE; ++e) x[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < L::VE; ++e) qr[r][p * L::VE + e] = x[e] * scale_log2;
    }
  }

  float m[GT], l[GT], acc[GT][L::EPL];
#pragma unroll
  for (int r = 0; r < GT; ++r) {
    m[r] = kNeg;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < L::EPL; ++e) acc[r][e] = 0.0f;
  }

  const long long row_stride = (long long)K * H;  // elements from key j to j + 1
  const long long base_off = (long long)b * Sk * row_stride + (long long)kvh * H + gl * L::VE;
  const int lane_key = warp * L::KPW + grp;

  for (long long base = s0; base <= s1; base += L::STEP) {  // uniform over the block
    uint4 kr[L::U][L::PIECES], vr[L::U][L::PIECES];
    bool ok[L::U];
#pragma unroll
    for (int u = 0; u < L::U; ++u) {
      const long long j = base + u * (kWarps * L::KPW) + lane_key;
      ok[u] = j <= s1;
#pragma unroll
      for (int p = 0; p < L::PIECES; ++p) {
        if (ok[u] && L::holds(p, gl)) {
          const long long off = base_off + j * row_stride + p * L::LPK * L::VE;
          kr[u][p] = __ldg(reinterpret_cast<const uint4*>(k + off));
          vr[u][p] = __ldg(reinterpret_cast<const uint4*>(v + off));
        } else {
          kr[u][p] = vr[u][p] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }

    // scores: a lane's partial dot products, then summed over its lane group
    float sc[L::U][GT];
#pragma unroll
    for (int u = 0; u < L::U; ++u) {
      float kf[L::EPL];
#pragma unroll
      for (int p = 0; p < L::PIECES; ++p) unpack(kr[u][p], kf + p * L::VE, T());
#pragma unroll
      for (int r = 0; r < GT; ++r) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < L::EPL; ++e) d = fmaf(qr[r][e], kf[e], d);
        sc[u][r] = d;
      }
    }
#pragma unroll
    for (int off = L::LPK / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < L::U; ++u) {
#pragma unroll
        for (int r = 0; r < GT; ++r) sc[u][r] += __shfl_xor_sync(kFull, sc[u][r], off);
      }
    }

    // online softmax per row over the lane group's U keys
#pragma unroll
    for (int r = 0; r < GT; ++r) {
      float tmax = -INFINITY;
#pragma unroll
      for (int u = 0; u < L::U; ++u) {
        if (!ok[u]) sc[u][r] = -INFINITY;  // past the split: p = 0
        tmax = fmaxf(tmax, sc[u][r]);
      }
      const float m_new = fmaxf(m[r], tmax);
      const float alpha = exp2f(m[r] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int u = 0; u < L::U; ++u) {
        sc[u][r] = exp2f(sc[u][r] - m_new);
        psum += sc[u][r];
      }
      l[r] = l[r] * alpha + psum;
#pragma unroll
      for (int e = 0; e < L::EPL; ++e) acc[r][e] *= alpha;
      m[r] = m_new;
    }
#pragma unroll
    for (int u = 0; u < L::U; ++u) {
      float vf[L::EPL];
#pragma unroll
      for (int p = 0; p < L::PIECES; ++p) unpack(vr[u][p], vf + p * L::VE, T());
#pragma unroll
      for (int r = 0; r < GT; ++r) {
#pragma unroll
        for (int e = 0; e < L::EPL; ++e) acc[r][e] = fmaf(sc[u][r], vf[e], acc[r][e]);
      }
    }
  }

  // merge the lane groups of the warp (partners end up bitwise equal)
#pragma unroll
  for (int off = L::LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < GT; ++r) {
      const float m_o = __shfl_xor_sync(kFull, m[r], off);
      const float l_o = __shfl_xor_sync(kFull, l[r], off);
      const float m_new = fmaxf(m[r], m_o);
      const float a = exp2f(m[r] - m_new), c = exp2f(m_o - m_new);
      l[r] = l[r] * a + l_o * c;
#pragma unroll
      for (int e = 0; e < L::EPL; ++e) {
        const float acc_o = __shfl_xor_sync(kFull, acc[r][e], off);
        acc[r][e] = acc[r][e] * a + acc_o * c;
      }
      m[r] = m_new;
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < GT; ++r) {
#pragma unroll
      for (int p = 0; p < L::PIECES; ++p) {
        if (!L::holds(p, gl)) continue;
#pragma unroll
        for (int e = 0; e < L::VE; ++e)
          sm_acc[warp][r][p * L::LPK * L::VE + gl * L::VE + e] = acc[r][p * L::VE + e];
      }
      if (gl == 0) {
        sm_m[warp][r] = m[r];
        sm_l[warp][r] = l[r];
      }
    }
  }
  __syncthreads();

  // merge the warps in order; write the output (one split) or the partials
  for (int i = threadIdx.x; i < rows * H; i += kThreads) {
    const int r = i / H, c = i % H;
    float m_star = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_star = fmaxf(m_star, sm_m[w][r]);
    float lsum = 0.0f, a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(sm_m[w][r] - m_star);
      lsum += sm_l[w][r] * f;
      a += sm_acc[w][r][c] * f;
    }
    const long long row = (long long)b * N + (long long)kvh * G + g0 + r;
    if (splits == 1) {
      store(o + row * H + c, a / fmaxf(lsum, 1e-30f));
    } else {
      ws_acc[(row * splits + s) * H + c] = a;
      if (c == 0) {
        ws_ml[(row * splits + s) * 2] = m_star;
        ws_ml[(row * splits + s) * 2 + 1] = lsum;
      }
    }
  }
}

// one warp per (b, q head): the splits' partials merged in split order
template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
flash_decode_merge(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
                   T* __restrict__ o, long long rows_total, int splits) {
  constexpr int CPL = (H + 31) / 32;  // columns per lane (the last partial at H = 112)
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows_total) return;
  const float* ml = ws_ml + row * splits * 2;
  float m_star = kNeg;
  for (int s = 0; s < splits; ++s) m_star = fmaxf(m_star, ml[2 * s]);
  float lsum = 0.0f, a[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) a[c] = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const float f = exp2f(ml[2 * s] - m_star);
    lsum += ml[2 * s + 1] * f;
    const float* src = ws_acc + (row * splits + s) * H + lane;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (H % 32 == 0 || lane + 32 * c < H) a[c] += src[32 * c] * f;
  }
  const float denom = fmaxf(lsum, 1e-30f);
#pragma unroll
  for (int c = 0; c < CPL; ++c)
    if (H % 32 == 0 || lane + 32 * c < H) store(o + row * H + lane + 32 * c, a[c] / denom);
}

template <typename T, int H, int GT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* ws, int B,
                   int Sk, int N, int K, int causal, int window, long long q_offset, int k_len,
                   float scale, int chunk, int splits, cudaStream_t stream) {
  const int G = N / K;
  const long long rows_total = (long long)B * N;
  float* ws_acc = ws;
  float* ws_ml = ws == nullptr ? nullptr : ws + rows_total * splits * H;
  if (splits > 0) {
    const dim3 grid((unsigned)splits, (unsigned)(K * ((G + GT - 1) / GT)), (unsigned)B);
    flash_decode_split<T, H, GT><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), ws_acc, ws_ml, Sk, N, K, causal, window, q_offset, k_len,
        scale * kLog2e, chunk, splits);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || splits == 1) return e;
  }
  // splits == 0 (no visible key) merges nothing and writes zeros
  const unsigned blocks = (unsigned)((rows_total + kWarps - 1) / kWarps);
  flash_decode_merge<T, H><<<blocks, kThreads, 0, stream>>>(ws_acc, ws_ml, static_cast<T*>(o),
                                                            rows_total, splits);
  return cudaGetLastError();
}

template <typename T, int H>
cudaError_t by_group(int G, const void* q, const void* k, const void* v, void* o, float* ws,
                     int B, int Sk, int N, int K, int causal, int window, long long q_offset,
                     int k_len, float scale, int chunk, int splits, cudaStream_t stream) {
  if (G <= 1)
    return launch<T, H, 1>(q, k, v, o, ws, B, Sk, N, K, causal, window, q_offset, k_len,
                           scale, chunk, splits, stream);
  if (G <= 2)
    return launch<T, H, 2>(q, k, v, o, ws, B, Sk, N, K, causal, window, q_offset, k_len,
                           scale, chunk, splits, stream);
  if (G <= 4)
    return launch<T, H, 4>(q, k, v, o, ws, B, Sk, N, K, causal, window, q_offset, k_len,
                           scale, chunk, splits, stream);
  return launch<T, H, kMaxRows>(q, k, v, o, ws, B, Sk, N, K, causal, window, q_offset, k_len,
                                scale, chunk, splits, stream);
}

template <typename T>
cudaError_t by_head_dim(int H, int G, const void* q, const void* k, const void* v, void* o,
                        float* ws, int B, int Sk, int N, int K, int causal, int window,
                        long long q_offset, int k_len, float scale, int chunk, int splits,
                        cudaStream_t stream) {
  switch (H) {
    case 32:
      return by_group<T, 32>(G, q, k, v, o, ws, B, Sk, N, K, causal, window, q_offset, k_len,
                             scale, chunk, splits, stream);
    case 64:
      return by_group<T, 64>(G, q, k, v, o, ws, B, Sk, N, K, causal, window, q_offset, k_len,
                             scale, chunk, splits, stream);
    case 112:
      return by_group<T, 112>(G, q, k, v, o, ws, B, Sk, N, K, causal, window, q_offset, k_len,
                              scale, chunk, splits, stream);
    case 128:
      return by_group<T, 128>(G, q, k, v, o, ws, B, Sk, N, K, causal, window, q_offset, k_len,
                              scale, chunk, splits, stream);
    case 256:
      return by_group<T, 256>(G, q, k, v, o, ws, B, Sk, N, K, causal, window, q_offset, k_len,
                              scale, chunk, splits, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, 1, N, H), k and v (B, Sk, K, H), o like q; is_bf16: 0 for fp32, 1
// for bf16. Pointers 16-byte aligned and contiguous; H in {32, 64, 112, 128, 256};
// N % K == 0 (the wrapper checks). chunk and splits cover the visible key
// range (chunk * splits >= its length, no split empty; splits = 0 when it
// is empty). ws: fp32 workspace of B * N * splits * (H + 2) floats when
// splits > 1, else unused. Both passes go on `stream`.
extern "C" int flash_attention_decode(const void* q, const void* k, const void* v, void* o,
                                      void* ws, int B, int Sk, int N, int K, int H,
                                      int is_bf16, int causal, int window, long long q_offset,
                                      int k_len, float scale, int chunk, int splits,
                                      cudaStream_t stream) {
  if ((long long)B * N == 0) return (int)cudaGetLastError();
  if (K <= 0 || N % K != 0 || splits < 0 || (splits > 0 && chunk <= 0) ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int G = N / K;
  float* w = static_cast<float*>(ws);
  const cudaError_t e =
      is_bf16 ? by_head_dim<__nv_bfloat16>(H, G, q, k, v, o, w, B, Sk, N, K, causal, window,
                                           q_offset, k_len, scale, chunk, splits, stream)
              : by_head_dim<float>(H, G, q, k, v, o, w, B, Sk, N, K, causal, window, q_offset,
                                   k_len, scale, chunk, splits, stream);
  return (int)e;
}
