// GQA flash attention, forward only, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:_kernel (launched
// by flash_attention, the Pallas call over a (batch, q head, q block, kv
// block) grid with the kv axis sequential).
//
//   o[b, i, n] = softmax_j(scale * q[b, i, n] . k[b, j, n / G]) v[b, j, n / G]
//
// over the kv positions j that the masks leave: j < k_len; j <= i +
// q_offset when causal; j > i + q_offset - window when window > 0.
// q (B, Sq, N, H), k and v (B, Sk, K, H), G = N / K, fp32 or bf16; o in
// q's dtype. The softmax runs online in fp32 with the TPU kernel's
// constants: masked scores are -1e30 (not -inf), each kv tile rescales the
// running sum and accumulator by exp(m_old - m_new), and the output is
// acc / max(l, 1e-30). A row with a valid key therefore gets exactly the
// masked softmax; a kv tile the masks wholly exclude for the block's rows is
// never loaded (the decode case: the cache beyond the current position).
//
// What bounds it on an H100: prefill is bound by operations (4 H flops per
// unmasked (q, k) pair and head against 12-24 bytes per token); decode at
// Sq = 1 is bound by reading the kv cache once (bytes).
//
// What the design does about it: one thread block per (batch, kv head,
// tile of ROWS q rows), where the rows are the flattened (query, q head of
// the group) pairs, so the G q heads that share a kv head share every K/V
// tile the block stages in shared memory (GQA costs no extra kv reads), and
// a decode step (Sq = 1) puts its G rows in one block instead of padding a
// 64-row q tile. Each warp owns ROWS / 4 rows and keeps their running max,
// sum and H-wide fp32 accumulator in registers; in the score pass lane j
// takes key j (K rows padded by one float, so the lanes hit distinct
// banks), in the PV pass lane c takes output columns c, c + 32, ... K/V
// tiles are read with 16-byte vector loads. This is a SIMT kernel: the
// products run on the fp32 cores, not the tensor cores (wgmma and TMA
// pipelining are later work), so prefill sits well above its tensor-core
// bound. The wrapper sends it only the prefill calls the tensor-core kernel
// does not take: fp32 at every head_dim (the reduced configs' attention)
// and bf16 at H = 32; bf16 prefill at H in {64, 128, 256} goes to
// flash_attention_sm90.cu and decode to flash_attention_decode.cu.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <int H>
struct Tile {
  static constexpr int BK = 4096 / H;           // keys per tile: 128, 64, 32, 16
  static constexpr int KPL = (BK + 31) / 32;    // keys per lane, score pass
  static constexpr int HPL = H / 32;            // output columns per lane
  static constexpr int RPW = H <= 128 ? 16 : 8; // q rows per warp
  static constexpr int ROWS = RPW * kWarps;     // q rows per block
  static constexpr int SMEM_FLOATS = ROWS * H + BK * (H + 1) + BK * H;
};

// 16 bytes of T starting at p (16-byte aligned) as floats.
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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int Sq, int Sk, int N, int K, int causal, int window,
             long long q_offset, int k_len, float scale) {
  using C = Tile<H>;
  constexpr int VE = 16 / sizeof(T);  // elements per 16-byte load
  extern __shared__ float smem[];
  float* Qs = smem;                 // [ROWS][H], scaled
  float* Ks = Qs + C::ROWS * H;     // [BK][H + 1]
  float* Vs = Ks + C::BK * (H + 1); // [BK][H]

  const int G = N / K;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long rows_total = (long long)Sq * G;
  const long long row0 = (long long)blockIdx.x * C::ROWS;
  const long long row_end = row0 + C::ROWS < rows_total ? row0 + C::ROWS : rows_total;

  // q tile, scaled in fp32; row t is (query t / G, q head kvh * G + t % G)
  for (int e = threadIdx.x * VE; e < C::ROWS * H; e += kThreads * VE) {
    const int r = e / H, h = e % H;
    const long long t = row0 + r;
    float x[VE];
    if (t < rows_total) {
      load16(q + (((long long)b * Sq + t / G) * N + (long long)kvh * G + t % G) * H + h, x);
    } else {
#pragma unroll
      for (int c = 0; c < VE; ++c) x[c] = 0.0f;
    }
#pragma unroll
    for (int c = 0; c < VE; ++c) Qs[e + c] = x[c] * scale;
  }

  // kv range the block's rows can see
  const long long q_lo = q_offset + row0 / G;
  const long long q_hi = q_offset + (row_end - 1) / G;
  long long j_hi = (long long)k_len - 1;
  if (causal && q_hi < j_hi) j_hi = q_hi;
  long long j_lo = 0;
  if (window > 0 && q_lo - window + 1 > j_lo) j_lo = q_lo - window + 1;

  float m[C::RPW], l[C::RPW], acc[C::RPW][C::HPL];
#pragma unroll
  for (int i = 0; i < C::RPW; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < C::HPL; ++c) acc[i][c] = 0.0f;
  }

  for (long long kt = (j_lo / C::BK) * C::BK; kt <= j_hi; kt += C::BK) {
    __syncthreads();  // the previous tile is consumed (and Qs is written)
    for (int e = threadIdx.x * VE; e < C::BK * H; e += kThreads * VE) {
      const int j = e / H, h = e % H;
      const long long kp = kt + j;
      float xk[VE], xv[VE];
      if (kp < k_len) {
        const long long off = (((long long)b * Sk + kp) * K + kvh) * H + h;
        load16(k + off, xk);
        load16(v + off, xv);
      } else {  // padded kv columns: masked, and v = 0 as the TPU kernel pads
#pragma unroll
        for (int c = 0; c < VE; ++c) xk[c] = xv[c] = 0.0f;
      }
#pragma unroll
      for (int c = 0; c < VE; ++c) {
        Ks[j * (H + 1) + h + c] = xk[c];
        Vs[j * H + h + c] = xv[c];
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < C::RPW; ++i) {
      const int r = warp + i * kWarps;
      if (row0 + r >= rows_total) break;  // warp-uniform
      const long long qpos = q_offset + (row0 + r) / G;
      const float* qr = Qs + r * H;

      float s[C::KPL];
      float tmax = kNeg;
#pragma unroll
      for (int c = 0; c < C::KPL; ++c) {
        const int j = lane + 32 * c;
        if (j < C::BK) {
          const float* kr = Ks + j * (H + 1);
          float dot = 0.0f;
#pragma unroll 8
          for (int h = 0; h < H; ++h) dot = fmaf(qr[h], kr[h], dot);
          const long long kp = kt + j;
          bool ok = kp < k_len;
          if (causal) ok = ok && qpos >= kp;
          if (window > 0) ok = ok && kp > qpos - window;
          s[c] = ok ? dot : kNeg;
          tmax = fmaxf(tmax, s[c]);
        } else {
          s[c] = -INFINITY;  // lanes past a 16-key tile hold no column
        }
      }
      const float m_new = fmaxf(m[i], warp_max(tmax));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int c = 0; c < C::KPL; ++c) {
        s[c] = expf(s[c] - m_new);
        psum += s[c];
      }
      l[i] = l[i] * alpha + warp_sum(psum);
#pragma unroll
      for (int c = 0; c < C::HPL; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int c = 0; c < C::KPL; ++c) {
#pragma unroll 4
        for (int jj = 0; jj < 32; ++jj) {
          const int j = 32 * c + jj;
          if (j >= C::BK) break;
          const float p = __shfl_sync(kFull, s[c], jj);
          const float* vr = Vs + j * H + lane;
#pragma unroll
          for (int cc = 0; cc < C::HPL; ++cc) acc[i][cc] = fmaf(p, vr[32 * cc], acc[i][cc]);
        }
      }
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < C::RPW; ++i) {
    const long long t = row0 + warp + i * kWarps;
    if (t >= rows_total) break;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + (((long long)b * Sq + t / G) * N + (long long)kvh * G + t % G) * H + lane;
#pragma unroll
    for (int c = 0; c < C::HPL; ++c) store(orow + 32 * c, acc[i][c] / denom);
  }
}

template <typename T, int H>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Sk, int N, int K, int causal, int window, long long q_offset,
                   int k_len, float scale, cudaStream_t stream) {
  using C = Tile<H>;
  const int smem = C::SMEM_FLOATS * (int)sizeof(float);
  static bool attr_set = false;  // above 48 KB needs the opt-in, once per instance
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, H>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const long long rows = (long long)Sq * (N / K);
  const dim3 grid((unsigned)((rows + C::ROWS - 1) / C::ROWS), (unsigned)K, (unsigned)B);
  flash_kernel<T, H><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, N, K, causal, window, q_offset, k_len, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int H, const void* q, const void* k, const void* v, void* o, int B,
                     int Sq, int Sk, int N, int K, int causal, int window,
                     long long q_offset, int k_len, float scale, cudaStream_t stream) {
  switch (H) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Sk, N, K, causal, window, q_offset, k_len, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Sk, N, K, causal, window, q_offset, k_len, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Sk, N, K, causal, window, q_offset, k_len, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Sq, Sk, N, K, causal, window, q_offset, k_len, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// is_bf16: 0 for fp32 q/k/v/o, 1 for bf16. Pointers 16-byte aligned and
// contiguous; H in {32, 64, 128, 256}; N % K == 0 (the wrapper checks).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                               int Sq, int Sk, int N, int K, int H, int is_bf16, int causal,
                               int window, long long q_offset, int k_len, float scale,
                               cudaStream_t stream) {
  if ((long long)B * Sq * N == 0) return (int)cudaGetLastError();
  const cudaError_t e =
      is_bf16 ? dispatch<__nv_bfloat16>(H, q, k, v, o, B, Sq, Sk, N, K, causal, window,
                                        q_offset, k_len, scale, stream)
              : dispatch<float>(H, q, k, v, o, B, Sq, Sk, N, K, causal, window, q_offset,
                                k_len, scale, stream);
  return (int)e;
}
