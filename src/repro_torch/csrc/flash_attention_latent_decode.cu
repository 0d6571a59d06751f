// MLA's absorbed decode (DeepSeek-V2's multi-head latent attention) over
// the compressed cache, forward only, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference computes this step in jnp einsums,
// outside any Pallas kernel (repro/models/attention.py:mla_forward, its
// decode branch). It is added because the port's decode attention kernel
// (flash_attention_decode.cu) cannot serve it: one latent row is the key of
// all 16 heads, 576 wide (no multiple of its 32 lanes x 8 bf16), and its
// first 512 values are also the value, so K and V differ in width; and the
// port's fallback for it, promoting the bf16 cache to q's fp32 each step,
// would copy 75 MB a layer and step.
//
//   ctx[b, n] = softmax_j(scale * q[b, n] . kv[b, j]) kv[b, j, :L]
//
// over j <= q_offset (every row of the cache once q_offset >= S), where
// kv[b, j] is c_kv[b, j] (L = 512, the latent rank) joined to k_rope[b, j]
// (R = 64), read where each lies: two pointers, each with its batch and row
// strides in elements, so the cache's two leaves may be views of one (B, S,
// 576) buffer or two buffers. q (B, 1, N, L + R) is fp32 (q_lat = q_nope .
// W_uk joined to q_rope, both fp32 as in the reference, never rounded to the
// cache's dtype), the cache bf16 or fp32 (each element read once, widened
// to fp32), ctx (B, 1, N, L) fp32. The reference's constants: masked scores
// are -1e30, running maxima start there, the output is acc / max(l, 1e-30).
//
// What bounds it on an H100: at (8 sequences, 16 heads, 4096 keys) the
// cache's bytes take 0.01127 ms at 3.35 TB/s and the arithmetic, 2 (L + R)
// + 2 L flops a key and head, 0.01703 ms on the fp32 cores (67 TFLOP/s):
// operations. On the tensor cores as 3xTF32 the same work would take
// 0.00691 ms and bytes would bind; that form is later work.
//
// The design, a simple SIMT kernel:
// - Pass 1, grid (splits, B): block (s, b) walks keys [s chunk, (s + 1)
//   chunk) of the visible range (the host's plan,
//   kernels/flash_attention._decode_plan with one kv head: at B = 8, 16
//   splits of 256 keys). One block serves all N <= 16 heads of its
//   sequence, so each cache row is read from device memory once.
// - q's N rows are staged once in shared memory, fp32. Tiles of 32 keys
//   are read with 16-byte loads into registers one tile ahead (the next
//   tile's loads are in flight while this one is computed), then widened
//   to fp32 and stored in shared memory, rows 580 floats apart.
// - Scores: warp w takes columns [72 w, 72 w + 72) of the dot products, a
//   lane 4 heads x 4 keys (heads hg + 4 i, keys kg + 8 i, which the row
//   stride puts on distinct banks), reading 4 columns of each with one
//   16-byte load; the 8 warps' partial sums are added in warp order,
//   scaled after the sum (as the reference scales s_nope + s_rope), and
//   keys past the split masked.
// - The online softmax: warp w owns heads 2 w and 2 w + 1, a lane a key;
//   maxima and sums by shuffles; the running (m, l) of each head in shared
//   memory.
// - ctx += p v: thread t owns columns t and t + 256 of all 16 heads (32
//   fp32 accumulators), reads each key's two values and the tile's p by
//   16-byte broadcasts.
// - With one split, pass 1 writes ctx. Otherwise it writes the partials
//   (m, l, acc[L]) to the fp32 workspace and pass 2, one block per (b,
//   head), merges them in split order, as flash_attention_decode.cu does:
//   every order is fixed, so results repeat bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kL = 512;                // c_kv columns: the latent rank, and v's width
constexpr int kR = 64;                 // k_rope columns
constexpr int kD = kL + kR;            // a key row
constexpr int kP = kD + 4;             // a staged row, floats (16-byte aligned rows)
constexpr int kHeads = 16;             // heads a block, at most
constexpr int kT = 32;                 // keys a tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlice = kD / kWarps;    // columns of the dot products a warp sums
constexpr int kRed = 40;               // partial-score row stride: lanes on distinct banks
constexpr int kCols = kL / kThreads;   // value columns a thread

// shared memory, in floats
constexpr int kQOff = 0;
constexpr int kKOff = kQOff + kHeads * kP;
constexpr int kRedOff = kKOff + kT * kP;
constexpr int kPOff = kRedOff + kWarps * kHeads * kRed;
constexpr int kMOff = kPOff + kT * kHeads;
constexpr int kLOff = kMOff + kHeads;
constexpr int kAOff = kLOff + kHeads;
constexpr int kSmemFloats = kAOff + kHeads;
constexpr int kSmem = kSmemFloats * 4;

static_assert(kD % kWarps == 0 && kSlice % 4 == 0 && kL % kThreads == 0, "layout");
static_assert(kP % 4 == 0 && kKOff % 4 == 0 && kPOff % 4 == 0, "16-byte aligned rows");

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int VE = 4;  // elements a 16-byte load
  static __device__ __forceinline__ void widen(const uint4& x, float* out) {
    out[0] = __uint_as_float(x.x);
    out[1] = __uint_as_float(x.y);
    out[2] = __uint_as_float(x.z);
    out[3] = __uint_as_float(x.w);
  }
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VE = 8;
  static __device__ __forceinline__ void widen(const uint4& x, float* out) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
latent_decode_split(const float* __restrict__ q, const T* __restrict__ ckv,
                    const T* __restrict__ krope, float* __restrict__ o,
                    float* __restrict__ ws_acc, float* __restrict__ ws_ml, int N,
                    long long ckv_bs, long long ckv_rs, long long kr_bs, long long kr_rs,
                    long long j_hi, float scale, int chunk, int splits) {
  constexpr int VE = Elem<T>::VE;
  constexpr int UL = kL / VE, U = UL + kR / VE;  // 16-byte units a row
  constexpr int PER = kT * U / kThreads;         // 16-byte units a thread a tile
  static_assert(kT * U % kThreads == 0, "a tile's units split evenly");
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* qs = sm + kQOff;     // [kHeads][kP]
  float* ks = sm + kKOff;     // [kT][kP]
  float* red = sm + kRedOff;  // [kWarps][kHeads][kRed]; red[0] then holds the scores
  float* ps = sm + kPOff;     // [kT][kHeads]
  float* ms = sm + kMOff;
  float* ls = sm + kLOff;
  float* as = sm + kAOff;

  const int s = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long s0 = (long long)s * chunk;
  const long long s1 = s0 + chunk - 1 < j_hi ? s0 + chunk - 1 : j_hi;

  for (int e = tid; e < kHeads * (kD / 4); e += kThreads) {
    const int n = e / (kD / 4), c = 4 * (e % (kD / 4));
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (n < N) x = *reinterpret_cast<const float4*>(q + ((long long)b * N + n) * kD + c);
    *reinterpret_cast<float4*>(qs + n * kP + c) = x;
  }
  if (tid < kHeads) {
    ms[tid] = kNeg;
    ls[tid] = 0.0f;
  }

  // score lane layout: heads hg + 4 i, keys kg + 8 i
  const int hg = lane / 8, kg = lane % 8;
  float acc[kHeads][kCols];
#pragma unroll
  for (int n = 0; n < kHeads; ++n) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[n][c] = 0.0f;
  }
  const T* ckv_b = ckv + (long long)b * ckv_bs;
  const T* kr_b = krope + (long long)b * kr_bs;

  // a tile's 16-byte units, unit e = tid + i kThreads of the tile at row
  // e / U: read into registers (rows past the split are zeros), then
  // widened and stored
  uint4 pre[PER];
  auto fetch = [&](long long base) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * kThreads, j = e / U, u = e % U;
      const long long kp = base + j;
      pre[i] = make_uint4(0u, 0u, 0u, 0u);
      if (kp <= s1) {
        const T* src = u < UL ? ckv_b + kp * ckv_rs + u * VE : kr_b + kp * kr_rs + (u - UL) * VE;
        pre[i] = __ldg(reinterpret_cast<const uint4*>(src));
      }
    }
  };
  fetch(s0);

  for (long long base = s0; base <= s1; base += kT) {  // uniform over the block
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * kThreads, j = e / U, u = e % U;
      float x[VE];
      Elem<T>::widen(pre[i], x);
      float* dst = ks + j * kP + u * VE;
#pragma unroll
      for (int c = 0; c < VE; c += 4)
        *reinterpret_cast<float4*>(dst + c) = make_float4(x[c], x[c + 1], x[c + 2], x[c + 3]);
    }
    __syncthreads();
    if (base + kT <= s1) fetch(base + kT);  // in flight while this tile is computed

    // partial dot products over this warp's columns, 4 columns a load
    {
      float d[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) d[i][j] = 0.0f;
      }
      const float* qr = qs + hg * kP + warp * kSlice;
      const float* kr = ks + kg * kP + warp * kSlice;
#pragma unroll 2
      for (int c = 0; c < kSlice; c += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = ld4(qr + 4 * i * kP + c);
          kv[i] = ld4(kr + 8 * i * kP + c);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            d[i][j] = fmaf(qv[i].x, kv[j].x, d[i][j]);
            d[i][j] = fmaf(qv[i].y, kv[j].y, d[i][j]);
            d[i][j] = fmaf(qv[i].z, kv[j].z, d[i][j]);
            d[i][j] = fmaf(qv[i].w, kv[j].w, d[i][j]);
          }
        }
      }
      float* rw = red + warp * kHeads * kRed;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) rw[(hg + 4 * i) * kRed + kg + 8 * j] = d[i][j];
      }
    }
    __syncthreads();

    // the warps' sums in warp order, scaled, masked past the split
    for (int e = tid; e < kHeads * kT; e += kThreads) {
      const int n = e / kT, j = e % kT;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[(w * kHeads + n) * kRed + j];
      red[n * kRed + j] = base + j <= s1 ? sum * scale : kNeg;
    }
    __syncthreads();

    // online softmax: warp w owns heads 2 w and 2 w + 1, a lane a key
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = 2 * warp + hh;
      const float x = red[n * kRed + lane];
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_old = ms[n];
      const float m_new = fmaxf(m_old, mx);
      const float p = exp2f((x - m_new) * kLog2e);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
      ps[lane * kHeads + n] = p;
      if (lane == 0) {
        const float alpha = exp2f((m_old - m_new) * kLog2e);
        ls[n] = ls[n] * alpha + sum;
        ms[n] = m_new;
        as[n] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p v over the tile's keys
#pragma unroll
    for (int n = 0; n < kHeads; ++n) {
      const float a = as[n];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[n][c] *= a;
    }
#pragma unroll 4
    for (int j = 0; j < kT; ++j) {
      float v[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) v[c] = ks[j * kP + tid + c * kThreads];
      const float4* pj = reinterpret_cast<const float4*>(ps + j * kHeads);
#pragma unroll
      for (int n4 = 0; n4 < kHeads / 4; ++n4) {
        const float4 p4 = pj[n4];
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[4 * n4 + i][c] = fmaf(pv[i], v[c], acc[4 * n4 + i][c]);
        }
      }
    }
    __syncthreads();  // the tile, the scores and p are free for the next tile
  }

  // write ctx (one split) or the partials; the loop is unrolled so that acc
  // stays in registers
#pragma unroll
  for (int n = 0; n < kHeads; ++n) {
    if (n >= N) break;
    const long long row = (long long)b * N + n;
    if (splits == 1) {
      const float denom = fmaxf(ls[n], 1e-30f);
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[row * kL + tid + c * kThreads] = acc[n][c] / denom;
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        ws_acc[(row * splits + s) * kL + tid + c * kThreads] = acc[n][c];
      if (tid == 0) {
        ws_ml[(row * splits + s) * 2] = ms[n];
        ws_ml[(row * splits + s) * 2 + 1] = ls[n];
      }
    }
  }
}

// one block per (b, head): the splits' partials merged in split order
__global__ void __launch_bounds__(kThreads)
latent_decode_merge(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
                    float* __restrict__ o, int splits) {
  const long long row = blockIdx.x;
  const float* ml = ws_ml + row * splits * 2;
  float m_star = kNeg;
  for (int s = 0; s < splits; ++s) m_star = fmaxf(m_star, ml[2 * s]);
  float lsum = 0.0f, a[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) a[c] = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const float f = exp2f((ml[2 * s] - m_star) * kLog2e);
    lsum += ml[2 * s + 1] * f;
    const float* src = ws_acc + (row * splits + s) * kL + threadIdx.x;
#pragma unroll
    for (int c = 0; c < kCols; ++c) a[c] += src[c * kThreads] * f;
  }
  const float denom = fmaxf(lsum, 1e-30f);
#pragma unroll
  for (int c = 0; c < kCols; ++c) o[row * kL + threadIdx.x + c * kThreads] = a[c] / denom;
}

template <typename T>
cudaError_t launch(const void* q, const void* ckv, const void* krope, void* o, float* ws, int B,
                   int S, int N, long long ckv_bs, long long ckv_rs, long long kr_bs,
                   long long kr_rs, long long q_offset, float scale, int chunk, int splits,
                   cudaStream_t stream) {
  static bool attr_set = false;  // above 48 KB needs the opt-in, once per instance
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        latent_decode_split<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const long long j_hi = q_offset < S - 1 ? q_offset : (long long)S - 1;
  const long long rows = (long long)B * N;
  float* ws_ml = ws == nullptr ? nullptr : ws + rows * splits * kL;
  const dim3 grid((unsigned)splits, (unsigned)B);
  latent_decode_split<T><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(ckv), static_cast<const T*>(krope),
      static_cast<float*>(o), ws, ws_ml, N, ckv_bs, ckv_rs, kr_bs, kr_rs, j_hi, scale, chunk,
      splits);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  latent_decode_merge<<<(unsigned)rows, kThreads, 0, stream>>>(ws, ws_ml, static_cast<float*>(o),
                                                               splits);
  return cudaGetLastError();
}

}  // namespace

// q (B, 1, N, 576) fp32 contiguous; c_kv (B, S, 512) and k_rope (B, S, 64)
// in the cache's dtype (is_bf16: 1 for bf16, 0 for fp32), unit stride along
// the last axis, batch and row strides in elements, 16-byte aligned rows; o
// (B, 1, N, 512) fp32. 1 <= N <= 16, S >= 1, q_offset >= 0. chunk and
// splits cover [0, min(q_offset, S - 1)] (chunk a multiple of 32, chunk *
// splits >= its length, no split empty). ws: fp32 workspace of B * N *
// splits * (512 + 2) floats when splits > 1, else unused. Both passes go on
// `stream`.
extern "C" int flash_attention_latent_decode(const void* q, const void* ckv, const void* krope,
                                             void* o, void* ws, int B, int S, int N,
                                             long long ckv_bs, long long ckv_rs,
                                             long long kr_bs, long long kr_rs, int is_bf16,
                                             long long q_offset, float scale, int chunk,
                                             int splits, cudaStream_t stream) {
  if (B == 0) return (int)cudaGetLastError();
  if (N < 1 || N > kHeads || S < 1 || q_offset < 0 || splits < 1 || chunk <= 0 ||
      chunk % kT != 0 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  const cudaError_t e =
      is_bf16 ? launch<__nv_bfloat16>(q, ckv, krope, o, w, B, S, N, ckv_bs, ckv_rs, kr_bs, kr_rs,
                                      q_offset, scale, chunk, splits, stream)
              : launch<float>(q, ckv, krope, o, w, B, S, N, ckv_bs, ckv_rs, kr_bs, kr_rs,
                              q_offset, scale, chunk, splits, stream);
  return (int)e;
}

// The registers a thread and the local (spill and stack) bytes a thread of
// the split pass for a cache of bf16 (is_bf16 = 1) or fp32, as
// cudaFuncGetAttributes reports them.
extern "C" int flash_attention_latent_decode_attrs(int is_bf16, int* regs,
                                                   long long* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = is_bf16 ? cudaFuncGetAttributes(&a, latent_decode_split<__nv_bfloat16>)
                                : cudaFuncGetAttributes(&a, latent_decode_split<float>);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (long long)a.localSizeBytes;
  return 0;
}
