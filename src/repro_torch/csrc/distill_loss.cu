// Fused distillation loss over the vocabulary axis, forward and backward,
// for Hopper (sm_90a), on fp32 or bf16 logits.
//
// Replaces the TPU kernels repro/kernels/distill_loss.py:_fwd_kernel and
// repro/kernels/distill_loss.py:_bwd_kernel (launched by _distill_loss_fwd
// and _distill_loss_bwd, the custom VJP of distill_loss_batched).
//
// Per row r of the stacked (B*N, V) logits z and teacher log-probs t:
//   forward   loss[r]  = lw * (logZ - z[y]) + beta * KL,
//             stats[r] = (logZ, KL),  KL = sum(e*z)/l - logZ - sum(e*t)/l
//   backward  dz[r, j] = g[r] * (lw * (p_j - [j == y])
//                                + beta * p_j * ((z_j - logZ - t_j) - KL)),
//             p_j = exp(z_j - logZ)
//
// z and t share one element type, fp32 or bf16, as the TPU kernel takes
// them: it reads either as fp32 (astype(float32)) and writes dz in z's
// dtype. So here: every element is widened to fp32 as it is loaded, all
// arithmetic and the online state are fp32, loss and stats are fp32, and
// dz is rounded once to z's type. The LM training loss is the bf16 case
// (beta = 0, t all zeros, V = 128256 for llama3.2-3b).
//
// What bounds them on an H100: both are streaming passes with a handful of
// flops per element, so at the LM shapes (V in the thousands to 128k) the
// bound is device-memory bandwidth: the forward reads z and t once, the
// backward reads z and t and writes dz once. At FedEEC's shapes (8 rows of
// V = 10) the data is a few hundred bytes and the launch itself is the cost.
//
// What the design does about it: the forward never materialises softmax(z)
// in device memory. Each thread keeps a running (max, sum e, sum e*z,
// sum e*t) over its strided share of the row in fp32 registers (the TPU
// kernel carried the same state across sequential vocab tiles in VMEM);
// the per-thread states merge with warp shuffles, rescaled by
// exp(m_i - m), then across warps through shared memory. A row is one warp
// when V is small, so one 128-thread block serves four rows, and a whole
// 256-thread block when V is large. The gold logit is read directly at
// z[y]. The backward is elementwise from the saved (logZ, KL), with a
// grid-stride loop and coalesced accesses. In bf16, where every row starts
// on a 16-byte boundary (V % 8 == 0 and 16-byte aligned pointers), both
// kernels move 8 elements per 16-byte load and store; otherwise they take
// one element at a time. Both launch on the caller's stream and allocate
// nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kWarp = 32;
constexpr int kVec = 8;  // bf16 elements per 16-byte access

struct Online {
  float m, l, sz, st;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ void unpack8(const uint4& u, float* out) {
  const __nv_bfloat162* two = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(two[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* in) {
  uint4 u;
  __nv_bfloat162* two = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) two[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  return u;
}

__device__ __forceinline__ void push(Online& s, float z, float t) {
  if (z > s.m) {
    const float a = expf(s.m - z);
    s.l = s.l * a + 1.0f;
    s.sz = s.sz * a + z;
    s.st = s.st * a + t;
    s.m = z;
  } else {
    const float e = expf(z - s.m);
    s.l += e;
    s.sz += e * z;
    s.st += e * t;
  }
}

__device__ __forceinline__ Online merge(const Online& a, const Online& b) {
  const float m = fmaxf(a.m, b.m);
  const float fa = expf(a.m - m);
  const float fb = expf(b.m - m);
  return {m, a.l * fa + b.l * fb, a.sz * fa + b.sz * fb, a.st * fa + b.st * fb};
}

__device__ __forceinline__ Online warp_merge(Online s) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    Online o;
    o.m = __shfl_xor_sync(0xffffffffu, s.m, off);
    o.l = __shfl_xor_sync(0xffffffffu, s.l, off);
    o.sz = __shfl_xor_sync(0xffffffffu, s.sz, off);
    o.st = __shfl_xor_sync(0xffffffffu, s.st, off);
    s = merge(s, o);
  }
  return s;
}

// WARP_PER_ROW: each warp owns one row (blockDim.x / 32 rows per block);
// otherwise the whole block owns row blockIdx.x. VEC (bf16 only): the row
// is read 8 elements per 16-byte load.
template <typename T, bool WARP_PER_ROW, bool VEC>
__global__ void distill_fwd_kernel(const T* __restrict__ z, const T* __restrict__ t,
                                   const int* __restrict__ y, float* __restrict__ loss,
                                   float* __restrict__ stats, long long rows, int V,
                                   float beta, float lw) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  long long row;
  int tid, nthreads;
  if constexpr (WARP_PER_ROW) {
    row = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
    tid = lane;
    nthreads = kWarp;
    if (row >= rows) return;  // whole warp leaves together
  } else {
    row = blockIdx.x;
    tid = threadIdx.x;
    nthreads = blockDim.x;
  }
  const T* zr = z + row * V;
  const T* tr = t + row * V;

  Online s{kNeg, 0.0f, 0.0f, 0.0f};
  if constexpr (VEC) {
    const uint4* zv = reinterpret_cast<const uint4*>(zr);
    const uint4* tv = reinterpret_cast<const uint4*>(tr);
    for (int j = tid; j < V / kVec; j += nthreads) {
      float zf[kVec], tf[kVec];
      unpack8(zv[j], zf);
      unpack8(tv[j], tf);
#pragma unroll
      for (int i = 0; i < kVec; ++i) push(s, zf[i], tf[i]);
    }
  } else {
    for (int j = tid; j < V; j += nthreads) push(s, widen(zr[j]), widen(tr[j]));
  }
  s = warp_merge(s);

  if constexpr (!WARP_PER_ROW) {
    __shared__ Online part[kWarp];
    if (lane == 0) part[warp] = s;
    __syncthreads();
    if (warp != 0) return;
    const int nw = nthreads / kWarp;
    s = lane < nw ? part[lane] : Online{kNeg, 0.0f, 0.0f, 0.0f};
    s = warp_merge(s);
  }

  if (tid == 0) {
    const float logz = s.m + logf(fmaxf(s.l, 1e-38f));
    const int label = y[row];
    // the wrapper validates labels; an out-of-range one yields NaN, never
    // an out-of-bounds read
    const float zy =
        (label >= 0 && label < V) ? widen(zr[label]) : __int_as_float(0x7fc00000);
    const float ce = logz - zy;
    const float kl = s.sz / s.l - logz - s.st / s.l;
    loss[row] = lw * ce + beta * kl;
    stats[2 * row] = logz;
    stats[2 * row + 1] = kl;
  }
}

__device__ __forceinline__ float dz_of(float zi, float ti, bool gold, float logz, float kl,
                                       float g, float beta, float lw) {
  const float sp = expf(zi - logz);
  const float d = lw * (sp - (gold ? 1.0f : 0.0f)) + beta * sp * ((zi - logz - ti) - kl);
  return g * d;
}

template <typename T>
__global__ void distill_bwd_kernel(const T* __restrict__ z, const T* __restrict__ t,
                                   const int* __restrict__ y, const float* __restrict__ stats,
                                   const float* __restrict__ g, T* __restrict__ dz,
                                   long long total, int V, float beta, float lw) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const long long row = i / V;
    const int col = (int)(i - row * V);
    put(dz + i, dz_of(widen(z[i]), widen(t[i]), col == y[row], stats[2 * row],
                      stats[2 * row + 1], g[row], beta, lw));
  }
}

// bf16 with V % 8 == 0: element i = 8 * iv; the 8 elements lie in one row
__global__ void distill_bwd_vec_kernel(const __nv_bfloat16* __restrict__ z,
                                       const __nv_bfloat16* __restrict__ t,
                                       const int* __restrict__ y,
                                       const float* __restrict__ stats,
                                       const float* __restrict__ g,
                                       __nv_bfloat16* __restrict__ dz, long long total_vec,
                                       int V, float beta, float lw) {
  const uint4* zv = reinterpret_cast<const uint4*>(z);
  const uint4* tv = reinterpret_cast<const uint4*>(t);
  uint4* dv = reinterpret_cast<uint4*>(dz);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long iv = (long long)blockIdx.x * blockDim.x + threadIdx.x; iv < total_vec;
       iv += stride) {
    const long long i = iv * kVec;
    const long long row = i / V;
    const int col = (int)(i - row * V);
    const float logz = stats[2 * row];
    const float kl = stats[2 * row + 1];
    const float gr = g[row];
    const int label = y[row];
    float zf[kVec], tf[kVec], out[kVec];
    unpack8(zv[iv], zf);
    unpack8(tv[iv], tf);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      out[k] = dz_of(zf[k], tf[k], col + k == label, logz, kl, gr, beta, lw);
    dv[iv] = pack8(out);
  }
}

int grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  return (int)(blocks < 4096 ? blocks : 4096);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, bool VEC>
void fwd(const T* z, const T* t, const int* y, float* loss, float* stats, long long rows,
         int V, float beta, float lw, cudaStream_t stream) {
  if (V <= 4096) {
    constexpr int threads = 128;  // four rows per block
    const long long rows_per_block = threads / kWarp;
    const int blocks = (int)((rows + rows_per_block - 1) / rows_per_block);
    distill_fwd_kernel<T, true, VEC><<<blocks, threads, 0, stream>>>(
        z, t, y, loss, stats, rows, V, beta, lw);
  } else {
    distill_fwd_kernel<T, false, VEC><<<(int)rows, 256, 0, stream>>>(
        z, t, y, loss, stats, rows, V, beta, lw);
  }
}

}  // namespace

extern "C" int distill_loss_fwd(const float* z, const float* t, const int* y, float* loss,
                                float* stats, long long rows, int V, float beta, float lw,
                                cudaStream_t stream) {
  if (rows == 0) return (int)cudaGetLastError();
  fwd<float, false>(z, t, y, loss, stats, rows, V, beta, lw, stream);
  return (int)cudaGetLastError();
}

extern "C" int distill_loss_fwd_bf16(const __nv_bfloat16* z, const __nv_bfloat16* t,
                                     const int* y, float* loss, float* stats, long long rows,
                                     int V, float beta, float lw, cudaStream_t stream) {
  if (rows == 0) return (int)cudaGetLastError();
  if (V % kVec == 0 && aligned16(z) && aligned16(t))
    fwd<__nv_bfloat16, true>(z, t, y, loss, stats, rows, V, beta, lw, stream);
  else
    fwd<__nv_bfloat16, false>(z, t, y, loss, stats, rows, V, beta, lw, stream);
  return (int)cudaGetLastError();
}

extern "C" int distill_loss_bwd(const float* z, const float* t, const int* y,
                                const float* stats, const float* g, float* dz,
                                long long rows, int V, float beta, float lw,
                                cudaStream_t stream) {
  const long long total = rows * (long long)V;
  if (total == 0) return (int)cudaGetLastError();
  constexpr int threads = 256;
  distill_bwd_kernel<float><<<grid_for(total, threads), threads, 0, stream>>>(
      z, t, y, stats, g, dz, total, V, beta, lw);
  return (int)cudaGetLastError();
}

extern "C" int distill_loss_bwd_bf16(const __nv_bfloat16* z, const __nv_bfloat16* t,
                                     const int* y, const float* stats, const float* g,
                                     __nv_bfloat16* dz, long long rows, int V, float beta,
                                     float lw, cudaStream_t stream) {
  const long long total = rows * (long long)V;
  if (total == 0) return (int)cudaGetLastError();
  constexpr int threads = 256;
  if (V % kVec == 0 && aligned16(z) && aligned16(t) && aligned16(dz)) {
    const long long total_vec = total / kVec;
    distill_bwd_vec_kernel<<<grid_for(total_vec, threads), threads, 0, stream>>>(
        z, t, y, stats, g, dz, total_vec, V, beta, lw);
  } else {
    distill_bwd_kernel<__nv_bfloat16><<<grid_for(total, threads), threads, 0, stream>>>(
        z, t, y, stats, g, dz, total, V, beta, lw);
  }
  return (int)cudaGetLastError();
}
