// RWKV6 ("Finch") time-mix recurrence, forward only, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py:_kernel (launched by
// rwkv6_scan, the Pallas call over a (batch, head, time chunk) grid with the
// time axis sequential and the state in VMEM scratch).
//
// Per batch b and head h, with the hd x hd state S (fp32) starting at s0:
//   y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]
// r, k, v, w (B, T, H, hd), u (H, hd), s0 (B, H, hd, hd), all fp32; y
// (B, T, H, hd) and the final state sT (B, H, hd, hd), fp32. Any T, no
// padding.
//
// What bounds it on an H100: each token and head reads 4 hd floats and
// writes hd (20 hd bytes) against 5 hd^2 + 5 hd fp32 flops (an FMA counted
// as two: per element of S, one FMA for y and a multiply and an FMA for
// the state), some 16 flops a byte at hd = 64, under the card's fp32 ridge
// (67 TFLOP/s over 3.35 TB/s = 20), so the bound is bytes. In practice the
// sequential time axis limits it: one (b, h) pair's steps cannot overlap,
// and B * H blocks (32 at prefill with B = 1) leave most SMs idle; long
// sequences run csrc/rwkv6_scan_chunked.cu instead.
//
// What the design does about it (RWKV's own CUDA design, which the TPU
// kernel's docstring cites): one thread block per (b, h) with hd threads;
// thread j keeps column j of S in registers for the whole sequence, so the
// state never touches memory between s0 and sT. The block stages CH steps
// of r, k and w (hd values each) in shared memory at a time, one
// synchronisation per chunk; thread j reads its own v_t[j], then updates
// its column with no reduction across threads.
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;

template <int HD>
__global__ void __launch_bounds__(HD)
rwkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ s0,
             float* __restrict__ y, float* __restrict__ sT, int T, int H) {
  __shared__ float rs[kChunk][HD], ks[kChunk][HD], ws[kChunk][HD], us[HD];
  const int b = blockIdx.x / H, h = blockIdx.x % H, j = threadIdx.x;
  const long long state = ((long long)b * H + h) * HD * HD;

  float S[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = s0[state + i * HD + j];
  us[j] = u[h * HD + j];

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int n = T - t0 < kChunk ? T - t0 : kChunk;
    __syncthreads();  // the previous chunk is consumed
    for (int tt = 0; tt < n; ++tt) {
      const long long off = (((long long)b * T + t0 + tt) * H + h) * HD + j;
      rs[tt][j] = r[off];
      ks[tt][j] = k[off];
      ws[tt][j] = w[off];
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const long long off = (((long long)b * T + t0 + tt) * H + h) * HD + j;
      const float vj = v[off];
      float yj = 0.0f;
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float kv = ks[tt][i] * vj;
        yj = fmaf(rs[tt][i], S[i] + us[i] * kv, yj);
        S[i] = fmaf(ws[tt][i], S[i], kv);
      }
      y[off] = yj;
    }
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) sT[state + i * HD + j] = S[i];
}

template <int HD>
cudaError_t launch(const float* r, const float* k, const float* v, const float* w,
                   const float* u, const float* s0, float* y, float* sT, int B, int T,
                   int H, cudaStream_t stream) {
  rwkv6_kernel<HD><<<B * H, HD, 0, stream>>>(r, k, v, w, u, s0, y, sT, T, H);
  return cudaGetLastError();
}

}  // namespace

// hd in {16, 32, 64, 128} (the wrapper checks); all pointers contiguous fp32.
extern "C" int rwkv6_scan(const float* r, const float* k, const float* v, const float* w,
                          const float* u, const float* s0, float* y, float* sT, int B,
                          int T, int H, int hd, cudaStream_t stream) {
  if (B * H == 0) return (int)cudaGetLastError();
  cudaError_t e;
  switch (hd) {
    case 16: e = launch<16>(r, k, v, w, u, s0, y, sT, B, T, H, stream); break;
    case 32: e = launch<32>(r, k, v, w, u, s0, y, sT, B, T, H, stream); break;
    case 64: e = launch<64>(r, k, v, w, u, s0, y, sT, B, T, H, stream); break;
    case 128: e = launch<128>(r, k, v, w, u, s0, y, sT, B, T, H, stream); break;
    default: e = cudaErrorInvalidValue;
  }
  return (int)e;
}
