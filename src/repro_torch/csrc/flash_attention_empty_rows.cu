// GQA flash attention: the rows whose visible key range is empty.
//
// Part of the port of the TPU kernel repro/kernels/flash_attention.py:_kernel.
// A query at qpos = q_offset + i sees keys [j_lo, j_hi]: j_hi = Sk - 1, or
// min(Sk - 1, qpos) when causal; j_lo = max(0, qpos - window + 1) when
// window > 0, else 0. When that range is empty (a window that ends before
// the keys do, or a causal query before key 0) every score is masked. The
// repository's numerics oracle (repro/kernels/ref.py:flash_attention_ref) and
// the jnp attention (repro/models/attention.py:mha) then take a softmax over
// Sk equal -1e30 scores and return the mean of v over all Sk keys; the Pallas
// kernel, which reaches no kv block there, writes 0. The port follows the
// oracle: the wrapper finds from ints alone whether a call has such rows
// and, after the attention kernel it picked, launches this kernel, which
// overwrites exactly those rows with the mean of v.
//
//   o[b, i, n, h] = (1 / Sk) sum_j v[b, j, n / G, h]   for each empty row i
//
// v (B, Sk, K, H) and o (B, Sq, N, H), fp32 or bf16, where H is v's head_dim
// (Hv: 128 in MLA's expanded prefill, whose q and k are 192 wide); the sum
// is fp32, o is rounded once to its dtype.
//
// What bounds it: reading v once per (batch, kv head) (bytes). No ported
// model reaches such a row, so the design is the simplest one: one block
// per (kv head, batch), one thread per column h summing the column down the
// keys (neighbouring threads read neighbouring addresses), then each thread
// tests every query row's range from ints and writes its column of the G q
// heads of the empty rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void mean_v_kernel(const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                              int N, int K, int H, int causal, int window,
                              long long q_offset) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int h = threadIdx.x;
  const int G = N / K;
  float sum = 0.0f;
  for (int j = 0; j < Sk; ++j) sum += widen(v[(((long long)b * Sk + j) * K + kvh) * H + h]);
  const float mean = sum / (float)Sk;
  for (int i = 0; i < Sq; ++i) {
    const long long qpos = q_offset + i;
    long long j_hi = (long long)Sk - 1;
    if (causal && qpos < j_hi) j_hi = qpos;
    long long j_lo = 0;
    if (window > 0 && qpos - window + 1 > j_lo) j_lo = qpos - window + 1;
    if (j_lo <= j_hi) continue;
    T* orow = o + (((long long)b * Sq + i) * N + (long long)kvh * G) * H + h;
    for (int g = 0; g < G; ++g) put(orow + (long long)g * H, mean);
  }
}

}  // namespace

// is_bf16: 0 for fp32 v/o, 1 for bf16. Contiguous; H <= 1024 (one thread a
// column); N % K == 0 (the wrapper checks); Sk >= 1.
extern "C" int flash_attention_empty_rows(const void* v, void* o, int B, int Sq, int Sk,
                                          int N, int K, int H, int is_bf16, int causal,
                                          int window, long long q_offset,
                                          cudaStream_t stream) {
  if ((long long)B * Sq * N == 0 || Sk <= 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)K, (unsigned)B);
  if (is_bf16)
    mean_v_kernel<__nv_bfloat16><<<grid, H, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Sk, N, K,
        H, causal, window, q_offset);
  else
    mean_v_kernel<float><<<grid, H, 0, stream>>>(static_cast<const float*>(v),
                                                 static_cast<float*>(o), Sq, Sk, N, K, H,
                                                 causal, window, q_offset);
  return (int)cudaGetLastError();
}
