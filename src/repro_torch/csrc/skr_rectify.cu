// SKR rectification map (paper Eq. 31) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/skr_rectify.py:_kernel (launched by
// skr_rectify_batched). Given per-row (p_c, do, qbar, label) it maps the
// temperature-softmax probabilities P (rows, C) to the knowledge Q:
//   Q[r, j] = qbar[r]                                  if do[r] and j == label[r]
//           = P[r, j] * (1 - qbar[r]) / max(1 - p_c[r], 1e-12)   if do[r]
//           = P[r, j]                                  otherwise
// with the same expression order as the TPU kernel, so the result is
// bit-identical to the plain version (IEEE division; no fast-math).
//
// What bounds it on an H100: one read and one write of P, a division and a
// multiply per element: device-memory bandwidth at LM shapes (C in the
// thousands); the launch itself at FedEEC's 8 rows of C = 10.
//
// What the design does about it: one elementwise grid-stride pass with
// neighbouring threads on neighbouring addresses; the per-row scalars are
// read once per element from L1-resident arrays; no shared memory, no
// synchronisation. The sequential SKR queue pass that produces the per-row
// values stays outside (repro_torch/core/skr.py), as the TPU path kept it.
#include <cuda_runtime.h>

namespace {

__global__ void skr_rectify_kernel(const float* __restrict__ p,
                                   const int* __restrict__ label,
                                   const float* __restrict__ pc,
                                   const unsigned char* __restrict__ dorect,
                                   const float* __restrict__ qb,
                                   float* __restrict__ out, long long total,
                                   int C) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const long long row = i / C;
    const int col = (int)(i - row * C);
    const float pi = p[i];
    float r = pi;
    if (dorect[row]) {
      const float q = qb[row];
      const float scale = (1.0f - q) / fmaxf(1.0f - pc[row], 1e-12f);
      r = col == label[row] ? q : pi * scale;
    }
    out[i] = r;
  }
}

}  // namespace

extern "C" int skr_rectify(const float* p, const int* label, const float* pc,
                           const unsigned char* dorect, const float* qb,
                           float* out, long long rows, int C,
                           cudaStream_t stream) {
  const long long total = rows * (long long)C;
  if (total == 0) return (int)cudaGetLastError();
  constexpr int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  skr_rectify_kernel<<<(int)blocks, threads, 0, stream>>>(p, label, pc, dorect,
                                                          qb, out, total, C);
  return (int)cudaGetLastError();
}
