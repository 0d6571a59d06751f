// What the *_attrs C entries of the port's kernel library report for one
// kernel instance: cudaFuncGetAttributes' view of it on the card, beside
// the dynamic shared memory its launch passes. The static analysis
// (repro_torch.analysis.kernel_contracts) holds its mirror of each
// instance to these numbers.
#pragma once

#include <cuda_runtime.h>

// out[0] registers a thread, out[1] local (spill and stack) bytes a thread,
// out[2] static shared bytes, out[3] the most threads a block of it can
// have, out[4] dyn, the dynamic shared bytes its launch passes, out[5] the
// dynamic shared bytes a block of it may take (what the launch site's
// cudaFuncSetAttribute set, or the default).
template <typename K>
inline cudaError_t kernel_attrs(K kernel, long long dyn, long long* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (long long)a.localSizeBytes;
  out[2] = (long long)a.sharedSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  out[4] = dyn;
  out[5] = a.maxDynamicSharedSizeBytes;
  return cudaSuccess;
}
