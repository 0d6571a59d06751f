// SKR for Hopper (sm_90a): the rectification map (paper Eq. 31), and SKR's
// whole Algorithm 2 (queue pass and map) in one launch.
//
// Replaces the TPU kernel repro/kernels/skr_rectify.py:_kernel (launched by
// skr_rectify_batched), which is the map only: given per-row (p_c, do, qbar,
// label) it maps the temperature-softmax probabilities P (rows, C) to the
// knowledge Q:
//   Q[r, j] = qbar[r]                                  if do[r] and j == label[r]
//           = P[r, j] * (1 - qbar[r]) / max(1 - p_c[r], 1e-12)   if do[r]
//           = P[r, j]                                  otherwise
// with the same expression order as the TPU kernel (rectify() below), so the
// result is bit-identical to the plain version (IEEE division; no fast-math).
//
// Two entries:
//
// skr_rectify, the map alone (the reference's signature): one elementwise
// grid-stride pass with neighbouring threads on neighbouring addresses.
// What bounds it on an H100: one read and one write of P, a division and a
// multiply per element: device-memory bandwidth at LM shapes (C in the
// thousands); the launch itself at FedEEC's 8 rows of C = 10.
//
// skr_process, the fused entry: repro.core.skr.skr_process_batch (the
// reference's lax.scan over a teacher step's rows) for B independent pairs.
// Each row i, in order: correct = argmax(P_i) == c (ties to the lowest
// index, NaN counting as the largest value, as torch.argmax and jnp.argmax);
// cnt = the count of class c after the earlier rows' pushes; qbar =
// sum(q[c, :cnt]) / max(cnt, 1); do = !correct && cnt > 0; Eq. 31 on the
// row; on a correct row, p_c pushed at head[c], head and count advanced mod
// Bq. On the main path (FedEEC, 8 rows of 10 classes, queues of 20) the
// work is a few hundred bytes: what bounds it is latency, the launch, one
// round trip for the inputs, the barriers between phases and the class
// threads' walk over the rows; before this entry it was the host's, a
// Python loop of about 20 small device ops a row.
// The design runs the whole pass in one block per pair (the B axis):
//   phase 0: the pair's queue state copied into the output buffers, where
//            phase 2 updates it: the input state is never written. The
//            last warps copy, so that the first warps' row loads of phase 1
//            go out with theirs;
//   phase 1: a warp per row, all rows at once: p_c, the argmax, correct.
//            They do not depend on the queue;
//   phase 2: a thread per class (a strided loop past the block's width)
//            walks the rows in order and, on its own class's rows, reads
//            (cnt, qbar, do) and pushes. A class's queue is touched by its
//            thread alone and rows of different classes never interact, so
//            this is exact for Algorithm 2 with no locks and no barrier
//            between rows;
//   phase 3: Eq. 31 over the rows, a warp per row with lanes along it.
// The per-row scalars sit in shared memory, kChunk rows at a time: a pair
// with more rows runs the phases once per chunk, in row order, and the
// class threads carry their queues from chunk to chunk. The block size is
// FedEEC's: 512 threads were faster than 1024 at its (1, 8, 10, 20).
// A label outside [0, C) or a count or head outside the queue ORs a bit
// into err[pair] instead of indexing out of bounds (the row passes through
// unchanged and pushes nothing); a clean pair leaves err[pair] as it was.
// The wrapper passes host-mapped pinned words as err and reads them at the
// caller's next sync, not after each launch.
#include <cuda_runtime.h>

#include "kernel_attrs.cuh"

namespace {

// Eq. 31 for one element of a rectified row, in the TPU kernel's order
__device__ __forceinline__ float rectify(float pi, bool at_label, float pc, float qb) {
  const float scale = (1.0f - qb) / fmaxf(1.0f - pc, 1e-12f);
  return at_label ? qb : pi * scale;
}

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
    out[i] = dorect[row] ? rectify(pi, col == label[row], pc[row], qb[row]) : pi;
  }
}

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;  // rows whose scalars a block holds at once: 13 KB
// per-row flags in shared memory
constexpr unsigned char kCorrect = 1, kRectify = 2;
// bits of err[pair]
constexpr int kBadLabel = 1, kBadState = 2;
constexpr unsigned kAll = 0xffffffffu;

// a ranks above b for argmax: larger, or NaN against a number
__device__ __forceinline__ bool above(float a, float b) {
  return a > b || (a != a && b == b);
}

template <typename Label>
__global__ void __launch_bounds__(kThreads) skr_process_kernel(
    const float* __restrict__ p, const Label* __restrict__ label,
    const float* __restrict__ q, const int* __restrict__ count,
    const int* __restrict__ head, float* __restrict__ out,
    float* __restrict__ q_out, int* __restrict__ count_out,
    int* __restrict__ head_out, int* __restrict__ err, int N, int C, int Bq) {
  __shared__ int s_lab[kChunk];  // the row's class, -1 for a label out of range
  __shared__ float s_pc[kChunk];
  __shared__ float s_qb[kChunk];
  __shared__ unsigned char s_flag[kChunk];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.x, CB = (long long)C * Bq;
  p += b * N * C;
  out += b * N * C;
  label += b * N;
  q += b * CB;
  q_out += b * CB;
  count += b * C;
  head += b * C;
  count_out += b * C;
  head_out += b * C;
  int bad = 0;

  // phase 0: the state into the output buffers, by the threads from the
  // last down (phase 1's rows start at warp 0). Nothing reads it before
  // phase 2, so the barrier after phase 1 covers it
  const int rtid = kThreads - 1 - tid;
  for (long long k = rtid; k < CB; k += kThreads) q_out[k] = q[k];
  for (int c = rtid; c < C; c += kThreads) {
    count_out[c] = count[c];
    head_out[c] = head[c];
  }

  for (int r0 = 0; r0 < N; r0 += kChunk) {
    const int rows = min(kChunk, N - r0);

    // phase 1: a warp per row: the argmax and p_c from one read of the row
    for (int r = warp; r < rows; r += kWarps) {
      const float* row = p + (long long)(r0 + r) * C;
      const long long y = (long long)label[r0 + r];
      const bool ok = y >= 0 && y < C;
      float best = 0.0f, pcv = 0.0f;
      int arg = -1;
#pragma unroll 4
      for (int j = lane; j < C; j += 32) {
        const float v = row[j];
        if (arg < 0 || above(v, best)) {  // a lane's j only rises: the first of equals stays
          best = v;
          arg = j;
        }
        if (j == y) pcv = v;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(kAll, best, off);
        const int oa = __shfl_xor_sync(kAll, arg, off);
        // symmetric in the two lanes, so every lane ends with the same pick
        if (oa >= 0 && (arg < 0 || above(ob, best) || (!above(best, ob) && oa < arg))) {
          best = ob;
          arg = oa;
        }
      }
      // p_c from the lane that read it
      const float pc = __shfl_sync(kAll, pcv, ok ? (int)(y & 31) : 0);
      if (lane == 0) {
        s_lab[r] = ok ? (int)y : -1;
        s_pc[r] = pc;
        s_flag[r] = ok && arg == y ? kCorrect : 0;
        if (!ok) bad |= kBadLabel;
      }
    }
    __syncthreads();

    // phase 2: a thread per class walks the rows in order
    for (int c = tid; c < C; c += kThreads) {
      int cnt = count_out[c], hd = head_out[c];
      if (cnt < 0 || cnt > Bq || hd < 0 || hd >= Bq) {
        bad |= kBadState;  // its rows pass through
        continue;
      }
      float* qc = q_out + (long long)c * Bq;
      for (int r = 0; r < rows; ++r) {
        if (s_lab[r] != c) continue;
        // the queue mean: slots 0..cnt-1 added one at a time in slot order,
        // an order this loop fixes (no reduction tree)
        float s = 0.0f;
#pragma unroll 4
        for (int k = 0; k < cnt; ++k) s += qc[k];
        s_qb[r] = s / (float)max(cnt, 1);
        if (s_flag[r] & kCorrect) {
          qc[hd] = s_pc[r];
          hd = hd + 1 == Bq ? 0 : hd + 1;
          cnt = min(cnt + 1, Bq);
        } else if (cnt > 0) {
          s_flag[r] = kRectify;
        }
      }
      count_out[c] = cnt;
      head_out[c] = hd;
    }
    __syncthreads();

    // phase 3: Eq. 31, a warp per row, lanes along the row
    for (int r = warp; r < rows; r += kWarps) {
      const long long i = (long long)(r0 + r) * C;
      const bool rect = s_flag[r] & kRectify;
      const int y = s_lab[r];
      const float pc = s_pc[r], qb = s_qb[r];
#pragma unroll 4
      for (int j = lane; j < C; j += 32) {
        const float v = p[i + j];
        out[i + j] = rect ? rectify(v, j == y, pc, qb) : v;
      }
    }
    __syncthreads();  // the next chunk's phase 1 rewrites the row scalars
  }

  const int e = (__syncthreads_or(bad & kBadLabel) ? kBadLabel : 0) |
                (__syncthreads_or(bad & kBadState) ? kBadState : 0);
  // only a fault writes: one block a word, launches on a stream in order
  if (tid == 0 && e) err[b] |= e;
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

// p (B, N, C) fp32; label (B, N) int32, or int64 if label_is_i64; q (B, C,
// Bq) fp32; count, head (B, C) int32. Writes out (B, N, C) and the new
// state (q_out, count_out, head_out, fresh buffers of the input state's
// shapes), and ORs kBadLabel | kBadState into err[pair] (B int32 words,
// device or host-mapped memory) for a pair with a fault. C >= 1, Bq >= 1.
extern "C" int skr_process(const float* p, const void* label, int label_is_i64,
                           const float* q, const int* count, const int* head,
                           float* out, float* q_out, int* count_out,
                           int* head_out, int* err, int B, int N, int C, int Bq,
                           cudaStream_t stream) {
  if (B == 0) return (int)cudaGetLastError();
  if (label_is_i64) {
    skr_process_kernel<long long><<<B, kThreads, 0, stream>>>(
        p, static_cast<const long long*>(label), q, count, head, out, q_out,
        count_out, head_out, err, N, C, Bq);
  } else {
    skr_process_kernel<int><<<B, kThreads, 0, stream>>>(
        p, static_cast<const int*>(label), q, count, head, out, q_out,
        count_out, head_out, err, N, C, Bq);
  }
  return (int)cudaGetLastError();
}

// The attributes of one kernel instance (kernel_attrs.cuh's out[6]):
// kernel 0 the map (skr_rectify_kernel), 1 the fused kernel on int32
// labels, 2 on int64 labels. None takes dynamic shared memory.
extern "C" int skr_rectify_attrs(int kernel, long long* out) {
  switch (kernel) {
    case 0: return (int)kernel_attrs(skr_rectify_kernel, 0, out);
    case 1: return (int)kernel_attrs(skr_process_kernel<int>, 0, out);
    case 2: return (int)kernel_attrs(skr_process_kernel<long long>, 0, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
