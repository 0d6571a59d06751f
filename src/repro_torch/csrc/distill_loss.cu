// Fused distillation loss over the vocabulary axis, forward and backward,
// for Hopper (sm_90a), on fp32 or bf16 logits, with a cross-entropy entry
// that never reads a teacher.
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
// Two entries per direction and type. The t entries (distill_loss_fwd,
// distill_loss_bwd, and _bf16) read t. The cross-entropy entries
// (distill_loss_fwd_ce, distill_loss_bwd_ce, and _bf16) are beta = 0 with no
// t at all: no pointer, no load. They compute sum(e*t) as 0, so
// KL = sum(e*z)/l - logZ and loss = lw * CE. Both are instantiations of one
// template (HAS_T), so at beta = 0 the CE entry gives the bits the t entry
// gives on an all-zero t.
//
// z and t share one element type, fp32 or bf16, as the TPU kernel takes
// them: every element is widened to fp32 as it is loaded, all arithmetic
// and state are fp32, loss and stats are fp32, and dz is rounded once to
// z's type. The LM training loss is the bf16 CE entry (V = 128256 for
// llama3.2-3b); FedEEC runs fp32 rows of V = 10 through both entries.
//
// What bounds them on an H100: both are streaming passes with a few flops
// per element, so the bound is device-memory bytes: the forward reads z
// (and t) once, the backward reads z (and t) and writes dz once. Two
// things stand between a simple kernel and that bound. (1) Bytes in flight:
// 3.35 TB/s over about 1 us of latency wants some 32 KB of loads in flight
// on each of the 132 SMs; a warp issuing one 4-byte load a lane at a time
// keeps 128 B. (2) Issue slots at long bf16 rows: at 263 MB of z the memory
// time is 78 us, and an online softmax that rescales per element, with a
// branch and a second exp whenever the max moves, spends about as long in
// instructions.
//
// What the design does about it:
// - Every access is 16 bytes (float4, or eight bf16) wherever z, t and dz
//   share their address modulo 16. A row that starts off a 16-byte
//   boundary peels its head, and a ragged row its tail, with scalar loads
//   (fewer than one vector's worth each, one element a thread); the rest of
//   the row still takes 16-byte accesses. Pointers of different phases take
//   the same kernels with scalar accesses (VEC = false).
// - Forward, rows held in registers (V * sizeof(T) <= 16 KB): a row belongs
//   to TPR = 32-256 threads (the smallest power of two that holds it at 64
//   bytes a thread), four to one rows a block of max(TPR, 128) threads, so
//   a block's barriers wait on one row, not on a neighbour's late loads.
//   Each thread issues all of its loads (four 16-byte vectors of z, and of
//   t) before any arithmetic; then two passes over registers: the row max
//   (shuffles, then shared memory across the row's warps), then l, sum(e*z)
//   and sum(e*t) with one exp per element and no branch per element, summed
//   together (interleaved shuffles, one barrier). At (4, 256, 2048) fp32
//   every row is in flight at once: 64 KB per SM. Rows of 4 KB and more
//   load with ld.global.nc.L1::no_allocate (they come from device memory;
//   for FedEEC's few short rows, which L2 holds, plain loads measured
//   faster). What bounds it past that, at (4, 256, 2048), is fixed cost:
//   the first bytes' latency and the last warps' exps after the bytes
//   arrive, not the transfer.
// - Forward, streamed rows (longer V): a block per row (256 threads, 512
//   when there are too few rows to give each SM two blocks), 16-byte loads
//   four deep per thread; each chunk of four vectors takes its max first,
//   then one rescale of the running (m, l, sum(e*z), sum(e*t)), so there is
//   one exp per element plus one per chunk, and no branch on the data. The
//   states merge by shuffles, then across warps. A shared-memory ring fed by
//   cp.async.bulk was not chosen: eight resident blocks of 256 threads with
//   64 bytes in flight each keep 128 KB in flight per SM from registers,
//   four times what the bandwidth needs, and the ring would add a barrier
//   per stage for nothing the registers do not already give (a bulk copy of
//   each register-layout row into shared memory, tried, measured slower
//   than the 16-byte loads).
// - The forward's exps are ex2.approx.ftz: a term that flushes (below
//   2^-126 of the row max's, whose own term is 1) lies far below l's ulp.
//   The backward's exp keeps denormals: p itself is written.
// - The gold logit: rows in registers pick it from the register that holds
//   it (a select per element, summed with l), so no load waits on the
//   label; streamed rows read it directly at z[y] after the loop.
// - Backward: work units of a row slice: 32-256 threads each own a row
//   (rows up to 16 KB), or 256 threads own one 16 KB slice of a long row.
//   A unit reads logZ, KL, g and y once, issues its four 16-byte loads of z
//   (and t) before any arithmetic, and writes dz with 16-byte stores. No
//   per-element division: a unit's row is a shift of the thread index, or
//   one 32-bit division per thread for slices.
// All launch on the caller's stream and allocate nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarp = 32;
constexpr int kBlock = 256;        // threads of a backward block; the most a forward block has
constexpr int kThreadBytes = 64;   // bytes of a row a thread holds: four 16-byte loads
constexpr int kRowsBlock = 128;    // threads of a register-layout forward block, at least

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 2^x with results below 2^-126 flushed to 0 (forward sums only)
__device__ __forceinline__ float ex2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// E elements at a time: one 16-byte vector (VEC) or one element
template <typename T, bool VEC>
struct Access;

template <>
struct Access<float, true> {
  static constexpr int E = 4;
  using Raw = float4;
  template <bool NC = false>
  __device__ static Raw load(const float* p) {
    if constexpr (NC) {
      float4 r;
      asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
                   : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
                   : "l"(p));
      return r;
    } else {
      return *reinterpret_cast<const float4*>(p);
    }
  }
  __device__ static void unpack(const Raw& r, float* o) {
    o[0] = r.x;
    o[1] = r.y;
    o[2] = r.z;
    o[3] = r.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Access<__nv_bfloat16, true> {
  static constexpr int E = 8;
  using Raw = uint4;
  template <bool NC = false>
  __device__ static Raw load(const __nv_bfloat16* p) {
    if constexpr (NC) {
      uint4 r;
      asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
                   : "l"(p));
      return r;
    } else {
      return *reinterpret_cast<const uint4*>(p);
    }
  }
  __device__ static void unpack(const Raw& r, float* o) {
    const __nv_bfloat162* two = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < E / 2; ++i) {
      const float2 f = __bfloat1622float2(two[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 u;
    __nv_bfloat162* two = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < E / 2; ++i) two[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <typename T>
struct Access<T, false> {
  static constexpr int E = 1;
  using Raw = T;
  template <bool NC = false>
  __device__ static Raw load(const T* p) {
    return *p;
  }
  __device__ static void unpack(const Raw& r, float* o) { o[0] = widen(r); }
  __device__ static void store(T* p, const float* v) { put(p, v[0]); }
};

// A row as a scalar head (up to the first 16-byte boundary), nvec whole
// vectors, and a scalar tail of ntail elements from tail0
struct Row {
  int head, nvec, tail0, ntail;
};

template <typename T, bool VEC>
__device__ __forceinline__ Row row_geom(const T* p, int V) {
  if constexpr (VEC) {
    constexpr int E = Access<T, true>::E;
    const int mis = (int)(reinterpret_cast<uintptr_t>(p) & 15u) / (int)sizeof(T);
    const int head = min(V, (E - mis) % E);
    const int nvec = (V - head) / E;
    const int tail0 = head + nvec * E;
    return {head, nvec, tail0, V - tail0};
  } else {
    return {0, V, V, 0};
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The row's max over its TPR threads: shuffles, then (TPR > 32) the row's
// warps' partials through red[kBlock / kWarp] in warp order
template <int TPR>
__device__ __forceinline__ float row_max(float v, float* red) {
  v = warp_max(v);
  if constexpr (TPR > kWarp) {
    if (threadIdx.x % kWarp == 0) red[threadIdx.x / kWarp] = v;
    __syncthreads();
    const int first = (threadIdx.x / TPR) * (TPR / kWarp);
    v = red[first];
#pragma unroll
    for (int k = 1; k < TPR / kWarp; ++k) v = fmaxf(v, red[first + k]);
  }
  return v;
}

// The row's sums of N values at once: interleaved shuffles, then one
// barrier for all N; red is N arrays of kBlock / kWarp floats
template <int TPR, int N>
__device__ __forceinline__ void row_sum(float* v, float (*red)[kBlock / kWarp]) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
  }
  if constexpr (TPR > kWarp) {
    if (threadIdx.x % kWarp == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) red[i][threadIdx.x / kWarp] = v[i];
    }
    __syncthreads();
    const int first = (threadIdx.x / TPR) * (TPR / kWarp);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      v[i] = red[i][first];
#pragma unroll
      for (int k = 1; k < TPR / kWarp; ++k) v[i] += red[i][first + k];
    }
  }
}

template <bool HAS_T>
__device__ __forceinline__ void finish(long long row, float m, float l, float sz, float st,
                                       float zy, float beta, float lw, float* loss,
                                       float* stats) {
  const float logz = m + logf(fmaxf(l, 1e-38f));
  const float ce = logz - zy;
  float kl;
  if constexpr (HAS_T) {
    kl = sz / l - logz - st / l;
    loss[row] = lw * ce + beta * kl;
  } else {
    kl = sz / l - logz;
    loss[row] = lw * ce;
  }
  stats[2 * row] = logz;
  stats[2 * row + 1] = kl;
}

struct Online {
  float m, l, sz, st;
};

// Fold N values into the running state: the chunk's max first, one rescale,
// then one exp per value
template <int N, bool HAS_T>
__device__ __forceinline__ void fold(Online& s, const float* zv, const float* tv) {
  float cm = zv[0];
#pragma unroll
  for (int i = 1; i < N; ++i) cm = fmaxf(cm, zv[i]);
  const float mn = fmaxf(s.m, cm);
  const float mL = mn * kLog2e;
  // a difference, not fmaf(s.m, kLog2e, -mL): at s.m = mn = kNeg that
  // leaves mL's rounding error, some 1e22, and exp of it is inf
  const float a = ex2_ftz((s.m - mn) * kLog2e);
  s.l *= a;
  s.sz *= a;
  if constexpr (HAS_T) s.st *= a;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float ex = ex2_ftz(fmaf(zv[i], kLog2e, -mL));
    s.l += ex;
    s.sz = fmaf(ex, zv[i], s.sz);
    if constexpr (HAS_T) s.st = fmaf(ex, tv[i], s.st);
  }
  s.m = mn;
}

template <bool HAS_T>
__device__ __forceinline__ Online merge(const Online& a, const Online& b) {
  const float m = fmaxf(a.m, b.m);
  const float fa = ex2_ftz((a.m - m) * kLog2e);  // two empty states: 1, not inf
  const float fb = ex2_ftz((b.m - m) * kLog2e);
  return {m, a.l * fa + b.l * fb, a.sz * fa + b.sz * fb,
          HAS_T ? a.st * fa + b.st * fb : 0.0f};
}

template <bool HAS_T>
__device__ __forceinline__ Online warp_merge(Online s) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    Online o;
    o.m = __shfl_xor_sync(0xffffffffu, s.m, off);
    o.l = __shfl_xor_sync(0xffffffffu, s.l, off);
    o.sz = __shfl_xor_sync(0xffffffffu, s.sz, off);
    o.st = HAS_T ? __shfl_xor_sync(0xffffffffu, s.st, off) : 0.0f;
    s = merge<HAS_T>(s, o);
  }
  return s;
}

// ------------------------------------------------------------ forward, registers

template <typename T, bool HAS_T, bool VEC, int TPR>
__global__ void __launch_bounds__(kBlock)
    fwd_regs(const T* __restrict__ z, const T* __restrict__ t, const int* __restrict__ y,
             float* __restrict__ loss, float* __restrict__ stats, long long rows, int V,
             float beta, float lw) {
  using A = Access<T, VEC>;
  constexpr int E = A::E;
  constexpr int L = kThreadBytes / (E * (int)sizeof(T));  // loads a thread holds
  __shared__ float red[5][kBlock / kWarp];
  constexpr int NT = TPR > kRowsBlock ? TPR : kRowsBlock;
  // rows of 4 KB and more come from device memory, not L2: no L1 allocation
  constexpr bool kStream = TPR >= 128;

  const int sub = threadIdx.x / TPR;
  const int tid = threadIdx.x % TPR;
  const long long row = (long long)blockIdx.x * (NT / TPR) + sub;
  const bool live = row < rows;
  const bool lead = live && tid == 0;
  const long long off = (live ? row : 0) * (long long)V;
  const T* zr = z + off;
  const T* tr = HAS_T ? t + off : nullptr;
  const Row g = live ? row_geom<T, VEC>(zr, V) : Row{0, 0, 0, 0};
  const int label = live ? y[row] : -1;  // one address a row: a broadcast

  // every load of the row, before any arithmetic
  typename A::Raw zw[L];
  typename A::Raw tw[HAS_T ? L : 1];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int j = k * TPR + tid;
    if (j < g.nvec) {
      zw[k] = A::template load<kStream>(zr + g.head + j * E);
      if constexpr (HAS_T) tw[k] = A::template load<kStream>(tr + g.head + j * E);
    }
  }
  const bool in_head = tid < g.head;
  const bool in_tail = tid < g.ntail;
  float zh = kNeg, th = 0.0f, zt = kNeg, tt = 0.0f;
  if (in_head) {
    zh = widen(zr[tid]);
    if constexpr (HAS_T) th = widen(tr[tid]);
  }
  if (in_tail) {
    zt = widen(zr[g.tail0 + tid]);
    if constexpr (HAS_T) tt = widen(tr[g.tail0 + tid]);
  }

  float zf[L * E];
  float tf[HAS_T ? L * E : 1];
  float m = kNeg;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    if (k * TPR + tid < g.nvec) {
      A::unpack(zw[k], zf + k * E);
      if constexpr (HAS_T) A::unpack(tw[k], tf + k * E);
#pragma unroll
      for (int e = 0; e < E; ++e) m = fmaxf(m, zf[k * E + e]);
    }
  }
  if (in_head) m = fmaxf(m, zh);
  if (in_tail) m = fmaxf(m, zt);
  m = row_max<TPR>(m, red[0]);

  // l, sum(e*z), the gold logit (picked from the registers that hold it:
  // no load that waits on the label) and sum(e*t)
  const float mL = m * kLog2e;
  float sums[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int j = k * TPR + tid;
    if (j < g.nvec) {
      const int rel = label - g.head - j * E;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ex = ex2_ftz(fmaf(zf[k * E + e], kLog2e, -mL));
        sums[0] += ex;
        sums[1] = fmaf(ex, zf[k * E + e], sums[1]);
        sums[2] = e == rel ? zf[k * E + e] : sums[2];
        if constexpr (HAS_T) sums[3] = fmaf(ex, tf[k * E + e], sums[3]);
      }
    }
  }
  if (in_head) {
    const float ex = ex2_ftz(fmaf(zh, kLog2e, -mL));
    sums[0] += ex;
    sums[1] = fmaf(ex, zh, sums[1]);
    sums[2] = tid == label ? zh : sums[2];
    if constexpr (HAS_T) sums[3] = fmaf(ex, th, sums[3]);
  }
  if (in_tail) {
    const float ex = ex2_ftz(fmaf(zt, kLog2e, -mL));
    sums[0] += ex;
    sums[1] = fmaf(ex, zt, sums[1]);
    sums[2] = g.tail0 + tid == label ? zt : sums[2];
    if constexpr (HAS_T) sums[3] = fmaf(ex, tt, sums[3]);
  }
  // one thread holds the gold logit, the others 0: the sum is exact
  row_sum<TPR, HAS_T ? 4 : 3>(sums, red + 1);
  // the wrapper validates labels; an out-of-range one yields NaN
  const float zy = label >= 0 && label < V ? sums[2] : __int_as_float(0x7fc00000);
  if (lead) finish<HAS_T>(row, m, sums[0], sums[1], sums[3], zy, beta, lw, loss, stats);
}

// ------------------------------------------------------------ forward, streamed

template <typename T, bool HAS_T, bool VEC>
__global__ void __launch_bounds__(512)
    fwd_stream(const T* __restrict__ z, const T* __restrict__ t, const int* __restrict__ y,
               float* __restrict__ loss, float* __restrict__ stats, int V, float beta,
               float lw) {
  using A = Access<T, VEC>;
  constexpr int E = A::E;
  constexpr int U = kThreadBytes / (E * (int)sizeof(T));  // loads in flight a thread
  __shared__ Online part[512 / kWarp];

  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long long off = row * (long long)V;
  const T* zr = z + off;
  const T* tr = HAS_T ? t + off : nullptr;
  const Row g = row_geom<T, VEC>(zr, V);
  const int label = tid == 0 ? y[row] : 0;

  Online s{kNeg, 0.0f, 0.0f, 0.0f};
  if (tid < g.head) {
    const float zv = widen(zr[tid]);
    const float tv = HAS_T ? widen(tr[tid]) : 0.0f;
    fold<1, HAS_T>(s, &zv, &tv);
  }
  if (tid < g.ntail) {
    const float zv = widen(zr[g.tail0 + tid]);
    const float tv = HAS_T ? widen(tr[g.tail0 + tid]) : 0.0f;
    fold<1, HAS_T>(s, &zv, &tv);
  }
  const T* zb = zr + g.head;
  const T* tb = HAS_T ? tr + g.head : nullptr;
  int j = tid;
  for (; j + (U - 1) * nt < g.nvec; j += U * nt) {
    typename A::Raw zw[U];
    typename A::Raw tw[HAS_T ? U : 1];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      zw[k] = A::template load<true>(zb + (j + k * nt) * E);
      if constexpr (HAS_T) tw[k] = A::template load<true>(tb + (j + k * nt) * E);
    }
    float zf[U * E];
    float tf[HAS_T ? U * E : 1];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      A::unpack(zw[k], zf + k * E);
      if constexpr (HAS_T) A::unpack(tw[k], tf + k * E);
    }
    fold<U * E, HAS_T>(s, zf, tf);
  }
  {  // the rest: fewer than U vectors for this thread, loaded together
    typename A::Raw zw[U];
    typename A::Raw tw[HAS_T ? U : 1];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (j + k * nt < g.nvec) {
        zw[k] = A::template load<true>(zb + (j + k * nt) * E);
        if constexpr (HAS_T) tw[k] = A::template load<true>(tb + (j + k * nt) * E);
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (j + k * nt < g.nvec) {
        float zf[E], tf[E];
        A::unpack(zw[k], zf);
        if constexpr (HAS_T) A::unpack(tw[k], tf);
        fold<E, HAS_T>(s, zf, tf);
      }
    }
  }
  const float zy = (tid == 0 && label >= 0 && label < V) ? widen(zr[label])
                                                         : __int_as_float(0x7fc00000);

  s = warp_merge<HAS_T>(s);
  const int warp = tid / kWarp;
  if (tid % kWarp == 0) part[warp] = s;
  __syncthreads();
  if (warp != 0) return;
  const int nw = nt / kWarp;
  s = tid < nw ? part[tid] : Online{kNeg, 0.0f, 0.0f, 0.0f};
  s = warp_merge<HAS_T>(s);
  if (tid == 0) finish<HAS_T>(row, s.m, s.l, s.sz, s.st, zy, beta, lw, loss, stats);
}

// ------------------------------------------------------------ backward

template <bool HAS_T>
__device__ __forceinline__ float dz_of(float zi, float ti, bool gold, float logz, float kl,
                                       float g, float beta, float lw) {
  const float sp = exp2f((zi - logz) * kLog2e);
  const float d = HAS_T ? lw * (sp - (gold ? 1.0f : 0.0f)) + beta * sp * ((zi - logz - ti) - kl)
                        : lw * (sp - (gold ? 1.0f : 0.0f));
  return g * d;
}

// A unit is tpr threads on one slice of a row: the row's only slice when
// slices == 1 (kBlock / tpr rows a block), else one of its 16 KB slices
template <typename T, bool HAS_T, bool VEC>
__global__ void __launch_bounds__(kBlock)
    bwd(const T* __restrict__ z, const T* __restrict__ t, const int* __restrict__ y,
        const float* __restrict__ stats, const float* __restrict__ g, T* __restrict__ dz,
        long long rows, int V, int tpr, int slices, float beta, float lw) {
  using A = Access<T, VEC>;
  constexpr int E = A::E;
  constexpr int L = kThreadBytes / (E * (int)sizeof(T));

  const int lg = __ffs(tpr) - 1;  // tpr is a power of two
  const int tid = threadIdx.x & (tpr - 1);
  long long row;
  int slice;
  if (slices == 1) {  // kBlock / tpr rows a block
    row = (long long)blockIdx.x * (kBlock >> lg) + (threadIdx.x >> lg);
    slice = 0;
  } else {  // tpr == kBlock: one slice a block
    row = blockIdx.x / (unsigned)slices;
    slice = (int)(blockIdx.x - (unsigned)row * (unsigned)slices);
  }
  if (row >= rows) return;
  const long long off = row * (long long)V;
  const T* zr = z + off;
  const T* tr = HAS_T ? t + off : nullptr;
  T* dr = dz + off;
  const Row gm = row_geom<T, VEC>(zr, V);
  const float logz = stats[2 * row];
  const float kl = stats[2 * row + 1];
  const float gr = g[row];
  const int label = y[row];

  const int j0 = slice * tpr * L + tid;
  typename A::Raw zw[L];
  typename A::Raw tw[HAS_T ? L : 1];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int j = j0 + k * tpr;
    if (j < gm.nvec) {
      zw[k] = A::load(zr + gm.head + j * E);
      if constexpr (HAS_T) tw[k] = A::load(tr + gm.head + j * E);
    }
  }
  const bool in_head = slice == 0 && tid < gm.head;
  const bool in_tail = slice == slices - 1 && tid < gm.ntail;
  float zh = 0.0f, th = 0.0f, zt = 0.0f, tt = 0.0f;
  if (in_head) {
    zh = widen(zr[tid]);
    if constexpr (HAS_T) th = widen(tr[tid]);
  }
  if (in_tail) {
    zt = widen(zr[gm.tail0 + tid]);
    if constexpr (HAS_T) tt = widen(tr[gm.tail0 + tid]);
  }
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int j = j0 + k * tpr;
    if (j < gm.nvec) {
      float zf[E], tf[E], out[E];
      A::unpack(zw[k], zf);
      if constexpr (HAS_T) A::unpack(tw[k], tf);
      const int rel = label - gm.head - j * E;  // the gold element's place in this vector
#pragma unroll
      for (int e = 0; e < E; ++e)
        out[e] = dz_of<HAS_T>(zf[e], HAS_T ? tf[e] : 0.0f, e == rel, logz, kl, gr, beta, lw);
      A::store(dr + gm.head + j * E, out);
    }
  }
  if (in_head) put(dr + tid, dz_of<HAS_T>(zh, th, tid == label, logz, kl, gr, beta, lw));
  if (in_tail)
    put(dr + gm.tail0 + tid,
        dz_of<HAS_T>(zt, tt, gm.tail0 + tid == label, logz, kl, gr, beta, lw));
}

// ------------------------------------------------------------ launch

bool same_phase(const void* a, const void* b) {
  return (reinterpret_cast<uintptr_t>(a) & 15u) == (reinterpret_cast<uintptr_t>(b) & 15u);
}

bool row_threads_ok(int tpr) { return tpr == 32 || tpr == 64 || tpr == 128 || tpr == 256; }

// rows a register-layout block holds
constexpr long long rpb(int tpr) { return (tpr > kRowsBlock ? tpr : kRowsBlock) / tpr; }

template <typename T, bool HAS_T, bool VEC>
void fwd_regs_launch(int tpr, unsigned blocks, const T* z, const T* t, const int* y, float* loss,
                     float* stats, long long rows, int V, float beta, float lw,
                     cudaStream_t stream) {
  switch (tpr) {
    case 32:
      fwd_regs<T, HAS_T, VEC, 32><<<blocks, rpb(32) * 32, 0, stream>>>(z, t, y, loss, stats,
                                                                      rows, V, beta, lw);
      break;
    case 64:
      fwd_regs<T, HAS_T, VEC, 64><<<blocks, rpb(64) * 64, 0, stream>>>(z, t, y, loss, stats,
                                                                      rows, V, beta, lw);
      break;
    case 128:
      fwd_regs<T, HAS_T, VEC, 128><<<blocks, rpb(128) * 128, 0, stream>>>(z, t, y, loss, stats,
                                                                         rows, V, beta, lw);
      break;
    default:
      fwd_regs<T, HAS_T, VEC, 256><<<blocks, rpb(256) * 256, 0, stream>>>(z, t, y, loss, stats,
                                                                         rows, V, beta, lw);
  }
}

// layout 0: rows in registers, tpr threads a row; layout 1: a block of
// `threads` (256 or 512) a row
template <typename T, bool HAS_T>
int fwd(const T* z, const T* t, const int* y, float* loss, float* stats, long long rows, int V,
        float beta, float lw, int layout, int threads, cudaStream_t stream) {
  if (rows == 0) return (int)cudaGetLastError();
  if (V <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = !HAS_T || same_phase(z, t);
  if (layout == 0) {
    if (!row_threads_ok(threads) ||
        (long long)V * (long long)sizeof(T) > (long long)threads * kThreadBytes)
      return (int)cudaErrorInvalidValue;
    const long long blocks = (rows + rpb(threads) - 1) / rpb(threads);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (vec)
      fwd_regs_launch<T, HAS_T, true>(threads, (unsigned)blocks, z, t, y, loss, stats, rows, V,
                                      beta, lw, stream);
    else
      fwd_regs_launch<T, HAS_T, false>(threads, (unsigned)blocks, z, t, y, loss, stats, rows, V,
                                       beta, lw, stream);
  } else if (layout == 1) {
    if ((threads != 256 && threads != 512) || rows > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    if (vec)
      fwd_stream<T, HAS_T, true><<<(unsigned)rows, threads, 0, stream>>>(z, t, y, loss, stats, V,
                                                                        beta, lw);
    else
      fwd_stream<T, HAS_T, false><<<(unsigned)rows, threads, 0, stream>>>(z, t, y, loss, stats,
                                                                         V, beta, lw);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, bool HAS_T>
int bwd_launch(const T* z, const T* t, const int* y, const float* stats, const float* g, T* dz,
               long long rows, int V, float beta, float lw, int tpr, int slices,
               cudaStream_t stream) {
  if (rows == 0) return (int)cudaGetLastError();
  if (V <= 0 || !row_threads_ok(tpr) || slices < 1 || (slices > 1 && tpr != kBlock) ||
      (long long)V * (long long)sizeof(T) > (long long)slices * tpr * kThreadBytes)
    return (int)cudaErrorInvalidValue;
  const bool vec = same_phase(z, dz) && (!HAS_T || same_phase(z, t));
  const long long per = kBlock / tpr;
  const long long blocks = (rows * slices + per - 1) / per;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (vec)
    bwd<T, HAS_T, true><<<(unsigned)blocks, kBlock, 0, stream>>>(z, t, y, stats, g, dz, rows, V,
                                                                tpr, slices, beta, lw);
  else
    bwd<T, HAS_T, false><<<(unsigned)blocks, kBlock, 0, stream>>>(z, t, y, stats, g, dz, rows,
                                                                 V, tpr, slices, beta, lw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int distill_loss_fwd(const float* z, const float* t, const int* y, float* loss,
                                float* stats, long long rows, int V, float beta, float lw,
                                int layout, int threads, cudaStream_t stream) {
  return fwd<float, true>(z, t, y, loss, stats, rows, V, beta, lw, layout, threads, stream);
}

extern "C" int distill_loss_fwd_bf16(const __nv_bfloat16* z, const __nv_bfloat16* t,
                                     const int* y, float* loss, float* stats, long long rows,
                                     int V, float beta, float lw, int layout, int threads,
                                     cudaStream_t stream) {
  return fwd<__nv_bfloat16, true>(z, t, y, loss, stats, rows, V, beta, lw, layout, threads,
                                  stream);
}

extern "C" int distill_loss_fwd_ce(const float* z, const int* y, float* loss, float* stats,
                                   long long rows, int V, float lw, int layout, int threads,
                                   cudaStream_t stream) {
  return fwd<float, false>(z, nullptr, y, loss, stats, rows, V, 0.0f, lw, layout, threads,
                           stream);
}

extern "C" int distill_loss_fwd_ce_bf16(const __nv_bfloat16* z, const int* y, float* loss,
                                        float* stats, long long rows, int V, float lw,
                                        int layout, int threads, cudaStream_t stream) {
  return fwd<__nv_bfloat16, false>(z, nullptr, y, loss, stats, rows, V, 0.0f, lw, layout,
                                   threads, stream);
}

extern "C" int distill_loss_bwd(const float* z, const float* t, const int* y,
                                const float* stats, const float* g, float* dz, long long rows,
                                int V, float beta, float lw, int tpr, int slices,
                                cudaStream_t stream) {
  return bwd_launch<float, true>(z, t, y, stats, g, dz, rows, V, beta, lw, tpr, slices, stream);
}

extern "C" int distill_loss_bwd_bf16(const __nv_bfloat16* z, const __nv_bfloat16* t,
                                     const int* y, const float* stats, const float* g,
                                     __nv_bfloat16* dz, long long rows, int V, float beta,
                                     float lw, int tpr, int slices, cudaStream_t stream) {
  return bwd_launch<__nv_bfloat16, true>(z, t, y, stats, g, dz, rows, V, beta, lw, tpr, slices,
                                         stream);
}

extern "C" int distill_loss_bwd_ce(const float* z, const int* y, const float* stats,
                                   const float* g, float* dz, long long rows, int V, float lw,
                                   int tpr, int slices, cudaStream_t stream) {
  return bwd_launch<float, false>(z, nullptr, y, stats, g, dz, rows, V, 0.0f, lw, tpr, slices,
                                  stream);
}

extern "C" int distill_loss_bwd_ce_bf16(const __nv_bfloat16* z, const int* y,
                                        const float* stats, const float* g, __nv_bfloat16* dz,
                                        long long rows, int V, float lw, int tpr, int slices,
                                        cudaStream_t stream) {
  return bwd_launch<__nv_bfloat16, false>(z, nullptr, y, stats, g, dz, rows, V, 0.0f, lw, tpr,
                                          slices, stream);
}
