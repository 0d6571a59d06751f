// RWKV6 ("Finch") time-mix recurrence, backward, for Hopper (sm_90a): the
// gradient that training runs through.
//
// Replaces no TPU kernel: the TPU kernel (repro/kernels/rwkv6_scan.py:_kernel)
// has no backward, and the reference trains through the gradient that XLA
// derives from the lax.scan of repro/models/ssm.py:96-119 (the same
// recurrence as repro/kernels/ref.py:98-111). This kernel computes that
// gradient, the function of kernels/ref.py:rwkv6_scan_grad_ref. With S_{t-1}
// the state before step t (S_{-1} = s0) and G_t the cotangent of S_t:
//   G_{T-1} = dsT,  G_{t-1} = diag(w_t) G_t + r_t dy_t^T,  ds0 = G_{-1};
//   b_t = v_t . dy_t,  a_t = sum_i r_t[i] u[i] k_t[i];
//   dr_t = S_{t-1} dy_t + u * k_t b_t,   dk_t = G_t v_t + u * r_t b_t,
//   dv_t = G_t^T k_t + a_t dy_t,         dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j],
//   du = sum over b, t of r_t * k_t b_t.
// r, k, v, w, dy (B, T, H, hd), u (H, hd), s0 and dsT (B, H, hd, hd), all
// fp32; dr, dk, dv, dw (B, T, H, hd), ds0 (B, H, hd, hd) and du's partial
// sums per chunk dup (B, H, ceil(T / L), hd), which the wrapper sums over B
// and the chunks. Any T.
//
// dw needs S_{t-1} and G_t at the same step, and the two run in opposite
// directions. Neither is recovered by dividing by w (the identity w * dw =
// reverse cumsum of r * dr - k * dk loses dw where w is 1e-30 or 0): S_{t-1}
// is recomputed forward from a stored state instead.
//
// What bounds it on an H100: the function reads r, k, v, w and dy and
// writes dr, dk, dv and dw, 36 hd bytes per token and head (2,304 at hd =
// 64), against 14 hd^2 fp32 flops (an FMA counted as two: per element of the
// hd x hd state, 3 to recompute S, 3 to step G back, 2 each for dr, dk, dv
// and dw), some 25 flops a byte at hd = 64, just above the card's fp32
// ridge (67 TFLOP/s over 3.35 TB/s = 20): operations, barely. This design
// adds work of its own: S_{t-1} is recomputed from its chunk's entry state
// at every step, (L - 1) / 2 extra state steps a step on average, and the
// chunk scratch (two hd x hd matrices a chunk) is written and read back.
//
// What the design does about it: the recurrence is linear in S and in G,
// so the time axis splits into chunks of L steps that run in parallel, as
// in the forward's csrc/rwkv6_scan_chunked.cu. Three kernels, B * H *
// ceil(T / L) blocks each but the scan:
//
// 1. local, one block per (chunk, h, b): the chunk's r, k, w, v and dy
//    staged in shared memory with 16-byte loads, then, from zero, the
//    chunk's state contribution dS_c (the forward recurrence), its
//    cotangent contribution dG_c = sum_t (r_t * P_t) dy_t^T, with P_t the
//    product of w since the chunk began (plain fp32 products), and the full
//    product P_end.
// 2. chunk_scan, one thread per element of S: the entry state of each
//    chunk, S <- diag(P_end,c) S + dS_c from s0, and the cotangent at each
//    chunk's last step, G <- diag(P_end,c) G + dG_c from dsT over the chunks
//    in reverse, each overwriting its chunk's dS_c / dG_c in place; the last
//    G is ds0.
// 3. grads, one block per (chunk, h, b): the chunk's r, k, v, w and dy in
//    shared memory, a_t and b_t a warp a step; each thread holds CW columns
//    of one row i of the entry state, of G and of a working state in
//    registers (rows are independent: S[i][:] <- w[i] S[i][:] + k[i] v and
//    G[i][:] <- w[i] G[i][:] + r[i] dy). Steps run in reverse: the working
//    state is reset to the entry state and stepped forward to S_{t-1}, then
//    dr, dk and dw are row sums (the RS lanes of a row meet by shuffles)
//    and dv a column sum, reduce-scattered over the warp's rows (log2 of
//    its rows shuffle steps, each halving the columns a lane holds) into
//    the warp's slot for the step in shared memory; then G steps back. The
//    steps need no barrier: the warps' slots are summed once, after the
//    last step. No state of a step is stored.
//
// Scratch from the caller, fp32: sx and gx (B, H, ceil(T / L), hd, hd),
// pend (B, H, ceil(T / L), hd). r, k, v, w, dy and the outputs must be
// 16-byte aligned. L is at most kMaxChunk (16 at hd = 128, where kernel 3's
// shared memory for 32 steps would pass the card's 227 KB).
#include <cuda_runtime.h>

namespace {

constexpr int kMaxChunk = 32;  // the longest chunk the entry takes

// thread layout of kernels 1 and 3: thread tid holds columns j0 .. j0 + CW
// of row i = tid / RS (j0 = (tid % RS) * CW); the RS threads of a row are
// neighbouring lanes
template <int HD>
struct Layout {
  static constexpr int CW = HD >= 128 ? 32 : 16;  // columns a thread
  static constexpr int RS = HD / CW;              // threads a row
  static constexpr int NT = HD * RS;              // threads a block
  static constexpr int WS = NT < 32 ? NT : 32;    // lanes a warp uses
  static constexpr int NW = (NT + 31) / 32;       // warps a block
  static constexpr int RW = WS / RS;              // rows a warp
  static constexpr int CL = CW / RW;              // dv columns a lane ends with
  static constexpr unsigned kMask = WS == 32 ? 0xffffffffu : (1u << WS) - 1u;
};

// n steps of one (b, h) row of a (B, T, H, HD) array into dst[n][HD]; row0
// is the index of (b, first step, h) among the B * T * H rows
template <int HD, int NT>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      long long row0, int H, int n, int tid) {
  for (int e = tid; e < n * HD / 4; e += NT) {
    const int t = e / (HD / 4), q = e % (HD / 4);
    *reinterpret_cast<float4*>(dst + t * HD + 4 * q) =
        *reinterpret_cast<const float4*>(src + (row0 + (long long)t * H) * HD + 4 * q);
  }
}

// kernel 1's dynamic shared memory: r, k, w, v, dy [L][HD] each
template <int HD>
size_t local_smem(int L) {
  return (size_t)5 * L * HD * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(Layout<HD>::NT)
local(const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
      const float* __restrict__ w, const float* __restrict__ dy, float* __restrict__ sx,
      float* __restrict__ gx, float* __restrict__ pend, int T, int H, int L) {
  using Lay = Layout<HD>;
  constexpr int CW = Lay::CW, NT = Lay::NT;
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;
  float* ks = rs + L * HD;
  float* ws = ks + L * HD;
  float* vs = ws + L * HD;
  float* ys = vs + L * HD;  // dy
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int i = tid / Lay::RS, j0 = (tid % Lay::RS) * CW;
  const int c0 = c * L, n = min(L, T - c0);
  const long long row0 = ((long long)b * T + c0) * H + h;
  stage<HD, NT>(rs, r, row0, H, n, tid);
  stage<HD, NT>(ks, k, row0, H, n, tid);
  stage<HD, NT>(ws, w, row0, H, n, tid);
  stage<HD, NT>(vs, v, row0, H, n, tid);
  stage<HD, NT>(ys, dy, row0, H, n, tid);
  __syncthreads();
  float S[CW], G[CW];
#pragma unroll
  for (int jj = 0; jj < CW; ++jj) S[jj] = G[jj] = 0.0f;
  float p = 1.0f;
  for (int t = 0; t < n; ++t) {
    const float ki = ks[t * HD + i], wi = ws[t * HD + i];
    const float rp = rs[t * HD + i] * p;
#pragma unroll
    for (int jj = 0; jj < CW; jj += 4) {
      const float4 v4 = *reinterpret_cast<const float4*>(vs + t * HD + j0 + jj);
      const float4 d4 = *reinterpret_cast<const float4*>(ys + t * HD + j0 + jj);
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w}, dd[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        S[jj + e] = fmaf(wi, S[jj + e], ki * vv[e]);
        G[jj + e] = fmaf(rp, dd[e], G[jj + e]);
      }
    }
    p *= wi;
  }
  const long long chunk = ((long long)b * H + h) * gridDim.x + c;
  float* ds = sx + chunk * HD * HD + i * HD + j0;
  float* dg = gx + chunk * HD * HD + i * HD + j0;
#pragma unroll
  for (int jj = 0; jj < CW; jj += 4) {
    *reinterpret_cast<float4*>(ds + jj) = make_float4(S[jj], S[jj + 1], S[jj + 2], S[jj + 3]);
    *reinterpret_cast<float4*>(dg + jj) = make_float4(G[jj], G[jj + 1], G[jj + 2], G[jj + 3]);
  }
  if (tid % Lay::RS == 0) pend[chunk * HD + i] = p;
}

template <int HD>
__global__ void __launch_bounds__(256)
chunk_scan(const float* __restrict__ s0, const float* __restrict__ dsT,
           const float* __restrict__ pend, float* __restrict__ sx, float* __restrict__ gx,
           float* __restrict__ ds0, long long n_elems, int NC) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_elems) return;
  const long long bh = e / (HD * HD);
  const int ij = (int)(e % (HD * HD)), i = ij / HD;
  float* ps = sx + bh * NC * HD * HD + ij;
  float* pg = gx + bh * NC * HD * HD + ij;
  const float* pe = pend + bh * NC * HD + i;
  float S = s0[e];
  for (int c = 0; c < NC; ++c) {
    const float d = ps[(long long)c * HD * HD];
    ps[(long long)c * HD * HD] = S;
    S = fmaf(pe[c * HD], S, d);
  }
  float G = dsT[e];
  for (int c = NC - 1; c >= 0; --c) {
    const float d = pg[(long long)c * HD * HD];
    pg[(long long)c * HD * HD] = G;
    G = fmaf(pe[c * HD], G, d);
  }
  ds0[e] = G;
}

// kernel 3's dynamic shared memory: the warps' dv partials [L][NW][HD], r,
// k, v, w, dy [L][HD] each, u [HD], a_t and b_t [L] each
template <int HD>
size_t grads_smem(int L) {
  return ((size_t)L * Layout<HD>::NW * HD + 5 * L * HD + HD + 2 * L) * sizeof(float);
}

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }

template <int HD>
__global__ void __launch_bounds__(Layout<HD>::NT)
grads(const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
      const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ dy,
      const float* __restrict__ sx, const float* __restrict__ gx, float* __restrict__ dr,
      float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dw,
      float* __restrict__ dup, int T, int H, int L) {
  using Lay = Layout<HD>;
  constexpr int CW = Lay::CW, RS = Lay::RS, NT = Lay::NT, WS = Lay::WS, NW = Lay::NW;
  constexpr int kSteps = ilog2(Lay::RW);  // reduce-scatter steps over a warp's rows
  extern __shared__ __align__(16) float smem[];
  float* dvp = smem;  // [L][NW][HD]
  float* rs = dvp + L * NW * HD;
  float* ks = rs + L * HD;
  float* vs = ks + L * HD;
  float* ws = vs + L * HD;
  float* ys = ws + L * HD;  // dy
  float* us = ys + L * HD;
  float* as = us + HD;
  float* bs = as + L;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int i = tid / RS, j0 = (tid % RS) * CW, lane = tid % WS, warp = tid / WS;
  const int c0 = c * L, n = min(L, T - c0);
  const long long row0 = ((long long)b * T + c0) * H + h;  // (b, c0, h) among B * T * H rows
  const long long chunk = ((long long)b * H + h) * gridDim.x + c;

  stage<HD, NT>(rs, r, row0, H, n, tid);
  stage<HD, NT>(ks, k, row0, H, n, tid);
  stage<HD, NT>(vs, v, row0, H, n, tid);
  stage<HD, NT>(ws, w, row0, H, n, tid);
  stage<HD, NT>(ys, dy, row0, H, n, tid);
  if (tid < HD) us[tid] = u[h * HD + tid];
  float Sc[CW], G[CW];
  const float* se = sx + chunk * HD * HD + i * HD + j0;
  const float* ge = gx + chunk * HD * HD + i * HD + j0;
#pragma unroll
  for (int jj = 0; jj < CW; jj += 4) {
    const float4 s4 = *reinterpret_cast<const float4*>(se + jj);
    const float4 g4 = *reinterpret_cast<const float4*>(ge + jj);
    Sc[jj] = s4.x, Sc[jj + 1] = s4.y, Sc[jj + 2] = s4.z, Sc[jj + 3] = s4.w;
    G[jj] = g4.x, G[jj + 1] = g4.y, G[jj + 2] = g4.z, G[jj + 3] = g4.w;
  }
  __syncthreads();
  for (int t = warp; t < n; t += NW) {  // the bonus scalars a_t and b_t, a warp a step
    float a = 0.0f, bb = 0.0f;
    for (int x = lane; x < HD; x += WS) {
      a = fmaf(rs[t * HD + x] * us[x], ks[t * HD + x], a);
      bb = fmaf(vs[t * HD + x], ys[t * HD + x], bb);
    }
#pragma unroll
    for (int m = 1; m < WS; m <<= 1) {
      a += __shfl_xor_sync(Lay::kMask, a, m);
      bb += __shfl_xor_sync(Lay::kMask, bb, m);
    }
    if (lane == 0) as[t] = a, bs[t] = bb;
  }
  __syncthreads();

  // the dv columns this lane holds after the reduce-scatter: at step st it
  // keeps the upper half of its block if bit st of its row in the warp is set
  int dv_col = j0;
#pragma unroll
  for (int st = 0; st < kSteps; ++st)
    if ((lane / RS >> st) & 1) dv_col += CW >> (st + 1);
  const float ui = us[i];
  float du = 0.0f;
  for (int t = n - 1; t >= 0; --t) {
    // S_{t-1}: the entry state stepped forward through steps 0 .. t - 1
    float S[CW];
#pragma unroll
    for (int jj = 0; jj < CW; ++jj) S[jj] = Sc[jj];
#pragma unroll 2
    for (int s = 0; s < t; ++s) {
      const float wi = ws[s * HD + i], ki = ks[s * HD + i];
#pragma unroll
      for (int jj = 0; jj < CW; jj += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(vs + s * HD + j0 + jj);
        S[jj] = fmaf(wi, S[jj], ki * v4.x);
        S[jj + 1] = fmaf(wi, S[jj + 1], ki * v4.y);
        S[jj + 2] = fmaf(wi, S[jj + 2], ki * v4.z);
        S[jj + 3] = fmaf(wi, S[jj + 3], ki * v4.w);
      }
    }
    const float ri = rs[t * HD + i], ki = ks[t * HD + i], wi = ws[t * HD + i], bt = bs[t];
    float pr = 0.0f, pk = 0.0f, pw = 0.0f;
    float kg[CW];
#pragma unroll
    for (int jj = 0; jj < CW; jj += 4) {
      const float4 d4 = *reinterpret_cast<const float4*>(ys + t * HD + j0 + jj);
      const float4 v4 = *reinterpret_cast<const float4*>(vs + t * HD + j0 + jj);
      const float dd[4] = {d4.x, d4.y, d4.z, d4.w}, vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pr = fmaf(S[jj + e], dd[e], pr);
        pk = fmaf(G[jj + e], vv[e], pk);
        pw = fmaf(G[jj + e], S[jj + e], pw);
        kg[jj + e] = ki * G[jj + e];
      }
    }
#pragma unroll
    for (int m = 1; m < RS; m <<= 1) {
      pr += __shfl_xor_sync(Lay::kMask, pr, m);
      pk += __shfl_xor_sync(Lay::kMask, pk, m);
      pw += __shfl_xor_sync(Lay::kMask, pw, m);
    }
    const long long off = (row0 + (long long)t * H) * HD;
    if (j0 == 0) {
      dr[off + i] = fmaf(ui * ki, bt, pr);
      dk[off + i] = fmaf(ui * ri, bt, pk);
      dw[off + i] = pw;
      du = fmaf(ri * ki, bt, du);
    }
    // dv: k_t[i] G_t[i][j] summed over the warp's rows by a reduce-scatter
    // (each step a lane sends the half of its columns it drops and adds
    // its partner's copy of the half it keeps), into the warp's slot of
    // step t; the warps' slots are summed after the loop
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int m = RS << st, half = CW >> (st + 1);
      const bool upper = (lane & m) != 0;
#pragma unroll
      for (int e = 0; e < half; ++e) {
        const float send = upper ? kg[e] : kg[e + half];
        const float keep = upper ? kg[e + half] : kg[e];
        kg[e] = keep + __shfl_xor_sync(Lay::kMask, send, m);
      }
    }
#pragma unroll
    for (int e = 0; e < Lay::CL; ++e) dvp[(t * NW + warp) * HD + dv_col + e] = kg[e];
    // G_{t-1}
#pragma unroll
    for (int jj = 0; jj < CW; jj += 4) {
      const float4 d4 = *reinterpret_cast<const float4*>(ys + t * HD + j0 + jj);
      G[jj] = fmaf(wi, G[jj], ri * d4.x);
      G[jj + 1] = fmaf(wi, G[jj + 1], ri * d4.y);
      G[jj + 2] = fmaf(wi, G[jj + 2], ri * d4.z);
      G[jj + 3] = fmaf(wi, G[jj + 3], ri * d4.w);
    }
  }
  if (j0 == 0) dup[chunk * HD + i] = du;
  __syncthreads();  // every warp's dv partials are in dvp
  for (int e = tid; e < n * HD; e += NT) {
    const int t = e / HD, j = e % HD;
    float sum = as[t] * ys[e];
#pragma unroll
    for (int q = 0; q < NW; ++q) sum += dvp[(t * NW + q) * HD + j];
    dv[(row0 + (long long)t * H) * HD + j] = sum;
  }
}

// dynamic shared memory above the default 48 KB where needed, and the
// largest shared memory carveout
template <typename K>
cudaError_t configure(K kernel, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int HD>
cudaError_t launch(const float* r, const float* k, const float* v, const float* w,
                   const float* u, const float* s0, const float* dy, const float* dsT,
                   float* dr, float* dk, float* dv, float* dw, float* dup, float* ds0,
                   float* sx, float* gx, float* pend, int B, int T, int H, int L,
                   cudaStream_t stream) {
  using Lay = Layout<HD>;
  // the shared memory opt-in of each kernel, raised to a chunk length's
  // needs the first time a launch needs more (off the per-call path)
  static size_t local_set = 0, grads_set = 0;
  cudaError_t e;
  if (local_smem<HD>(L) > local_set) {
    if ((e = configure(local<HD>, local_smem<HD>(L))) != cudaSuccess) return e;
    local_set = local_smem<HD>(L);
  }
  if (grads_smem<HD>(L) > grads_set) {
    if ((e = configure(grads<HD>, grads_smem<HD>(L))) != cudaSuccess) return e;
    grads_set = grads_smem<HD>(L);
  }
  const int NC = (T + L - 1) / L;
  if (NC > 0) {
    local<HD><<<dim3(NC, H, B), Lay::NT, local_smem<HD>(L), stream>>>(r, k, v, w, dy, sx, gx,
                                                                      pend, T, H, L);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  const long long n_elems = (long long)B * H * HD * HD;
  chunk_scan<HD><<<(unsigned)((n_elems + 255) / 256), 256, 0, stream>>>(s0, dsT, pend, sx, gx,
                                                                        ds0, n_elems, NC);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (NC > 0) {
    grads<HD><<<dim3(NC, H, B), Lay::NT, grads_smem<HD>(L), stream>>>(
        r, k, v, w, u, dy, sx, gx, dr, dk, dv, dw, dup, T, H, L);
    e = cudaGetLastError();
  }
  return e;
}

}  // namespace

// hd in {16, 32, 64, 128}, 1 <= chunk <= kMaxChunk; all pointers contiguous
// fp32, 16-byte aligned; dup holds B * H * ceil(T / chunk) * hd floats, sx
// and gx B * H * ceil(T / chunk) * hd^2 each, pend B * H * ceil(T / chunk) *
// hd.
extern "C" int rwkv6_scan_bwd(const float* r, const float* k, const float* v, const float* w,
                              const float* u, const float* s0, const float* dy,
                              const float* dsT, float* dr, float* dk, float* dv, float* dw,
                              float* dup, float* ds0, float* sx, float* gx, float* pend,
                              int B, int T, int H, int hd, int chunk, cudaStream_t stream) {
  if (chunk < 1 || chunk > kMaxChunk || T < 0) return (int)cudaErrorInvalidValue;
  if (B * H == 0) return (int)cudaGetLastError();
  cudaError_t e;
#define RWKV6_BWD(HD)                                                                   \
  launch<HD>(r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dw, dup, ds0, sx, gx, pend, B, T, H, \
             chunk, stream)
  switch (hd) {
    case 16: e = RWKV6_BWD(16); break;
    case 32: e = RWKV6_BWD(32); break;
    case 64: e = RWKV6_BWD(64); break;
    case 128: e = RWKV6_BWD(128); break;
    default: e = cudaErrorInvalidValue;
  }
#undef RWKV6_BWD
  return (int)e;
}
