// RWKV6 ("Finch") time-mix recurrence, forward only, for Hopper (sm_90a):
// the chunked state-passing scan that long sequences (prefill) run.
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py:_kernel (launched by
// rwkv6_scan, the Pallas call over a (batch, head, time chunk) grid with the
// time axis sequential and the state in VMEM scratch). Short sequences
// (decode) run csrc/rwkv6_scan.cu; the wrapper's _variant(T) picks.
//
// Per batch b and head h, with the hd x hd state S (fp32) starting at s0:
//   y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]
// r, k, v, w (B, T, H, hd), u (H, hd), s0 (B, H, hd, hd), all fp32; y
// (B, T, H, hd) and the final state sT (B, H, hd, hd), fp32. Any T.
//
// What bounds it on an H100: the function's own work is 5 hd^2 + 5 hd
// fp32 flops per token and head (an FMA counted as two: per element of S,
// one FMA for y and a multiply and an FMA for the state; the bonus term
// r_t . (u * k_t) v_t is O(hd)) against 20 hd bytes of r, k, v, w and y,
// some 16 flops a byte at hd = 64, under the card's fp32 ridge (67 TFLOP/s
// over 3.35 TB/s = 20): bytes. The sequential kernel cannot reach it,
// because each (b, h) pair's steps form one chain and B * H blocks (32 at
// rwkv6-1.6b's prefill) leave most SMs idle. The design below adds its own
// traffic: y_local, dS, the entry states and r_t * P_t are each written and
// read back once, about 1.5 times the function's bytes.
//
// What the design does about it: the recurrence is linear in S, so the
// time axis splits into chunks of L steps, each run from a zero state, and
// the chunks are joined afterwards. Three kernels, each parallel over
// (b, h, chunk) or over S's elements, B * H * ceil(T / L) blocks (512 at
// the prefill shape with L = 64):
//
// 1. local_pass, one block of hd threads per (chunk, h, b): cp.async
//    stages r, k, w and v 16 steps at a time into a two-slot ring (2 x 4 x
//    16 hd floats of dynamic shared memory, so that every block of the
//    prefill shape is resident at once), the next slot loading while the
//    block works on the current one. Per 16 steps, thread i first writes
//    r_t[i] P_t[i], with P_t = prod_{c0 <= i' < t} w_i' the decay since the
//    chunk began (plain fp32 products, no log or exp, so w = 0 or 1e-30
//    stays finite), and some threads the bonus scalars a_t = sum_i r_t[i]
//    u[i] k_t[i]. Then the recurrence from S = 0: each thread keeps a tile
//    of hd/4 rows by 4 columns of S in registers (each row's r, k and w
//    loaded once from shared memory for 4 columns), its y chains are hd/8
//    long, and the 4 lanes of a column quad meet by two shuffles. It writes
//    y_local_t = r_t S_local + a_t v_t into y, and the chunk's end state
//    dS_c and full decay product P_end,c into scratch. Three barriers per
//    16 steps.
// 2. chunk_scan, one thread per element of S: S_entry[c] = S, then
//    S <- diag(P_end,c) S + dS_c, from s0 over the chunks; the entry states
//    overwrite dS in place (each element is read before it is written),
//    the last S is sT. Phases 2 and 3 are not fused: phase 3 would need
//    every earlier chunk's dS.
// 3. correct, one block of 256 threads per (chunk, h, b): y_t += (r_t *
//    P_t) S_entry[c], an (L x hd) by (hd x hd) product from shared memory
//    in fp32 FMAs, 4 x 4 outputs per thread, each thread's y_local loaded
//    before the product. Not on TF32 tensor cores: their 10-bit mantissa
//    would miss the 3e-5 bound at |y| about 2.6; a 3xTF32 split is left for
//    later.
//
// Scratch from the caller, fp32: st (B, H, ceil(T / L), hd, hd), rp (B, T,
// H, hd) and pend (B, H, ceil(T / L), hd). r, k, v, w, st and rp must be
// 16-byte aligned. L is at most kMaxChunk. Each kernel's attributes are set
// once per head dim: the dynamic shared memory opt-in (the correction's
// for the longest chunk) and the largest shared memory carveout, so the SMs
// keep one L1 / shared split between them.
#include <cuda_runtime.h>

namespace {

constexpr int kRowGroups = 4;  // lanes that share one column quad's rows
constexpr int kCols = 4;       // columns of S per thread in the local pass
constexpr int kSub = 16;       // steps per stage of the local pass's cp.async ring
constexpr int kTile = 4;       // the correction's outputs per thread: kTile x kTile
constexpr int kCorrThreads = 256;
constexpr int kMaxChunk = 128;  // the longest chunk the entry takes

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n steps of one (b, h) row of a (B, T, H, HD) array into dst[n][HD]; row0
// is the index of (b, first step, h) in the (B * T * H) rows.
template <int HD>
__device__ __forceinline__ void stage(float* dst, const float* src, long long row0, int H,
                                      int n, int tid, int nt) {
  constexpr int kSeg = HD / 4;
  for (int s = tid; s < n * kSeg; s += nt) {
    const int t = s / kSeg, q = s % kSeg;
    cp_async16(dst + t * HD + 4 * q, src + (row0 + (long long)t * H) * HD + 4 * q);
  }
}

template <int HD>
__global__ void __launch_bounds__(HD)
local_pass(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ y, float* __restrict__ st,
           float* __restrict__ rp, float* __restrict__ pend, int T, int H, int L) {
  constexpr int NT = HD, RQ = HD / (4 * kRowGroups);  // float4s of rows per thread
  constexpr unsigned kMask = NT >= 32 ? 0xffffffffu : (1u << NT) - 1u;
  constexpr int kStage = 4 * kSub * HD;  // r, k, w, v of kSub steps
  extern __shared__ __align__(16) float smem[];
  float* us = smem + 2 * kStage;  // [HD]
  float* as = us + HD;            // [kSub]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int c0 = c * L, n = min(L, T - c0);
  const long long row0 = ((long long)b * T + c0) * H + h;
  us[tid] = u[h * HD + tid];

  auto stage_steps = [&](int t0) {  // steps t0.. of the chunk into ring slot (t0 / kSub) % 2
    float* buf = smem + ((t0 / kSub) & 1) * kStage;
    const long long rowt = row0 + (long long)t0 * H;
    const int m = min(kSub, n - t0);
    stage<HD>(buf, r, rowt, H, m, tid, NT);
    stage<HD>(buf + kSub * HD, k, rowt, H, m, tid, NT);
    stage<HD>(buf + 2 * kSub * HD, w, rowt, H, m, tid, NT);
    stage<HD>(buf + 3 * kSub * HD, v, rowt, H, m, tid, NT);
  };

  // thread (jq, g): columns j0..j0 + 3 and rows 16 q + 4 g + e (q < RQ,
  // e < 4), so the 4 lanes of a column quad read 64 contiguous bytes
  const int g = tid % kRowGroups, j0 = (tid / kRowGroups) * kCols;
  float S[RQ][4][kCols];
#pragma unroll
  for (int q = 0; q < RQ; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) S[q][e][jj] = 0.0f;
  float p = 1.0f;  // the decay product of row tid since the chunk began

  stage_steps(0);
  cp_async_commit();
  for (int t0 = 0; t0 < n; t0 += kSub) {
    const int m = min(kSub, n - t0);
    const long long rowt = row0 + (long long)t0 * H;
    const float* rs = smem + ((t0 / kSub) & 1) * kStage;
    const float* ks = rs + kSub * HD;
    const float* ws = ks + kSub * HD;
    const float* vs = ws + kSub * HD;
    __syncthreads();  // the previous steps are consumed: their slot and as are free
    if (t0 + kSub < n) stage_steps(t0 + kSub);
    cp_async_commit();
    cp_async_wait<1>();  // this stage's copies have landed
    __syncthreads();

    // r_t[i] P_t[i] for row i = tid, and the bonus scalars a_t = sum_i
    // r_t[i] u[i] k_t[i] (rows read rotated by t, so lanes hit other banks)
#pragma unroll 4
    for (int t = 0; t < m; ++t) {
      rp[(rowt + (long long)t * H) * HD + tid] = rs[t * HD + tid] * p;
      p *= ws[t * HD + tid];
    }
    for (int t = tid; t < m; t += NT) {
      float a = 0.0f;
#pragma unroll 8
      for (int mm = 0; mm < HD; ++mm) {
        const int i = (mm + t) & (HD - 1);
        a = fmaf(rs[t * HD + i] * us[i], ks[t * HD + i], a);
      }
      as[t] = a;
    }
    __syncthreads();

    for (int t = 0; t < m; ++t) {
      const float4 v4 = *reinterpret_cast<const float4*>(vs + t * HD + j0);
      const float vv[kCols] = {v4.x, v4.y, v4.z, v4.w};
      float ya[kCols], yb[kCols];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) ya[jj] = yb[jj] = 0.0f;
#pragma unroll
      for (int q = 0; q < RQ; ++q) {
        const int i = 16 * q + 4 * g;
        const float4 r4 = *reinterpret_cast<const float4*>(rs + t * HD + i);
        const float4 k4 = *reinterpret_cast<const float4*>(ks + t * HD + i);
        const float4 w4 = *reinterpret_cast<const float4*>(ws + t * HD + i);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int jj = 0; jj < kCols; ++jj) {
            if (e & 1)  // two y chains per column, odd and even rows
              yb[jj] = fmaf(rr[e], S[q][e][jj], yb[jj]);
            else
              ya[jj] = fmaf(rr[e], S[q][e][jj], ya[jj]);
            S[q][e][jj] = fmaf(ww[e], S[q][e][jj], kk[e] * vv[jj]);
          }
      }
      float yo[kCols];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        yo[jj] = ya[jj] + yb[jj];
#pragma unroll
        for (int mm = 1; mm < kRowGroups; mm <<= 1)
          yo[jj] += __shfl_xor_sync(kMask, yo[jj], mm);
      }
      if (g == 0) {
        const float a = as[t];
        *reinterpret_cast<float4*>(y + (rowt + (long long)t * H) * HD + j0) =
            make_float4(fmaf(a, vv[0], yo[0]), fmaf(a, vv[1], yo[1]), fmaf(a, vv[2], yo[2]),
                        fmaf(a, vv[3], yo[3]));
      }
    }
  }

  const long long chunk = ((long long)b * H + h) * gridDim.x + c;
  pend[chunk * HD + tid] = p;
  float* dst = st + chunk * HD * HD;
#pragma unroll
  for (int q = 0; q < RQ; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<float4*>(dst + (16 * q + 4 * g + e) * HD + j0) =
          make_float4(S[q][e][0], S[q][e][1], S[q][e][2], S[q][e][3]);
}

template <int HD>
__global__ void __launch_bounds__(256)
chunk_scan(const float* __restrict__ s0, const float* __restrict__ pend,
           float* __restrict__ st, float* __restrict__ sT, long long n_elems, int NC) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_elems) return;
  const long long bh = e / (HD * HD);
  const int ij = (int)(e % (HD * HD)), i = ij / HD;
  float S = s0[e];
  float* p = st + bh * NC * HD * HD + ij;
  const float* pe = pend + bh * NC * HD + i;
#pragma unroll 4
  for (int c = 0; c < NC; ++c) {
    const float d = p[(long long)c * HD * HD];
    const float P = pe[c * HD];
    p[(long long)c * HD * HD] = S;
    S = fmaf(P, S, d);
  }
  sT[e] = S;
}

template <int HD>
__global__ void __launch_bounds__(kCorrThreads)
correct(const float* __restrict__ rp, const float* __restrict__ st, float* __restrict__ y,
        int T, int H, int L) {
  extern __shared__ __align__(16) float smem[];
  const int L8 = (L + 7) & ~7, LP = L8 + 4;  // steps rounded up to the staging's 8
  float* Ss = smem;          // [HD][HD], the chunk's entry state
  float* qT = Ss + HD * HD;  // [HD][LP], (r_t * P_t)[i] at qT[i][t]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int c0 = c * L, n = min(L, T - c0);
  const long long row0 = ((long long)b * T + c0) * H + h;

  const float* src = st + (((long long)b * H + h) * gridDim.x + c) * HD * HD;
  for (int s = tid; s < HD * HD / 4; s += kCorrThreads) cp_async16(Ss + 4 * s, src + 4 * s);
  cp_async_commit();
  // r_t * P_t transposed: a warp reads 8 steps x 4 float4s of i (64
  // contiguous bytes a step) and writes 8 consecutive t per row of qT
  constexpr int I4 = HD / 4;
  for (int e = tid; e < L8 * I4; e += kCorrThreads) {
    const int t = e % 8 + 8 * (e / (8 * I4)), i = 4 * ((e / 8) % I4);
    float4 q4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (t < n) q4 = *reinterpret_cast<const float4*>(rp + (row0 + (long long)t * H) * HD + i);
    qT[i * LP + t] = q4.x;
    qT[(i + 1) * LP + t] = q4.y;
    qT[(i + 2) * LP + t] = q4.z;
    qT[(i + 3) * LP + t] = q4.w;
  }
  cp_async_wait<0>();
  __syncthreads();

  constexpr int JG = HD / kTile;
  const int tiles = JG * (L8 / kTile);
  for (int tile = tid; tile < tiles; tile += kCorrThreads) {
    const int j0 = (tile % JG) * kTile, t0 = (tile / JG) * kTile;
    if (t0 >= n) continue;
    // y_local of the tile, loaded before the product so that its latency
    // overlaps the FMAs
    float4 yl[kTile];
#pragma unroll
    for (int a = 0; a < kTile; ++a)
      if (t0 + a < n)
        yl[a] = *reinterpret_cast<const float4*>(y + (row0 + (long long)(t0 + a) * H) * HD + j0);
    float acc[kTile][kTile];
#pragma unroll
    for (int a = 0; a < kTile; ++a)
#pragma unroll
      for (int bb = 0; bb < kTile; ++bb) acc[a][bb] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < HD; ++i) {
      float qq[kTile], ss[kTile];
#pragma unroll
      for (int x = 0; x < kTile; x += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(qT + i * LP + t0 + x);
        const float4 s4 = *reinterpret_cast<const float4*>(Ss + i * HD + j0 + x);
        qq[x] = q4.x, qq[x + 1] = q4.y, qq[x + 2] = q4.z, qq[x + 3] = q4.w;
        ss[x] = s4.x, ss[x + 1] = s4.y, ss[x + 2] = s4.z, ss[x + 3] = s4.w;
      }
#pragma unroll
      for (int a = 0; a < kTile; ++a)
#pragma unroll
        for (int bb = 0; bb < kTile; ++bb) acc[a][bb] = fmaf(qq[a], ss[bb], acc[a][bb]);
    }
#pragma unroll
    for (int a = 0; a < kTile; ++a)
      if (t0 + a < n)
        *reinterpret_cast<float4*>(y + (row0 + (long long)(t0 + a) * H) * HD + j0) =
            make_float4(yl[a].x + acc[a][0], yl[a].y + acc[a][1], yl[a].z + acc[a][2],
                        yl[a].w + acc[a][3]);
  }
}

// the correction's shared memory: the entry state and the chunk's r_t * P_t
// transposed, its steps rounded up to the staging's 8
template <int HD>
size_t correct_smem(int L) {
  return ((size_t)HD * HD + (size_t)HD * (((L + 7) & ~7) + 4)) * sizeof(float);
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
                   const float* u, const float* s0, float* y, float* sT, float* st,
                   float* rp, float* pend, int B, int T, int H, int L, cudaStream_t stream) {
  const int NC = (T + L - 1) / L;
  const size_t smem1 = ((size_t)2 * 4 * kSub * HD + HD + kSub) * sizeof(float);
  static bool attrs_set = false;  // once per instance, off the per-call path
  if (!attrs_set) {
    cudaError_t e;
    if ((e = configure(local_pass<HD>, smem1)) != cudaSuccess ||
        (e = configure(chunk_scan<HD>, 0)) != cudaSuccess ||
        (e = configure(correct<HD>, correct_smem<HD>(kMaxChunk))) != cudaSuccess)
      return e;
    attrs_set = true;
  }
  cudaError_t e;
  if (NC > 0) {
    local_pass<HD><<<dim3(NC, H, B), HD, smem1, stream>>>(r, k, v, w, u, y, st, rp, pend,
                                                               T, H, L);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  const long long n_elems = (long long)B * H * HD * HD;
  chunk_scan<HD><<<(unsigned)((n_elems + 255) / 256), 256, 0, stream>>>(s0, pend, st, sT,
                                                                        n_elems, NC);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (NC > 0) {
    correct<HD><<<dim3(NC, H, B), kCorrThreads, correct_smem<HD>(L), stream>>>(rp, st, y, T,
                                                                              H, L);
    e = cudaGetLastError();
  }
  return e;
}

}  // namespace

// hd in {16, 32, 64, 128}, 1 <= chunk <= kMaxChunk; all pointers
// contiguous fp32, 16-byte aligned; st holds B * H * ceil(T / chunk) * hd^2
// floats, rp B * T * H * hd, pend B * H * ceil(T / chunk) * hd.
extern "C" int rwkv6_scan_chunked(const float* r, const float* k, const float* v,
                                  const float* w, const float* u, const float* s0, float* y,
                                  float* sT, float* st, float* rp, float* pend, int B, int T,
                                  int H, int hd, int chunk, cudaStream_t stream) {
  if (chunk < 1 || chunk > kMaxChunk || T < 0) return (int)cudaErrorInvalidValue;
  if (B * H == 0) return (int)cudaGetLastError();
  cudaError_t e;
  switch (hd) {
    case 16: e = launch<16>(r, k, v, w, u, s0, y, sT, st, rp, pend, B, T, H, chunk, stream); break;
    case 32: e = launch<32>(r, k, v, w, u, s0, y, sT, st, rp, pend, B, T, H, chunk, stream); break;
    case 64: e = launch<64>(r, k, v, w, u, s0, y, sT, st, rp, pend, B, T, H, chunk, stream); break;
    case 128: e = launch<128>(r, k, v, w, u, s0, y, sT, st, rp, pend, B, T, H, chunk, stream); break;
    default: e = cudaErrorInvalidValue;
  }
  return (int)e;
}
