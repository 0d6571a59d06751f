// RWKV6 ("Finch") time-mix recurrence, backward, for Hopper (sm_90a): the
// gradient that training runs through, in its chunked matrix form with the
// products on the tensor cores as 3xTF32.
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
// sums per chunk dup (B, H, ceil(T / C), hd), which the wrapper sums over B
// and the chunks. Any T.
//
// The matrix form (kernels/ref.py:rwkv6_scan_grad_chunked_ref is the same
// algorithm in torch). Within a run of steps t = 0 .. n - 1 with entry
// state S0 and exit cotangent GL (the cotangent of its last state), Pin_t
// = prod_{tau < t} w_tau, Qout_t = prod_{tau > t} w_tau and D_{s,t} =
// prod_{s < tau < t} w_tau, each a running product:
//   S_{t-1} = diag(Pin_t) S0 + sum_{s<t} diag(D_{s,t}) k_s v_s^T,
//   G_t = diag(Qout_t) GL + sum_{s>t} diag(D_{t,s}) r_s dy_s^T,
// so every hd x hd product is a GEMM over the run: dS = (K * Qout)^T V and
// dG = (R * Pin)^T DY (the run's state and cotangent contributions), X =
// DY S0^T, Y = V GL^T, Zv = (K * Qout) GL and M1 = DY V^T (L x L). What is
// left is decayed, O(L hd) a token: with Gv (rows G v_s, from Y) and Xg
// (rowsum(S0 * G), from rowsum(S0 * GL)) taken at G_t, steps in reverse,
//   dr_t = Pin_t * X_t + sum_{s<t} D_{s,t} * k_s M1[t,s] + u * k_t b_t,
//   dk_t = Gv[t] + u * r_t b_t,
//   dw_t = Pin_t * Xg + sum_{s<t} D_{s,t} * k_s * Gv[s],
//   A[t,s] = sum_i r_t[i] D_{s,t}[i] k_s[i] (A[t,t] = a_t),
//   then Gv[s] <- w_t * Gv[s] + r_t M1[t,s], Xg <- w_t * Xg + r_t * X_t,
// and dv = Zv + A^T DY, a GEMM again (b_t is M1[t,t]). Nothing divides by w
// or by a product of w, and nothing takes a log or exp of either: the
// identity w * dw = reverse cumsum of r * dr - k * dk, or D_{s,t} as a
// ratio of Pin's, would lose dw where w is 1e-30 or 0. Decays of 0, 1e-30
// and 1 give finite, exact gradients.
//
// What bounds it on an H100. The function reads r, k, v, w and dy and
// writes dr, dk, dv and dw, 36 hd bytes a token and head (0.045 ms at
// (2, 1024, 32, 64)). On the fp32 cores its work would be 14 hd^2 flops a
// token and head (0.057 ms at 67 TFLOP/s). This design moves the hd^2 part
// to the tensor cores: with chunks of C steps and sub-chunks of L (NQ =
// C / L), (10 + (NQ - 1) + 2 (NQ - 1) / NQ) hd^2 + 4 L hd GEMM flops a
// token and head, three times over as 3xTF32, at TF32's 495 TFLOP/s (0.025
// ms at C = 64, L = 16), and about (3.5 L + 12) hd fp32 flops of decayed
// parts at 67 (0.004 ms). Its chunk scratch (two hd x hd matrices a chunk,
// written by kernel 1, read and rewritten by kernel 2, read by kernel 3)
// adds 8 hd^2 * 4 bytes a chunk: 0.040 ms at C = 64. So bytes bound it, at
// about 0.085 ms.
//
// Why 3xTF32: fp32 reaches the tensor cores only as TF32, whose 10-bit
// mantissa loses the gradient's digits: with the GEMM operands rounded once
// to TF32, the plain form missed the 1e-4 of max|g| rule on dr, dk, dv, dw
// and ds0 at (1, 128, 2, 64) (3.3e-4 to 4.1e-4 of max|g|). Each operand x
// is split into hi = tf32(x) and lo = x - hi, and lo hi + hi lo + hi hi is
// accumulated in fp32, the small terms in an accumulator of their own
// (csrc/flash_attention.cu's split; see split below for lo's rounding); the
// dropped lo lo is about 2^-22 of the product.
//
// Why mma.sync and not wgmma: tf32 wgmma takes both shared-memory operands
// K-major only, and the products here contract over every axis in turn (the
// steps for dS and dG, the head dim for X, Y, Zv and M1), so several
// operands would need a transposed copy, and the lo halves would have to be
// staged beside the hi halves in shared memory, which a chunk's inputs
// already fill (csrc/flash_attention.cu explains the same for attention).
// mma.sync m16n8k8 reads its fragments from registers, so each thread
// splits what it loads, from any layout. wgmma stays a later lever.
//
// The design: three kernels behind one C entry.
// 1. local, one block per (chunk of C steps, h, b): the chunk's r, k, v, w
//    and dy staged in shared memory by cp.async (rows past T zero and w = 1
//    there, so they add nothing), R scaled by Pin and K by Qout in place
//    (one thread a column, running products through registers), then dS_c
//    and dG_c on the tensor cores, written to scratch with P_end.
// 2. chunk_scan, one thread per element of S: the entry state of each
//    chunk, S <- diag(P_end,c) S + dS_c from s0, and the cotangent at each
//    chunk's last step, G <- diag(P_end,c) G + dG_c from dsT over the chunks
//    in reverse, each overwriting its chunk's dS_c / dG_c in place; the last
//    G is ds0.
// 3. grads, one block of 256 threads per (chunk, h, b), the chunk's inputs
//    and exit cotangent staged by cp.async, its sub-chunks of L steps in
//    reverse, two barriers each:
//    A. G of the sub-chunk's last step stored from registers; its R * Pin,
//       K * Qout and P_end (running products); its entry state S0_q =
//       diag(Pin_b) S_entry + (K * D_{.,b})^T V over the chunk's earlier
//       steps, a GEMM from the chunk's entry state (held in registers, read
//       once), so that no state of a sub-chunk is stored;
//    B. X, Y, Zv and M1 (GEMMs, each on its own warps), rowsum(S0_q * G)
//       (four lanes a row), the previous sub-chunk's G = diag(P_end) G +
//       (R * Pin)^T DY into registers, and the decays K * D to the previous
//       sub-chunk's first step.
//    Then the decayed parts of every sub-chunk at once, one thread per
//    (sub-chunk, column i), its k, w and Gv in registers and M1 read as
//    broadcasts; A's sums over i are reduce-scattered over the warp (about
//    one shuffle a value, each step's t + 1 values padded to a power of two)
//    and the warps' partials added in shared memory. Last dv = Zv + A^T DY,
//    a GEMM per sub-chunk. The entry states and exit cotangents stay at the
//    coarse chunk, so the scratch is C / L times smaller than at the
//    sub-chunk.
//
// Every GEMM is tile_mma: warp tiles of 16 x 8 NB outputs, m16n8k8 steps
// reading each operand element from shared (or global) memory at constant
// strides, the A fragment split once for NB B fragments.
//
// Scratch from the caller, fp32: sx and gx (B, H, ceil(T / C), hd, hd),
// pend (B, H, ceil(T / C), hd). r, k, v, w, dy and the outputs must be
// 16-byte aligned. L is kSubChunk = 16 and divides C; C is at most kMaxChunk,
// and at hd = 128 it is L (one sub-chunk a chunk: nothing longer fits
// shared memory); shared memory bounds C at each hd (rwkv6_scan_bwd_smem
// gives the need; the launch fails where it passes the card's 227 KB).
// The sub-chunk length is fixed at 16: on an H100, sub-chunks of 32 were
// 2.3x slower at chunks of 32 and did not fit shared memory at 64 (the
// decayed parts and A grow with L).
#include <cuda_runtime.h>

#include <cstdint>

#include "kernel_attrs.cuh"

namespace {

constexpr int kMaxChunk = 128;  // the longest chunk the entry takes
constexpr int kSubChunk = 16;   // L, steps a sub-chunk of kernel 3
constexpr int kThreads = 256;   // threads a block of kernels 1 and 3

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero): add half of the 13 dropped bits' range and clear them
// (csrc/flash_attention.cu:tf32_rna).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo with hi = tf32(x); lo = x - hi is exact in fp32, and goes to
// the tensor core as it is: it reads lo's top 19 bits, so the dropped tail
// is under 2^-10 of lo, 2^-21 of x (csrc/flash_attention.cu rounds lo too,
// two instructions more a value, for its tighter 3e-5 bound).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d (16 x 8 fp32) += a (16 x 8 tf32, row) * b (8 x 8 tf32, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's tile of C = A B, 16 x 8 NB outputs from row m0 and column n0:
// acc[nb][e] = init(m, n) + sum_k A(m, k) B(k, n) as 3xTF32, with A(m, k) =
// a[m * AM + k * AK] and B(k, n) = b[k * BK + n * BN] (shared or global
// memory; the strides are constants, so each load's offset is too); K is a
// multiple of 8. The fragments of m16n8k8: lane (g, t4) = (lane / 4, lane %
// 4) holds A at rows g, g + 8 and columns t4, t4 + 4, B at rows t4, t4 + 4
// and column g, C at rows g, g + 8 and columns 2 t4, 2 t4 + 1 (tile_row,
// tile_col). Each A fragment is split once for NB B fragments. The small
// terms (lo hi + hi lo) build up in an accumulator of their own, added
// last: two chains a tile instead of one.
__device__ __forceinline__ int tile_row(int lane, int e) { return (lane >> 2) + 8 * (e >> 1); }
__device__ __forceinline__ int tile_col(int lane, int e) { return 2 * (lane & 3) + (e & 1); }

template <int NB, int AM, int AK, int BK, int BN, typename Init>
__device__ __forceinline__ void tile_mma(float (&acc)[NB][4], int m0, int n0, int K,
                                         const float* a, const float* b, Init init) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  float small[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[nb][e] = init(m0 + tile_row(lane, e), n0 + 8 * nb + tile_col(lane, e));
      small[nb][e] = 0.0f;
    }
  // where both operands step through k with a row stride, k-slots t4 and
  // t4 + 4 read rows 2 t4 and 2 t4 + 1 (in A and B alike, so the sum is the
  // same): with a stride of 4 mod 32 words, the lanes' rows then fall on 32
  // banks instead of 16
  constexpr bool kPerm = AK != 1 && BK != 1;
  constexpr int kHi = kPerm ? 1 : 4;  // k offset of the second k-slot
  const int kt = kPerm ? 2 * t4 : t4;
  const float* a0 = a + (m0 + g) * AM + kt * AK;
  const float* b0 = b + (n0 + g) * BN + kt * BK;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[4], al[4];
    split(a0[0], ah[0], al[0]);
    split(a0[8 * AM], ah[1], al[1]);
    split(a0[kHi * AK], ah[2], al[2]);
    split(a0[8 * AM + kHi * AK], ah[3], al[3]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      uint32_t bh0, bl0, bh1, bl1;
      split(b0[8 * nb * BN], bh0, bl0);
      split(b0[8 * nb * BN + kHi * BK], bh1, bl1);
      mma(small[nb], al, bh0, bh1);
      mma(small[nb], ah, bl0, bl1);
      mma(acc[nb], ah, bh0, bh1);
    }
    a0 += 8 * AK;
    b0 += 8 * BK;
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] += small[nb][e];
}

// C (M x N) = init + A B over the block's warps, in warp tiles of 16 x 8 NB
// (tile_mma), each output to store(m, n, value). M is a multiple of 16, N
// of 8 NB. Tile 0 goes to warp ``first``, so that several products in one
// phase spread over the warps.
template <int NB, int AM, int AK, int BK, int BN, typename Init, typename Store>
__device__ __forceinline__ void block_gemm(int M, int N, int K, const float* a, const float* b,
                                           Init init, Store store, int first = 0) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int warp = ((threadIdx.x >> 5) + nw - first % nw) % nw;
  const int tn = N / (8 * NB), tiles = (M / 16) * tn;
  for (int tile = warp; tile < tiles; tile += nw) {
    const int m0 = (tile / tn) * 16, n0 = (tile % tn) * 8 * NB;
    float acc[NB][4];
    tile_mma<NB, AM, AK, BK, BN>(acc, m0, n0, K, a, b, init);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(m0 + tile_row(lane, e), n0 + 8 * nb + tile_col(lane, e), acc[nb][e]);
  }
}

// 16 bytes from global to shared memory, asynchronously
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// rows steps of one (b, h) row of a (B, T, H, HD) array into dst[rows][HD +
// 4] by 16-byte cp.async copies, all in flight at once; steps at or past n
// are set to fill. row0 is the index of (b, first step, h) among the B * T
// * H rows. The caller waits (cp_async_wait_all) and syncs.
template <int HD>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, long long row0,
                                      int H, int n, int rows, float fill) {
  for (int e = threadIdx.x; e < rows * HD / 4; e += blockDim.x) {
    const int t = e / (HD / 4), q = e % (HD / 4);
    float* d = dst + t * (HD + 4) + 4 * q;
    if (t < n)
      cp_async16(d, src + (row0 + (long long)t * H) * HD + 4 * q);
    else
      *reinterpret_cast<float4*>(d) = make_float4(fill, fill, fill, fill);
  }
}

// kernel 1's dynamic shared memory: r, k, v, w, dy [C][HD + 4] each
template <int HD>
size_t local_smem(int C) {
  return (size_t)5 * C * (HD + 4) * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
local(const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
      const float* __restrict__ w, const float* __restrict__ dy, float* __restrict__ sx,
      float* __restrict__ gx, float* __restrict__ pend, int T, int H, int C) {
  constexpr int SP = HD + 4;
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;
  float* ks = rs + C * SP;
  float* vs = ks + C * SP;
  float* ws = vs + C * SP;
  float* ys = ws + C * SP;  // dy
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int c0 = c * C, n = min(C, T - c0), n8 = (n + 7) & ~7;
  const long long row0 = ((long long)b * T + c0) * H + h;
  stage<HD>(rs, r, row0, H, n, C, 0.0f);
  stage<HD>(ks, k, row0, H, n, C, 0.0f);
  stage<HD>(vs, v, row0, H, n, C, 0.0f);
  stage<HD>(ws, w, row0, H, n, C, 1.0f);
  stage<HD>(ys, dy, row0, H, n, C, 0.0f);
  cp_async_wait_all();
  __syncthreads();
  const long long chunk = ((long long)b * H + h) * gridDim.x + c;
  // R * Pin (a thread a column, forward) and K * Qout (backward), in place,
  // 8 rows at a time through registers (rows past n hold w = 1 and 0)
  for (int job = tid; job < 2 * HD; job += blockDim.x) {
    const int i = job % HD;
    float p = 1.0f, xv[8], wv[8];
    if (job < HD) {
      for (int t0 = 0; t0 < n8; t0 += 8) {
#pragma unroll
        for (int e = 0; e < 8; ++e) xv[e] = rs[(t0 + e) * SP + i], wv[e] = ws[(t0 + e) * SP + i];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          rs[(t0 + e) * SP + i] = xv[e] * p;
          p *= wv[e];
        }
      }
      pend[chunk * HD + i] = p;
    } else {
      for (int t0 = n8 - 8; t0 >= 0; t0 -= 8) {
#pragma unroll
        for (int e = 0; e < 8; ++e) xv[e] = ks[(t0 + e) * SP + i], wv[e] = ws[(t0 + e) * SP + i];
#pragma unroll
        for (int e = 7; e >= 0; --e) {
          ks[(t0 + e) * SP + i] = xv[e] * p;
          p *= wv[e];
        }
      }
    }
  }
  __syncthreads();
  float* ds = sx + chunk * HD * HD;
  float* dg = gx + chunk * HD * HD;
  const auto zero = [](int, int) { return 0.0f; };
  // dS_c[i][j] = sum_t (k_t Qout_t)[i] v_t[j],  dG_c[i][j] = sum_t (r_t Pin_t)[i] dy_t[j]
  constexpr int NB = HD >= 32 ? 4 : 2;
  block_gemm<NB, 1, SP, SP, 1>(HD, HD, n8, ks, vs, zero,
                               [&](int i, int j, float x) { ds[i * HD + j] = x; });
  block_gemm<NB, 1, SP, SP, 1>(HD, HD, n8, rs, ys, zero,
                               [&](int i, int j, float x) { dg[i * HD + j] = x; }, 4);
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

// Sums of N values over the GS lanes of a group (the lanes sharing every
// lane bit from GS up), scattered: each level (lane mask M, from GS / 2
// down) halves the NV values a lane holds, sending the half it drops to its
// partner and adding the partner's copy of the half it keeps; once one
// value is left the remaining levels add it whole. Lane l then holds the
// sums for indices base .. base + N / GS - 1 (one index when N <= GS);
// lanes with a non-zero bit among the last, whole levels hold copies, and
// only the first writes dst[index]. A recursion over the levels, so that
// every index is a constant and v stays in registers.
template <int NV, int M, int N>
__device__ __forceinline__ void reduce_level(float (&v)[N], int lane, unsigned mask, int& base) {
  if constexpr (M >= 1) {
    if constexpr (NV > 1) {
      constexpr int half = NV / 2;
      const bool upper = (lane & M) != 0;
#pragma unroll
      for (int e = 0; e < half; ++e) {
        const float lo = v[e], hi = v[e + half];
        v[e] = (upper ? hi : lo) + __shfl_xor_sync(mask, upper ? lo : hi, M);
      }
      if (upper) base += half;
      reduce_level<half, M / 2, N>(v, lane, mask, base);
    } else {
      v[0] += __shfl_xor_sync(mask, v[0], M);
      reduce_level<1, M / 2, N>(v, lane, mask, base);
    }
  }
}

template <int N, int GS>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], float* dst, int lane,
                                               unsigned mask) {
  constexpr int kLeft = N > GS ? N / GS : 1;     // values a lane holds at the end
  constexpr int kCopies = N >= GS ? 1 : GS / N;  // lanes holding each sum
  int base = 0;
  reduce_level<N, GS / 2, N>(v, lane, mask, base);
  if ((lane & (kCopies - 1)) == 0) {
#pragma unroll
    for (int e = 0; e < kLeft; ++e) dst[base + e] = v[e];
  }
}

// kernel 3's dynamic shared memory, in floats (see the layout in grads)
template <int HD>
__host__ __device__ constexpr int grads_floats(int C) {
  constexpr int L = kSubChunk;
  return 5 * C * (HD + 4)                                   // r, k, v, w, dy
         + HD * (HD + 4)                                    // G
         + (C > L ? HD * (HD + 4) + (C - L) * (HD + 4) : 0)  // S0_q, K * D
         + 2 * L * (HD + 4)                                 // K * Qout, R * Pin
         + 3 * C * (HD + 4)                                 // X, Y, Zv
         + C * L                                            // M1
         + (C / L) * L * L * (1 + (HD > 32 ? HD / 32 : 1))  // A, its warps' partials
         + 3 * (C / L) * HD                                 // rowsum(S0 * G), du partials,
                                                            // per-sub-chunk vectors
         + 4 * HD;                                          // u, Pin_b, P_end, spare
}

template <int HD>
size_t grads_smem(int C) {
  return (size_t)grads_floats<HD>(C) * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
grads(const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
      const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ dy,
      const float* __restrict__ sx, const float* __restrict__ gx, float* __restrict__ dr,
      float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dw,
      float* __restrict__ dup, int T, int H, int C) {
  constexpr int L = kSubChunk;
  constexpr int SP = HD + 4;                   // row stride of every [rows][HD] array
  constexpr int GS = HD < 32 ? HD : 32;        // lanes of a column group
  constexpr int WQ = HD > 32 ? HD / 32 : 1;    // warps a sub-chunk's columns span
  constexpr int NB = HD >= 32 ? 4 : 2;         // warp tiles of 16 x 8 NB for HD-wide products
  // at HD = 128 only C = L fits shared memory (the entry checks): no
  // sub-chunk states, and none of their registers
  constexpr bool kSub = HD < 128;
  const int NQ = kSub ? C / L : 1;
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;
  float* ks = rs + C * SP;
  float* vs = ks + C * SP;
  float* ws = vs + C * SP;
  float* ys = ws + C * SP;  // dy
  float* gm = ys + C * SP;  // the carried cotangent G [HD][SP]
  float* sq = gm + HD * SP;                  // S0_q [HD][SP] (C > L)
  float* kd = sq + (C > L ? HD * SP : 0);    // k_s D_{s,b} [C - L][SP]
  float* kq = kd + (C > L ? (C - L) * SP : 0);  // k_t Qout_t [L][SP]
  float* rp = kq + L * SP;                   // r_t Pin_t [L][SP]
  float* xs = rp + L * SP;                   // X [C][SP]
  float* yv = xs + C * SP;                   // Y, the initial Gv [C][SP]
  float* zv = yv + C * SP;                   // Zv [C][SP]
  float* m1 = zv + C * SP;                   // M1 [C][L]: row q L + t, column s
  float* am = m1 + C * L;                    // A [NQ][L][L]: [q][t][s], s <= t
  float* ap = am + NQ * L * L;               // partials [NQ][WQ][L][L]
  float* c0s = ap + NQ * WQ * L * L;         // rowsum(S0_q * G_q) [NQ][HD]
  float* dus = c0s + NQ * HD;                // du partials [NQ][HD]
  float* us = dus + NQ * HD;                 // u [HD]
  float* pinb = us + HD;                     // Pin_b [HD]
  float* pendq = pinb + HD;                  // P_end of the sub-chunk [HD]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int c0 = c * C, n = min(C, T - c0), nq = (n + L - 1) / L;
  const long long row0 = ((long long)b * T + c0) * H + h;  // (b, c0, h) among B * T * H rows
  const long long chunk = ((long long)b * H + h) * gridDim.x + c;
  const float* se = sx + chunk * HD * HD;  // the chunk's entry state
  const float* ge = gx + chunk * HD * HD;  // its exit cotangent

  stage<HD>(rs, r, row0, H, n, C, 0.0f);
  stage<HD>(ks, k, row0, H, n, C, 0.0f);
  stage<HD>(vs, v, row0, H, n, C, 0.0f);
  stage<HD>(ws, w, row0, H, n, C, 1.0f);
  stage<HD>(ys, dy, row0, H, n, C, 0.0f);
  for (int e = tid; e < HD * HD / 4; e += blockDim.x) {
    const int i = e / (HD / 4), q4 = e % (HD / 4);
    cp_async16(gm + i * SP + 4 * q4, ge + i * HD + 4 * q4);
  }
  for (int e = tid; e < HD; e += blockDim.x) us[e] = u[h * HD + e];
  // the products of sub-chunks past T are never computed: zero them, so
  // that the decayed pass can run every sub-chunk (its inputs there are 0)
  for (int e = tid; e < (NQ - nq) * L * SP; e += blockDim.x) {
    xs[nq * L * SP + e] = 0.0f;
    yv[nq * L * SP + e] = 0.0f;
    zv[nq * L * SP + e] = 0.0f;
  }
  for (int e = tid; e < (NQ - nq) * L * L; e += blockDim.x) m1[nq * L * L + e] = 0.0f;
  for (int e = tid; e < (NQ - nq) * HD; e += blockDim.x) c0s[nq * HD + e] = 0.0f;
  for (int e = tid; e < NQ * WQ * L * L; e += blockDim.x) ap[e] = 0.0f;
  cp_async_wait_all();
  __syncthreads();

  const auto zero = [](int, int) { return 0.0f; };
  // k_s D_{s,b0} and Pin_b0 over the steps before sub-chunk q's first step
  // b0 (running products backward from b0, a thread a column, on the last
  // warps), for S0_q
  const auto decay_to = [&](int b0) {
    for (int i = tid - (kThreads - HD); i >= 0 && i < HD; i += blockDim.x) {
      float p = 1.0f;
      for (int s0 = b0 - 8; s0 >= 0; s0 -= 8) {  // b0 is a multiple of 16
        float kv[8], wv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) kv[e] = ks[(s0 + e) * SP + i], wv[e] = ws[(s0 + e) * SP + i];
#pragma unroll
        for (int e = 7; e >= 0; --e) {
          kd[(s0 + e) * SP + i] = kv[e] * p;
          p *= wv[e];
        }
      }
      pinb[i] = p;
    }
  };
  decay_to((nq - 1) * L);
  __syncthreads();
  // G's update a sub-chunk back is computed into registers in one phase and
  // stored in the next: the warp's tiles of G, fixed
  constexpr int kGN = HD / (8 * NB);               // tiles of G across
  constexpr int kGTiles = (HD / 16) * kGN;         // 16 x 8 NB tiles of G
  constexpr int kGPerWarp = kSub ? (kGTiles + kThreads / 32 - 1) / (kThreads / 32) : 1;
  float gacc[kGPerWarp][NB][4];
  // the chunk's entry state at this warp's tiles of S0_q (the tiles of G),
  // read once: every sub-chunk's S0_q starts from it
  float sent[kGPerWarp][NB][4];
  if (kSub && C > L) {
#pragma unroll
    for (int x = 0; x < kGPerWarp; ++x) {
      const int tile = warp + x * nw;
      if (tile < kGTiles) {
        const int m0 = (tile / kGN) * 16, n0 = (tile % kGN) * 8 * NB;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sent[x][nb][e] =
                se[(m0 + tile_row(lane, e)) * HD + n0 + 8 * nb + tile_col(lane, e)];
      }
    }
  }
  for (int q = nq - 1; q >= 0; --q) {
    const int b0 = q * L;  // the sub-chunk's first step in the chunk
    // phase A: G of the sub-chunk's last step into shared memory (from the
    // registers of the last phase B; the chunk's exit cotangent is staged);
    // r_t Pin_t and P_end (forward) and k_t Qout_t (backward), a thread a
    // column; S0_q = diag(Pin_b0) S_entry + (K D)^T V over the steps before b0
    if (kSub && q < nq - 1) {
#pragma unroll
      for (int x = 0; x < kGPerWarp; ++x) {
        const int tile = warp + x * nw;
        if (tile < kGTiles) {
          const int m0 = (tile / kGN) * 16, n0 = (tile % kGN) * 8 * NB;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              gm[(m0 + tile_row(lane, e)) * SP + n0 + 8 * nb + tile_col(lane, e)] =
                  gacc[x][nb][e];
        }
      }
    }
    for (int job = tid; job < 2 * HD; job += blockDim.x) {
      const int i = job % HD;
      const float* x = (job < HD ? rs : ks) + b0 * SP + i;
      float xv[L], wv[L], p = 1.0f;
#pragma unroll
      for (int t = 0; t < L; ++t) xv[t] = x[t * SP], wv[t] = ws[(b0 + t) * SP + i];
      if (job < HD) {
#pragma unroll
        for (int t = 0; t < L; ++t) {
          rp[t * SP + i] = xv[t] * p;
          p *= wv[t];
        }
        pendq[i] = p;
      } else {
#pragma unroll
        for (int t = L - 1; t >= 0; --t) {
          kq[t * SP + i] = xv[t] * p;
          p *= wv[t];
        }
      }
    }
    const float* sqp = se;  // where S0_q is read from, and its row stride
    int sqs = HD;
    if (kSub && C > L) {
#pragma unroll
      for (int x = 0; x < kGPerWarp; ++x) {
        const int tile = warp + x * nw;
        if (tile < kGTiles) {
          const int m0 = (tile / kGN) * 16, n0 = (tile % kGN) * 8 * NB;
          float acc[NB][4];
          tile_mma<NB, 1, SP, SP, 1>(acc, m0, n0, b0, kd, vs, zero);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = m0 + tile_row(lane, e), j = n0 + 8 * nb + tile_col(lane, e);
              sq[i * SP + j] = fmaf(pinb[i], sent[x][nb][e], acc[nb][e]);
            }
        }
      }
      sqp = sq;
      sqs = SP;
    }
    __syncthreads();
    // phase B: X[t][i] = (S0_q dy_t)[i], Y[t][i] = (G v_t)[i], Zv[t][j] =
    // (k_t Qout_t)^T G, M1[t][s] = dy_t . v_s; rowsum(S0_q * G), four lanes a
    // row; G of the previous sub-chunk's last step, diag(P_end) G + (R
    // Pin)^T DY, into registers; the decays to the previous sub-chunk
    const float* dyq = ys + b0 * SP;
    const float* vq = vs + b0 * SP;
    constexpr int kT = (L / 16) * (HD / (8 * NB));  // warp tiles of each L x HD product
    const auto store_x = [&](int t, int i, float x) { xs[(b0 + t) * SP + i] = x; };
    if (kSub && C > L)
      block_gemm<NB, SP, 1, 1, SP>(L, HD, HD, dyq, sq, zero, store_x, 0);
    else
      block_gemm<NB, SP, 1, 1, HD>(L, HD, HD, dyq, se, zero, store_x, 0);
    block_gemm<NB, SP, 1, 1, SP>(L, HD, HD, vq, gm, zero,
                                 [&](int t, int i, float x) { yv[(b0 + t) * SP + i] = x; }, kT);
    block_gemm<NB, SP, 1, SP, 1>(L, HD, HD, kq, gm, zero,
                                 [&](int t, int j, float x) { zv[(b0 + t) * SP + j] = x; },
                                 2 * kT);
    block_gemm<1, SP, 1, 1, SP>(L, L, HD, dyq, vq, zero,
                                [&](int t, int s, float x) { m1[(b0 + t) * L + s] = x; }, 3 * kT);
    for (int i = warp * 8 + lane / 4; i < HD; i += nw * 8) {
      const int j0 = (lane % 4) * (HD / 4);
      float acc = 0.0f;
#pragma unroll
      for (int j = j0; j < j0 + HD / 4; ++j) acc = fmaf(sqp[i * sqs + j], gm[i * SP + j], acc);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (lane % 4 == 0) c0s[q * HD + i] = acc;
    }
    if (kSub && q > 0) {
#pragma unroll
      for (int x = 0; x < kGPerWarp; ++x) {
        const int tile = warp + x * nw;
        if (tile < kGTiles)
          tile_mma<NB, 1, SP, SP, 1>(gacc[x], (tile / kGN) * 16, (tile % kGN) * 8 * NB, L, rp,
                                     dyq, [&](int i, int j) { return pendq[i] * gm[i * SP + j]; });
      }
      decay_to(b0 - L);
    }
    __syncthreads();
  }

  // the decayed parts: thread (sub-chunk q, column i), steps in reverse;
  // what the pass reads is written only before it (the views say so, so
  // that the next step's loads can pass this step's stores of A)
  {
  const float* __restrict__ rs_ = rs;
  const float* __restrict__ xs_ = xs;
  const float* __restrict__ m1_ = m1;
  for (int pair = tid; pair < NQ * HD; pair += blockDim.x) {
    const int q = pair / HD, i = pair % HD, b0 = q * L;
    const int gl = lane & (GS - 1);  // lane within the column group
    const unsigned gmask =
        GS == 32 ? 0xffffffffu : ((1u << (GS & 31)) - 1u) << (lane & ~(GS - 1));
    float kk[L], ww[L], gv[L];
#pragma unroll
    for (int s = 0; s < L; ++s) {
      kk[s] = ks[(b0 + s) * SP + i];
      ww[s] = ws[(b0 + s) * SP + i];
      gv[s] = yv[(b0 + s) * SP + i];
    }
    const float ui = us[i];
    float xg = c0s[q * HD + i], du = 0.0f;
    float* apq = ap + (q * WQ + (HD > 32 ? i / 32 : 0)) * L * L;
#pragma unroll
    for (int t = L - 1; t >= 0; --t) {
      const float rt = rs_[(b0 + t) * SP + i], xt = xs_[(b0 + t) * SP + i], wt = ww[t];
      const float* __restrict__ m1t = m1_ + (b0 + t) * L;
      float p[L];
      float acc_r = 0.0f, acc_w = 0.0f, d = 1.0f;  // d = D_{s,t}
#pragma unroll
      for (int s = t - 1; s >= 0; --s) {
        const float mts = m1t[s], kdd = kk[s] * d;
        acc_r = fmaf(kdd, mts, acc_r);
        acc_w = fmaf(kdd, gv[s], acc_w);
        p[s] = rt * kdd;
        gv[s] = fmaf(wt, gv[s], rt * mts);
        d *= ww[s];
      }
      // d is now Pin_t
      const float bt = m1t[t], kb = kk[t] * bt;
      p[t] = rt * ui * kk[t];
#pragma unroll
      for (int s = t + 1; s < L; ++s) p[s] = 0.0f;
      if (b0 + t < n) {
        const long long off = (row0 + (long long)(b0 + t) * H) * HD + i;
        dr[off] = fmaf(d, xt, acc_r) + ui * kb;
        dk[off] = fmaf(ui * rt, bt, gv[t]);
        dw[off] = fmaf(d, xg, acc_w);
      }
      du = fmaf(rt, kb, du);
      xg = fmaf(wt, xg, rt * xt);
      // the sums of p[0 .. t] over the columns, padded to a power of two
      if (t < 2)
        reduce_scatter<2, GS>(reinterpret_cast<float(&)[2]>(p), apq + t * L, gl, gmask);
      else if (t < 4)
        reduce_scatter<4, GS>(reinterpret_cast<float(&)[4]>(p), apq + t * L, gl, gmask);
      else if (t < 8)
        reduce_scatter<8, GS>(reinterpret_cast<float(&)[8]>(p), apq + t * L, gl, gmask);
      else
        reduce_scatter<L, GS>(p, apq + t * L, gl, gmask);
    }
    dus[q * HD + i] = du;
  }
  }
  __syncthreads();
  for (int e = tid; e < NQ * L * L; e += blockDim.x) {
    const int q = e / (L * L), ts = e % (L * L);
    float a = 0.0f;
#pragma unroll
    for (int x = 0; x < WQ; ++x) a += ap[(q * WQ + x) * L * L + ts];
    am[e] = a;
  }
  for (int i = tid; i < HD; i += blockDim.x) {
    float s = 0.0f;
    for (int q = 0; q < NQ; ++q) s += dus[q * HD + i];
    dup[chunk * HD + i] = s;
  }
  __syncthreads();
  // dv_t = Zv_t + sum_{t' >= t} A[t'][t] dy_t', every sub-chunk's tiles on other warps
  constexpr int kDvTiles = (L / 16) * (HD / (8 * NB));
  for (int q = 0; q < nq; ++q) {
    const int b0 = q * L;
    block_gemm<NB, 1, L, SP, 1>(L, HD, L, am + q * L * L, ys + b0 * SP,
                                [&](int t, int j) { return zv[(b0 + t) * SP + j]; },
                                [&](int t, int j, float x) {
                                  if (b0 + t < n) dv[(row0 + (long long)(b0 + t) * H) * HD + j] = x;
                                },
                                q * kDvTiles);
  }
}

// dynamic shared memory above the default 48 KB where needed, and the
// largest shared memory carveout. A refusal (more than the card has) is
// returned and cleared from the runtime's last error, so that the next
// launch's cudaGetLastError does not report it again.
template <typename K>
cudaError_t configure(K kernel, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

// the shared memory opt-in of kernels 1 and 3, raised to a chunk length's
// needs the first time a launch needs more (off the per-call path, and
// before their attributes are read)
template <int HD>
cudaError_t opt_in(int C) {
  static size_t local_set = 0, grads_set = 0;
  cudaError_t e;
  if (local_smem<HD>(C) > local_set) {
    if ((e = configure(local<HD>, local_smem<HD>(C))) != cudaSuccess) return e;
    local_set = local_smem<HD>(C);
  }
  if (grads_smem<HD>(C) > grads_set) {
    if ((e = configure(grads<HD>, grads_smem<HD>(C))) != cudaSuccess) return e;
    grads_set = grads_smem<HD>(C);
  }
  return cudaSuccess;
}

template <int HD>
cudaError_t launch(const float* r, const float* k, const float* v, const float* w,
                   const float* u, const float* s0, const float* dy, const float* dsT,
                   float* dr, float* dk, float* dv, float* dw, float* dup, float* ds0,
                   float* sx, float* gx, float* pend, int B, int T, int H, int C,
                   cudaStream_t stream) {
  cudaError_t e = opt_in<HD>(C);
  if (e != cudaSuccess) return e;
  const int NC = (T + C - 1) / C;
  if (NC > 0) {
    local<HD><<<dim3(NC, H, B), kThreads, local_smem<HD>(C), stream>>>(r, k, v, w, dy, sx, gx,
                                                                       pend, T, H, C);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  const long long n_elems = (long long)B * H * HD * HD;
  chunk_scan<HD><<<(unsigned)((n_elems + 255) / 256), 256, 0, stream>>>(s0, dsT, pend, sx, gx,
                                                                        ds0, n_elems, NC);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (NC > 0) {
    grads<HD><<<dim3(NC, H, B), kThreads, grads_smem<HD>(C), stream>>>(
        r, k, v, w, u, dy, sx, gx, dr, dk, dv, dw, dup, T, H, C);
    e = cudaGetLastError();
  }
  return e;
}

// the larger of kernel 1's and kernel 3's dynamic shared memory
template <int HD>
size_t smem_need(int C) {
  return local_smem<HD>(C) > grads_smem<HD>(C) ? local_smem<HD>(C) : grads_smem<HD>(C);
}

// the chunk lengths the entry takes at head_dim hd
bool valid_chunk(int hd, int chunk) {
  return chunk >= kSubChunk && chunk <= kMaxChunk && chunk % kSubChunk == 0 &&
         (hd != 128 || chunk == kSubChunk);
}

// kernel 0 local, 1 chunk_scan, 2 grads (kernels 1-3 above), at chunks of
// C steps
template <int HD>
cudaError_t attrs(int kernel, int C, long long* out) {
  const cudaError_t e = opt_in<HD>(C);
  if (e != cudaSuccess) return e;
  switch (kernel) {
    case 0: return kernel_attrs(local<HD>, (long long)local_smem<HD>(C), out);
    case 1: return kernel_attrs(chunk_scan<HD>, 0, out);
    case 2: return kernel_attrs(grads<HD>, (long long)grads_smem<HD>(C), out);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// hd in {16, 32, 64, 128}; chunk (C) a multiple of kSubChunk up to
// kMaxChunk, kSubChunk itself at hd 128; all pointers contiguous fp32,
// 16-byte aligned; dup and pend hold B * H * ceil(T / C) * hd floats, sx and
// gx B * H * ceil(T / C) * hd^2 each. A chunk whose shared memory passes the
// card's limit (rwkv6_scan_bwd_smem) fails with the launch's error.
extern "C" int rwkv6_scan_bwd(const float* r, const float* k, const float* v, const float* w,
                              const float* u, const float* s0, const float* dy,
                              const float* dsT, float* dr, float* dk, float* dv, float* dw,
                              float* dup, float* ds0, float* sx, float* gx, float* pend,
                              int B, int T, int H, int hd, int chunk, cudaStream_t stream) {
  if (T < 0 || !valid_chunk(hd, chunk)) return (int)cudaErrorInvalidValue;
  if (B * H == 0) return (int)cudaGetLastError();
  cudaError_t e;
#define RWKV6_BWD(HD)                                                                       \
  launch<HD>(r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dw, dup, ds0, sx, gx, pend, B, T, H, chunk, \
             stream)
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

// The dynamic shared memory a block of the entry's largest kernel needs at
// head_dim hd and chunks of chunk steps, in bytes (no card needed): a chunk
// needs no more than the card's opt-in limit to launch.
extern "C" int rwkv6_scan_bwd_smem(int hd, int chunk, long long* bytes) {
  if (!valid_chunk(hd, chunk)) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: *bytes = (long long)smem_need<16>(chunk); break;
    case 32: *bytes = (long long)smem_need<32>(chunk); break;
    case 64: *bytes = (long long)smem_need<64>(chunk); break;
    case 128: *bytes = (long long)smem_need<128>(chunk); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// The attributes of one kernel instance at head_dim hd and chunks of chunk
// steps, as kernel_attrs.cuh reports them (out[6]), after the opt-in the
// entry makes for that chunk: kernel 0 local, 1 chunk_scan, 2 grads.
extern "C" int rwkv6_scan_bwd_attrs(int kernel, int hd, int chunk, long long* out) {
  if (!valid_chunk(hd, chunk)) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return (int)attrs<16>(kernel, chunk, out);
    case 32: return (int)attrs<32>(kernel, chunk, out);
    case 64: return (int)attrs<64>(kernel, chunk, out);
    case 128: return (int)attrs<128>(kernel, chunk, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
