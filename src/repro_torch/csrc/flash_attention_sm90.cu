// GQA flash attention, forward only, bf16, on Hopper's tensor cores (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:_kernel for the
// calls the wrapper (repro_torch/kernels/flash_attention.py:_variant) sends
// here: q, k, v in bf16, head_dim H in {64, 128}, more than one query (a
// prefill). Decode (Sq = 1) goes to flash_attention_decode.cu; fp32 and H
// in {32, 256} stay on the SIMT kernel in flash_attention.cu.
//
//   o[b, i, n] = softmax_j(scale * q[b, i, n] . k[b, j, n / G]) v[b, j, n / G]
//
// over the keys j the masks leave: j < k_len; j <= i + q_offset when
// causal; j > i + q_offset - window when window > 0. The softmax runs online
// in fp32 with the TPU kernel's constants: masked scores are -1e30, each kv
// tile rescales the running sum and accumulator by exp(m_old - m_new), and
// the output is acc / max(l, 1e-30), rounded once to bf16.
//
// What bounds it on an H100: operations. A (query, key) pair that the masks
// leave costs 4 H flops per q head; at (1, 4096, 24/8, 128) causal that is
// 0.104 ms at the bf16 tensor-core peak (989 TFLOP/s) against 0.03 ms of
// bytes, and only wgmma reaches that rate.
//
// What the design does about it:
// - A block of 256 threads (two warpgroups) owns BM = 128 flattened
//   (query, q head of the group) rows of one (batch, kv head): row t is
//   (query t / G, q head kvh * G + t % G), so each K/V tile is loaded once
//   for the G q heads that share it. Each warpgroup is one 64-row wgmma M
//   tile. Blocks are taken heaviest first (the last q rows see the most
//   keys under the causal mask), so the last wave is short.
// - Q (BM x H) is loaded once; K and V come in tiles of BN = 64 keys
//   through a two-stage ring: tile k + 1 is copied with 16-byte cp.async
//   while tile k is consumed; cp.async.wait_group and __syncthreads order
//   them. The loaders write wgmma's 128-byte swizzled layout themselves
//   (64-column chunks of 128-byte rows, the 16-byte unit u of row r at
//   u ^ (r % 8)). Keys at or past k_len and rows past Sq * G are
//   zero-filled, so padded V rows are 0.
// - S = Q K^T: wgmma m64n64k16, both operands K-major in shared memory (the
//   natural [row][h] layout of Q and K), fp32 accumulators; the softmax
//   scale multiplies S in fp32 after the product (H^-0.5 is no power of two
//   at H = 128, so folding it into bf16 q would change the inputs).
// - Masks and the online softmax work on the accumulator fragment: a
//   thread holds 2 rows x 16 keys; the row max is reduced over the 4 lanes
//   that share a row, the row sum stays per thread until the epilogue. Kv
//   tiles the masks wholly exclude for the block are never loaded, tiles
//   they wholly exclude for one warpgroup are skipped by it, and tiles
//   wholly inside the masks skip the per-element mask arithmetic.
// - O += P V keeps p in fp32 as the TPU kernel does: P = P_hi + P_lo with
//   P_hi = bf16(p), P_lo = bf16(p - P_hi) (about 16 bits of p), and two
//   wgmma m64nHk16 per 16 keys into one fp32 accumulator. A comes from
//   registers: the S fragment of 16 keys, packed to bf16 pairs, is the A
//   fragment of one k16 step. B = V from shared memory in its [key][h]
//   layout, with B's transpose bit set. That is 6 H flops per pair in
//   place of 4 H; the bound counts the work itself, 4 H.
//
// No TMA and no warp specialisation (producer warp, setmaxnreg, mbarrier
// ring): every thread loads and computes, and tiles are synchronised with
// __syncthreads. Those, and overlapping one warpgroup's softmax with the
// other's products, are later work if the numbers call for them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBM = 128;       // flattened rows per block
constexpr int kBN = 64;        // keys per K/V tile
constexpr int kThreads = 256;  // two warpgroups of 64 rows
// one block per SM: ptxas gives the H = 128 instance 203 registers a thread;
// a budget of two blocks (128 registers) spills
constexpr int kMinBlocks = 1;
constexpr unsigned kFull = 0xffffffffu;

template <int H>
struct Cfg {
  static constexpr int UNITS = H / 8;                 // 16-byte units per row
  static constexpr int Q_BYTES = kBM * H * 2;
  static constexpr int KV_BYTES = kBN * H * 2;        // one K or V tile
  static constexpr int SMEM = Q_BYTES + 4 * KV_BYTES + 1024;  // + room to align
  static constexpr int O_REGS = H / 2;                // m64nHk16 fp32 fragment
};

// Byte offset of 16-byte unit u of row r in a tile of R rows laid out for
// wgmma's 128-byte swizzle: 64-column chunks of R rows x 128 bytes each.
template <int R>
__device__ __forceinline__ uint32_t swz(int r, int u) {
  return (uint32_t)((u >> 3) * R * 128 + r * 128 + (((u & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; with valid false the 16 bytes are
// zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets in 16-byte units, layout type 1 at bit 62.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// The accumulators are written asynchronously: pin every read of them after
// the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define F4(a, i) "+f"(a[(i)]), "+f"(a[(i) + 1]), "+f"(a[(i) + 2]), "+f"(a[(i) + 3])
#define F16(a, i) F4(a, i), F4(a, (i) + 4), F4(a, (i) + 8), F4(a, (i) + 12)
#define F32(a, i) F16(a, i), F16(a, (i) + 16)

// d (64 x 64 fp32) = A (64 x 16, K-major smem) * B (16 x 64, K-major smem)
// + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : F32(d, 0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 fp32) += A (64 x 16 bf16, registers) * B (16 x 64, MN-major smem)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 fp32) += A (64 x 16 bf16, registers) * B (16 x 128, MN-major smem)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F32(d, 0), F32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F32
#undef F16
#undef F4

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 two = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<const uint32_t*>(&two);
}

template <int H>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_sm90_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Sq,
                  int Sk, int N, int K, int causal, int window, long long q_offset,
                  int k_len, float scale) {
  using C = Cfg<H>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle repeats every 1 KB
  const uint32_t sK = sQ + C::Q_BYTES;                         // 2 stages
  const uint32_t sV = sK + 2 * C::KV_BYTES;                    // 2 stages

  // blocks heaviest first: the q block index runs slowest, in reverse
  const int G = N / K;
  const long long lin =
      blockIdx.x + (long long)gridDim.x * (blockIdx.y + (long long)gridDim.y * blockIdx.z);
  const long long per = (long long)gridDim.y * gridDim.z;
  const int qblk = gridDim.x - 1 - (int)(lin / per);
  const int kvh = (int)(lin % per) % K, b = (int)(lin % per) / K;

  const int tid = threadIdx.x;
  const long long rows_total = (long long)Sq * G;
  const long long row0 = (long long)qblk * kBM;
  const long long row_end = row0 + kBM < rows_total ? row0 + kBM : rows_total;

  // kv range the block's rows can see
  const long long q_lo = q_offset + row0 / G;
  const long long q_hi = q_offset + (row_end - 1) / G;
  long long j_hi = (long long)k_len - 1;
  if (causal && q_hi < j_hi) j_hi = q_hi;
  long long j_lo = 0;
  if (window > 0 && q_lo - window + 1 > j_lo) j_lo = q_lo - window + 1;
  const long long kt0 = (j_lo / kBN) * kBN;
  const int n_tiles = j_hi < kt0 ? 0 : (int)((j_hi - kt0) / kBN + 1);

  // Q once, rows past Sq * G zero-filled
  for (int e = tid; e < kBM * C::UNITS; e += kThreads) {
    const int r = e / C::UNITS, u = e % C::UNITS;
    const long long t = row0 + r;
    const bool ok = t < rows_total;
    const __nv_bfloat16* src =
        ok ? q + (((long long)b * Sq + t / G) * N + (long long)kvh * G + t % G) * H + u * 8 : q;
    cp_async16(sQ + swz<kBM>(r, u), src, ok);
  }
  auto load_kv = [&](int stage, long long kt) {
    for (int e = tid; e < kBN * C::UNITS; e += kThreads) {
      const int j = e / C::UNITS, u = e % C::UNITS;
      const long long kp = kt + j;
      const bool ok = kp < k_len;
      const long long off = ok ? (((long long)b * Sk + kp) * K + kvh) * H + u * 8 : 0;
      const uint32_t dst = (uint32_t)stage * C::KV_BYTES + swz<kBN>(j, u);
      cp_async16(sK + dst, k + off, ok);
      cp_async16(sV + dst, v + off, ok);
    }
  };
  if (n_tiles > 0) load_kv(0, kt0);
  cp_async_commit();

  // this thread's rows: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the
  // block; lane l of warp w (in the warpgroup) holds rows 16 w + l / 4 and
  // 16 w + l / 4 + 8, and of each 8-key group the keys 2 (l % 4) and + 1
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const long long wrow0 = row0 + 64 * wg;
  const bool wg_active = wrow0 < rows_total;
  const long long wrow_end = wrow0 + 64 < rows_total ? wrow0 + 64 : rows_total;
  const long long wq_lo = q_offset + wrow0 / G;
  const long long wq_hi = wg_active ? q_offset + (wrow_end - 1) / G : wq_lo;
  const long long t_r[2] = {wrow0 + 16 * warp + lane / 4, wrow0 + 16 * warp + lane / 4 + 8};
  const long long qpos[2] = {q_offset + t_r[0] / G, q_offset + t_r[1] / G};
  const int col = 2 * (lane % 4);

  float acc[C::O_REGS];
#pragma unroll
  for (int i = 0; i < C::O_REGS; ++i) acc[i] = 0.0f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};

  for (int it = 0; it < n_tiles; ++it) {
    const long long kt = kt0 + (long long)it * kBN;
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_kv(stage ^ 1, kt + kBN);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of Q and of tile it have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();

    const bool skip = (causal && kt > wq_hi) || (window > 0 && kt + kBN - 1 <= wq_lo - window);
    if (wg_active && !skip) {
      // S = Q K^T over H / 16 k-steps of 32 bytes within each 128-byte chunk
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        const uint32_t chunk = kk / 4, off = (kk % 4) * 32;
        const uint64_t da = make_desc(sQ + chunk * kBM * 128 + wg * 64 * 128 + off, 16, 1024);
        const uint64_t db =
            make_desc(sK + stage * C::KV_BYTES + chunk * kBN * 128 + off, 16, 1024);
        wgmma_ss_n64(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // s[4 i + c]: row c / 2, key kt + 8 i + col + c % 2
      const bool full = kt + kBN <= k_len && (!causal || kt + kBN - 1 <= wq_lo) &&
                        (window <= 0 || kt > wq_hi - window);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= scale;
      if (!full) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const long long kp = kt + 8 * (i / 4) + col + (i % 2);
          const long long qp = qpos[(i / 2) % 2];
          bool ok = kp < k_len;
          if (causal) ok = ok && qp >= kp;
          if (window > 0) ok = ok && kp > qp - window;
          if (!ok) s[i] = kNeg;
        }
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNeg;
#pragma unroll
        for (int i = 0; i < 8; ++i) mx = fmaxf(mx, fmaxf(s[4 * i + 2 * h], s[4 * i + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        alpha[h] = exp2f((m[h] - m_new) * kLog2e);
        float sum = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = s[4 * i + 2 * h + c];
            x = exp2f((x - m_new) * kLog2e);
            sum += x;
          }
        }
        l[h] = l[h] * alpha[h] + sum;
        m[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < C::O_REGS; ++i) acc[i] *= alpha[(i / 2) % 2];

      // P = P_hi + P_lo as the A fragments of the four k16 steps over the
      // tile's keys: step kk's fragment is s[8 kk .. 8 kk + 7] in pairs
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x0 = s[8 * kk + 2 * r], x1 = s[8 * kk + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
          p_hi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
          p_lo[kk][r] = pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
        }
      }

      // O += P_hi V + P_lo V; V's 16 keys of step kk start 16 rows of 128
      // bytes further; its 64-column chunks lie kBN * 128 bytes apart
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = make_desc(sV + stage * C::KV_BYTES + kk * 16 * 128, kBN * 128, 1024);
        wgmma_rs(acc, p_hi[kk], db);
        wgmma_rs(acc, p_lo[kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncthreads();  // stage `stage` is free for the load of tile it + 2
  }
  cp_async_wait<0>();

  if (!wg_active) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(kFull, lt, 1);
    lt += __shfl_xor_sync(kFull, lt, 2);
    const long long t = t_r[h];
    if (t >= rows_total) continue;
    const float denom = fmaxf(lt, 1e-30f);
    __nv_bfloat16* orow =
        o + (((long long)b * Sq + t / G) * N + (long long)kvh * G + t % G) * H + col;
#pragma unroll
    for (int i = 0; i < H / 8; ++i) {
      const __nv_bfloat162 two =
          __floats2bfloat162_rn(acc[4 * i + 2 * h] / denom, acc[4 * i + 2 * h + 1] / denom);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) = two;
    }
  }
}

template <int H>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                   int N, int K, int causal, int window, long long q_offset, int k_len,
                   float scale, cudaStream_t stream) {
  constexpr int smem = Cfg<H>::SMEM;
  static bool attr_set = false;  // above 48 KB needs the opt-in, once per instance
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_sm90_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const long long rows = (long long)Sq * (N / K);
  const dim3 grid((unsigned)((rows + kBM - 1) / kBM), (unsigned)K, (unsigned)B);
  flash_sm90_kernel<H><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Sk, N, K,
      causal, window, q_offset, k_len, scale);
  return cudaGetLastError();
}

}  // namespace

// bf16 q/k/v/o only. Pointers 16-byte aligned and contiguous; H in {64, 128}
// (else cudaErrorInvalidValue); N % K == 0 (the wrapper checks).
extern "C" int flash_attention_sm90(const void* q, const void* k, const void* v, void* o,
                                    int B, int Sq, int Sk, int N, int K, int H, int causal,
                                    int window, long long q_offset, int k_len, float scale,
                                    cudaStream_t stream) {
  if ((long long)B * Sq * N == 0) return (int)cudaGetLastError();
  switch (H) {
    case 64:
      return (int)launch<64>(q, k, v, o, B, Sq, Sk, N, K, causal, window, q_offset, k_len,
                             scale, stream);
    case 128:
      return (int)launch<128>(q, k, v, o, B, Sq, Sk, N, K, causal, window, q_offset, k_len,
                              scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
