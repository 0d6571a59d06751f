// GQA flash attention, forward only, bf16, on Hopper's tensor cores (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:_kernel for the
// calls the wrapper (repro_torch/kernels/flash_attention.py:_variant) sends
// here: q, k, v in bf16, (q and k's head_dim H, v's Hv) in {(64, 64),
// (128, 128), (256, 256), (192, 128), (112, 112)}, more than one query (a
// prefill).
// Decode (Sq = 1) goes to flash_attention_decode.cu; fp32 prefill at every
// head_dim, and bf16 prefill at H = 32, go to the 3xTF32 kernel in
// flash_attention.cu. (64, 64), (128, 128) and (192, 128) run
// flash_sm90_kernel, the design below; (256, 256) (gemma3-12b's) runs
// flash_sm90_h256_kernel, the same arithmetic with a TMA producer,
// described above it. (192, 128) is deepseek-v2-lite-16b's MLA prefill in
// its expanded form: q and k are 128 nope + 64 rope columns, v 128.
// (112, 112) is zamba2-7b's shared attention block (32 heads of 112) and
// runs flash_sm90_kernel too, on tiles padded to 128 columns (below).
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
// leave costs 2 H + 2 Hv flops per q head; at (1, 4096, 24/8, 128) causal
// that is 0.104 ms at the bf16 tensor-core peak (989 TFLOP/s) against 0.03
// ms of bytes, at (1, 4096, 16/16, 192/128) 0.0869 ms against 0.025 ms, and
// only wgmma reaches that rate.
//
// What the design does about it:
// - A block of 256 threads (two warpgroups) owns BM = 128 flattened
//   (query, q head of the group) rows of one (batch, kv head): row t is
//   (query t / G, q head kvh * G + t % G), so each K/V tile is loaded once
//   for the G q heads that share it. Each warpgroup is one 64-row wgmma M
//   tile. Blocks are taken heaviest first (the last q rows see the most
//   keys under the causal mask), so the last wave is short.
// - Q (BM x H) is loaded once; K (BN x H) and V (BN x Hv) come in tiles of BN = 64 keys
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
//   wgmma m64nHvk16 per 16 keys into one fp32 accumulator. A comes from
//   registers: the S fragment of 16 keys, packed to bf16 pairs, is the A
//   fragment of one k16 step. B = V from shared memory in its [key][h]
//   layout, with B's transpose bit set. That is 2 H + 4 Hv flops per pair
//   in place of 2 H + 2 Hv; the bound counts the work itself.
// - (192, 128): Q and K rows are three 64-column swizzle chunks, S = Q K^T
//   12 k16 steps; V and O as at (128, 128). Shared memory Q 48 KB + K 2 x
//   24 KB + V 2 x 16 KB = 128 KB, one block an SM as at (128, 128). The
//   scale is H^-0.5 = 192^-0.5, the reference's (nope + rope)^-0.5.
// - (112, 112): a row is 14 of the 16-byte units, so each tile is laid out
//   as at (128, 128) (two 64-column swizzle chunks; 96 KB, one block an SM)
//   and the loaders copy units 0-13 only. S = Q K^T takes 7 k16 steps,
//   which read columns 0-111: units 14-15 of Q and K are never read. P V
//   runs as m64n128k16, the (128, 128) instance's product and O fragment,
//   over V's 128 staged columns: units 14-15 of V are zeroed once in
//   shared memory at the start (never loaded from global memory; the
//   loaders never write them), so O's columns 112-127 are zeros, and the
//   epilogue writes columns 0-111 only. m64n112k16 is a legal wgmma too,
//   but its N is no multiple of the 64-column swizzle atom of an MN-major
//   B; the padded N keeps the layout the (128, 128) instance runs, for 14%
//   more P V work (2 H + 4 x 128 flops a pair in place of 2 H + 4 H). The
//   scale is 112^-0.5, the head_dim's own.
//
// No TMA and no warp specialisation (producer warp, setmaxnreg, mbarrier
// ring): every thread loads and computes, and tiles are synchronised with
// __syncthreads. Those, and overlapping one warpgroup's softmax with the
// other's products, are later work if the numbers call for them.
#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "kernel_attrs.cuh"

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

template <int H, int HV>
struct Cfg {
  static constexpr int UNITS = H / 8;                 // 16-byte units per q or k row
  static constexpr int V_UNITS = HV / 8;              // 16-byte units per v or o row
  static constexpr int HP = (H + 63) / 64 * 64;       // staged q / k row: whole swizzle chunks
  static constexpr int HVP = (HV + 63) / 64 * 64;     // staged v row, and O's columns
  static constexpr int Q_BYTES = kBM * HP * 2;
  static constexpr int K_BYTES = kBN * HP * 2;        // one K tile
  static constexpr int V_BYTES = kBN * HVP * 2;       // one V tile
  static constexpr int SMEM = Q_BYTES + 2 * (K_BYTES + V_BYTES) + 1024;  // + room to align
  static constexpr int O_REGS = HVP / 2;              // m64nHVPk16 fp32 fragment
  static_assert(H % 16 == 0 && HV % 8 == 0, "S takes k16 steps; rows are 16-byte units");
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

// d (64 x 256 fp32) += A (64 x 16 bf16, registers) * B (16 x 256, MN-major smem)
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : F32(d, 0), F32(d, 32), F32(d, 64), F32(d, 96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F32
#undef F16
#undef F4

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 two = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<const uint32_t*>(&two);
}

template <int H, int HV>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_sm90_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Sq,
                  int Sk, int N, int K, int causal, int window, long long q_offset,
                  int k_len, float scale) {
  using C = Cfg<H, HV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle repeats every 1 KB
  const uint32_t sK = sQ + C::Q_BYTES;                         // 2 stages
  const uint32_t sV = sK + 2 * C::K_BYTES;                     // 2 stages
  if constexpr (C::HVP != HV) {
    // V's padding units (never loaded) are zeros, so O's padding columns
    // are; the first __syncthreads and proxy fence below publish them
    for (int e = threadIdx.x; e < 2 * kBN * (C::HVP - HV) / 8; e += kThreads) {
      const int per = (C::HVP - HV) / 8, row = e / per, u = HV / 8 + e % per;
      const uint32_t dst = sV + (uint32_t)(row / kBN) * C::V_BYTES + swz<kBN>(row % kBN, u);
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(0u), "r"(0u),
                   "r"(0u), "r"(0u)
                   : "memory");
    }
  }

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
      const uint32_t dst = (uint32_t)stage * C::K_BYTES + swz<kBN>(j, u);
      cp_async16(sK + dst, k + off, ok);
      if constexpr (H == HV) cp_async16(sV + dst, v + off, ok);  // one walk for both
    }
    if constexpr (H != HV) {
      for (int e = tid; e < kBN * C::V_UNITS; e += kThreads) {
        const int j = e / C::V_UNITS, u = e % C::V_UNITS;
        const long long kp = kt + j;
        const bool ok = kp < k_len;
        const long long off = ok ? (((long long)b * Sk + kp) * K + kvh) * HV + u * 8 : 0;
        cp_async16(sV + (uint32_t)stage * C::V_BYTES + swz<kBN>(j, u), v + off, ok);
      }
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
            make_desc(sK + stage * C::K_BYTES + chunk * kBN * 128 + off, 16, 1024);
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
        const uint64_t db = make_desc(sV + stage * C::V_BYTES + kk * 16 * 128, kBN * 128, 1024);
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
        o + (((long long)b * Sq + t / G) * N + (long long)kvh * G + t % G) * HV + col;
#pragma unroll
    for (int i = 0; i < HV / 8; ++i) {
      const __nv_bfloat162 two =
          __floats2bfloat162_rn(acc[4 * i + 2 * h] / denom, acc[4 * i + 2 * h + 1] / denom);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) = two;
    }
  }
}

// above 48 KB needs the opt-in: once per instance, before its first launch
// (and before its attributes are read)
template <int H, int HV>
cudaError_t opt_in() {
  constexpr int smem = Cfg<H, HV>::SMEM;
  static_assert(smem <= 232448, "shared memory over the 227 KB a block may have");
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_sm90_kernel<H, HV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  return cudaSuccess;
}

template <int H, int HV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                   int N, int K, int causal, int window, long long q_offset, int k_len,
                   float scale, cudaStream_t stream) {
  constexpr int smem = Cfg<H, HV>::SMEM;
  const cudaError_t e = opt_in<H, HV>();
  if (e != cudaSuccess) return e;
  const long long rows = (long long)Sq * (N / K);
  const dim3 grid((unsigned)((rows + kBM - 1) / kBM), (unsigned)K, (unsigned)B);
  flash_sm90_kernel<H, HV><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Sk, N, K,
      causal, window, q_offset, k_len, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ H = 256
//
// gemma3-12b's head_dim. The arithmetic is flash_sm90_kernel's, term for
// term (the same rows, tiles, scale after the product, masks, online
// rescale, P_hi + P_lo, epilogue), so one CPU emulation holds both. What
// H = 256 changes is the budgets:
// - Registers. O's m64n256 fp32 fragment is 128 registers a thread; with
//   the S tile (32), P (32 packed) and the K/V loaders' addressing, the
//   all-threads-load layout above would need about 267, above the 255 a
//   thread may have. So the block is warp-specialised: 384 threads, two
//   consumer warpgroups (threads 0-255, the 64-row wgmma tiles as above)
//   and one producer warpgroup (256-383). setmaxnreg takes the producer
//   down to 40 registers and the consumers up to 232 (2 x 128 x 232 + 128
//   x 40 = 64,512 of the SM's 65,536); the consumers hold no load
//   addressing at all.
// - Copies. One producer thread issues each K and V tile by TMA (four
//   boxes of 64 keys x 64 columns each, 128-byte swizzle: the layout the
//   wgmma descriptors read) into a two-stage ring with a full and an empty
//   mbarrier per stage; the consumers wait on full, run their products on
//   the tile and arrive on empty. The tensor maps are built per call on the
//   host (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint,
//   so nothing links against libcuda) over (H, K, k_len, B): keys past
//   k_len come in as zeros, the padding rule above. Q, whose flattened
//   (query, q head) rows are one TMA box only when 128 % G == 0, is copied
//   once by the producer warpgroup with cp.async and published through its
//   own mbarrier.
// - Shared memory: Q 64 KB + 2 stages x (K + V) 128 KB + barriers + 1 KB of
//   alignment, about 193 KB: one block an SM.
// The two consumer warpgroups no longer step in lockstep (no
// __syncthreads in the loop), so one's softmax can overlap the other's
// products. Tile skipping is as above.

constexpr int kWsThreads = 384;  // two consumer warpgroups + one producer warpgroup
constexpr int kConsumers = 256;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

struct H256 {
  static constexpr int H = 256;
  static constexpr int UNITS = H / 8;
  static constexpr int CHUNKS = H / 64;              // 128-byte column chunks a row
  static constexpr int Q_BYTES = kBM * H * 2;        // 64 KB
  static constexpr int KV_BYTES = kBN * H * 2;       // one K or V tile, 32 KB
  static constexpr int BOX_BYTES = kBN * 128;        // one TMA box: 64 keys x 64 columns
  static constexpr int BAR_OFFSET = Q_BYTES + 4 * KV_BYTES;
  static constexpr int SMEM = BAR_OFFSET + 5 * 8 + 1024;  // + full[2], empty[2], q; + align
  static constexpr int O_REGS = H / 2;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// Spin until the barrier's phase with this parity has completed. A wait
// that outlasts about two seconds of SM clock is a fault of the kernel:
// trap (a launch error the wrapper raises) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 32)) {
      __trap();
    }
  }
}

// One TMA box from a 4-D tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__global__ void __launch_bounds__(kWsThreads, 1)
flash_sm90_h256_kernel(const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o,
                       int Sq, int N, int K, int causal, int window, long long q_offset,
                       int k_len, float scale) {
  using C = H256;
  constexpr int H = C::H;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle repeats every 1 KB
  const uint32_t sK = sQ + C::Q_BYTES;                         // 2 stages
  const uint32_t sV = sK + 2 * C::KV_BYTES;                    // 2 stages
  const uint32_t full_bar = sQ + C::BAR_OFFSET;                // stage s at + 8 s
  const uint32_t empty_bar = full_bar + 16;                    // stage s at + 8 s
  const uint32_t q_bar = full_bar + 32;

  // blocks heaviest first, as flash_sm90_kernel
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

  if (tid == 0) {
    mbar_init(full_bar, 1);
    mbar_init(full_bar + 8, 1);
    mbar_init(empty_bar, kConsumers);
    mbar_init(empty_bar + 8, kConsumers);
    mbar_init(q_bar, kWsThreads - kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warpgroup: Q by cp.async, then K/V tiles by TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int ptid = tid - kConsumers;
    for (int e = ptid; e < kBM * C::UNITS; e += kWsThreads - kConsumers) {
      const int r = e / C::UNITS, u = e % C::UNITS;
      const long long t = row0 + r;
      const bool ok = t < rows_total;
      const __nv_bfloat16* src =
          ok ? q + (((long long)b * Sq + t / G) * N + (long long)kvh * G + t % G) * H + u * 8 : q;
      cp_async16(sQ + swz<kBM>(r, u), src, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    mbar_arrive(q_bar);
    if (ptid == 0) {
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it & 1;
        // stage's previous tile (it - 2) released by both consumer warpgroups
        if (it >= 2) mbar_wait(empty_bar + 8 * stage, ((it >> 1) & 1) ^ 1);
        const uint32_t full = full_bar + 8 * stage;
        mbar_arrive_expect_tx(full, 2 * C::KV_BYTES);
        const int kt = (int)(kt0 + (long long)it * kBN);
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c) {
          const uint32_t dst = (uint32_t)stage * C::KV_BYTES + c * C::BOX_BYTES;
          tma_load_4d(sK + dst, &map_k, full, 64 * c, kvh, kt, b);
          tma_load_4d(sV + dst, &map_v, full, 64 * c, kvh, kt, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: the products and the online softmax
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
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

    mbar_wait(q_bar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const long long kt = kt0 + (long long)it * kBN;
      const int stage = it & 1;
      mbar_wait(full_bar + 8 * stage, (it >> 1) & 1);

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
              make_desc(sK + stage * C::KV_BYTES + chunk * C::BOX_BYTES + off, 16, 1024);
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
          for (int i = 0; i < 8; ++i)
            mx = fmaxf(mx, fmaxf(s[4 * i + 2 * h], s[4 * i + 2 * h + 1]));
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

        // O += P_hi V + P_lo V, P packed 16 keys (one k16 step) at a time
        // right before its two products; V's 16 keys of step kk start 16
        // rows of 128 bytes further, its 64-column chunks one box apart
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t p_hi[4], p_lo[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float x0 = s[8 * kk + 2 * r], x1 = s[8 * kk + 2 * r + 1];
            const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
            p_hi[r] = *reinterpret_cast<const uint32_t*>(&hi);
            p_lo[r] = pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
          }
          const uint64_t db =
              make_desc(sV + stage * C::KV_BYTES + kk * 16 * 128, C::BOX_BYTES, 1024);
          wgmma_rs(acc, p_hi, db);
          wgmma_rs(acc, p_lo, db);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      }
      mbar_arrive(empty_bar + 8 * stage);  // this thread is done with the stage
    }

    if (wg_active) {
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
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A 4-D map over a (B, Sk, K, 256) bf16 tensor as (H, K, k_len, B), boxes of
// 64 columns x 1 head x 64 keys x 1 batch with the 128-byte swizzle; reads
// past k_len come back as zeros.
cudaError_t encode_kv_map(CUtensorMap* map, const void* base, int B, int Sk, int K, int k_len) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  constexpr int H = H256::H;
  const cuuint64_t dims[4] = {(cuuint64_t)H, (cuuint64_t)K,
                              (cuuint64_t)(k_len > 0 ? k_len : 1), (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)H * 2, (cuuint64_t)K * H * 2,
                                 (cuuint64_t)Sk * K * H * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kBN, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t opt_in_h256() {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_sm90_h256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, H256::SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  return cudaSuccess;
}

cudaError_t launch_h256(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                        int Sk, int N, int K, int causal, int window, long long q_offset,
                        int k_len, float scale, cudaStream_t stream) {
  constexpr int smem = H256::SMEM;
  cudaError_t e = opt_in_h256();
  if (e != cudaSuccess) return e;
  CUtensorMap map_k, map_v;
  e = encode_kv_map(&map_k, k, B, Sk, K, k_len);
  if (e == cudaSuccess) e = encode_kv_map(&map_v, v, B, Sk, K, k_len);
  if (e != cudaSuccess) return e;
  const long long rows = (long long)Sq * (N / K);
  const dim3 grid((unsigned)((rows + kBM - 1) / kBM), (unsigned)K, (unsigned)B);
  flash_sm90_h256_kernel<<<grid, kWsThreads, smem, stream>>>(
      map_k, map_v, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o), Sq, N,
      K, causal, window, q_offset, k_len, scale);
  return cudaGetLastError();
}

template <int H, int HV>
cudaError_t instance_attrs(long long* out) {
  const cudaError_t e = opt_in<H, HV>();
  if (e != cudaSuccess) return e;
  return kernel_attrs(flash_sm90_kernel<H, HV>, Cfg<H, HV>::SMEM, out);
}

}  // namespace

// bf16 q/k/v/o only. q and k (.., H), v and o (.., Hv); pointers 16-byte
// aligned and contiguous; (H, Hv) in {(64, 64), (128, 128), (256, 256),
// (192, 128), (112, 112)} (else cudaErrorInvalidValue); N % K == 0 (the
// wrapper checks).
extern "C" int flash_attention_sm90(const void* q, const void* k, const void* v, void* o,
                                    int B, int Sq, int Sk, int N, int K, int H, int Hv,
                                    int causal, int window, long long q_offset, int k_len,
                                    float scale, cudaStream_t stream) {
  if ((long long)B * Sq * N == 0) return (int)cudaGetLastError();
  if (H == 64 && Hv == 64)
    return (int)launch<64, 64>(q, k, v, o, B, Sq, Sk, N, K, causal, window, q_offset, k_len,
                               scale, stream);
  if (H == 128 && Hv == 128)
    return (int)launch<128, 128>(q, k, v, o, B, Sq, Sk, N, K, causal, window, q_offset, k_len,
                                 scale, stream);
  if (H == 192 && Hv == 128)
    return (int)launch<192, 128>(q, k, v, o, B, Sq, Sk, N, K, causal, window, q_offset, k_len,
                                 scale, stream);
  if (H == 112 && Hv == 112)
    return (int)launch<112, 112>(q, k, v, o, B, Sq, Sk, N, K, causal, window, q_offset, k_len,
                                 scale, stream);
  if (H == 256 && Hv == 256)
    return (int)launch_h256(q, k, v, o, B, Sq, Sk, N, K, causal, window, q_offset, k_len,
                            scale, stream);
  return (int)cudaErrorInvalidValue;
}

// The attributes of the instance (H, Hv), as kernel_attrs.cuh reports them
// (out[6]: registers, local bytes, static shared bytes, the most threads a
// block, the dynamic shared bytes its launch passes and the opt-in), after
// the opt-in its launch makes. The (256, 256) instance's registers are the
// count at launch (384 threads, one block an SM); setmaxnreg moves its
// consumers to 232 and its producer to 40.
extern "C" int flash_attention_sm90_attrs(int H, int Hv, long long* out) {
  if (H == 64 && Hv == 64) return (int)instance_attrs<64, 64>(out);
  if (H == 128 && Hv == 128) return (int)instance_attrs<128, 128>(out);
  if (H == 192 && Hv == 128) return (int)instance_attrs<192, 128>(out);
  if (H == 112 && Hv == 112) return (int)instance_attrs<112, 112>(out);
  if (H != 256 || Hv != 256) return (int)cudaErrorInvalidValue;
  const cudaError_t e = opt_in_h256();
  if (e != cudaSuccess) return (int)e;
  return (int)kernel_attrs(flash_sm90_h256_kernel, H256::SMEM, out);
}
