// MLA's absorbed decode (DeepSeek-V2's multi-head latent attention) over
// the compressed cache, forward only, for Hopper (sm_90a): both products on
// the tensor cores, fp32-accurate.
//
// Replaces no TPU kernel: the reference computes this step in jnp einsums,
// outside any Pallas kernel (repro/models/attention.py:mla_forward, its
// decode branch). It is added because the port's decode attention kernel
// (flash_attention_decode.cu) cannot serve it: one latent row is the key of
// all 16 heads, 576 wide (no multiple of its 32 lanes x 8 bf16), and its
// first 512 values are also the value, so K and V differ in width; and the
// port's fallback for it, promoting the bf16 cache to q's fp32 each step,
// would copy 75 MB a layer and step.
//
//   ctx[b, n] = softmax_j(scale * q[b, n] . kv[b, j]) kv[b, j, :L]
//
// over j <= q_offset (every row of the cache once q_offset >= S), where
// kv[b, j] is c_kv[b, j] (L = 512, the latent rank) joined to k_rope[b, j]
// (R = 64), read where each lies: two pointers, each with its batch and row
// strides in elements, so the cache's two leaves may be views of one (B, S,
// 576) buffer or two buffers. q (B, 1, N, L + R) is fp32 (q_lat = q_nope .
// W_uk joined to q_rope, both fp32 as in the reference, never rounded to the
// cache's dtype), the cache bf16 or fp32, ctx (B, 1, N, L) fp32. The
// reference's constants: masked scores are -1e30, running maxima start
// there, the output is acc / max(l, 1e-30).
//
// What bounds it on an H100: bytes. At (8 sequences, 16 heads, 4096 keys)
// the bf16 cache is 37.7 MB, 0.011435 ms at 3.35 TB/s. Its 2 (576 + 512)
// flops a key and head take 0.017028 ms on the fp32 cores (67 TFLOP/s),
// which bound the first, SIMT form of this kernel; on the tensor cores,
// with fp32's accuracy, a few microseconds. At serving's short ranges
// (1-128 keys) launch latency, the first rows' arrival and the fill of the
// card set the time.
//
// Both products run on the tensor cores and keep q and p in fp32:
// - bf16 cache (the serving path): wgmma m64n48k16 in bf16, both operands
//   in shared memory. A is the cache, exact in bf16: keys as M for S^T = K
//   q^T, value columns as M (A transposed, the same staged rows) for ctx^T
//   = V^T P^T. B is q's or p's three bf16 parts side by side in N (3 x 16
//   heads): x = x1 + x2 + x3 within 2^-24 |x| (each part rounded to
//   nearest, the residues exact in fp32), so each A tile is read from
//   shared memory once for all three products, whose fp32 sums are added
//   smallest first. q is split once a block, p once an iteration.
//   mma.sync was tried first: m16n8k8 TF32 with the 16 heads as m16 (two
//   products a bf16 cache) took 0.0279 ms at 4096 keys, bound by issuing
//   its products; wgmma with the parts one after another in N = 16 was
//   bound by reading A from shared memory three times.
// - fp32 cache (the card-vs-CPU parities' fp32 models): wgmma reads fp32
//   only as TF32, truncated, and K-major only, so this instance runs
//   mma.sync m16n8k8 TF32 with every fp32 operand split into hi = tf32(x)
//   and lo = tf32(x - hi) (rounded as cvt.rna) and three products, lo hi +
//   hi lo + hi hi, as flash_attention.cu does.
//
// The design:
// - Pass 1, grid (splits x vsplits, B): block (s, vs, b) walks keys [s
//   chunk, (s + 1) chunk) of the visible range and writes value columns
//   [vs 512 / vsplits, (vs + 1) 512 / vsplits); the host's plan
//   (kernels/flash_attention._latent_plan) keeps the grid within one wave
//   of one block an SM: at B = 8, 16 splits of 256 keys at a full cache,
//   and at serving's 1-128 keys one or two splits of 64 keys with the
//   value columns across 4 blocks (32-64 blocks), each of which recomputes
//   S from rows that L2 holds. One block serves all N <= 16 heads, so each
//   cache row is read once per block.
// - bf16: iterations of 64 keys (wgmma's M). One thread stages them by TMA
//   in the cache's own dtype, 9 boxes of 64 keys x 64 columns (8 of c_kv, 1
//   of k_rope; one tensor map a leaf, so the leaves are read where they
//   lie) with the 128-byte swizzle that the descriptors read, into two
//   slots with an mbarrier each: the next 64 keys are in flight while these
//   are computed, and no thread spends registers or issue slots on the
//   copies (with 16-byte cp.async by every thread, the copies did not
//   overlap the products). Rows past the cache come in as zeros; rows past
//   the split are masked. The value operand is the first 512 columns of
//   the same staged rows. q's 16-byte loads go out before the first TMA,
//   which they would queue behind.
// - bf16, an iteration: warpgroup w takes depth [288 w, 288 w + 288) of
//   S^T (18 k16 steps), the two partials are added in warpgroup order
//   through shared memory, then scaled (as the reference scales s_nope +
//   s_rope) and masked past the split. The online softmax: warp w owns
//   heads 2 w and 2 w + 1, a lane two neighbouring keys; maxima and sums
//   by shuffles, (m, l) in registers; p's parts go to shared memory as
//   P^T's B operand (its column groups padded by 16 bytes, so a warp's
//   stores hit distinct banks). Then ctx^T += V^T P^T: warpgroup w owns
//   4 / vsplits of the block's 64-column m-tiles (a template argument:
//   ptxas serializes a wgmma in a branch), each with the three parts' sums
//   apart (72 fp32 registers a thread at vsplits 1), rescaled by the
//   iteration's alpha. Three barriers an iteration.
// - fp32: tiles of 32 keys through a two-stage cp.async ring (rows 584
//   floats apart, so the fragment loads hit distinct banks). Warp w owns
//   the 72 columns [72 w, 72 w + 72) of S (9 k-steps), holds q's split A
//   fragments for them in registers, and multiplies them into all 32 keys
//   (k-index t reads column 2t and t + 4 reads 2t + 1, in A and B alike);
//   the 8 partials are added in warp order, then scaled and masked. The
//   softmax as above, a lane a key; p's TF32 hi and lo in P V's A-fragment
//   order; warp w owns 64 / vsplits value columns of all 16 heads.
// - With one split, pass 1 writes ctx. Otherwise it writes the partials (m,
//   l, acc[L]) to the fp32 workspace and pass 2, one block per (b, head),
//   merges them in split order, as flash_attention_decode.cu does: every
//   order is fixed, so results repeat bit for bit.
#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "kernel_attrs.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kL = 512;               // c_kv columns: the latent rank, and v's width
constexpr int kR = 64;                // k_rope columns
constexpr int kD = kL + kR;           // a key row
constexpr int kHeads = 16;            // heads a block, at most
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVsplits = 4;        // 128 value columns a block at least
constexpr int kMaxSplits = 16;        // kernels/flash_attention.LATENT_MAX_SPLITS
constexpr int kChunkAlign = 32;       // a split's keys: a multiple of both kernels' tiles

static_assert(kHeads == 2 * kWarps, "softmax: a warp two heads");

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

// ---------------------------------------------------------------- bf16 cache

namespace wg {
constexpr int kIt = 64;                      // keys an iteration: wgmma's M
constexpr int kBox = kIt * 128;              // a TMA box: 64 keys x 64 columns, 128-byte rows
constexpr int kBoxes = kD / 64;              // a slot: 8 boxes of c_kv, 1 of k_rope
constexpr int kSlot = kBoxes * kBox;         // 64 keys
constexpr int kN = 3 * kHeads;               // wgmma's N: the three parts of 16 heads
// the B operands (q's parts, P's parts): K-major, no swizzle, core matrices
// of 8 rows x 8 columns (16 bytes a row), the 6 row groups 128 bytes
// apart, column groups kLbo (16 bytes more than 6 x 128, so that a warp's
// stores to 8 column groups fall on distinct banks)
constexpr int kLbo = 6 * 128 + 16;
constexpr int kQBytes = (kD / 8) * kLbo;     // q's parts, all 576 columns
constexpr int kPBytes = (kIt / 8) * kLbo;    // P's parts, 64 keys
constexpr int kRed = kIt + 4;                // partial-score row stride, floats
constexpr int kSteps = kD / 16 / 2;          // k16 steps of S a warpgroup
constexpr int Q_OFF = 2 * kSlot;
constexpr int P_OFF = Q_OFF + kQBytes;
constexpr int RED_OFF = P_OFF + kPBytes;
constexpr int A_OFF = RED_OFF + 2 * kHeads * kRed * 4;
constexpr int ML_OFF = A_OFF + kHeads * 4;
constexpr int BAR_OFF = ML_OFF + 2 * kHeads * 4;  // full[2]: slot 0, 1
constexpr int SMEM = BAR_OFF + 2 * 8 + 1024;      // + the 1 KB alignment of the swizzle
static_assert(kD % 64 == 0 && kHeads * kD % (4 * kThreads) == 0 && RED_OFF % 16 == 0,
              "layout");
static_assert(SMEM <= 232448, "shared memory over the 227 KB a block may have");

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets in 16-byte units, layout type (0 no swizzle, 1 128-byte
// swizzle) at bit 62. No swizzle, K-major: core matrices (8 rows x 16
// bytes) adjacent along K are lbo apart, along N sbo. 128-byte swizzle:
// rows of 128 bytes, 8-row groups sbo = 1024 apart; MN-major, 64-element
// groups along M lbo apart.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (swizzle << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
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

// One TMA box from a 3-D tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
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
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
}
// The accumulators are written asynchronously: pin every read of them after
// the wait.
__device__ __forceinline__ void fence_regs(float (&d)[kN / 2]) {
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define F4(a, i) "+f"(a[(i)]), "+f"(a[(i) + 1]), "+f"(a[(i) + 2]), "+f"(a[(i) + 3])

// d (64 x 48 fp32) += A (64 x 16 bf16, smem; TA: 0 K-major, 1 MN-major) *
// B (16 x 48 bf16, K-major smem). d[8 p + 4 j + c]: row 16 (warp % 4) +
// g + 8 (c / 2), column 16 p + 8 j + 2 t4 + c % 2: head 8 j + 2 t4 + c % 2
// of part p
template <int TA>
__device__ __forceinline__ void wgmma_n48(float (&d)[kN / 2], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, %27, 0;\n}\n"
      : F4(d, 0), F4(d, 4), F4(d, 8), F4(d, 12), F4(d, 16), F4(d, 20)
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

// x as three bf16 parts, largest first: x = x1 + x2 + x3 within 2^-24 |x|
__device__ __forceinline__ void split3(float x, __nv_bfloat16 (&part)[3]) {
  part[0] = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(part[0]);
  part[1] = __float2bfloat16_rn(r);
  part[2] = __float2bfloat16_rn(r - __bfloat162float(part[1]));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// byte offset of (row r, column c) of a B operand, r = 16 part + head
__device__ __forceinline__ int b_off(int r, int c) {
  return (c / 8) * kLbo + (r / 8) * 128 + (r % 8) * 16 + (c % 8) * 2;
}
}  // namespace wg

// MT: 64-column m-tiles of ctx^T a warpgroup, 4 / vsplits, a template
// argument so that no wgmma sits in a branch (ptxas serializes those)
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
latent_decode_wgmma(const __grid_constant__ CUtensorMap map_ckv,
                    const __grid_constant__ CUtensorMap map_kr, const float* __restrict__ q,
                    float* __restrict__ o, float* __restrict__ ws_acc,
                    float* __restrict__ ws_ml, int N, long long j_hi, float scale, int chunk,
                    int splits, int vsplits) {
  using namespace wg;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sb = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle repeats every 1 KB
  char* smem = reinterpret_cast<char*>(smem_raw) + (sb - smem_u32(smem_raw));
  char* pparts = smem + P_OFF;                                // P^T's B operand
  float* red = reinterpret_cast<float*>(smem + RED_OFF);      // [warpgroup][head][kRed]
  float* alpha_s = reinterpret_cast<float*>(smem + A_OFF);    // [head]
  float* ml_s = reinterpret_cast<float*>(smem + ML_OFF);      // [head][m, l]

  const int s = blockIdx.x / vsplits, vs = blockIdx.x % vsplits, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int wgi = warp / 4, wq = warp % 4;
  const long long s0 = (long long)s * chunk;
  const long long s1 = s0 + chunk - 1 < j_hi ? s0 + chunk - 1 : j_hi;
  const int n_it = (int)((s1 - s0) / kIt + 1);
  const uint32_t full = sb + BAR_OFF;  // slot k's at + 8 k

  // iteration it's 64 rows into slot it % 2 by one thread: the 8 boxes of
  // c_kv and the box of k_rope, 128-byte swizzled; rows past the cache come
  // in as zeros, rows past the split are masked
  auto load_it = [&](int it) {
    const uint32_t dst = sb + (it % 2) * kSlot, bar = full + 8 * (it % 2);
    const int row = (int)(s0 + (long long)it * kIt);
    mbar_arrive_expect_tx(bar, kSlot);
#pragma unroll
    for (int c = 0; c < kBoxes - 1; ++c) tma_load_3d(dst + c * kBox, &map_ckv, bar, 64 * c, row, b);
    tma_load_3d(dst + (kBoxes - 1) * kBox, &map_kr, bar, 0, row, b);
  };
  // q's three bf16 parts, S^T's B operand (heads past N are zeros): every
  // thread's 16-byte loads issued before the first is split (and before the
  // first rows, which they would queue behind), 4 columns to an 8-byte
  // store of each part
  {
    constexpr int kPer = kHeads * kD / 4 / kThreads;
    float4 x[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads, n = e / (kD / 4), c = 4 * (e % (kD / 4));
      x[i] = n < N ? *reinterpret_cast<const float4*>(q + ((long long)b * N + n) * kD + c)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    if (tid == 0) {
      mbar_init(full, 1);
      mbar_init(full + 8, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      load_it(0);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads, n = e / (kD / 4), c = 4 * (e % (kD / 4));
      const float v[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
      __nv_bfloat16 part[4][3];
#pragma unroll
      for (int j = 0; j < 4; ++j) split3(v[j], part[j]);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        *reinterpret_cast<uint2*>(smem + Q_OFF + b_off(kHeads * k + n, c)) =
            make_uint2(pack2(part[0][k], part[1][k]), pack2(part[2][k], part[3][k]));
    }
  }

  // this warpgroup's m-tiles of ctx^T: MT of the block's 2 MT; each holds
  // the three parts' sums apart until the end
  const int mt0 = (2 * vs + wgi) * MT;
  float acc[MT][kN / 2];
#pragma unroll
  for (int t = 0; t < MT; ++t) {
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[t][i] = 0.0f;
  }
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};  // heads 2 warp + h, alike in every lane

  fence_proxy_async();  // q's parts, visible to wgmma
  __syncthreads();      // and the barriers' init
  for (int it = 0; it < n_it; ++it) {
    const long long base = s0 + (long long)it * kIt;
    // the other slot, the scores and P are free; then iteration it's rows
    __syncthreads();
    if (tid == 0 && it + 1 < n_it) load_it(it + 1);
    mbar_wait(full + 8 * (it % 2), (it / 2) & 1);
    const uint32_t slot = sb + (it % 2) * kSlot;

    // S^T (64 keys x 16 heads) over this warpgroup's depth, the three parts
    // of q side by side in N: k16 step k is bytes 32 (k % 4) .. + 31 of the
    // rows of box k / 4
    {
      float sd[kN / 2];
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) sd[i] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const int k = kSteps * wgi + kk;
        wgmma_n48<0>(sd, desc(slot + (k / 4) * kBox + 32 * (k % 4), 16, 1024, 1),
                     desc(sb + Q_OFF + 2 * k * kLbo, kLbo, 128, 0));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sd);
      // the parts' sums, smallest first: key 16 wq + g + 8 (c / 2), head
      // 8 j + 2 t4 + c % 2 of sd[8 p + 4 j + c]
      float* rw = red + wgi * kHeads * kRed;
      const int key = 16 * wq + g;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int n = 8 * (i / 4) + 2 * t4 + i % 2;
        rw[n * kRed + key + 8 * ((i / 2) % 2)] = (sd[16 + i] + sd[8 + i]) + sd[i];
      }
    }
    __syncthreads();

    // the warpgroups' sums in order, scaled, masked past the split; the
    // online softmax of heads 2 warp + h, keys 2 lane and 2 lane + 1
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = 2 * warp + h;
      const float2 s0p = *reinterpret_cast<const float2*>(red + n * kRed + 2 * lane);
      const float2 s1p = *reinterpret_cast<const float2*>(red + (kHeads + n) * kRed + 2 * lane);
      const float x0 = base + 2 * lane <= s1 ? (s0p.x + s1p.x) * scale : kNeg;
      const float x1 = base + 2 * lane + 1 <= s1 ? (s0p.y + s1p.y) * scale : kNeg;
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[h], mx);
      const float p0 = exp2f((x0 - m_new) * kLog2e), p1 = exp2f((x1 - m_new) * kLog2e);
      float ps = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(kFull, ps, off);
      const float a = exp2f((m[h] - m_new) * kLog2e);
      l[h] = l[h] * a + ps;
      m[h] = m_new;
      if (lane == 0) alpha_s[n] = a;
      __nv_bfloat16 q0[3], q1[3];
      split3(p0, q0);
      split3(p1, q1);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        *reinterpret_cast<uint32_t*>(pparts + b_off(kHeads * k + n, 2 * lane)) =
            pack2(q0[k], q1[k]);
    }
    fence_proxy_async();
    __syncthreads();

    // ctx^T += V^T P^T, P's three parts side by side in N: m-tile t is value
    // columns 64 (mt0 + t) .. + 63, box mt0 + t of the slot (A transposed);
    // k16 step kk is keys 16 kk .. + 15, its rows 16 kk .. + 15.
    // acc[t][8 p + 4 j + c]: column 64 (mt0 + t) + 16 wq + g + 8 (c / 2),
    // head 8 j + 2 t4 + c % 2 of part p
    {
      const float al[4] = {alpha_s[2 * t4], alpha_s[2 * t4 + 1], alpha_s[8 + 2 * t4],
                           alpha_s[9 + 2 * t4]};
#pragma unroll
      for (int t = 0; t < MT; ++t) {
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) acc[t][i] *= al[2 * ((i % 8) / 4) + i % 2];
      }
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < MT; ++t) {
#pragma unroll
        for (int kk = 0; kk < kIt / 16; ++kk)
          wgmma_n48<1>(acc[t], desc(slot + (mt0 + t) * kBox + 2048 * kk, kBox, 1024, 1),
                       desc(sb + P_OFF + 2 * kk * kLbo, kLbo, 128, 0));
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int t = 0; t < MT; ++t) fence_regs(acc[t]);
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ml_s[2 * (2 * warp + h)] = m[h];
      ml_s[2 * (2 * warp + h) + 1] = l[h];
    }
  }
  __syncthreads();

  // ctx (one split) or the partials: the parts' sums, smallest first
#pragma unroll
  for (int t = 0; t < MT; ++t) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int head = 8 * (i / 4) + 2 * t4 + i % 2;
      const int col = 64 * (mt0 + t) + 16 * wq + g + 8 * ((i / 2) % 2);
      const float x = (acc[t][16 + i] + acc[t][8 + i]) + acc[t][i];
      if (head < N) {
        const long long row = (long long)b * N + head;
        if (splits == 1)
          o[row * kL + col] = x / fmaxf(ml_s[2 * head + 1], 1e-30f);
        else
          ws_acc[(row * splits + s) * kL + col] = x;
      }
    }
  }
  if (splits > 1 && vs == 0 && tid < N) {
    const long long row = (long long)b * N + tid;
    ws_ml[(row * splits + s) * 2] = ml_s[2 * tid];
    ws_ml[(row * splits + s) * 2 + 1] = ml_s[2 * tid + 1];
  }
}

// ---------------------------------------------------------------- fp32 cache

namespace f32 {
constexpr int kT = 32;                // keys a tile
constexpr int kRS = kD + 8;           // a staged row, floats
constexpr int kKS = kD / 8 / kWarps;  // k-steps of S a warp: 9
constexpr int kRed = 40;              // partial-score row stride: lanes on distinct banks
constexpr int kPFrag = (kT / 8) * 32 * 4;  // floats of P's A fragments for a tile, hi or lo
constexpr int kNT = kL / kWarps / 8;  // n8 tiles of value columns a warp at vsplits 1
constexpr int kU = kD / 4;            // 16-byte units of a row
constexpr int kTile = kT * kRS;       // floats
constexpr int RED_OFF = 2 * kTile * 4;  // bytes: two stages
constexpr int P_OFF = RED_OFF + kWarps * kHeads * kRed * 4;
constexpr int A_OFF = P_OFF + 2 * kPFrag * 4;
constexpr int ML_OFF = A_OFF + kHeads * 4;
constexpr int SMEM = ML_OFF + 2 * kHeads * 4;
static_assert(kD % (8 * kWarps) == 0 && kNT % kMaxVsplits == 0 && kT * kU % kThreads == 0,
              "layout");
static_assert(SMEM <= 232448, "shared memory over the 227 KB a block may have");

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero): add half of the 13 dropped bits' range and clear them.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32; x - hi is exact in fp32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d (16 x 8 fp32) += a (16 x 8 tf32, row) * b (8 x 8 tf32, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b with a given as (hi, lo) and b split here: lo hi + hi lo + hi hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}
}  // namespace f32

__global__ void __launch_bounds__(kThreads, 1)
latent_decode_mma(const float* __restrict__ q, const float* __restrict__ ckv,
                  const float* __restrict__ krope, float* __restrict__ o,
                  float* __restrict__ ws_acc, float* __restrict__ ws_ml, int N,
                  long long ckv_bs, long long ckv_rs, long long kr_bs, long long kr_rs,
                  long long j_hi, float scale, int chunk, int splits, int vsplits) {
  using namespace f32;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* ring = reinterpret_cast<float*>(smem);                  // [stage][key][kRS]
  float* red = reinterpret_cast<float*>(smem + RED_OFF);         // [warp][head][kRed]
  float* pfr = reinterpret_cast<float*>(smem + P_OFF);           // [hi, lo][k-step][lane][4]
  float* alpha_s = reinterpret_cast<float*>(smem + A_OFF);       // [head]
  float* ml_s = reinterpret_cast<float*>(smem + ML_OFF);         // [head][m, l]

  const int s = blockIdx.x / vsplits, vs = blockIdx.x % vsplits, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const long long s0 = (long long)s * chunk;
  const long long s1 = s0 + chunk - 1 < j_hi ? s0 + chunk - 1 : j_hi;
  const int n_tiles = (int)((s1 - s0) / kT + 1);
  const float* ckv_b = ckv + (long long)b * ckv_bs;
  const float* kr_b = krope + (long long)b * kr_bs;

  // tile rows base .. base + 31 into a stage, 16 bytes a copy; rows past
  // the split are zero-filled
  auto load_tile = [&](int stage, long long base) {
    float* dst = ring + stage * kTile;
#pragma unroll
    for (int i = 0; i < kT * kU / kThreads; ++i) {
      const int e = tid + i * kThreads, j = e / kU, u = e % kU;
      const long long kp = base + j;
      const bool ok = kp <= s1;
      const float* src = ckv_b;
      if (ok) src = u < kL / 4 ? ckv_b + kp * ckv_rs + 4 * u : kr_b + kp * kr_rs + 4 * u - kL;
      cp_async16(smem_u32(dst + j * kRS + 4 * u), src, ok);
    }
  };
  load_tile(0, s0);
  cp_async_commit();

  // q's A fragments for this warp's k-steps, split once: a0 (head g,
  // column 2 t4), a1 (g + 8, 2 t4), a2 (g, 2 t4 + 1), a3 (g + 8, 2 t4 + 1)
  // of k-step kk's 8 columns; heads past N are zeros
  uint32_t qh[kKS][4], ql[kKS][4];
  {
    const float* qb = q + (long long)b * N * kD;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      const int c = warp * kKS * 8 + 8 * kk + 2 * t4;
      float2 r0 = make_float2(0.0f, 0.0f), r1 = make_float2(0.0f, 0.0f);
      if (g < N) r0 = *reinterpret_cast<const float2*>(qb + g * kD + c);
      if (g + 8 < N) r1 = *reinterpret_cast<const float2*>(qb + (g + 8) * kD + c);
      split(r0.x, qh[kk][0], ql[kk][0]);
      split(r1.x, qh[kk][1], ql[kk][1]);
      split(r0.y, qh[kk][2], ql[kk][2]);
      split(r1.y, qh[kk][3], ql[kk][3]);
    }
  }

  // this warp's value columns: nt n8 tiles from c0
  const int nt = kNT / vsplits;
  const int c0 = vs * (kL / vsplits) + warp * 8 * nt;
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};  // heads 2 warp + h, alike in every lane

  for (int it = 0; it < n_tiles; ++it) {
    const long long base = s0 + (long long)it * kT;
    cp_async_wait<0>();  // this thread's copies of tile it have landed
    __syncthreads();  // everyone's; tile it - 1, the scores, P and alpha are free
    if (it + 1 < n_tiles) load_tile((it + 1) % 2, base + kT);
    cp_async_commit();
    const float* tile = ring + (it % 2) * kTile;

    // partial scores over this warp's columns; sp[j]: heads g, g + 8 and
    // keys 8 j + 2 t4, + 1
    {
      float sp[kT / 8][4];
#pragma unroll
      for (int j = 0; j < kT / 8; ++j) sp[j][0] = sp[j][1] = sp[j][2] = sp[j][3] = 0.0f;
      const float* kr = tile + g * kRS + warp * kKS * 8 + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
#pragma unroll
        for (int j = 0; j < kT / 8; ++j) {
          const float2 x = *reinterpret_cast<const float2*>(kr + 8 * j * kRS + 8 * kk);
          mma3(sp[j], qh[kk], ql[kk], x.x, x.y);
        }
      }
      float* rw = red + warp * kHeads * kRed;
#pragma unroll
      for (int j = 0; j < kT / 8; ++j) {
        *reinterpret_cast<float2*>(rw + g * kRed + 8 * j + 2 * t4) =
            make_float2(sp[j][0], sp[j][1]);
        *reinterpret_cast<float2*>(rw + (g + 8) * kRed + 8 * j + 2 * t4) =
            make_float2(sp[j][2], sp[j][3]);
      }
    }
    __syncthreads();

    // the warps' sums in warp order, scaled, masked past the split; the
    // online softmax of heads 2 warp + h, a lane a key
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = 2 * warp + h;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[(w * kHeads + n) * kRed + lane];
      const float x = base + lane <= s1 ? sum * scale : kNeg;
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[h], mx);
      const float p = exp2f((x - m_new) * kLog2e);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(kFull, ps, off);
      const float a = exp2f((m[h] - m_new) * kLog2e);
      l[h] = l[h] * a + ps;
      m[h] = m_new;
      if (lane == 0) alpha_s[n] = a;
      // key `lane` of head n in P V's A fragment: k-step lane / 8, lane
      // 4 (n % 8) + (lane % 8) / 2, register n / 8 + 2 (lane % 2)
      uint32_t hi, lo;
      split(p, hi, lo);
      const int slot =
          ((lane / 8) * 32 + 4 * (n % 8) + (lane % 8) / 2) * 4 + n / 8 + 2 * (lane % 2);
      pfr[slot] = __uint_as_float(hi);
      pfr[kPFrag + slot] = __uint_as_float(lo);
    }
    __syncthreads();

    // ctx = ctx alpha + P V over the tile's 4 k-steps of 8 keys
    const float a0 = alpha_s[g], a1 = alpha_s[g + 8];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      if (n < nt) {
        acc[n][0] *= a0;
        acc[n][1] *= a0;
        acc[n][2] *= a1;
        acc[n][3] *= a1;
      }
    }
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
      const float4 h4 = *reinterpret_cast<const float4*>(pfr + (j * 32 + lane) * 4);
      const float4 l4 = *reinterpret_cast<const float4*>(pfr + kPFrag + (j * 32 + lane) * 4);
      const uint32_t ph[4] = {__float_as_uint(h4.x), __float_as_uint(h4.y),
                              __float_as_uint(h4.z), __float_as_uint(h4.w)};
      const uint32_t pl[4] = {__float_as_uint(l4.x), __float_as_uint(l4.y),
                              __float_as_uint(l4.z), __float_as_uint(l4.w)};
      const float* vr = tile + (8 * j + 2 * t4) * kRS + c0 + g;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        if (n < nt) mma3(acc[n], ph, pl, vr[8 * n], vr[kRS + 8 * n]);
      }
    }
  }
  cp_async_wait<0>();

  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ml_s[2 * (2 * warp + h)] = m[h];
      ml_s[2 * (2 * warp + h) + 1] = l[h];
    }
  }
  __syncthreads();

  // ctx (one split) or the partials: acc[n][2 r], [2 r + 1] are head
  // g + 8 r, columns c0 + 8 n + 2 t4, + 1
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int head = g + 8 * r;
    if (head >= N) continue;
    const long long row = (long long)b * N + head;
    const float denom = fmaxf(ml_s[2 * head + 1], 1e-30f);
    float* dst = splits == 1 ? o + row * kL : ws_acc + (row * splits + s) * kL;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      if (n < nt) {
        const float2 x = splits == 1 ? make_float2(acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom)
                                     : make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
        *reinterpret_cast<float2*>(dst + c0 + 8 * n + 2 * t4) = x;
      }
    }
  }
  if (splits > 1 && vs == 0 && tid < N) {
    const long long row = (long long)b * N + tid;
    ws_ml[(row * splits + s) * 2] = ml_s[2 * tid];
    ws_ml[(row * splits + s) * 2 + 1] = ml_s[2 * tid + 1];
  }
}

// ---------------------------------------------------------------- merge

// one block per (b, head), 4 columns a thread: the splits' partials merged
// in split order, every split's loads issued before the first is used
constexpr int kMergeThreads = kL / 4;
__global__ void __launch_bounds__(kMergeThreads)
latent_decode_merge(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
                    float* __restrict__ o, int splits) {
  const long long row = blockIdx.x;
  const int c = 4 * threadIdx.x;
  float2 ml[kMaxSplits];
  float4 part[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    if (s < splits) {
      ml[s] = reinterpret_cast<const float2*>(ws_ml)[row * splits + s];
      part[s] = *reinterpret_cast<const float4*>(ws_acc + (row * splits + s) * kL + c);
    }
  }
  float m_star = kNeg;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    if (s < splits) m_star = fmaxf(m_star, ml[s].x);
  float lsum = 0.0f;
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    if (s < splits) {
      const float f = exp2f((ml[s].x - m_star) * kLog2e);
      lsum += ml[s].y * f;
      a.x += part[s].x * f;
      a.y += part[s].y * f;
      a.z += part[s].z * f;
      a.w += part[s].w * f;
    }
  }
  const float denom = fmaxf(lsum, 1e-30f);
  *reinterpret_cast<float4*>(o + row * kL + c) =
      make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom);
}

// the merge pass after a split pass of more than one split
cudaError_t merge(float* ws, void* o, int B, int N, int splits, cudaStream_t stream) {
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long long rows = (long long)B * N;
  latent_decode_merge<<<(unsigned)rows, kMergeThreads, 0, stream>>>(
      ws, ws + rows * splits * kL, static_cast<float*>(o), splits);
  return cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A 3-D map over a (B, S, cols) bf16 leaf with batch and row strides in
// elements, as (cols, S, B): boxes of 64 columns x 64 rows x 1 sequence
// with the 128-byte swizzle; rows past S come back as zeros.
cudaError_t encode_leaf(CUtensorMap* map, const void* base, int cols, int S, int B,
                        long long bs, long long rs) {
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
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)rs * 2, (cuuint64_t)(B > 1 ? bs : S * rs) * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)wg::kIt, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// above 48 KB needs the opt-in: once per instance, before its first launch
// (and before its attributes are read)
template <int MT>
cudaError_t opt_in_wgmma() {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        latent_decode_wgmma<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  return cudaSuccess;
}

cudaError_t opt_in_mma() {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        latent_decode_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, f32::SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  return cudaSuccess;
}

template <int MT>
cudaError_t launch_wgmma(const void* q, const void* ckv, const void* krope, void* o, float* ws,
                         int B, int S, int N, long long ckv_bs, long long ckv_rs,
                         long long kr_bs, long long kr_rs, long long j_hi, float scale,
                         int chunk, int splits, int vsplits, cudaStream_t stream) {
  cudaError_t e = opt_in_wgmma<MT>();
  if (e != cudaSuccess) return e;
  CUtensorMap map_ckv, map_kr;
  e = encode_leaf(&map_ckv, ckv, kL, S, B, ckv_bs, ckv_rs);
  if (e == cudaSuccess) e = encode_leaf(&map_kr, krope, kR, S, B, kr_bs, kr_rs);
  if (e != cudaSuccess) return e;
  float* ws_ml = ws == nullptr ? nullptr : ws + (long long)B * N * splits * kL;
  latent_decode_wgmma<MT><<<dim3((unsigned)(splits * vsplits), (unsigned)B), kThreads, wg::SMEM,
                            stream>>>(map_ckv, map_kr, static_cast<const float*>(q),
                                      static_cast<float*>(o), ws, ws_ml, N, j_hi, scale, chunk,
                                      splits, vsplits);
  return merge(ws, o, B, N, splits, stream);
}

cudaError_t launch_mma(const void* q, const void* ckv, const void* krope, void* o, float* ws,
                       int B, int N, long long ckv_bs, long long ckv_rs, long long kr_bs,
                       long long kr_rs, long long j_hi, float scale, int chunk, int splits,
                       int vsplits, cudaStream_t stream) {
  const cudaError_t e = opt_in_mma();
  if (e != cudaSuccess) return e;
  float* ws_ml = ws == nullptr ? nullptr : ws + (long long)B * N * splits * kL;
  latent_decode_mma<<<dim3((unsigned)(splits * vsplits), (unsigned)B), kThreads, f32::SMEM,
                       stream>>>(static_cast<const float*>(q), static_cast<const float*>(ckv),
                                 static_cast<const float*>(krope), static_cast<float*>(o), ws,
                                 ws_ml, N, ckv_bs, ckv_rs, kr_bs, kr_rs, j_hi, scale, chunk,
                                 splits, vsplits);
  return merge(ws, o, B, N, splits, stream);
}

template <int MT>
cudaError_t wgmma_attrs(long long* out) {
  const cudaError_t e = opt_in_wgmma<MT>();
  if (e != cudaSuccess) return e;
  return kernel_attrs(latent_decode_wgmma<MT>, wg::SMEM, out);
}

}  // namespace

// q (B, 1, N, 576) fp32 contiguous, 16-byte aligned; c_kv (B, S, 512) and
// k_rope (B, S, 64) in the cache's dtype (is_bf16: 1 for bf16, 0 for
// fp32), unit stride along the last axis, batch and row strides in
// elements, 16-byte aligned rows; o (B, 1, N, 512) fp32. 1 <= N <= 16, S >=
// 1, q_offset >= 0. chunk (a multiple of 32) and splits (at most 16) cover
// [0, min(q_offset, S - 1)] with no split empty; vsplits (1, 2 or 4)
// blocks share a split's 512 value columns. ws: fp32 workspace of B * N *
// splits * (512 + 2) floats when splits > 1, else unused. Both passes go
// on `stream`.
extern "C" int flash_attention_latent_decode(const void* q, const void* ckv, const void* krope,
                                             void* o, void* ws, int B, int S, int N,
                                             long long ckv_bs, long long ckv_rs,
                                             long long kr_bs, long long kr_rs, int is_bf16,
                                             long long q_offset, float scale, int chunk,
                                             int splits, int vsplits, cudaStream_t stream) {
  if (B == 0) return (int)cudaGetLastError();
  if (N < 1 || N > kHeads || S < 1 || q_offset < 0 || splits < 1 || splits > kMaxSplits ||
      chunk <= 0 || chunk % kChunkAlign != 0 || (splits > 1 && ws == nullptr) ||
      vsplits < 1 || vsplits > kMaxVsplits || kMaxVsplits % vsplits != 0)
    return (int)cudaErrorInvalidValue;
  const long long j_hi = q_offset < S - 1 ? q_offset : (long long)S - 1;
  if ((long long)(splits - 1) * chunk > j_hi || (long long)splits * chunk <= j_hi)
    return (int)cudaErrorInvalidValue;  // a split would be empty, or keys left over
  float* w = static_cast<float*>(ws);
  if (!is_bf16)
    return (int)launch_mma(q, ckv, krope, o, w, B, N, ckv_bs, ckv_rs, kr_bs, kr_rs, j_hi, scale,
                           chunk, splits, vsplits, stream);
  cudaError_t (*const run)(const void*, const void*, const void*, void*, float*, int, int, int,
                           long long, long long, long long, long long, long long, float, int,
                           int, int, cudaStream_t) =
      vsplits == 1 ? &launch_wgmma<4> : vsplits == 2 ? &launch_wgmma<2> : &launch_wgmma<1>;
  return (int)run(q, ckv, krope, o, w, B, S, N, ckv_bs, ckv_rs, kr_bs, kr_rs, j_hi, scale, chunk,
                  splits, vsplits, stream);
}

// The attributes of one kernel instance, as kernel_attrs.cuh reports them
// (out[6]: registers, local bytes, static shared bytes, the most threads a
// block, the dynamic shared bytes its launch passes and the opt-in), after
// the opt-in its launch makes: kernel 0 the wgmma split pass for a bf16
// cache at mt value-column m-tiles (4, 2 or 1: vsplits 1, 2 or 4), 1 the
// mma.sync split pass for an fp32 cache, 2 the merge pass.
extern "C" int flash_attention_latent_decode_attrs(int kernel, int mt, long long* out) {
  cudaError_t e;
  switch (kernel) {
    case 0:
      return (int)(mt == 4 ? wgmma_attrs<4>(out)
                   : mt == 2 ? wgmma_attrs<2>(out)
                   : mt == 1 ? wgmma_attrs<1>(out) : cudaErrorInvalidValue);
    case 1:
      if ((e = opt_in_mma()) != cudaSuccess) return (int)e;
      return (int)kernel_attrs(latent_decode_mma, f32::SMEM, out);
    case 2:
      return (int)kernel_attrs(latent_decode_merge, 0, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
