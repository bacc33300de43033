// Prefill attention: causal or sliding-window masked softmax(q k^T / sqrt(D)) v
// with grouped-query heads, by an online softmax over kv tiles, on Hopper's
// tensor cores, fed by TMA.
//
// Replaces the Pallas kernel `flash_attention_kernel` / `flash_attention_call`
// of src/repro/kernels/flash_attention.py (pallas_call at :106).  On the TPU
// the kv axis is a sequential grid dimension that carries the running max,
// denominator and accumulator in VMEM scratch from one grid step to the next.
// Here blocks run in parallel and in no order, so the kv loop lives inside
// the block and the running state lives in registers.
//
// Layout: q and out are [B, Sq, H, D], k and v [B, Sk, KVH, D], read through
// their strides (the last dimension contiguous), so the model's projections
// need no transposes.  Query head h reads kv head h / (H / KVH).  float32 or
// bfloat16 in, float32 accumulation, out in the input type.
//
// Semantics kept from the reference kernel: masked scores are the finite
// -1e30 (so a row whose first visited tile holds no visible key is wiped by
// alpha = exp(-1e30 - m) once one arrives), and the final division is by
// max(l, 1e-30).  Keys past Sk (the ragged last tile, which TMA fills with
// zeros) are not part of the function at all: they are masked to -inf, never
// scored, so their probability is exactly 0.  Neither Sq nor Sk has to divide
// the tile size.
//
// What bounds it on this card: at llama3.2-3b's prefill (B = 4, S = 512,
// H = 24, D = 128, causal) the function needs 4 B H D (S(S+1)/2) = 6.5 GFLOP
// and moves 67 MB (float32).  In bfloat16 on the tensor cores (989 TFLOP/s)
// that is ~7 us of operations against ~10 us of bytes: bound by bytes.  In
// float32 the products run as split TF32 (below), three TF32 tensor-core
// products each (495 TFLOP/s): ~39 us against ~20 us of bytes, bound by
// operations.
//
// Design: one block per (b, h, q tile), the heavy causal q tiles (the last
// ones) launched first; kv tiles wholly above the causal diagonal or before
// the window are never visited.  Warp-specialised roles meet at mbarriers:
//  * the producer (one thread) loads the q tile once and the K and V tiles
//    through a ring of stages in shared memory by TMA; "full" barriers count
//    TMA's bytes, "empty" ones the consumers' releases, so copies run ahead
//    of the products;
//  * the tensor maps describe the strided [B, S, heads, D] tensors as they
//    are (4-D, innermost D), one box per 32/64/128-byte slice of a row, in
//    the matching TMA swizzle, so no tensor is transposed in device memory.
//    They are encoded on the host for every call (cuTensorMapEncodeTiled,
//    reached through cudaGetDriverEntryPoint: no -lcuda) and passed as
//    __grid_constant__ parameters; the wrapper's call_ms includes that cost;
//  * bfloat16: two consumer warpgroups (128 query rows; 16 a warp) share
//    each 64-key tile of a two-stage ring, and a producer warp follows them.
//    S = Q K^T is `wgmma.m64n64k16` with Q and K in shared memory (K-major,
//    as stored); P is rounded to bfloat16 in registers, where the
//    accumulator's layout is already the A operand's, and O += P V is
//    `wgmma.m64nDk16` with V read through the transpose bit.  A warpgroup
//    skips the tiles none of its rows sees.  This is less precise than the
//    reference, which computes P V in float32: each weight is off by up to
//    2^-9 relative, and l is summed from the unrounded P, so the weights no
//    longer sum to exactly l.  On outputs of O(1) that is a few 1e-3, under
//    the output's own bfloat16 rounding, but a value near a rounding edge may
//    round to the other neighbour than the plain version's (one ulp: 2^-7 on
//    [2, 4), 2^-6 on [4, 8));
//  * float32: one TF32 product keeps ~11 bits of mantissa (~5e-4 off in the
//    output at D = 128, against a tolerance of 2e-5), so each operand is split
//    x = hi + lo (hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi)) and each
//    product is lo*hi + hi*lo + hi*hi on `wgmma` TF32 with float32
//    accumulation (lo*lo, 2^-22 relative, dropped).  wgmma takes TF32 B
//    operands only K-major from shared memory: K is (as stored), V is not.
//    So a helper warpgroup splits each 32-key tile as TMA lands it, on the
//    CUDA cores, while the consumer warpgroup (64 query rows) runs the
//    previous tile's products: K's hi half over K and its lo half beside it;
//    V transposed to V^T [D][keys] through registers, hi over V, lo beside
//    it, with the keys of each group of 8 reordered so that the score
//    accumulator, split in registers, is the A operand of P V.  The
//    consumers split Q once (hi in place, lo kept in registers as the A
//    operand of Q_lo K_hi).  A stage is 4 tiles (64 KB at D = 128); three
//    stages and Q fill 224 KB: one block a SM.  Helper thread 0 is the
//    producer: it loads tile i - 1 + 3 once the consumers release tile i - 1,
//    two tiles ahead of the helpers, off the consumers' path;
//  * the softmax runs in the log2 domain (scores times scale * log2(e),
//    `ex2.approx`), masks only the tiles that reach past Sk, the diagonal or
//    the window, and every product-sum outside the tensor cores is an
//    explicit fmaf (the library is built with -fmad=false).
// Head dims 16 to 256.  bfloat16 at D = 256 keeps this geometry (Q 64 KB, two
// stages of 64 KB); its P V is two products of 128 columns.  float32 at D =
// 256 does not fit it and runs flash_attention_wide_kernel (below).
// A barrier wait that does not complete within ~2 s traps (a launch error in
// place of a hung card).

#include <cuda.h>  // CUtensorMap and the encoder's types; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

using repro::ensure_smem;
using repro::kMaxDevices;
using repro::split_tf32;

// Shared-memory geometry of one instance.  A tile of R rows of D elements is
// stored as kChunks slices of kSW bytes a row ([R][kSW] each, 1024-byte
// aligned), in the TMA swizzle of that width (32, 64 or 128 bytes).
template <typename T, int D>
struct Geo {
  static constexpr int kEs = (int)sizeof(T);
  static constexpr bool kF32 = kEs == 4;
  static constexpr int kWG = kF32 ? 1 : 2;        // consumer warpgroups, 64 query rows each
  static constexpr int kBQ = 64 * kWG;            // query rows per block
  static constexpr int kConsumers = 128 * kWG;    // warps 0 .. 4 kWG - 1
  static constexpr int kHelpers = kF32 ? 128 : 0;  // float32: the warpgroup that splits
  // bfloat16: a producer warp after the consumers; float32: helper thread 0
  static constexpr int kProducerWarp = kF32 ? -1 : kConsumers / 32;
  static constexpr int kThreads = kConsumers + kHelpers + (kF32 ? 0 : 32);
  static constexpr int kStages = kF32 ? 3 : 2;  // K/V ring depth
  static constexpr int kBK = kF32 ? 32 : 64;  // keys per kv tile
  static constexpr int kRowBytes = D * kEs;
  static constexpr int kSW = kRowBytes < 128 ? kRowBytes : 128;
  static constexpr int kSWE = kSW / kEs;  // elements of a slice row
  static constexpr int kChunks = kRowBytes / kSW;
  static constexpr int kQChunk = kBQ * kSW;
  static constexpr int kKVChunk = kBK * kSW;
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKVBytes = kChunks * kKVChunk;  // one K or V tile
  static constexpr int kLoadBytes = 2 * kKVBytes;      // what TMA brings into a stage
  // float32 only: each stage also holds K's lo half and V^T's lo half (the
  // helpers write K's hi half over K, and V^T's hi half over V: [D][kBK]
  // keys, 128-byte rows, the size of V)
  static constexpr int kKloInStage = kLoadBytes;
  static constexpr int kVtloInStage = kKloInStage + (kF32 ? kKVBytes : 0);
  static constexpr int kStageBytes = kVtloInStage + (kF32 ? kKVBytes : 0);
  static constexpr int kRingOffset = kQBytes;
  static constexpr int kBarOffset = kRingOffset + kStages * kStageBytes;
  static constexpr int kBarriers = 1 + (kF32 ? 3 : 2) * kStages;
  static constexpr int kSmem = kBarOffset + 8 * kBarriers + 1024;  // + alignment slack
  static_assert(kQChunk % 1024 == 0 && kKVChunk % 1024 == 0, "tiles stay 1024-byte aligned");
  static_assert(!kF32 || (kBK * 4 == 128 && kKVBytes == D * 128),
                "a float32 V^T row is one 128-byte swizzle row, V^T the size of V");
  static_assert(kSmem <= 232448, "fits the 227 KB a block can use");
};

// The TMA swizzle of width SW (CuTe's Swizzle<log2(SW/16), 4, 3>): in a
// 1024-byte-aligned slice of SW-byte rows, the 16-byte unit u of row r sits
// at unit u ^ row_bits(r), the row's address bits 7 and up.  For a row whose
// index is a multiple of 8 plus rr they are row_bits(rr).
template <int SW>
__device__ __forceinline__ uint32_t row_bits(int rr) {
  return (uint32_t)((rr * SW) >> 7) & (uint32_t)(SW / 16 - 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 32)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode of width SW.
template <int SW>
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t kLayout = SW == 128 ? 1 : (SW == 64 ? 2 : 3);
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (kLayout << 62);
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

// Tie the accumulators to this point of the program: wgmma writes them
// asynchronously, so no read may move above the wait (nor a write below
// the wgmma that reads them).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}

// S[64 x 64] += A[64 x 16] B[64 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[8][4], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O[64 x 16] += P[64 x 16] V[16 x 16]: P bf16 in registers, V N-major in shared
// memory (the transpose bit)
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[2][4],
                                                 const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 32] += P[64 x 16] V[16 x 32]: P bf16 in registers, V N-major in shared
// memory (the transpose bit)
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[4][4],
                                                 const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 64] += P[64 x 16] V[16 x 64]: P bf16 in registers, V N-major in shared
// memory (the transpose bit)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[8][4],
                                                 const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 128] += P[64 x 16] V[16 x 128]: P bf16 in registers, V N-major in shared
// memory (the transpose bit)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[16][4],
                                                 const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------- wgmma (float32 as split TF32)

// S[64 x 32] += A[64 x 8] B[32 x 8]^T in TF32, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_m64n32k8_tf32_ss(float (&d)[4][4], uint64_t da,
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(1));
}

// O[64 x 16] += P[64 x 8] V[8 x 16] in TF32: P in registers, V^T K-major in shared memory
__device__ __forceinline__ void wgmma_m64n16k8_tf32_rs(float (&d)[2][4],
                                                      const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 32] += P[64 x 8] V[8 x 32] in TF32: P in registers, V^T K-major in shared memory
__device__ __forceinline__ void wgmma_m64n32k8_tf32_rs(float (&d)[4][4],
                                                      const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 64] += P[64 x 8] V[8 x 64] in TF32: P in registers, V^T K-major in shared memory
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[8][4],
                                                      const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 128] += P[64 x 8] V[8 x 128] in TF32: P in registers, V^T K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&d)[16][4],
                                                      const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// O[64 x D] += P[64 x 16] V[16 x D], V's 16 key rows at `v` in slices of SW
// bytes a row, `chunk` bytes apart.  D = 256 is two products of 128 columns,
// the second reading slices 2 and 3 into the accumulator's columns 128..255.
template <int D, int SW>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 8][4], const uint32_t (&a)[4],
                                         uint32_t v, uint32_t chunk) {
  const uint64_t db = gmma_desc<SW>(v, chunk, 8 * SW);
  if constexpr (D == 16) wgmma_m64n16k16_rs(o, a, db);
  if constexpr (D == 32) wgmma_m64n32k16_rs(o, a, db);
  if constexpr (D == 64) wgmma_m64n64k16_rs(o, a, db);
  if constexpr (D == 128) wgmma_m64n128k16_rs(o, a, db);
  if constexpr (D == 256) {
    wgmma_m64n128k16_rs(*reinterpret_cast<float(*)[16][4]>(&o[0]), a, db);
    wgmma_m64n128k16_rs(*reinterpret_cast<float(*)[16][4]>(&o[16]), a,
                        gmma_desc<SW>(v + 2 * chunk, chunk, 8 * SW));
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- split TF32 (float32)

template <int D>
__device__ __forceinline__ void wgmma_pv_tf32(float (&o)[D / 8][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  if constexpr (D == 16) wgmma_m64n16k8_tf32_rs(o, a, db);
  if constexpr (D == 32) wgmma_m64n32k8_tf32_rs(o, a, db);
  if constexpr (D == 64) wgmma_m64n64k8_tf32_rs(o, a, db);
  if constexpr (D == 128) wgmma_m64n128k8_tf32_rs(o, a, db);
}

// Generic writes to shared memory made visible to the tensor cores'
// (async proxy) reads.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// hi = the tile rounded to TF32, in place; lo = the rest, at the same
// offsets in `lo` (16 bytes a thread at a time, all loads first: the layout
// is kept as is).  NT threads, tid < NT.
template <int kBytes, int NT>
__device__ __forceinline__ void split_tile(uint8_t* tile, uint8_t* lo, int tid) {
  constexpr int kPer = kBytes / (16 * NT);
  static_assert(kBytes % (16 * NT) == 0, "whole 16-byte units per thread");
  float4 x[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) x[p] = *reinterpret_cast<const float4*>(tile + 16 * (tid + NT * p));
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    uint4 h, l;
    split_tf32(x[p].x, h.x, l.x);
    split_tf32(x[p].y, h.y, l.y);
    split_tf32(x[p].z, h.z, l.z);
    split_tf32(x[p].w, h.w, l.w);
    *reinterpret_cast<uint4*>(tile + 16 * (tid + NT * p)) = h;
    *reinterpret_cast<uint4*>(lo + 16 * (tid + NT * p)) = l;
  }
}

// The V tile ([kBK = 32 keys][D], TMA's swizzled slices) transposed to
// V^T [D][32] in 128-byte swizzled rows and split: hi over V itself, lo into
// `vtlo`, with the keys of each group of 8 reordered so that key 2j + e is
// the (j + 4e)-th, the order in which the score accumulator, taken as the A
// operand, holds them.  The helper warpgroup reads all of V into registers,
// meets at its own barrier, then writes.  Lanes read neighbouring columns of
// one key row and write neighbouring rows of V^T: no bank conflicts.
template <int D, int NT>
__device__ __forceinline__ void split_vt(uint8_t* v, uint8_t* vtlo, int tid) {
  using G = Geo<float, D>;
  constexpr int kPer = D * 8 / NT;  // 16-byte units of V^T per thread
  static_assert(D * 8 % NT == 0, "whole units per thread");
  float x[kPer][4];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int idx = tid + NT * p;
    const int d = idx % D, u = idx / D;  // row d of V^T, its 16-byte unit u (4 keys)
    const int key0 = 8 * (u >> 1) + (u & 1);
    const uint32_t col = (uint32_t)(d % G::kSWE);
    const uint8_t* slice = v + (d / G::kSWE) * G::kKVChunk + (col & 3) * 4;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int key = key0 + 2 * m;
      const uint32_t unit = (col >> 2) ^ row_bits<G::kSW>(key & 7);
      x[p][m] = *reinterpret_cast<const float*>(slice + key * G::kSW + (unit << 4));
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");  // the helpers have read all of V
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int idx = tid + NT * p;
    const int d = idx % D, u = idx / D;
    uint4 h, l;
    split_tf32(x[p][0], h.x, l.x);
    split_tf32(x[p][1], h.y, l.y);
    split_tf32(x[p][2], h.z, l.z);
    split_tf32(x[p][3], h.w, l.w);
    const int off = d * 128 + (((u ^ d) & 7) << 4);
    *reinterpret_cast<uint4*>(v + off) = h;
    *reinterpret_cast<uint4*>(vtlo + off) = l;
  }
}

// ---------------------------------------------------------------- the online softmax

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One kv tile's scores in wgmma's m64nN accumulator layout: this thread
// holds rows r and r + 8 of its warp's 16, keys 8j + 2q + e (j < NB, e < 2)
// at s[j][2 * half + e].  Scales them to
// the log2 domain (scale2 = scale * log2(e)), masks them where the tile
// reaches past Sk, the causal diagonal or the window (kMask), exponentiates
// them in place and updates the running max m and denominator l (both in
// that domain); returns each row's rescale factor in alpha.
template <int NB, bool kMask>
__device__ __forceinline__ void online_softmax(float (&s)[NB][4], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int k0, int nk, int qi0,
                                               int q4, int causal, int window, float scale2) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = qi0 + 8 * half;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[j][2 * half + e];
        if (kMask) {
          const int c = 8 * j + 2 * q4 + e;
          const int kj = k0 + c;
          bool ok = true;
          if (causal) ok = ok && kj <= qi;
          if (window > 0) ok = ok && kj > qi - window;
          x = c >= nk ? -INFINITY : (ok ? x * scale2 : kNegInf);
        } else {
          x = x * scale2;
        }
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[half], mx);
    alpha[half] = ex2(m[half] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[j][2 * half + e];
        x = ex2(x - m_new);
        rs += x;
      }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l[half] = l[half] * alpha[half] + rs;
    m[half] = m_new;
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------- the kernel

template <typename T, int D>
__global__ void __launch_bounds__(Geo<T, D>::kThreads)
flash_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, T* __restrict__ o, int H,
                       int KVH, int Sq, int Sk, long long osb, long long oss, long long osh,
                       int causal, int window, float scale) {
  using G = Geo<T, D>;
  constexpr int kBQ = G::kBQ;
  constexpr int kBK = G::kBK;
  constexpr int kStages = G::kStages;
  constexpr int kSW = G::kSW;
  constexpr int kNB = kBK / 8;    // 8-key column blocks of a score tile
  constexpr int kDB = D / 8;      // 8-wide column blocks of the output
  constexpr int kSteps = kSW / 32;  // 32-byte k steps (k16 bf16, k8 tf32) in a slice row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gsm = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t ring = base + G::kRingOffset;
  const uint32_t qbar = base + G::kBarOffset;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = qt * kBQ;

  // the kv tiles some row of [lo, hi) can see
  auto tiles = [&](int lo, int hi, int& t_lo, int& t_hi) {
    int k_lo = 0, k_hi = Sk;
    if (causal) k_hi = min(Sk, hi);
    if (window > 0) k_lo = max(0, lo - window + 1);
    t_lo = k_lo / kBK;
    t_hi = k_hi > k_lo ? (k_hi + kBK - 1) / kBK : t_lo;
  };
  int t_lo, t_hi;
  tiles(q0, min(q0 + kBQ, Sq), t_lo, t_hi);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // barriers: q, then per stage full (TMA), [ready (float32: the helpers'
  // split is done)], empty (the consumers are done)
  const uint32_t full0 = qbar + 8;
  const uint32_t ready0 = full0 + 8 * kStages;
  const uint32_t empty0 = ready0 + (G::kF32 ? 8 * kStages : 0);
  const int n = t_hi - t_lo;  // kv tiles of this block; tile i sits in stage i % kStages
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      if (G::kF32) mbar_init(ready0 + 8 * s, G::kHelpers);
      mbar_init(empty0 + 8 * s, G::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The producer loads q and the first kStages tiles, then tile i + kStages
  // once every consumer has released tile i (its stage).
  auto produce = [&](int i) {
    const int s = i % kStages;
    mbar_wait(empty0 + 8 * s, ((uint32_t)(i / kStages) & 1u) ^ 1u);
    const uint32_t full = full0 + 8 * s;
    const uint32_t k_s = ring + s * G::kStageBytes;
    const int t = t_lo + i;
    mbar_expect_tx(full, G::kLoadBytes);
    for (int c = 0; c < G::kChunks; ++c)
      tma_load_4d(k_s + c * G::kKVChunk, &kmap, full, c * G::kSWE, kvh, t * kBK, b);
    for (int c = 0; c < G::kChunks; ++c)
      tma_load_4d(k_s + G::kKVBytes + c * G::kKVChunk, &vmap, full, c * G::kSWE, kvh, t * kBK,
                  b);
  };
  auto produce_q = [&]() {
    mbar_expect_tx(qbar, G::kQBytes);
    for (int c = 0; c < G::kChunks; ++c)
      tma_load_4d(q_s + c * G::kQChunk, &qmap, qbar, c * G::kSWE, h, q0, b);
  };

  if constexpr (!G::kF32) {
    if (warp == G::kProducerWarp) {
      // ---------------------------------------------- producer (bfloat16)
      if (lane == 0) {
        produce_q();
        for (int i = 0; i < n; ++i) produce(i);
      }
      return;
    }
  } else {
    if (warp >= G::kConsumers / 32) {
      // ---------------------------------------------- helpers (float32)
      // stage by stage as TMA fills them: K split in place (its lo half
      // beside it), V transposed and split in place, on the CUDA cores,
      // while the consumers run the products of the tile before.  Helper
      // thread 0 is the producer: once the helpers have handed over tile i,
      // it waits for the consumers to release tile i - 1 and loads tile
      // i - 1 + kStages into that stage, two tiles ahead of the helpers.
      const int tid = threadIdx.x - G::kConsumers;
      if (tid == 0) {
        produce_q();
        for (int i = 0; i < n && i < kStages; ++i) produce(i);
      }
      __syncwarp();
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        mbar_wait(full0 + 8 * s, (uint32_t)(i / kStages) & 1u);
        uint8_t* st = gsm + G::kRingOffset + s * G::kStageBytes;
        split_tile<G::kKVBytes, G::kHelpers>(st, st + G::kKloInStage, tid);
        split_vt<D, G::kHelpers>(st + G::kKVBytes, st + G::kVtloInStage, tid);
        fence_async();
        mbar_arrive(ready0 + 8 * s);
        if (tid == 0 && i >= 1 && i - 1 + kStages < n) produce(i - 1 + kStages);
        __syncwarp();  // the warp meets again before the next pass's barrier
      }
      return;
    }
  }

  // -------------------------------------------------- consumers
  const int wg = warp >> 2;       // this warpgroup's 64 rows of the tile
  const int g = lane >> 2;        // row in an 8-row group
  const int q4 = lane & 3;        // column pair
  const int r0 = 16 * warp + g;   // this thread's rows r0 and r0 + 8 of the tile
  const int wq0 = q0 + 64 * wg;   // the warpgroup's first query
  const int wq_end = min(wq0 + 64, Sq);
  const float scale2 = scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  float acc[kDB][4];
#pragma unroll
  for (int j = 0; j < kDB; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  // softmax of one tile's scores and the rescale of the accumulator; masks
  // only where the tile reaches past Sk, the diagonal or the window
  auto softmax = [&](float (&sc)[kNB][4], int k0) {
    const int nk = min(kBK, Sk - k0);  // keys of this tile inside [0, Sk)
    const bool edge = nk < kBK || (causal && k0 + kBK - 1 > wq0) ||
                      (window > 0 && k0 <= wq_end - 1 - window);
    if (edge)
      online_softmax<kNB, true>(sc, m, l, alpha, k0, nk, q0 + r0, q4, causal, window, scale2);
    else
      online_softmax<kNB, false>(sc, m, l, alpha, k0, nk, q0 + r0, q4, causal, window, scale2);
#pragma unroll
    for (int j = 0; j < kDB; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
  };

  if constexpr (!G::kF32) {
    // ---------------- bfloat16: both products on wgmma, operands as stored
    int w_lo = t_hi, w_hi = t_hi;  // the tiles this warpgroup's rows can see
    if (wq0 < Sq) tiles(wq0, wq_end, w_lo, w_hi);
    mbar_wait(qbar, 0);
    for (int i = 0, t = t_lo; t < t_hi; ++t, ++i) {
      const int s = i % kStages;
      const uint32_t k_s = ring + s * G::kStageBytes;
      const uint32_t v_s = k_s + G::kKVBytes;
      mbar_wait(full0 + 8 * s, (uint32_t)(i / kStages) & 1u);
      if (t < w_lo || t >= w_hi) {  // no row of this warpgroup sees this tile
        mbar_arrive(empty0 + 8 * s);
        continue;
      }
      // S = Q K^T: D / 16 steps of k16
      float sc[kNB][4];
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / kSteps;
        const uint32_t off = (uint32_t)((kk % kSteps) * 32);
        const uint64_t da =
            gmma_desc<kSW>(q_s + c * G::kQChunk + wg * 64 * kSW + off, 16, 8 * kSW);
        const uint64_t db = gmma_desc<kSW>(k_s + c * G::kKVChunk + off, 16, 8 * kSW);
        wgmma_m64n64k16_ss(sc, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      softmax(sc, t * kBK);
      // O += P V: kBK / 16 steps of k16 (16 key rows each), P from registers
      uint32_t pa[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
        pa[kk][1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
        pa[kk][2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        pa[kk][3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wgmma_pv<D, kSW>(acc, pa[kk], v_s + kk * 16 * kSW, G::kKVChunk);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(empty0 + 8 * s);
    }
  } else {
    // ---------------- float32: split TF32 on wgmma, from the helpers' tiles.
    // Q is split here, once: its hi half written back in place, its lo half
    // kept in registers as the A operand of Q_lo K_hi.
    uint32_t qlo[D / 8][4];
    mbar_wait(qbar, 0);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * warp + g + 8 * (e & 1);
        const int col = 8 * kk + q4 + 4 * (e >> 1);
        const uint32_t unit = (uint32_t)((col % G::kSWE) >> 2) ^ row_bits<kSW>(row & 7);
        float* p = reinterpret_cast<float*>(gsm + (col / G::kSWE) * G::kQChunk + row * kSW +
                                            (unit << 4) + (col & 3) * 4);
        uint32_t hi;
        split_tf32(*p, hi, qlo[kk][e]);
        *p = __uint_as_float(hi);
      }
    fence_async();
    asm volatile("bar.sync 2, 128;\n" ::: "memory");  // all of Q_hi is written
    for (int i = 0, t = t_lo; t < t_hi; ++t, ++i) {
      const int s = i % kStages;
      const uint32_t k_s = ring + s * G::kStageBytes;
      const uint32_t klo_s = k_s + G::kKloInStage;
      const uint32_t vt_s = k_s + G::kKVBytes;
      const uint32_t vtlo_s = k_s + G::kVtloInStage;
      mbar_wait(ready0 + 8 * s, (uint32_t)(i / kStages) & 1u);
      // S = Q K^T = Q_lo K_hi + Q_hi K_lo + Q_hi K_hi: D / 8 steps of k8
      float sc[kNB][4];
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint32_t off = (uint32_t)((kk / kSteps) * G::kQChunk + (kk % kSteps) * 32);
        const uint32_t koff = (uint32_t)((kk / kSteps) * G::kKVChunk + (kk % kSteps) * 32);
        const uint64_t qh = gmma_desc<kSW>(q_s + off, 16, 8 * kSW);
        const uint64_t kh = gmma_desc<kSW>(k_s + koff, 16, 8 * kSW);
        const uint64_t kl = gmma_desc<kSW>(klo_s + koff, 16, 8 * kSW);
        wgmma_m64n32k8_tf32_rs(sc, qlo[kk], kh);
        wgmma_m64n32k8_tf32_ss(sc, qh, kl);
        wgmma_m64n32k8_tf32_ss(sc, qh, kh);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      softmax(sc, t * kBK);
      // O += P V = P_lo V_hi + P_hi V_lo + P_hi V_hi: kBK / 8 steps of k8, P
      // from registers (the score fragment is the A fragment, keys reordered)
      uint32_t ph[kNB][4], pl[kNB][4];
#pragma unroll
      for (int jj = 0; jj < kNB; ++jj) {
        split_tf32(sc[jj][0], ph[jj][0], pl[jj][0]);
        split_tf32(sc[jj][2], ph[jj][1], pl[jj][1]);
        split_tf32(sc[jj][1], ph[jj][2], pl[jj][2]);
        split_tf32(sc[jj][3], ph[jj][3], pl[jj][3]);
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < kNB; ++jj) {
        const uint64_t vh = gmma_desc<128>(vt_s + jj * 32, 16, 1024);
        const uint64_t vl = gmma_desc<128>(vtlo_s + jj * 32, 16, 1024);
        wgmma_pv_tf32<D>(acc, pl[jj], vh);
        wgmma_pv_tf32<D>(acc, ph[jj], vl);
        wgmma_pv_tf32<D>(acc, ph[jj], vh);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(empty0 + 8 * s);
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + r0 + 8 * half;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[half], 1e-30f);
    T* orow = o + b * osb + qi * oss + h * osh;
#pragma unroll
    for (int j = 0; j < kDB; ++j)
      store2(orow + 8 * j + 2 * q4, acc[j][2 * half] / denom, acc[j][2 * half + 1] / denom);
  }
}

// ---------------------------------------------------------------- float32 at D = 256
//
// The TMA kernel's float32 geometry does not fit D = 256: Q's lo half alone
// is 128 registers a thread beside a 128-register accumulator, and a stage of
// K, V and their lo halves is 128 KB.  So float32 at D = 256 (paligemma-3b's
// heads) runs this kernel instead: split TF32 on `mma.sync` m16n8k8, each
// operand split into hi and lo halves in registers as it is loaded from
// shared memory (Q, K and V stay float32 there), so no split copy is stored.
// A block is 64 query rows, a warp 16 of them with the accumulator of all
// 256 output columns (128 registers); kv tiles of 32 keys stream through two
// stages of `cp.async` copies, rows padded to 260 floats so that every
// fragment load of a warp hits 32 banks.  Q (66,560 bytes) and two stages of
// K and V (133,120) fill 199,680 bytes: one block an SM.  A warp skips the
// tiles none of its rows sees; rows and keys past the end are zero-filled
// and keys past Sk masked to -inf, as in the kernel above, whose online
// softmax (log2 domain, the -1e30 mask, max(l, 1e-30)) this one shares.
namespace wide {
constexpr int D = 256;
constexpr int kBQ = 64;     // query rows a block, 16 a warp
constexpr int kBK = 32;     // keys a kv tile
constexpr int kThreads = 128;
constexpr int kLd = D + 4;  // floats a row in shared memory
constexpr int kQFloats = kBQ * kLd;
constexpr int kTileFloats = kBK * kLd;
constexpr int kSmem = (kQFloats + 2 * 2 * kTileFloats) * 4;  // Q, then 2 stages of K and V
static_assert(kSmem <= 232448, "fits the 227 KB a block can use");

// `rows` rows of D floats from `src` (row stride `ld` elements) into `dst`
// (row stride kLd) as 16-byte copies; rows at or past `valid` are zeroed.
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long ld, int rows,
                                          int valid) {
  for (int i = threadIdx.x; i < rows * (D / 4); i += kThreads) {
    const int r = i / (D / 4), u = 4 * (i % (D / 4));
    if (r < valid)
      repro::cp_async16(dst + r * kLd + u, src + r * ld + u);
    else
      *reinterpret_cast<float4*>(dst + r * kLd + u) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}
}  // namespace wide

__global__ void __launch_bounds__(wide::kThreads)
flash_attention_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o, int H, int KVH,
                            int Sq, int Sk, long long qsb, long long qss, long long qsh,
                            long long ksb, long long kss, long long ksh, long long osb,
                            long long oss, long long osh, int causal, int window,
                            float scale) {
  using namespace wide;
  using repro::mma_tf32;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;
  float* ring = fsm + kQFloats;  // stage s: K at ring + 2 s kTileFloats, V after it

  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const int wq0 = q0 + 16 * warp, wq_end = min(wq0 + 16, Sq);

  // the kv tiles some row of [lo, hi) can see
  auto tiles = [&](int lo, int hi, int& t_lo, int& t_hi) {
    int k_lo = 0, k_hi = Sk;
    if (causal) k_hi = min(Sk, hi);
    if (window > 0) k_lo = max(0, lo - window + 1);
    t_lo = k_lo / kBK;
    t_hi = k_hi > k_lo ? (k_hi + kBK - 1) / kBK : t_lo;
  };
  int t_lo, t_hi, w_lo = 0, w_hi = 0;
  tiles(q0, min(q0 + kBQ, Sq), t_lo, t_hi);
  if (wq0 < Sq) tiles(wq0, wq_end, w_lo, w_hi);
  const float* kb = k + b * ksb + kvh * ksh;
  const float* vb = v + b * ksb + kvh * ksh;
  auto load_tile = [&](int t) {
    float* st = ring + ((t - t_lo) & 1) * 2 * kTileFloats;
    const int valid = min(kBK, Sk - t * kBK);
    load_rows(st, kb + (long long)t * kBK * kss, kss, kBK, valid);
    load_rows(st + kTileFloats, vb + (long long)t * kBK * kss, kss, kBK, valid);
  };

  const float scale2 = scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  if (t_hi > t_lo) {
    load_rows(qs, q + b * qsb + (long long)q0 * qss + h * qsh, qss, kBQ, Sq - q0);
    load_tile(t_lo);
    repro::cp_async_commit();
  }
  for (int t = t_lo; t < t_hi; ++t) {
    if (t + 1 < t_hi) load_tile(t + 1);
    repro::cp_async_commit();  // a group every pass, empty at the last
    repro::cp_async_wait(1);   // tile t (and Q) have landed for this thread
    __syncthreads();           // ... and for every thread
    if (t >= w_lo && t < w_hi) {
      const float* ks = ring + ((t - t_lo) & 1) * 2 * kTileFloats;
      const float* vs = ks + kTileFloats;
      const float* qrow = qs + (16 * warp + g) * kLd;
      // S = Q K^T = Q_lo K_hi + Q_hi K_lo + Q_hi K_hi: D / 8 steps of k8
      float sc[kBK / 8][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < D / 8; ++kk) {
        const int c = 8 * kk + q4;
        uint32_t ah[4], al[4];
        split_tf32(qrow[c], ah[0], al[0]);
        split_tf32(qrow[8 * kLd + c], ah[1], al[1]);
        split_tf32(qrow[c + 4], ah[2], al[2]);
        split_tf32(qrow[8 * kLd + c + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          const float* krow = ks + (8 * j + g) * kLd + c;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(krow[0], bh0, bl0);
          split_tf32(krow[4], bh1, bl1);
          mma_tf32(sc[j], al, bh0, bh1);
          mma_tf32(sc[j], ah, bl0, bl1);
          mma_tf32(sc[j], ah, bh0, bh1);
        }
      }
      const int k0 = t * kBK;
      const int nk = min(kBK, Sk - k0);  // keys of this tile inside [0, Sk)
      const bool edge = nk < kBK || (causal && k0 + kBK - 1 > wq0) ||
                        (window > 0 && k0 <= wq_end - 1 - window);
      if (edge)
        online_softmax<kBK / 8, true>(sc, m, l, alpha, k0, nk, wq0 + g, q4, causal, window,
                                      scale2);
      else
        online_softmax<kBK / 8, false>(sc, m, l, alpha, k0, nk, wq0 + g, q4, causal, window,
                                       scale2);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
      // O += P V = P_lo V_hi + P_hi V_lo + P_hi V_hi: kBK / 8 steps of k8.
      // The score fragment is the A fragment with the keys of each group of
      // 8 reordered (k index q4 + 4 e holds key 2 q4 + e), so V's rows are
      // read in that order.
#pragma unroll
      for (int jj = 0; jj < kBK / 8; ++jj) {
        uint32_t ph[4], pl[4];
        split_tf32(sc[jj][0], ph[0], pl[0]);
        split_tf32(sc[jj][2], ph[1], pl[1]);
        split_tf32(sc[jj][1], ph[2], pl[2]);
        split_tf32(sc[jj][3], ph[3], pl[3]);
        const float* v0 = vs + (8 * jj + 2 * q4) * kLd + g;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t vh0, vl0, vh1, vl1;
          split_tf32(v0[8 * n], vh0, vl0);
          split_tf32(v0[kLd + 8 * n], vh1, vl1);
          mma_tf32(acc[n], pl, vh0, vh1);
          mma_tf32(acc[n], ph, vl0, vl1);
          mma_tf32(acc[n], ph, vh0, vh1);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  repro::cp_async_wait(0);

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = wq0 + g + 8 * half;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[half], 1e-30f);
    float* orow = o + b * osb + qi * oss + h * osh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(orow + 8 * j + 2 * q4, acc[j][2 * half] / denom, acc[j][2 * half + 1] / denom);
  }
}

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled find_encoder() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                     cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                            &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
  return reinterpret_cast<EncodeTiled>(fn);
}

// The 4-D map of a [B, S, heads, D] tensor (strides in elements, the last
// dimension contiguous) whose box is one kSW-byte slice of `rows` rows of one
// head.
template <typename T, int D>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, long long sb,
                     long long ss, long long sh, int rows) {
  using G = Geo<T, D>;
  static const EncodeTiled encode = find_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(sh * G::kEs), (cuuint64_t)(ss * G::kEs),
                                 (cuuint64_t)(sb * G::kEs)};
  const cuuint32_t box[4] = {(cuuint32_t)G::kSWE, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = G::kSW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : G::kSW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUtensorMapDataType type =
      G::kEs == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUresult res = encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out of range reads as 0
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KVH,
                   int Sq, int Sk, const long long* st, int causal, int window, float scale,
                   cudaStream_t stream) {
  using G = Geo<T, D>;
  CUtensorMap qm, km, vm;
  cudaError_t err = make_map<T, D>(&qm, q, B, Sq, H, st[0], st[1], st[2], G::kBQ);
  if (err == cudaSuccess) err = make_map<T, D>(&km, k, B, Sk, KVH, st[3], st[4], st[5], G::kBK);
  if (err == cudaSuccess) err = make_map<T, D>(&vm, v, B, Sk, KVH, st[3], st[4], st[5], G::kBK);
  if (err != cudaSuccess) return err;
  auto kernel = flash_attention_kernel<T, D>;
  static int smem_set[kMaxDevices] = {};
  err = ensure_smem(kernel, G::kSmem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + G::kBQ - 1) / G::kBQ, H, B);
  kernel<<<grid, G::kThreads, G::kSmem, stream>>>(qm, km, vm, static_cast<T*>(o), H, KVH, Sq, Sk,
                                                st[6], st[7], st[8], causal, window, scale);
  return cudaGetLastError();
}

// float32 at D = 256: the mma.sync kernel, its tiles read through the strides
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int KVH, int Sq, int Sk, const long long* st, int causal, int window,
                        float scale, cudaStream_t stream) {
  static int smem_set[kMaxDevices] = {};
  cudaError_t err = ensure_smem(flash_attention_wide_kernel, wide::kSmem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + wide::kBQ - 1) / wide::kBQ, H, B);
  flash_attention_wide_kernel<<<grid, wide::kThreads, wide::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, KVH, Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, void* o, int B,
                     int H, int KVH, int Sq, int Sk, const long long* st, int causal,
                     int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, KVH, Sq, Sk, st, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, KVH, Sq, Sk, st, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KVH, Sq, Sk, st, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KVH, Sq, Sk, st, causal, window, scale, stream);
    case 256:
      if constexpr (sizeof(T) == 4)
        return launch_wide(q, k, v, o, B, H, KVH, Sq, Sk, st, causal, window, scale, stream);
      else
        return launch<T, 256>(q, k, v, o, B, H, KVH, Sq, Sk, st, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/o [B, Sq, H, D], k/v [B, Sk, KVH, D]; strides in elements, last dim 1;
// k and v share their strides.  bf16 != 0: bfloat16 tensors, else float32.
// TMA needs q, k and v 16-byte aligned and every stride a multiple of 16
// bytes (the wrapper checks; a map that cannot be encoded returns
// cudaErrorInvalidValue).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int B, int H, int KVH, int Sq, int Sk, int D, int bf16,
                                     long long qsb, long long qss, long long qsh,
                                     long long ksb, long long kss, long long ksh,
                                     long long osb, long long oss, long long osh,
                                     int causal, int window, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KVH < 1 || H % KVH != 0) return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = bf16 ? dispatch<__nv_bfloat16>(D, q, k, v, o, B, H, KVH, Sq, Sk, st,
                                                   causal, window, scale, s)
                         : dispatch<float>(D, q, k, v, o, B, H, KVH, Sq, Sk, st, causal,
                                           window, scale, s);
  return (int)err;
}
