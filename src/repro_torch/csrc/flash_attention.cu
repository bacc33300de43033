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
// bfloat16 in, float32 accumulation, out in the input type.  Row i of q is
// the query at key position q_offset + i: 0 for a whole sequence, a rank's
// first row for its rows of a sequence-sharded q (K and V whole).  The
// masks, and the range of kv tiles a q tile visits, use those positions;
// the q tiles, their TMA boxes and the output rows stay local.
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
// Head dims: every D from 1 to 256.  One up to 128 that is not an
// instantiated width (kimi-k2-1t-a32b's 112, SigLIP-so400m's 72, 8, 100)
// runs the geometry of the next one, W (16, 32, 64, 128: 72 and 112 at
// 128); one from 129 to 256 (192, 200) runs the head-dim-256 kernel below.
// The tensor maps keep the true extent D, so TMA reads columns D .. W-1 of
// q, K and V as zeros (OOB fill), which change neither Q K^T nor the first
// D columns of P V; the split-TF32 halves of a zero are zeros; the O store
// writes only the first D columns (a row of o is H D wide: a W-column store
// would write into the next head), two at a time where D and o's strides are
// even, else one by one; the scale is the true D's (the wrapper's D^-0.5).
// The padding costs W / D of the tensor-core work (128 / 112 = 1.14 at
// kimi's heads, 128 / 72 = 1.78 at SigLIP's) and no extra bytes of device
// memory: the zeros are made by TMA, not read.
// Rows of D sizeof(T) bytes that are no multiple of 16 (bfloat16 at a D that
// is no multiple of 8, float32 at one that is no multiple of 4) have no
// layout whose strides TMA takes: the wrapper copies q, k and v of such a D
// into tensors whose rows are padded to 16 bytes (kernels/flash_attention.py
// `kernel_operands`; route (b) of the two this port weighed, the other being
// loads without TMA in the kernel), whose maps keep the true extent D, and
// refuses any other layout TMA cannot read (a misaligned base, odd strides):
// the kernel itself only ever sees strides TMA takes.  Head dim 256 (paligemma-3b's heads)
// does not fit this geometry in either type and has a design of its own,
// flash_attention_d256_kernel (below, with its note).
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

using repro::bulk_load;
using repro::ensure_smem;
using repro::from_f32;
using repro::kMaxDevices;
using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::smem_u32;
using repro::split_tf32;

// Shared-memory geometry of one instance, of width D (the head dim rounded up
// to an instantiated width).  A tile of R rows of D elements is
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
  static_assert(D <= 128, "head dim 256 runs flash_attention_d256_kernel");
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

// ---------------------------------------------------------------- TMA

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
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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


// S[64 x 16] += A[64 x 8] B[16 x 8]^T in TF32, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_m64n16k8_tf32_ss(float (&d)[2][4], uint64_t da,
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "l"(da), "l"(db), "r"(1));
}

// S[64 x 32] += A[64 x 16] B[32 x 16]^T in bfloat16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[4][4], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(1));
}

// O[64 x D] += P[64 x 16] V[16 x D], V's 16 key rows at `v` in slices of SW
// bytes a row, `chunk` bytes apart.
template <int D, int SW>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 8][4], const uint32_t (&a)[4],
                                         uint32_t v, uint32_t chunk) {
  const uint64_t db = gmma_desc<SW>(v, chunk, 8 * SW);
  if constexpr (D == 16) wgmma_m64n16k16_rs(o, a, db);
  if constexpr (D == 32) wgmma_m64n32k16_rs(o, a, db);
  if constexpr (D == 64) wgmma_m64n64k16_rs(o, a, db);
  if constexpr (D == 128) wgmma_m64n128k16_rs(o, a, db);
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

// Columns col and col + 1 (col even) of an output row, those below dim:
// one paired store where `pair` (dim and the row's start even), else one by
// one.
template <typename T>
__device__ __forceinline__ void store_cols(T* row, int col, float a, float b, int dim,
                                           bool pair) {
  if (pair && col + 1 < dim) {
    store2(row + col, a, b);
    return;
  }
  if (col < dim) from_f32(row + col, a);
  if (col + 1 < dim) from_f32(row + col + 1, b);
}

// ---------------------------------------------------------------- the kernel

template <typename T, int D, bool kWhole>
__global__ void __launch_bounds__(Geo<T, D>::kThreads)
flash_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, T* __restrict__ o, int H,
                       int KVH, int Sq, int Sk, long long osb, long long oss, long long osh,
                       int causal, int window, int q_offset, float scale, int dim) {
  // D: the geometry's width; dim (<= D): the head dim, the columns of o
  // written (q, K and V read as zeros past it); kWhole: dim a multiple of 8
  // and o's strides even (every served model's), so o's columns are stored
  // in pairs with no test of the pair against dim
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

  // the kv tiles some row of [lo, hi) can see (rows local, at key
  // positions q_offset on: the masks compare global positions)
  auto tiles = [&](int lo, int hi, int& t_lo, int& t_hi) {
    int k_lo = 0, k_hi = Sk;
    if (causal) k_hi = min(Sk, hi + q_offset);
    if (window > 0) k_lo = max(0, lo + q_offset - window + 1);
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
    const bool edge = nk < kBK || (causal && k0 + kBK - 1 > wq0 + q_offset) ||
                      (window > 0 && k0 <= wq_end + q_offset - 1 - window);
    const int qi0 = q0 + q_offset + r0;  // this thread's first row, as a key position
    if (edge)
      online_softmax<kNB, true>(sc, m, l, alpha, k0, nk, qi0, q4, causal, window, scale2);
    else
      online_softmax<kNB, false>(sc, m, l, alpha, k0, nk, qi0, q4, causal, window, scale2);
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

  [[maybe_unused]] const bool pair = ((osb | oss | osh | (long long)dim) & 1) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + r0 + 8 * half;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[half], 1e-30f);
    T* orow = o + b * osb + qi * oss + h * osh;
#pragma unroll
    for (int j = 0; j < kDB; ++j)
      if (8 * j < dim) {
        if constexpr (kWhole)
          store2(orow + 8 * j + 2 * q4, acc[j][2 * half] / denom, acc[j][2 * half + 1] / denom);
        else
          store_cols(orow, 8 * j + 2 * q4, acc[j][2 * half] / denom,
                     acc[j][2 * half + 1] / denom, dim, pair);
      }
  }
}

// ---------------------------------------------------------------- head dim 256
//
// Head dims from 129 to 255 run this kernel as well, with columns D .. 255 of
// q, K and V zeros: q's (and bfloat16's K and V) from TMA, the maps keeping
// the true extent; float32's K and V images written as zeros there by the
// split kernel; only o's D columns are stored.
//
// At D = 256 (paligemma-3b's heads: 8 query heads on one kv head) the
// geometry above does not fit: one warpgroup holding all 256 output columns
// of its 64 rows needs 128 accumulator registers a thread, and float32's Q_lo
// operand another 128.  Here a block is one 64-row q tile.
//
// What bounds it: at paligemma-3b's prefill (B = 4, S = 512, causal) the
// function needs 4.30 GFLOP and moves 18.9 MB in bfloat16 (37.7 MB in
// float32): float32 as split TF32 (12.9 GFLOP on 495 TFLOP/s) is bound by
// operations, ~26 us; bfloat16 by bytes, ~5.6 us.  What the design does:
//  * float32: two consumer warpgroups split the output's columns: warpgroup
//    c keeps columns [128 c, 128 c + 128) of O (64 registers) and contracts
//    S = Q K^T over its half of D.  The two partial score tiles meet through
//    shared memory (double-buffered, one named barrier a kv tile); each adds
//    the other's (a + b = b + a bit for bit, so both hold the same scores)
//    and runs the same online softmax.  Split TF32 on `wgmma` as above
//    (S = Q_lo K_hi + Q_hi K_lo + Q_hi K_hi, O += P_lo V_hi + P_hi V_lo +
//    P_hi V_hi); Q's hi half is written back in place once a block, its lo
//    half stays in registers as the A operand of Q_lo K_hi.  K and V are
//    split once a call, not once a block: with one kv head for 8 query heads
//    every K/V tile is read by 8 heads x Sq / 64 blocks, and splitting (and
//    transposing V) in each of them cost the old mma.sync kernel as much as
//    its products.  flash_attention_split_kv_kernel writes each kv tile of
//    kBK keys as this kernel's shared-memory image of it: K_hi and K_lo in
//    128-byte swizzled slices of 32 columns, V^T_hi and V^T_lo as [256][kBK]
//    rows with the keys of each group of 8 reordered so that the score
//    accumulator is the A operand of P V (see split_vt), zeros past Sk;
//    one bulk copy (TMA's non-tensor form: the image is already swizzled)
//    brings each half-stage into a 1024-byte-aligned stage.  The image is
//    4 x 256 float32 a key (8.4 MB at paligemma's prefill), read from L2;
//  * bfloat16: one warpgroup holds all 256 columns (128 accumulator
//    registers) and contracts S over all of D, so nothing is exchanged; a
//    block is 128 threads and 96 KB, two blocks share an SM, and one's
//    softmax runs under the other's products.  Q, K and V come straight
//    from the tensors by TMA (tensor maps, as above), S on `wgmma`
//    m64n64k16 from shared memory, P rounded to bfloat16 in registers and
//    O += P V on m64n128k16 with V read through the transpose bit (the same
//    precision departure as above);
//  * thread 0 issues every copy (no producer warp: a float32 thread may
//    keep up to 255 registers with no setmaxnreg): the next K tile into a
//    stage once every warpgroup has met past the current one (their S
//    products are done), the next V tile once their P V products are;
//  * blocks are ranked by their work: every head's heaviest q tiles first
//    (the last ones under a causal mask or a window), and the blocks
//    resident at once paired so that an SM's second block is light where
//    its first is heavy.  In the grid's own order (each head's tiles in
//    turn) the last heavy tiles started late: 26% of float32's time at
//    paligemma's prefill (scripts/flash_variants.py, order_by_head);
//  * kv tiles above the diagonal or before the window are never loaded,
//    masks run only on edge tiles, and the softmax runs in the log2 domain.

// Geometry: kBK keys a kv tile, kStages tiles in each ring and kWG consumer
// warpgroups (with one, it holds all 256 columns and contracts S over all
// of D, with no exchange).  The choices are Geo256Of's, below
// (scripts/flash_variants.py times the others).
template <typename T, int kBK_, int kStages_, int kWG_>
struct Geo256 {
  static constexpr int D = 256;
  static constexpr int kEs = (int)sizeof(T);
  static constexpr bool kF32 = kEs == 4;
  static constexpr int kBQ = 64;  // query rows a block
  static constexpr int kWG = kWG_;
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kCols = D / kWG;  // a warpgroup's output columns and share of S's D
  static constexpr int kQSteps = kF32 ? kCols / 8 : 1;  // float32: k8 steps of Q_lo's registers
  static constexpr int kBK = kBK_;
  static constexpr int kStages = kStages_;
  static constexpr int kNB = kBK / 8;        // 8-key column blocks of a score tile
  static constexpr int kSWE = 128 / kEs;     // elements of a 128-byte slice row
  static constexpr int kSlices = D / kSWE;   // 8 (float32) or 4 (bfloat16)
  static constexpr int kQChunk = kBQ * 128;
  static constexpr int kQBytes = kSlices * kQChunk;
  static constexpr int kKChunk = kBK * 128;  // one slice of a K (bfloat16: or V) tile
  static constexpr int kKTile = kSlices * kKChunk;
  // float32: a V^T row holds the tile's kBK keys (64 or 128 bytes, swizzled
  // at that width); bfloat16: V is stored as K is
  static constexpr int kVSW = kF32 ? kBK * 4 : 128;
  static constexpr int kVTile = kF32 ? D * kVSW : kKTile;
  static constexpr int kKStage = (kF32 ? 2 : 1) * kKTile;  // float32: K_hi, K_lo
  static constexpr int kVStage = (kF32 ? 2 : 1) * kVTile;  // float32: V^T_hi, V^T_lo
  static constexpr int kImage = kKStage + kVStage;         // float32: a tile's image
  static constexpr int kKRing = kQBytes;
  static constexpr int kVRing = kKRing + kStages * kKStage;
  static constexpr int kXchg = kVRing + kStages * kVStage;  // [2 buffers][2 wgs][kNB][128] float4
  static constexpr int kXchgBytes = kWG == 2 ? 2 * 2 * kBQ * kBK * 4 : 0;
  static constexpr int kBarOffset = kXchg + kXchgBytes;
  static constexpr int kSmem = kBarOffset + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
  static_assert(kF32 ? (kBK == 16 || kBK == 32) : (kBK == 32 || kBK == 64),
                "the score products take these widths");
  static_assert(kWG == 2 || (kWG == 1 && !kF32),
                "float32's Q_lo and accumulator need two warpgroups' registers");
  static_assert(kKChunk % 1024 == 0, "slices stay 1024-byte aligned");
  static_assert(kKStage % 1024 == 0 && kVStage % 1024 == 0, "stages stay 1024-byte aligned");
  static_assert(kSmem <= 232448, "fits the 227 KB a block can use");
};

template <typename T>
struct Geo256Of;
template <>
struct Geo256Of<float> {  // 32-key tiles, one stage, two warpgroups
  using G = Geo256<float, 32, 1, 2>;
};
template <>
struct Geo256Of<__nv_bfloat16> {  // 64-key tiles, one stage, one warpgroup
  using G = Geo256<__nv_bfloat16, 64, 1, 1>;
};

// S[64 x N] += A[64 x 8] B[N x 8]^T in TF32: A from shared memory (ss) or
// registers (rs), B K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_s_tf32_ss(float (&d)[N / 8][4], uint64_t da, uint64_t db) {
  if constexpr (N == 16) wgmma_m64n16k8_tf32_ss(d, da, db);
  if constexpr (N == 32) wgmma_m64n32k8_tf32_ss(d, da, db);
}
template <int N>
__device__ __forceinline__ void wgmma_s_tf32_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                                uint64_t db) {
  if constexpr (N == 16) wgmma_m64n16k8_tf32_rs(d, a, db);
  if constexpr (N == 32) wgmma_m64n32k8_tf32_rs(d, a, db);
}
// S[64 x N] += A[64 x 16] B[N x 16]^T in bfloat16, both K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_s_bf16_ss(float (&d)[N / 8][4], uint64_t da, uint64_t db) {
  if constexpr (N == 32) wgmma_m64n32k16_ss(d, da, db);
  if constexpr (N == 64) wgmma_m64n64k16_ss(d, da, db, 1);
}

// float32 at D = 256: keys [8 blockIdx.x, 8 blockIdx.x + 8) of kv head
// blockIdx.y (b KVH + kvh) written into their tile's image (see the note
// above): K_hi, K_lo, V^T_hi, V^T_lo, zeros past Sk and past the head dim
// `dim` (<= 256).  Eight keys are one
// group of the V^T order, two 16-byte units of each V^T row, so a block
// writes whole units; the grid has Sk / 8 blocks a kv head, enough to keep
// the loads of every SM in flight.  A thread a column d: it reads column d
// of the 8 key rows (a warp reads 128 contiguous bytes of each), writes its
// K values into their swizzled slots (a warp writes one 128-byte slice row)
// and its 8 V^T values as two 16-byte units.
template <typename G>
__global__ void __launch_bounds__(256)
flash_attention_split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v,
                                uint8_t* __restrict__ img, int KVH, int Sk, long long ksb,
                                long long kss, long long ksh, int dim) {
  static_assert(G::D == 256, "a thread a column");
  constexpr int kGroups = G::kBK / 8;  // 8-key groups a tile
  const int t = blockIdx.x / kGroups;  // the tile
  const int r0 = 8 * (blockIdx.x % kGroups);  // the group's first row in it
  const int bk = blockIdx.y;
  const int b = bk / KVH, kvh = bk - b * KVH;
  const int d = threadIdx.x;
  const long long n_tiles = (Sk + G::kBK - 1) / G::kBK;
  uint8_t* out = img + ((long long)bk * n_tiles + t) * G::kImage;
  const float* kp = k + b * ksb + kvh * ksh + d;
  const float* vp = v + b * ksb + kvh * ksh + d;
  const int kcol = (d >> 5) * G::kKChunk + (d & 3) * 4;  // column d's slice and word
  const uint32_t kunit = (uint32_t)((d & 31) >> 2);       // ... and 16-byte unit, unswizzled
  float kx[8], vx[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {  // all loads first
    const int key = t * G::kBK + r0 + r;
    kx[r] = key < Sk && d < dim ? kp[(long long)key * kss] : 0.f;
    vx[r] = key < Sk && d < dim ? vp[(long long)key * kss] : 0.f;
  }
  float vh[8], vl[8];  // this group of V^T row d, keys in the kernel's order
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    uint32_t hi, lo;
    split_tf32(kx[r], hi, lo);
    const int row = r0 + r;  // (row & 7) == r: r0 is a multiple of 8
    const int off = kcol + row * 128 + (int)((kunit ^ (uint32_t)r) << 4);
    *reinterpret_cast<uint32_t*>(out + off) = hi;
    *reinterpret_cast<uint32_t*>(out + G::kKTile + off) = lo;
    // key 2 i + e of a group sits at position i + 4 e
    split_tf32(vx[r], hi, lo);
    vh[(r >> 1) + 4 * (r & 1)] = __uint_as_float(hi);
    vl[(r >> 1) + 4 * (r & 1)] = __uint_as_float(lo);
  }
  uint8_t* vrow = out + G::kKStage + d * G::kVSW;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const uint32_t unit = (uint32_t)(r0 / 4 + p);  // 16-byte unit of the row, unswizzled
    const int off = (int)((unit ^ row_bits<G::kVSW>(d & 7)) << 4);
    *reinterpret_cast<float4*>(vrow + off) =
        make_float4(vh[4 * p], vh[4 * p + 1], vh[4 * p + 2], vh[4 * p + 3]);
    *reinterpret_cast<float4*>(vrow + G::kVTile + off) =
        make_float4(vl[4 * p], vl[4 * p + 1], vl[4 * p + 2], vl[4 * p + 3]);
  }
}

// This warpgroup's share of S for the tile in k_s (all of it with one
// warpgroup), issued and committed, not waited: float32 as split TF32 over
// its kCols columns of D (Q_lo from registers, Q_hi from shared memory),
// bfloat16 from shared memory.
template <typename G>
__device__ __forceinline__ void d256_scores(float (&d)[G::kNB][4], uint32_t q_s, uint32_t k_s,
                                            const uint32_t (&qlo)[G::kQSteps][4], int wg) {
#pragma unroll
  for (int j = 0; j < G::kNB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
  fence_regs(d);
  wgmma_fence();
  if constexpr (G::kF32) {
#pragma unroll
    for (int kk = 0; kk < G::kCols / 8; ++kk) {
      const int dk = (G::kCols / 8) * wg + kk;  // k8 step along D, 4 to a 128-byte slice
      const uint32_t qoff = (uint32_t)((dk >> 2) * G::kQChunk + (dk & 3) * 32);
      const uint32_t koff = (uint32_t)((dk >> 2) * G::kKChunk + (dk & 3) * 32);
      const uint64_t qh = gmma_desc<128>(q_s + qoff, 16, 1024);
      const uint64_t kh = gmma_desc<128>(k_s + koff, 16, 1024);
      const uint64_t kl = gmma_desc<128>(k_s + G::kKTile + koff, 16, 1024);
      wgmma_s_tf32_rs<G::kBK>(d, qlo[kk], kh);
      wgmma_s_tf32_ss<G::kBK>(d, qh, kl);
      wgmma_s_tf32_ss<G::kBK>(d, qh, kh);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < G::kCols / 16; ++kk) {
      const int dk = (G::kCols / 16) * wg + kk;  // k16 step along D, 4 to a 128-byte slice
      const uint32_t qoff = (uint32_t)((dk >> 2) * G::kQChunk + (dk & 3) * 32);
      const uint32_t koff = (uint32_t)((dk >> 2) * G::kKChunk + (dk & 3) * 32);
      wgmma_s_bf16_ss<G::kBK>(d, gmma_desc<128>(q_s + qoff, 16, 1024),
                              gmma_desc<128>(k_s + koff, 16, 1024));
    }
  }
  wgmma_commit();
}

// O += P V for the tile in v_s, P from this warpgroup's scores, issued and
// committed, not waited: float32 as split TF32 against this warpgroup's
// rows of V^T, bfloat16 against its 64-column slices of V through the
// transpose bit.
template <typename G>
__device__ __forceinline__ void d256_pv(float (&acc)[G::kCols / 8][4],
                                        const float (&s)[G::kNB][4], uint32_t v_s, int wg) {
  constexpr int kNB = G::kNB;
  if constexpr (G::kF32) {
    // P_lo V_hi + P_hi V_lo + P_hi V_hi: kBK / 8 steps of k8, P from registers
    // (the score fragment is the A fragment, keys reordered)
    uint32_t ph[kNB][4], pl[kNB][4];
#pragma unroll
    for (int jj = 0; jj < kNB; ++jj) {
      split_tf32(s[jj][0], ph[jj][0], pl[jj][0]);
      split_tf32(s[jj][2], ph[jj][1], pl[jj][1]);
      split_tf32(s[jj][1], ph[jj][2], pl[jj][2]);
      split_tf32(s[jj][3], ph[jj][3], pl[jj][3]);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < kNB; ++jj) {
      const uint32_t vt = v_s + wg * 128 * G::kVSW + jj * 32;  // this warpgroup's rows of V^T
      const uint64_t vh = gmma_desc<G::kVSW>(vt, 16, 8 * G::kVSW);
      const uint64_t vl = gmma_desc<G::kVSW>(vt + G::kVTile, 16, 8 * G::kVSW);
      wgmma_m64n128k8_tf32_rs(acc, pl[jj], vh);
      wgmma_m64n128k8_tf32_rs(acc, ph[jj], vl);
      wgmma_m64n128k8_tf32_rs(acc, ph[jj], vh);
    }
  } else {
    // kBK / 16 steps of k16, P rounded to bfloat16 in registers
    uint32_t pa[G::kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < G::kBK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < G::kBK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < G::kCols / 128; ++c)  // 128-column products
        wgmma_m64n128k16_rs(
            *reinterpret_cast<float(*)[16][4]>(&acc[16 * c]), pa[kk],
            gmma_desc<128>(v_s + (2 * (G::kCols / 128) * wg + 2 * c) * G::kKChunk +
                               kk * 16 * 128,
                           G::kKChunk, 1024));
  }
  wgmma_commit();
}

// The head-dim-256 attention (see the note above).  float32 reads K and V
// from `img` (the split kernel's output; kmap and vmap unused), bfloat16
// through kmap and vmap (img unused).
template <typename T, typename G>
__global__ void __launch_bounds__(G::kThreads, 1)
flash_attention_d256_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const uint8_t* __restrict__ img, T* __restrict__ o, int B, int H,
                            int KVH, int Sq, int Sk, long long osb, long long oss,
                            long long osh, int causal, int window, int q_offset, float scale,
                            int n_sm, int resident, int dim) {
  constexpr int kBK = G::kBK;
  constexpr int kStages = G::kStages;
  constexpr int kNB = G::kNB;
  constexpr int kCols = G::kCols;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gsm = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t k_ring = base + G::kKRing;
  const uint32_t v_ring = base + G::kVRing;
  // barriers: q, then per stage K full, then per stage V full (TMA's bytes)
  const uint32_t qbar = base + G::kBarOffset;
  const uint32_t kfull0 = qbar + 8;
  const uint32_t vfull0 = kfull0 + 8 * kStages;

  // Blocks start in the order of blockIdx.x.  The work is ranked heaviest
  // first (the last q tiles under a causal mask or a window), every head
  // and batch row of a q tile together.  The first n_sm blocks take the
  // heaviest ranks, one an SM; the rest of the blocks that are resident at
  // once (resident, n_sm x blocks an SM) take the next ranks lightest first,
  // so that an SM's second block is light where its first is heavy; later
  // blocks take the remaining ranks heaviest first, as SMs free up.
  const int n_blocks = gridDim.x;
  const int first = (int)blockIdx.x;
  const int end = min(resident, n_blocks);
  const int rank = first >= n_sm && first < end ? n_sm + (end - 1 - first) : first;
  const int n_qt = n_blocks / (H * B);
  const int qt = n_qt - 1 - rank / (H * B);
  const int h = rank % H;
  const int b = rank / H % B;
  const int kvh = h / (H / KVH);
  const int q0 = qt * G::kBQ;
  const int q_end = min(q0 + G::kBQ, Sq);
  int k_lo = 0, k_hi = Sk;  // the keys some row of the tile can see (row i at key q_offset + i)
  if (causal) k_hi = min(Sk, q_end + q_offset);
  if (window > 0) k_lo = max(0, q0 + q_offset - window + 1);
  const int t_lo = k_lo / kBK;
  const int n = k_hi > k_lo ? (k_hi + kBK - 1) / kBK - t_lo : 0;  // kv tiles of this block
  // float32: the images of this kv head's tiles
  const uint8_t* head_img =
      img + (long long)(b * KVH + kvh) * ((Sk + kBK - 1) / kBK) * G::kImage;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kfull0 + 8 * s, 1);
      mbar_init(vfull0 + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tile i of the block into stage i % kStages of the K (V) ring
  auto load_k = [&](int i) {
    const int s = i % kStages;
    const uint32_t bar = kfull0 + 8 * s;
    const uint32_t dst = k_ring + s * G::kKStage;
    const int t = t_lo + i;
    mbar_expect_tx(bar, G::kKStage);
    if constexpr (G::kF32) {
      bulk_load(dst, head_img + (long long)t * G::kImage, G::kKStage, bar);
    } else {
      for (int c = 0; c < G::kSlices; ++c)
        tma_load_4d(dst + c * G::kKChunk, &kmap, bar, c * G::kSWE, kvh, t * kBK, b);
    }
  };
  auto load_v = [&](int i) {
    const int s = i % kStages;
    const uint32_t bar = vfull0 + 8 * s;
    const uint32_t dst = v_ring + s * G::kVStage;
    const int t = t_lo + i;
    mbar_expect_tx(bar, G::kVStage);
    if constexpr (G::kF32) {
      bulk_load(dst, head_img + (long long)t * G::kImage + G::kKStage, G::kVStage, bar);
    } else {
      for (int c = 0; c < G::kSlices; ++c)
        tma_load_4d(dst + c * G::kKChunk, &vmap, bar, c * G::kSWE, kvh, t * kBK, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, G::kQBytes);
    for (int c = 0; c < G::kSlices; ++c)
      tma_load_4d(q_s + c * G::kQChunk, &qmap, qbar, c * G::kSWE, h, q0, b);
    for (int i = 0; i < n && i < kStages; ++i) {
      load_k(i);
      load_v(i);
    }
  }

  const int wg = threadIdx.x >> 7;  // its output columns [kCols wg, kCols wg + kCols), and S over them
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;       // row in an 8-row group
  const int q4 = lane & 3;       // column pair
  const int r0 = 16 * warp + g;  // this thread's rows r0 and r0 + 8 of the tile
  const float scale2 = scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  float acc[kCols / 8][4];
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  mbar_wait(qbar, 0);
  // float32: this warpgroup's half of Q split once: lo kept in registers
  // as the A operand of Q_lo K_hi, hi written back in place
  uint32_t qlo[G::kQSteps][4];
  if constexpr (G::kF32) {
#pragma unroll
    for (int kk = 0; kk < G::kQSteps; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * (e & 1);
        const int col = kCols * wg + 8 * kk + q4 + 4 * (e >> 1);
        const uint32_t unit = (uint32_t)((col & 31) >> 2) ^ row_bits<128>(row & 7);
        float* p = reinterpret_cast<float*>(gsm + (col >> 5) * G::kQChunk + row * 128 +
                                            (unit << 4) + (col & 3) * 4);
        uint32_t hi;
        split_tf32(*p, hi, qlo[kk][e]);
        *p = __uint_as_float(hi);
      }
    fence_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");  // this half of Q_hi is written
  }

  float4* xchg = reinterpret_cast<float4*>(gsm + G::kXchg);
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    const uint32_t parity = (uint32_t)(i / kStages) & 1u;
    mbar_wait(kfull0 + 8 * s, parity);
    float sc[kNB][4];
    d256_scores<G>(sc, q_s, k_ring + s * G::kKStage, qlo, wg);
    wgmma_wait<0>();
    fence_regs(sc);
    // With two warpgroups each adds the other's half of the scores (the same
    // layout, thread for thread; a + b = b + a, so both hold the same sums).
    // Past the barrier every warpgroup is done with K tile i.
    float4* mine = xchg + ((i & 1) * 2 + wg) * kNB * 128 + tid;
    const float4* theirs = xchg + ((i & 1) * 2 + (wg ^ 1)) * kNB * 128 + tid;
    if constexpr (G::kWG == 2) {
#pragma unroll
      for (int j = 0; j < kNB; ++j)
        mine[128 * j] = make_float4(sc[j][0], sc[j][1], sc[j][2], sc[j][3]);
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(G::kThreads) : "memory");
    if constexpr (G::kWG == 2) {
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const float4 x = theirs[128 * j];
        sc[j][0] += x.x;
        sc[j][1] += x.y;
        sc[j][2] += x.z;
        sc[j][3] += x.w;
      }
    }
    if (threadIdx.x == 0 && i + kStages < n) load_k(i + kStages);
    const int k0 = (t_lo + i) * kBK;
    const int nk = min(kBK, Sk - k0);  // keys of this tile inside [0, Sk)
    const bool edge = nk < kBK || (causal && k0 + kBK - 1 > q0 + q_offset) ||
                      (window > 0 && k0 <= q_end + q_offset - 1 - window);
    const int qi0 = q0 + q_offset + r0;  // this thread's first row, as a key position
    if (edge)
      online_softmax<kNB, true>(sc, m, l, alpha, k0, nk, qi0, q4, causal, window, scale2);
    else
      online_softmax<kNB, false>(sc, m, l, alpha, k0, nk, qi0, q4, causal, window, scale2);
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    mbar_wait(vfull0 + 8 * s, parity);
    d256_pv<G>(acc, sc, v_ring + s * G::kVStage, wg);
    wgmma_wait<0>();
    fence_regs(acc);
    if (i + kStages < n) {  // every warpgroup is done with V tile i: refill its stage now
      asm volatile("bar.sync 1, %0;\n" ::"n"(G::kThreads) : "memory");
      if (threadIdx.x == 0) load_v(i + kStages);
    }
  }

  const bool pair = ((osb | oss | osh | (long long)dim) & 1) == 0;
  const bool whole = pair && dim == G::D;  // paligemma-3b's: every column, paired
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + r0 + 8 * half;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[half], 1e-30f);
    T* orow = o + b * osb + qi * oss + h * osh;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      if (whole)
        store2(orow + kCols * wg + 8 * j + 2 * q4, acc[j][2 * half] / denom,
               acc[j][2 * half + 1] / denom);
      else
        store_cols(orow, kCols * wg + 8 * j + 2 * q4, acc[j][2 * half] / denom,
                   acc[j][2 * half + 1] / denom, dim, pair);
    }
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

// The 4-D map of a [B, S, heads, dim] tensor (strides in elements, the last
// dimension contiguous) whose box is one slice of `rows` rows of one head in
// a geometry of width D >= dim: the row's D elements if they span less than
// 128 bytes, else 128 bytes of them, in the TMA swizzle of that width.  The
// map's extent is the true dim: columns dim .. D-1 (a box partly or wholly
// past it) read as zeros.
template <typename T, int D>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, long long sb,
                     long long ss, long long sh, int rows, int dim) {
  constexpr int kEs = (int)sizeof(T);
  constexpr int kSW = D * kEs < 128 ? D * kEs : 128;
  static const EncodeTiled encode = find_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)dim, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(sh * kEs), (cuuint64_t)(ss * kEs),
                                 (cuuint64_t)(sb * kEs)};
  const cuuint32_t box[4] = {(cuuint32_t)(kSW / kEs), 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = kSW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : kSW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUtensorMapDataType type =
      kEs == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUresult res = encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out of range reads as 0
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Head dim `dim` on the geometry of width D >= dim.
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KVH,
                   int Sq, int Sk, int dim, const long long* st, int causal, int window,
                   int q_offset, float scale, cudaStream_t stream) {
  using G = Geo<T, D>;
  CUtensorMap qm, km, vm;
  cudaError_t err = make_map<T, D>(&qm, q, B, Sq, H, st[0], st[1], st[2], G::kBQ, dim);
  if (err == cudaSuccess)
    err = make_map<T, D>(&km, k, B, Sk, KVH, st[3], st[4], st[5], G::kBK, dim);
  if (err == cudaSuccess)
    err = make_map<T, D>(&vm, v, B, Sk, KVH, st[3], st[4], st[5], G::kBK, dim);
  if (err != cudaSuccess) return err;
  const bool whole = ((st[6] | st[7] | st[8] | (long long)dim) & 1) == 0 && dim % 8 == 0;
  auto kernel = whole ? flash_attention_kernel<T, D, true> : flash_attention_kernel<T, D, false>;
  static int smem_set[2][kMaxDevices] = {};
  err = ensure_smem(kernel, G::kSmem, smem_set[whole]);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + G::kBQ - 1) / G::kBQ, H, B);
  kernel<<<grid, G::kThreads, G::kSmem, stream>>>(qm, km, vm, static_cast<T*>(o), H, KVH, Sq, Sk,
                                                st[6], st[7], st[8], causal, window, q_offset,
                                                scale, dim);
  return cudaGetLastError();
}

// Bytes of the float32 D = 256 images: every kv tile of every (b, kv head).
long long d256_workspace_bytes(int B, int KVH, int Sk) {
  using G = Geo256Of<float>::G;
  return (long long)B * KVH * ((Sk + G::kBK - 1) / G::kBK) * G::kImage;
}

// Head dim `dim` from 129 to 256 on the head-dim-256 geometry: float32
// splits K and V into the workspace first (a second launch on the same
// stream), bfloat16 reads them through tensor maps.
template <typename T>
cudaError_t launch_d256(const void* q, const void* k, const void* v, void* o, void* ws,
                        long long ws_bytes, int B, int H, int KVH, int Sq, int Sk, int dim,
                        const long long* st, int causal, int window, int q_offset, float scale,
                        cudaStream_t stream) {
  using G = typename Geo256Of<T>::G;
  CUtensorMap qm{}, km{}, vm{};
  cudaError_t err = make_map<T, 256>(&qm, q, B, Sq, H, st[0], st[1], st[2], G::kBQ, dim);
  if (err != cudaSuccess) return err;
  if constexpr (G::kF32) {
    if (ws == nullptr || ws_bytes < d256_workspace_bytes(B, KVH, Sk)) return cudaErrorInvalidValue;
    const dim3 grid((Sk + G::kBK - 1) / G::kBK * (G::kBK / 8), B * KVH);
    flash_attention_split_kv_kernel<G><<<grid, 256, 0, stream>>>(
        static_cast<const float*>(k), static_cast<const float*>(v), static_cast<uint8_t*>(ws),
        KVH, Sk, st[3], st[4], st[5], dim);
    err = cudaGetLastError();
  } else {
    err = make_map<T, 256>(&km, k, B, Sk, KVH, st[3], st[4], st[5], G::kBK, dim);
    if (err == cudaSuccess)
      err = make_map<T, 256>(&vm, v, B, Sk, KVH, st[3], st[4], st[5], G::kBK, dim);
  }
  if (err != cudaSuccess) return err;
  auto kernel = flash_attention_d256_kernel<T, G>;
  static int smem_set[kMaxDevices] = {};
  err = ensure_smem(kernel, G::kSmem, smem_set);
  if (err != cudaSuccess) return err;
  // the SMs and how many blocks of this kernel each holds at once, for the
  // kernel's order of work (asked once a device, under the process-wide lock
  // ensure_smem takes: host threads launch on several streams at once)
  static int n_sm[kMaxDevices] = {}, resident[kMaxDevices] = {};
  int dev = 0, sms = 0, res = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> lock(repro::smem_mutex());
    if (n_sm[dev] == 0) {
      int blocks = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, G::kThreads,
                                                            G::kSmem);
      if (err != cudaSuccess) return err;
      n_sm[dev] = sms;
      resident[dev] = sms * (blocks > 0 ? blocks : 1);
    }
    sms = n_sm[dev];
    res = resident[dev];
  }
  const long long n_blocks = (long long)((Sq + G::kBQ - 1) / G::kBQ) * H * B;
  if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)n_blocks, G::kThreads, G::kSmem, stream>>>(
      qm, km, vm, static_cast<const uint8_t*>(ws), static_cast<T*>(o), B, H, KVH, Sq, Sk, st[6],
      st[7], st[8], causal, window, q_offset, scale, sms, res, dim);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, void* o, void* ws,
                     long long ws_bytes, int B, int H, int KVH, int Sq, int Sk,
                     const long long* st, int causal, int window, int qo, float scale,
                     cudaStream_t stream) {
  if (D < 1 || D > 256) return cudaErrorInvalidValue;
  if (D > 128)  // 129 .. 256 on the head-dim-256 geometry
    return launch_d256<T>(q, k, v, o, ws, ws_bytes, B, H, KVH, Sq, Sk, D, st, causal, window,
                          qo, scale, stream);
  // the next instantiated width: 8 at 16; 48 at 64; 72, 100 and 112 at 128
  if (D <= 16) return launch<T, 16>(q, k, v, o, B, H, KVH, Sq, Sk, D, st, causal, window, qo, scale, stream);
  if (D <= 32) return launch<T, 32>(q, k, v, o, B, H, KVH, Sq, Sk, D, st, causal, window, qo, scale, stream);
  if (D <= 64) return launch<T, 64>(q, k, v, o, B, H, KVH, Sq, Sk, D, st, causal, window, qo, scale, stream);
  return launch<T, 128>(q, k, v, o, B, H, KVH, Sq, Sk, D, st, causal, window, qo, scale, stream);
}

}  // namespace

// The keys of a float32 head-dim-256 kv tile, for the wrapper's workspace:
// it holds 4 x 256 float32 a key of whole tiles.
extern "C" int repro_flash_attention_split_tile() { return Geo256Of<float>::G::kBK; }

// q/o [B, Sq, H, D], k/v [B, Sk, KVH, D]; strides in elements, last dim 1;
// k and v share their strides.  D: 1 to 128 on the next instantiated
// width's geometry (16, 32, 64, 128), 129 to 256 on the head-dim-256 one;
// anything else returns cudaErrorInvalidValue.  Row i of q sits at key position q_offset + i
// (>= 0; a rank's rows of a sequence-sharded q): the causal mask and the
// window compare those positions.  bf16 != 0: bfloat16 tensors, else float32.
// TMA needs q, k and v 16-byte aligned and every stride a multiple of 16
// bytes (the wrapper checks; a map that cannot be encoded returns
// cudaErrorInvalidValue).  The workspace (16-byte aligned, ws_bytes long)
// is used by float32 at D from 129 to 256 only, which needs B KVH ceil(Sk / tile)
// tile 4096 bytes (tile: repro_flash_attention_split_tile()) and returns
// cudaErrorInvalidValue with less; any other call may pass NULL.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     void* ws, long long ws_bytes, int B, int H, int KVH,
                                     int Sq, int Sk, int D, int bf16, long long qsb,
                                     long long qss, long long qsh, long long ksb, long long kss,
                                     long long ksh, long long osb, long long oss, long long osh,
                                     int causal, int window, int q_offset, float scale,
                                     void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KVH < 1 || H % KVH != 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = bf16 ? dispatch<__nv_bfloat16>(D, q, k, v, o, ws, ws_bytes, B, H, KVH, Sq,
                                                   Sk, st, causal, window, q_offset, scale, s)
                         : dispatch<float>(D, q, k, v, o, ws, ws_bytes, B, H, KVH, Sq, Sk, st,
                                           causal, window, q_offset, scale, s);
  return (int)err;
}
