// Flash attention forward and backward for Hopper (sm_90a), written by hand.
//
// Counterparts of the Pallas TPU kernels in
// paddle_tpu/ops/pallas/flash_attention.py, one kernel for each kernel and
// dot strategy (FLAGS_flash_dot_impl) of the reference:
//   _fwd_kernel (:83)       bf16: flash_fwd_mma_kernel<D, kStd>
//                           nn, nn2: flash_fwd_mma_kernel<D, kNN> (reads K^T)
//                           f32: flash_fwd_mma_kernel<D, kStd, kSplit>
//   _dq_kernel (:174)       bf16: flash_dq_mma_kernel<D, kStd>
//                           f32: flash_dq_mma_kernel<D, kStd, kSplit>
//   _dq_kernel_nn (:203)    nn, nn2: flash_dq_mma_kernel<D, kNN> (reads K^T
//                           and V^T)
//   _dkv_kernel (:233)      bf16: flash_dkv_mma_kernel<D, kStd>
//                           nn: flash_dkv_mma_kernel<D, kNN> (reads K^T, V^T)
//                           f32: flash_dkv_mma_kernel<D, kStd, kSplit>
//   _dkv_kernel_nn2 (:289)  nn2: flash_dkv_mma_kernel<D, kNN2> (reads K^T,
//                           V^T, Q^T and dO^T, writes dK^T and dV^T)
//   probe's kern (:467)     flash_probe_kernel (the dot-form probe)
// That is on bf16 storage at D = 64, 128 and 256 (at D = 256 the same
// kernels have bodies of their own: fwd_d256_body, dq_d256_body,
// dkv_d256_body). On f32 storage every strategy runs the kF32 instances
// flash_fwd_mma_kernel<D, kStd, kF32>, flash_dq_mma_kernel<D, kStd, kF32>
// and flash_dkv_mma_kernel<D, kStd, kF32>, which read Q, K, V and dO as the
// bf16 terms flash_split_kernel made of them (nn and nn2 split their
// transposed operands into the same terms, and nn2's dK/dV stores dK^T and
// dV^T), at every head_dim.
// Each computes what its TPU counterpart computes, with the same numerics:
// dots accumulate in f32, sm_scale is applied in f32 after the Q.K dot,
// masked scores are -1e30 (not -inf). Under bf16, nn and nn2, P is rounded
// to the input dtype before P.V, and P and dS are rounded to the input
// dtype only where they enter a dot; strategy f32 computes every dot in
// f32 and rounds only what it stores (on bf16 storage the kSplit instances
// form their f32 dots from exact bf16 products, see the forward's note).
// delta = rowsum(dO * O) comes from the caller, in f32.
//
// Layout: q, k, v, o, dO, dQ, dK, dV are [B, L, H, D] contiguous (the
// public layout, read through strides); the transposed operands of nn and
// nn2 (K^T, V^T, Q^T, dO^T, dK^T, dV^T) are [B, H, D, L] contiguous, made
// and undone by torch transposes outside the kernels, as XLA makes them
// outside the TPU kernels. LSE and delta are [B, H, L] f32. D is 64, 128 or
// 256; L a multiple of 64. Other head_dims up to 256 and lengths that are a
// multiple of a smaller block reach the kernels zero-padded (by the caller,
// ops/flash_attention.py): zero columns add exact zeros to every score,
// and the forward and dQ mask the keys at and past kv_len, the true length.
//
// Tiling. The TPU kernels hold a whole K/V row of the head in VMEM; on the
// H100 that is 256 KB at L = 1024, D = 64 in bf16, beyond a block's 227 KB
// of shared memory, so every kernel streams tiles through shared memory. A
// block owns output tiles that no other block touches: the forward and dQ
// per query tile, dK/dV per key tile, so no block reduces across blocks and
// no atomics are needed. The causal loop bounds of the TPU kernels (kmax,
// qstart) are kept. The forward's softmax blocks are 128 keys wide (one
// tile, or two 64-key tiles), the reference's flash_block_k, so P is
// rounded against the running max at the reference's own block
// boundaries; elsewhere the tile sizes change only the order of f32 sums.
//
// Bound. At the GPT-350M training shape (B*H = 128, L = 1024, D = 64,
// causal, bf16) each kernel reads and writes 67-134 MB and does 1.7e10 to
// 3.4e10 flops, so on the tensor cores bytes and flops bound it about
// equally, at 20-40 us. The forward, dQ and dK/dV (the Hopper path below)
// are persistent and warp-specialised: a producer warpgroup keeps TMA
// loads of the streamed tiles in flight in a ring of shared-memory stages
// across work items, two consumer warpgroups run every product as wgmma,
// and the score tile stays in registers as the A operand of the next
// product. At D = 64 the softmax's exponentials (one MUFU op per score)
// take as many cycles as the products; the forward's consumers take turns
// at the tensor cores so that one's softmax overlaps the other's products
// (PERF.md has the ablations and each kernel's time on an H100). The
// f32-dot forward, dQ and dK/dV on bf16 storage are the kSplit instances
// of these kernels, whose f32 dots are bf16 tensor-core products (exact in
// f32) of split operands. On f32 storage the forward, dQ and dK/dV split
// both operands of every product and run six bf16 tensor-core passes a
// product (kF32), operations-bound on the tensor cores. At D = 256 every
// kernel of every strategy on both storages is a tensor-core instance too,
// whose O, dQ, dK and dV fill 128 registers a thread (their notes say how
// they fit).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;  // rows of a query tile and of a key tile
constexpr int kWideD = 256;  // the widest head_dim, whose kernels have
                             // bodies of their own
constexpr float kNegInf = -1e30f;

// Which operands arrive transposed ([B, H, D, L]): none (kStd, strategy
// bf16 and f32), K^T and V^T (kNN), also Q^T and dO^T in and dK^T and
// dV^T out of the dK/dV kernel (kNN2).
enum Form { kStd = 0, kNN = 1, kNN2 = 2 };

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------- Hopper path
// The forward, dQ and dK/dV kernels. A block has three warpgroups: a producer
// (warpgroup 0, its registers cut to kProducerRegs by setmaxnreg), whose
// first thread issues every TMA load, and two consumers (warpgroups 1 and
// 2, raised to kConsumerRegs), each owning 64 rows of the block's output
// tile and running every product as wgmma. The streamed tiles pass through
// a ring of shared-memory stages, each with a `full` mbarrier (the
// producer's arrival with the byte count, completed by the TMA) and an
// `empty` one (every consumer thread arrives when its products on the
// stage are done).
//
// Every tile sits in shared memory as TMA leaves it under the 128-byte
// swizzle: rows of 64 bf16 (128 bytes), eight rows to a 1024-byte atom, a
// wider row split into 64-column chunks. One such tile is read K-major (its
// 64 columns are the product's depth) or, through the descriptor's
// transpose bit, MN-major (its rows are the depth): so a tile that two
// products read along different dimensions is loaded once, and the
// transposed operands of nn and nn2 come by TMA in their own layout with
// the bits swapped. The tensor cores then see the same products as for
// bf16, which keeps nn and nn2 bitwise bf16's.
//
// Budget: 128 threads x 40 registers + 256 x 232 = 64,512 of the SM's
// 65,536, so one block per SM (a block with one consumer: 128 x 40 + 128 x
// 256). Each kernel's shared memory is at least
// kOneBlockSmem, more than half of the SM's 228 KB less the 1 KB each block
// reserves, so that no second block is placed beside it (its consumers
// could not get their registers).

constexpr int kWG = 128;                  // threads of a warpgroup
constexpr int kHopperThreads = 3 * kWG;   // producer + two consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// a block with one consumer (kF32 at D = 128) gives it the most setmaxnreg
// allows: 128 x 40 + 128 x 256 of the 256 x 168 the block starts with
constexpr int kSoleConsumerRegs = 256;
constexpr int kSeg = 64;                  // bf16 in one 128-byte row
constexpr int kRowBytes = 128;
constexpr int kAtomBytes = 8 * kRowBytes; // one swizzle atom: 8 rows
constexpr int kChunk = 64 * kRowBytes;    // 64 rows x 64 columns
constexpr int kBig = 128;                 // forward key tile, dK/dV block
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kOneBlockSmem = 116 * 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x in one MUFU instruction (subnormal results flush to 0; P enters the
// products in bf16, whose smallest normal is f32's)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// max / sum over the 4 lanes (t = 0..3) that hold one row of an
// accumulator
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Work item `it` of this block in a persistent grid of G blocks: the
// items (head, tile) are numbered heaviest causal tile first (rank =
// idx / n_heads, rank 0 the heaviest; head = idx % n_heads) and dealt in
// snake order, block b taking item it * G + b in even rounds and it * G +
// G - 1 - b in odd ones, so that every block gets about the same work.
// False past the last item.
__device__ __forceinline__ bool work_item(int it, int n_heads, int n_items,
                                          int& bh, int& rank) {
  const int G = gridDim.x, blk = blockIdx.x;
  const int idx = it * G + ((it & 1) ? G - 1 - blk : blk);
  if (idx >= n_items) return false;
  bh = idx % n_heads;
  rank = idx / n_heads;
  return true;
}

// Byte offset of element (r, c), c < 64, in a [rows][64] bf16 tile under
// the 128-byte swizzle (16-byte chunk c/8 of row r moved to (c/8) ^ (r%8)).
__device__ __forceinline__ int swz(int r, int c) {
  return r * kRowBytes + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrive, and expect `bytes` more from the copies that complete on `bar`.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive_at(uint32_t a) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(a) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  mbar_arrive_at(smem_addr(bar));
}
// Wait for the completion of the barrier's phase of this parity. A wait
// that lasts 2^34 clocks (about 10 s) traps: the launch then fails with an
// error instead of holding the card.
__device__ __forceinline__ void mbar_wait_at(uint32_t a, int parity) {
  long long start = 0;
  for (int n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (n == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  mbar_wait_at(smem_addr(bar), parity);
}

// The box of `map` at (c0 = column, c1 = row) into shared memory at dst.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// `bytes` contiguous bytes (a multiple of 16) from global memory.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
      "[%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)),
         "r"(c0), "r"(c1)
      : "memory");
}
// Commit this thread's stores and wait until they have read shared memory.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Make this thread's shared-memory stores visible to the TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// wgmma descriptor of a 128-byte-swizzled tile at shared address `addr`:
// 8-row groups 1024 bytes apart (SBO); `lbo`, the distance between 64-wide
// blocks of the M or N dimension, matters only to an MN-major read.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo = 16) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(kAtomBytes >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of wgmmas are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of accumulator registers
// across a wgmma fence or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
// The same for register A fragments, which a running wgmma still reads.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e]) :: "memory");
}

// Accumulator operands of a wgmma: "+f"(d[0]) .. "+f"(d[N - 1]).
#define WG_F8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_F16 WG_F8(0), WG_F8(8)
#define WG_F32 WG_F16, WG_F8(16), WG_F8(24)
#define WG_F64 WG_F32, WG_F8(32), WG_F8(40), WG_F8(48), WG_F8(56)
#define WG_F128 WG_F64, WG_F8(64), WG_F8(72), WG_F8(80), WG_F8(88),      \
    WG_F8(96), WG_F8(104), WG_F8(112), WG_F8(120)

// d (64 x 32, f32) = A.B, + d if scale_d; A and B from shared memory,
// transposed (MN-major) where TA / TB is 1
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : WG_F16
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 64, f32) = A.B, + d if scale_d; A and B from shared memory,
// transposed (MN-major) where TA / TB is 1
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : WG_F32
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 64, f32) += A.B: A (64 x 16, bf16) from registers, B from
// shared memory, transposed where TB is 1
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, "
      "%38;\n}\n"
      : WG_F32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

// d (64 x 128, f32) = A.B, + d if scale_d; A and B from shared memory,
// transposed (MN-major) where TA / TB is 1
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : WG_F64
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 128, f32) += A.B: A (64 x 16, bf16) from registers, B from
// shared memory, transposed where TB is 1
template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, "
      "%70;\n}\n"
      : WG_F64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

// d (64 x 256, f32) += A.B: A (64 x 16, bf16) from registers, B from
// shared memory, transposed where TB is 1. The D = 256 kernels' output
// products: one instruction a depth step, A's fragment read once (two
// m64n128 products would hold the same 128 accumulator registers and
// issue twice)
template <int TB>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, "
      "%134;\n}\n"
      : WG_F128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

template <int TA, int TB, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 16) wgmma_ss_n32<TA, TB>(d, da, db, scale_d);
  else if constexpr (N == 32) wgmma_ss_n64<TA, TB>(d, da, db, scale_d);
  else wgmma_ss_n128<TA, TB>(d, da, db, scale_d);
}
template <int TB, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 32) wgmma_rs_n64<TB>(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n128<TB>(d, a, db);
  else wgmma_rs_n256<TB>(d, a, db);
}

// A wgmma accumulator (64 rows, N/2 floats a thread) holds, in thread
// (warp w, lane 4g + t) of its warpgroup, element i at row 16w + g +
// 8 * ((i >> 1) & 1) and column 8 * (i >> 2) + 2t + (i & 1). Columns
// 16kk .. 16kk+15 of it, rounded to bf16 in pairs, are the register A
// fragment of a product whose depth runs over those columns.
template <int N>
__device__ __forceinline__ void acc_to_a16(uint32_t (&a)[4],
                                           const float (&acc)[N], int kk) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    a[e] = pack_bf16(acc[8 * kk + 2 * e], acc[8 * kk + 2 * e + 1]);
}

// Two f32 values x0, x1 split into three bf16 pairs, hi = bf16(x), mid =
// bf16(x - hi), lo = bf16(x - hi - mid): both subtractions are exact in
// f32, and the three terms hold the 24 significant bits of x, so hi + mid +
// lo = x, of either sign, for |x| down to about 2^-110, below which lo
// would be subnormal (an error under 2^-126 absolute).
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The same columns of an f32 accumulator split into three bf16 fragments
// (split_pair; P in [0, 1], dS signed and unbounded). Three bf16 products
// of the terms against one bf16 tile then form x.B with every product
// exact in f32, as an f32 dot of x with the bf16 values forms it.
template <int N>
__device__ __forceinline__ void acc_to_a16_split(uint32_t (&hi)[4],
                                                 uint32_t (&mid)[4],
                                                 uint32_t (&lo)[4],
                                                 const float (&acc)[N],
                                                 int kk) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    split_pair(acc[8 * kk + 2 * e], acc[8 * kk + 2 * e + 1], hi[e], mid[e],
               lo[e]);
}

// Operand modes of the forward, dQ and dK/dV kernels:
//   kBf16   bf16 storage, P and dS rounded to bf16 for their products
//           (strategies bf16, nn and nn2);
//   kSplit  bf16 storage, P and dS kept f32 and each split into three bf16
//           terms (strategy f32);
//   kF32    f32 storage (every strategy): Q, K, V and dO arrive as the
//           hi, mid and lo bf16 terms that flash_split_kernel made of them,
//           every f32 product runs as six bf16 passes of term pairs
//           (pass_a, pass_b), and O, dQ, dK and dV are stored in f32.
enum Mode { kBf16 = 0, kSplit = 1, kF32 = 2 };

// The six term pairs (a, b) of a product of two split f32 values (term 0
// hi, 1 mid, 2 lo), small weights first: lo.hi, hi.lo and mid.mid (about
// 2^-16 of the product), mid.hi and hi.mid (2^-8), hi.hi. The pairs left
// out, mid.lo, lo.mid and lo.lo, weigh under 2^-24 of the product, below
// f32's own rounding. Every pass is exact in its products.
constexpr int kPasses = 6;
// the pass loops of S and dP (S^T and dP^T) read both operands from shared
// memory, so a pass index need not be a constant: at D = 128 (kF32) they
// stay rolled, which keeps ptxas from holding every pass's descriptors
template <int D, int Mode>
constexpr int kUnrollPasses = Mode == kF32 && D == 128 ? 1 : kPasses;
__host__ __device__ constexpr int pass_a(int p) {
  return p == 0 ? 2 : (p == 2 || p == 3) ? 1 : 0;
}
__host__ __device__ constexpr int pass_b(int p) {
  return p == 1 ? 2 : (p == 2 || p == 4) ? 1 : 0;
}

// Shared memory of the forward: two buffers of a 128-row Q tile (64 rows
// for each consumer; item k uses buffer k % 2, so the next item's Q loads
// while this one finishes), then kStages ring stages of a 128-key K tile
// and of a V tile, then the barriers. At D = 64: 2 x 16 + 3 x 32 KB; at
// D = 128: 2 x 32 + 2 x 64 KB.
template <int D>
struct FwdSmem {
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kQ = kChunk * (D / kSeg);            // 64 query rows
  static constexpr int kKV = 2 * kChunk * (D / kSeg);       // 128 keys
  static constexpr size_t kBytes =
      4 * kQ + 2 * kStages * kKV + 8 * (4 + 3 * kStages) + 1024;
  static_assert(kBytes >= kOneBlockSmem, "one block per SM");
};

// Forward (_fwd_kernel :83). Bound: bytes, 0.020 ms at the training shape
// (Q, K, V read once, O and LSE written once). A persistent grid, one
// block per SM, walks the (head, 128-row query tile) items heaviest causal
// tile first (work_item). The producer loads each item's Q into one of two
// buffers and every K and V tile of its causal range into the ring, across
// item boundaries. A consumer runs, per key tile, S = Q.K^T (wgmma, both
// from shared memory: kStd reads K K-major, kNN reads K^T's tile through
// the transpose bit), the online softmax in registers (the causal mask
// only on the diagonal tile, keys at and past kv_len, the true length of
// zero-padded inputs, or past L only on a last tile), and O
// += P.V with P from registers and V's row tile read through the transpose
// bit. The next tile's S is issued with this tile's P.V, and the two
// consumers take turns at issuing products (named barriers), so that one
// runs its softmax while the tensor cores run the other's products. O
// leaves through the consumer's Q rows and a TMA store; LSE (natural log)
// as [B, H, L] f32. Rows past L (L = 64 mod 128) are skipped by their
// consumer, which still walks the ring and takes its turns.
//
// kSplit (strategy f32 on bf16 storage, _fwd_kernel's f32 form :120): the
// same kernel with every dot of the f32 function. S = Q.K^T is already
// exact in its products (a product of two bf16 values is exact in f32), so
// only P.V changes: P stays f32 for the row sums and LSE and is split into
// three bf16 terms (acc_to_a16_split), each multiplied by the same V tile
// into O, the small terms first. So P.V has P's f32 products, summed in
// f32 by the tensor cores in their own order. The three fragments of P
// cost 48 registers a step, so a step covers 64 keys (half a ring stage): its
// scores, its fragments and the previous step's fragments in flight fit
// beside O at D = 128 too. Four bf16 passes of 2 D flops a causal pair
// bound it: operations, 0.035 ms at the training shape.
// map_q, map_o: [B*L, H*D], boxes of 64 rows; map_v and, for kStd, map_k:
// [B*L, H*D], boxes of 128 rows; kNN's map_k: K^T as [B*H*D, L], boxes of
// D rows. (The kernel's body on bf16 storage; kF32 is fwd_f32_body.)
template <int D, int Form, bool Split>
__device__ __forceinline__ void fwd_bf16_body(
    const CUtensorMap& map_q, const CUtensorMap& map_k,
    const CUtensorMap& map_v, const CUtensorMap& map_o,
    float* __restrict__ lse, int BH, int H, int L, float scale, int causal,
    int kv_len) {
  using Smem = FwdSmem<D>;
  constexpr int C = D / kSeg, S = Smem::kStages;
  constexpr int NK = Split ? 64 : kBig;   // keys of one softmax step
  constexpr int R = kBig / NK;            // steps per ring stage
  constexpr int NP = Split ? 3 : 1;       // bf16 terms of P
  constexpr int KK = NK / 16;             // depth steps of P.V
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = align_1024(smem_raw);   // [buffer][consumer]
  unsigned char* k_s = q_s + 4 * Smem::kQ;
  unsigned char* v_s = k_s + S * Smem::kKV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + S * Smem::kKV);
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* v_full = k_full + S;
  uint64_t* empty = v_full + S;

  const int num_t = (L + kBig - 1) / kBig;
  const int n_items = BH * num_t;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 2);        // one thread of each consumer
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 2 * kWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    // ---- producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int n = 0;   // K/V tiles loaded so far
      int bh, rank;
      for (int it = 0; work_item(it, BH, n_items, bh, rank); ++it) {
        const int b = bh / H, h = bh % H, qt = num_t - 1 - rank;
        const int row0 = b * L, q0 = qt * kBig;
        const int kmax = causal ? qt + 1 : num_t;
        const int qb = it & 1;
        if (it >= 2) mbar_wait(&q_empty[qb], ((it >> 1) - 1) & 1);
        mbar_expect_tx(&q_full[qb], 2 * Smem::kQ);
        for (int w = 0; w < 2; ++w)
          for (int c = 0; c < C; ++c)
            tma_load(q_s + (2 * qb + w) * Smem::kQ + c * kChunk, &map_q,
                     &q_full[qb], h * D + c * kSeg, row0 + q0 + w * 64);
        for (int j = 0; j < kmax; ++j, ++n) {
          const int s = n % S, k0 = j * kBig;
          if (n >= S) mbar_wait(&empty[s], (n / S - 1) & 1);
          unsigned char* kd = k_s + s * Smem::kKV;
          unsigned char* vd = v_s + s * Smem::kKV;
          mbar_expect_tx(&k_full[s], Smem::kKV);
          if constexpr (Form == kStd) {
            for (int c = 0; c < C; ++c)
              tma_load(kd + c * 2 * kChunk, &map_k, &k_full[s],
                       h * D + c * kSeg, row0 + k0);
          } else {
            for (int u = 0; u < 2; ++u)   // [D][64] slabs of keys
              tma_load(kd + u * D * kRowBytes, &map_k, &k_full[s],
                       k0 + u * kSeg, bh * D);
          }
          mbar_expect_tx(&v_full[s], Smem::kKV);
          for (int c = 0; c < C; ++c)
            tma_load(vd + c * 2 * kChunk, &map_v, &v_full[s],
                     h * D + c * kSeg, row0 + k0);
        }
      }
    }
  } else {
    // ---- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int w = threadIdx.x / kWG - 1;
    const bool leader = (threadIdx.x & (kWG - 1)) == 0;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r_lo = 16 * warp + g;          // rows r_lo and r_lo + 8
    // The consumers take turns at issuing products (named barriers 3 and
    // 4): one issues while the other runs its softmax. Consumer 0 first.
    auto my_turn = [&]() { named_sync(3 + w, 2 * kWG); };
    auto pass_turn = [&]() { named_arrive(4 - w, 2 * kWG); };
    if (w == 1) named_arrive(3, 2 * kWG);
    int n = 0;                               // K/V tiles consumed so far
    int bh, rank;
    for (int it = 0; work_item(it, BH, n_items, bh, rank); ++it) {
      const int b = bh / H, h = bh % H, qt = num_t - 1 - rank;
      const int q0 = qt * kBig, row_lo = q0 + w * 64 + r_lo;
      const int kmax = causal ? qt + 1 : num_t;
      const int steps = kmax * R;
      const int qb = it & 1, n0 = n;
      n += kmax;
      mbar_wait(&q_full[qb], (it >> 1) & 1);
      if (q0 + w * 64 >= L) {   // rows past L: walk the ring and the turns
        for (int j = 0; j <= steps; ++j) {
          my_turn();
          pass_turn();
          if (j == steps) break;
          if (j % R) continue;
          const int s = (n0 + j / R) % S, parity = ((n0 + j / R) / S) & 1;
          mbar_wait(&k_full[s], parity);
          mbar_wait(&v_full[s], parity);
          mbar_arrive(&empty[s]);
        }
        if (leader) mbar_arrive(&q_empty[qb]);
        continue;
      }
      unsigned char* my_q = q_s + (2 * qb + w) * Smem::kQ;
      const uint32_t qa = smem_addr(my_q);

      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
      float sc[NK / 2];       // S, then P, of one step's keys
      uint32_t pa[NP * KK][4];  // P in bf16 (Split: lo, mid, hi), A of P.V

      // Issue S = Q.K^T of step j's keys into sc (waited for by the caller).
      auto issue_s = [&](int j) {
        const int s = (n0 + j / R) % S, u = j % R;
        const uint32_t kb = smem_addr(k_s + s * Smem::kKV);
        mbar_wait(&k_full[s], ((n0 + j / R) / S) & 1);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint64_t da = desc(qa + (ks / 4) * kChunk + (ks % 4) * 32);
          if constexpr (Form == kStd)
            wgmma_ss<0, 0>(sc, da,
                           desc(kb + u * kChunk + (ks / 4) * 2 * kChunk +
                                (ks % 4) * 32),
                           ks);
          else
            wgmma_ss<0, 1>(sc, da, desc(kb + u * D * kRowBytes +
                                            ks * 16 * kRowBytes,
                                        D * kRowBytes), ks);
        }
        wgmma_commit();
      };
      // Issue O += P.V of step j's keys from pa.
      auto issue_pv = [&](int j) {
        const int s = (n0 + j / R) % S, u = j % R;
        const uint32_t vb = smem_addr(v_s + s * Smem::kKV) + u * kChunk;
        mbar_wait(&v_full[s], ((n0 + j / R) / S) & 1);
        wgmma_fence();
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int kk = 0; kk < KK; ++kk)
            wgmma_rs<1>(o, pa[p * KK + kk],
                        desc(vb + kk * 16 * kRowBytes, 2 * kChunk));
        wgmma_commit();
      };
      // Step j's stage is done with once its last P.V is.
      auto release = [&](int j) {
        if (j % R == R - 1) mbar_arrive(&empty[(n0 + j / R) % S]);
      };
      // The online softmax of step j: sc from S to P (f32, against the
      // running max m of the scaled scores), m and l updated; alpha
      // rescales the O of earlier steps. The scale is applied in f32 inside
      // the exponent's FMA (scale * log2 e folded in); a masked score (past
      // the causal diagonal, or a key at or past kv_len) is -inf there, so
      // its P is 0, as exp(-1e30 - m) is, and the max of a
      // row's scaled scores is its largest raw score times the scale
      // (every row sees key 0, in its first step).
      auto softmax = [&](int j, float (&alpha)[2]) {
        const int k0 = j * NK;
        const bool edge =
            (causal && k0 + NK > q0 + w * 64) || k0 + NK > kv_len;
        const float scale_log2 = scale * kLog2e;
        if (edge) {   // a branch around the loop: only edge steps pay
#pragma unroll
          for (int i = 0; i < NK / 2; ++i) {
            const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
            const int row = row_lo + 8 * ((i >> 1) & 1);
            if ((causal && key > row) || key >= kv_len) sc[i] = -INFINITY;
          }
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < NK / 2; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        float neg_m[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[r], quad_max(mx[r]) * scale);
          alpha[r] = ex2((m[r] - m_new) * kLog2e);
          m[r] = m_new;
          neg_m[r] = -m_new * kLog2e;
        }
#pragma unroll
        for (int i = 0; i < NK / 2; ++i) {
          const int r = (i >> 1) & 1;
          const float p = ex2(fmaf(sc[i], scale_log2, neg_m[r]));
          sum[r] += p;
          sc[i] = p;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
          l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
      };
      auto pack_p = [&]() {
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          if constexpr (Split)
            acc_to_a16_split(pa[2 * KK + kk], pa[KK + kk], pa[kk], sc, kk);
          else
            acc_to_a16(pa[kk], sc, kk);
        }
      };

      // Step j's S and step j-1's P.V are issued together, and S is waited
      // for alone (wait_group 1). (ptxas hoists the wait for P.V above the
      // softmax; the overlap comes from the consumers' turns.)
      float alpha[2];
      my_turn();
      issue_s(0);
      pass_turn();
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(0, alpha);
      pack_p();
      for (int j = 1; j < steps; ++j) {
        my_turn();
        issue_s(j);
        issue_pv(j - 1);
        pass_turn();
        wgmma_wait<1>();
        fence_regs(sc);
        softmax(j, alpha);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        release(j - 1);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        pack_p();
      }
      my_turn();
      issue_pv(steps - 1);
      pass_turn();
      wgmma_wait<0>();
      fence_regs(o);
      release(steps - 1);

      // O = acc / l in bf16, staged in this consumer's Q rows (free since
      // its last S product) as the store map's swizzled boxes
#pragma unroll
      for (int j8 = 0; j8 < D / 8; ++j8)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int c = 8 * j8 + 2 * t;
          *reinterpret_cast<uint32_t*>(
              my_q + (c / kSeg) * kChunk + swz(r_lo + 8 * r, c % kSeg)) =
              pack_bf16(o[4 * j8 + 2 * r] / l[r],
                        o[4 * j8 + 2 * r + 1] / l[r]);
        }
      if (t == 0)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          lse[(size_t)bh * L + row_lo + 8 * r] = m[r] + logf(l[r]);
      fence_async_smem();
      named_sync(1 + w, kWG);
      if (leader) {
        for (int c = 0; c < C; ++c)
          tma_store(&map_o, my_q + c * kChunk, h * D + c * kSeg,
                    b * L + q0 + w * 64);
        tma_store_wait();            // the buffer may take the next Q
        mbar_arrive(&q_empty[qb]);
      }
    }
  }
}

// Shared memory of the kF32 forward: the Q rows of its consumers in three
// terms (one buffer: the terms triple the tiles), then a ring of kSlots
// slots, each a 64-key tile of K or of V in its three terms, then the
// barriers. D = 64: two consumers, 2 x 24 + 6 x 24 KB; D = 128: one
// consumer, which takes an item's two 64-row halves in turn (rounds), 48 +
// 3 x 48 KB.
template <int D>
struct FwdF32Smem {
  static constexpr int kNC = D == 128 ? 1 : 2;        // consumers
  static constexpr int kT = kChunk * (D / kSeg);      // 64 rows of one term
  static constexpr int kSlots = D == 64 ? 6 : 3;
  static constexpr size_t kBytes =
      (size_t)(kNC + kSlots) * 3 * kT + 8 * (2 + 2 * kSlots) + 1024;
  static_assert(kBytes >= kOneBlockSmem, "one block per SM");
  static_assert(kBytes <= 227 * 1024, "fits in a block's shared memory");
};

// Threads of a forward block: the producer and the consumers (one consumer
// is compiled for its 256 threads, as kBwdThreads says; kF32 at D = 256 has
// one, see fwd_f32_d256_body).
template <int D, int Mode>
constexpr int fwd_threads() {
  if constexpr (Mode == kF32 && D == kWideD) return 2 * kWG;
  else if constexpr (Mode == kF32) return (1 + FwdF32Smem<D>::kNC) * kWG;
  else return kHopperThreads;
}
template <int D, int Mode>
constexpr int kFwdThreads = fwd_threads<D, Mode>();

// kF32 (f32 storage, _fwd_kernel :83 for every strategy): the forward of
// PR 6's kF32 dQ and dK/dV. Q, K and V arrive as the hi, mid and lo bf16
// terms of flash_split_kernel (nn and nn2 split K^T into the same terms,
// so they give kStd's results bitwise). A persistent grid walks the (head,
// 128-row query tile) items as above; the producer loads each round's Q
// terms into the one buffer and, per 128-key softmax block (the
// reference's flash_block_k, so the running max moves at its boundaries),
// the block's 64-key K tiles and then its V tiles into the ring, one tile
// in three terms a slot. A consumer (64 rows) runs per block S = Q.K^T of
// each tile it needs as six wgmma passes of term pairs (small weights
// first), the online softmax in f32 with P = exp of the plain version's
// argument in expf, then O *= alpha and, per tile and 64-column chunk of O,
// P split in registers (acc_to_a16_split) times V's terms in six passes
// into a fresh accumulator that is added to O in f32 (promotion: the
// tensor cores' own rounding over L / 16 steps is past f32's check).
// Tiles past the diagonal are skipped, the diagonal tile and the keys at
// and past kv_len masked; the Q buffer is released after the consumer's
// last S. O leaves in f32 by plain stores, LSE (natural log) as [B, H, L].
// Twelve bf16 passes of 2 D flops a causal pair bound it: operations,
// 0.104 ms at the training shape.
template <int D>
__device__ __forceinline__ void fwd_f32_body(
    const CUtensorMap& map_q, const CUtensorMap& map_k,
    const CUtensorMap& map_v, float* __restrict__ lse,
    float* __restrict__ o_f32, int BH, int H, int L, float scale,
    int causal, int kv_len) {
  using Smem = FwdF32Smem<D>;
  constexpr int C = D / kSeg, T = Smem::kT, NC = Smem::kNC;
  constexpr int NS = Smem::kSlots, NR = 2 / NC;   // slots, rounds an item
  constexpr int UP = kUnrollPasses<D, kF32>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = align_1024(smem_raw);      // [consumer][term]
  unsigned char* ring = q_s + NC * 3 * T;         // [slot][term]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + NS * 3 * T);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_empty + 1;
  uint64_t* empty = full + NS;

  const int num_t = (L + kBig - 1) / kBig;
  const int n_items = BH * num_t;
  const int BL = BH / H * L;           // rows of one term

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, NC);            // one thread of each consumer
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * kWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    // ---- producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int n = 0, u = 0;   // slots and rounds loaded so far
      int bh, rank;
      for (int it = 0; work_item(it, BH, n_items, bh, rank); ++it) {
        const int b = bh / H, h = bh % H;
        for (int r = 0; r < NR; ++r) {
          const int q0 = (num_t - 1 - rank) * kBig + 64 * NC * r;
          if (q0 >= L) break;
          const int kmax = causal ? min(q0 / 64 + NC, L / 64) : L / 64;
          const int nw = min(NC, (L - q0) / 64);   // consumers with rows
          if (u >= 1) mbar_wait(q_empty, (u - 1) & 1);
          ++u;
          mbar_expect_tx(q_full, nw * 3 * T);
          for (int w = 0; w < nw; ++w)
            for (int term = 0; term < 3; ++term)
              for (int c = 0; c < C; ++c)
                tma_load(q_s + (w * 3 + term) * T + c * kChunk, &map_q,
                         q_full, h * D + c * kSeg,
                         term * BL + b * L + q0 + 64 * w);
          for (int j0 = 0; j0 < kmax; j0 += 2) {   // a block's K, then V
            const int nt = min(2, kmax - j0);
            for (int op = 0; op < 2; ++op)
              for (int j = j0; j < j0 + nt; ++j, ++n) {
                const int s = n % NS;
                if (n >= NS) mbar_wait(&empty[s], (n / NS - 1) & 1);
                mbar_expect_tx(&full[s], 3 * T);
                for (int term = 0; term < 3; ++term)
                  for (int c = 0; c < C; ++c)
                    tma_load(ring + (s * 3 + term) * T + c * kChunk,
                             op ? &map_v : &map_k, &full[s],
                             h * D + c * kSeg, term * BL + b * L + j * 64);
              }
          }
        }
      }
    }
  } else {
    // ---- consumers
    setmaxnreg_inc<NC == 1 ? kSoleConsumerRegs : kConsumerRegs>();
    const int w = threadIdx.x / kWG - 1;
    const bool leader = (threadIdx.x & (kWG - 1)) == 0;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r_lo = 16 * warp + g;          // rows r_lo and r_lo + 8
    const uint32_t qa = smem_addr(q_s + w * 3 * T);
    auto wait_full = [&](int i) { mbar_wait(&full[i % NS], (i / NS) & 1); };
    auto release = [&](int i) { mbar_arrive(&empty[i % NS]); };
    auto release_q = [&]() {   // every thread's last S is done with Q
      named_sync(1 + w, kWG);
      if (leader) mbar_arrive(q_empty);
    };
    int n = 0, u = 0;                        // slots, rounds consumed
    int bh, rank;
    for (int it = 0; work_item(it, BH, n_items, bh, rank); ++it) {
      const int b = bh / H, h = bh % H;
#pragma unroll 1
      for (int r = 0; r < NR; ++r) {
        const int q0 = (num_t - 1 - rank) * kBig + 64 * NC * r;
        if (q0 >= L) break;
        const int kmax = causal ? min(q0 / 64 + NC, L / 64) : L / 64;
        const int r0 = q0 + 64 * w;          // this consumer's first row
        const int n0 = n;
        n += 2 * kmax;
        mbar_wait(q_full, u & 1);
        ++u;
        if (r0 >= L) {   // rows past L: walk the ring only
          for (int i = n0; i < n; ++i) {
            wait_full(i);
            release(i);
          }
          if (leader) mbar_arrive(q_empty);
          continue;
        }
        // key tiles this consumer needs: 0 .. kend-1, the last one its
        // diagonal tile under causal
        const int kend = causal ? r0 / 64 + 1 : kmax;
        float o[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
        float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

        // S = Q.K^T of the tile in slot i: pass p multiplies term
        // pass_a(p) of Q by term pass_b(p) of K (read K-major)
        auto issue_s = [&](float (&sc)[32], int i) {
          const uint32_t kb = smem_addr(ring + (i % NS) * 3 * T);
          wait_full(i);
#pragma unroll (UP)
          for (int p = 0; p < kPasses; ++p)
#pragma unroll
            for (int ks = 0; ks < D / 16; ++ks) {
              const uint32_t step = (ks / 4) * kChunk + (ks % 4) * 32;
              wgmma_ss<0, 0>(sc, desc(qa + pass_a(p) * T + step),
                             desc(kb + pass_b(p) * T + step), p > 0 || ks > 0);
            }
        };
        // the scaled scores of key tile j, in f32 as the plain version
        // forms them; -inf past the causal diagonal, at and past kv_len,
        // and in a tile this consumer does not use
        auto scores = [&](float (&sc)[32], int j, bool used) {
          const int k0 = j * 64;
#pragma unroll
          for (int e = 0; e < 32; ++e) sc[e] = used ? sc[e] * scale : -INFINITY;
          if (used && ((causal && k0 + 64 > r0) || k0 + 64 > kv_len)) {
#pragma unroll
            for (int e = 0; e < 32; ++e) {
              const int key = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
              const int row = r0 + r_lo + 8 * ((e >> 1) & 1);
              if ((causal && key > row) || key >= kv_len) sc[e] = -INFINITY;
            }
          }
        };
        // O += P.V for the P of one tile and the V tile in slot i, promoted
        // per 64-column chunk of O (V's row tile read MN-major)
        auto pv = [&](const float (&sc)[32], int i) {
          uint32_t pa[3 * 4][4];   // [term][kk]: hi, mid, lo
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            acc_to_a16_split(pa[kk], pa[4 + kk], pa[8 + kk], sc, kk);
          const uint32_t vb = smem_addr(ring + (i % NS) * 3 * T);
          wait_full(i);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            float acc[32];
#pragma unroll
            for (int e = 0; e < 32; ++e) acc[e] = 0.f;
            wgmma_fence();
#pragma unroll
            for (int p = 0; p < kPasses; ++p)
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wgmma_rs<1>(acc, pa[pass_a(p) * 4 + kk],
                            desc(vb + pass_b(p) * T + c * kChunk +
                                     kk * 16 * kRowBytes,
                                 kChunk));
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
#pragma unroll
            for (int e = 0; e < 32; ++e) o[32 * c + e] += acc[e];
          }
          fence_regs(pa);
          release(i);
        };

        for (int j0 = 0, i0 = n0; j0 < kmax; j0 += 2) {
          // the block's K tiles sit in slots i0 .., its V tiles after them
          const int nt = min(2, kmax - j0);
          const int nu = max(0, min(nt, kend - j0));   // tiles used
          if (nu == 0) {
            for (int i = i0; i < i0 + 2 * nt; ++i) {
              wait_full(i);
              release(i);
            }
            i0 += 2 * nt;
            continue;
          }
          float s0[32], s1[32];
          wgmma_fence();
          issue_s(s0, i0);
          if (nu == 2) issue_s(s1, i0 + 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(s0);
          fence_regs(s1);
          if (nt == 2 && nu == 1) wait_full(i0 + 1);
          for (int i = i0; i < i0 + nt; ++i) release(i);
          if (j0 + 2 >= kend) release_q();   // this consumer's last S
          scores(s0, j0, true);
          scores(s1, j0 + 1, nu == 2);

          // online softmax over the block's keys: m, l and P (f32) against
          // the running max; alpha rescales the O of earlier blocks
          float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], fmaxf(s0[e], s1[e]));
          }
          float alpha[2];
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2) {
            const float m_new = fmaxf(m[r2], quad_max(mx[r2]));
            alpha[r2] = expf(m[r2] - m_new);
            m[r2] = m_new;
          }
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int r2 = (e >> 1) & 1;
            s0[e] = expf(s0[e] - m[r2]);
            s1[e] = expf(s1[e] - m[r2]);
            sum[r2] += s0[e] + s1[e];
          }
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2)
            l[r2] = l[r2] * alpha[r2] + quad_sum(sum[r2]);
#pragma unroll
          for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

          pv(s0, i0 + nt);
          if (nu == 2) pv(s1, i0 + nt + 1);
          else if (nt == 2) {
            wait_full(i0 + nt + 1);
            release(i0 + nt + 1);
          }
          i0 += 2 * nt;
        }

        // O = acc / l in f32, rows of [B, L, H, D]; LSE
#pragma unroll
        for (int j8 = 0; j8 < D / 8; ++j8)
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2) {
            const int row = r0 + r_lo + 8 * r2, c = 8 * j8 + 2 * t;
            *reinterpret_cast<float2*>(
                o_f32 + ((size_t)(b * L + row) * H + h) * D + c) =
                make_float2(o[4 * j8 + 2 * r2] / l[r2],
                            o[4 * j8 + 2 * r2 + 1] / l[r2]);
          }
        if (t == 0)
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2)
            lse[(size_t)bh * L + r0 + r_lo + 8 * r2] =
                m[r2] + logf(l[r2]);
      }
    }
  }
}

// Shared memory of the forward at D = 256: the 64 Q rows of each consumer
// (one buffer, 2 x 32 KB), a ring of kSlots one-tile slots (a 64-key tile
// of K, K^T or V, 32 KB), each consumer's stash of one tile's f32 scores
// (2 x 16 KB), then the barriers: 64 + 128 + 32 KB. FwdSmem's two Q
// buffers and 128-key stages would take 384 KB at this width.
struct FwdD256Smem {
  static constexpr int kT = kChunk * (kWideD / kSeg);   // 64 rows, 32 KB
  static constexpr int kSlots = 4;
  static constexpr int kStash = 64 * 64 * sizeof(float);
  static constexpr size_t kBytes = (size_t)(2 + kSlots) * kT + 2 * kStash +
                                   8 * (2 + 2 * kSlots) + 1024;
  static_assert(kBytes >= kOneBlockSmem, "one block per SM");
  static_assert(kBytes <= 227 * 1024, "fits in a block's shared memory");
};

// Forward at D = 256 (_fwd_kernel :83; kNN reads K^T), bf16 storage,
// strategies bf16, nn and nn2 (and, as Split, f32: see the end of this
// note). Bound: bytes, 0.040 ms at the head_dim-256
// phase's shape (B*H = 64, L = 1024, causal), with the operations' 0.035
// ms close behind. The design of the kF32 forward with one bf16 term: a
// persistent grid walks the (head, 128-row query tile) items heaviest
// causal tile first (work_item); the producer loads each item's Q rows
// into the one Q buffer and, per 128-key softmax block (the reference's
// flash_block_k), the block's 64-key K tiles and then its V tiles into the
// ring, one tile a slot, so the next block's K loads as soon as both
// consumers' S have released its slots. A consumer (64 query rows) runs
// per block S = Q.K^T of each of the two tiles (m64n64k16, 16 depth
// steps, both from shared memory; kNN reads K^T's [D][64] slab through the
// transpose bit), the online softmax over the block's 128 keys (the causal
// mask only on the diagonal tile, the keys at and past kv_len masked), P
// rounded to bf16 against the block's max as the reference rounds it, then
// O += P.V as m64n256k16 products with P's fragments as A and V's row
// tile read MN-major (one instruction a depth step; two m64n128 products
// would hold the same accumulator). O is 64 x 256 f32, 128 registers a
// thread, so a consumer holds one tile's scores at a time and parks the
// first tile's in shared memory (the stash) while it forms the second's:
// S, softmax and P.V run in series in a consumer, and the two consumers
// overlap each other (at this width the products are four times the
// softmax's work a score; turns at the tensor cores gained nothing). Key
// tiles past an item's diagonal are not loaded. A consumer gives its Q rows
// back after the item's last S, so the next item's Q loads under its last
// P.V, and O leaves in bf16 through its stash by TMA stores, LSE (natural
// log) as [B, H, L] f32. Rows past L (L = 64 mod 128) are skipped by their
// consumer, which still walks the ring. Maps: map_q, map_o, map_v and
// kStd's map_k [B*L, H*D] with boxes of 64 rows; kNN's map_k K^T as
// [B*H*D, L] with boxes of D rows.
//
// Split (strategy f32 on bf16 storage, _fwd_kernel's f32 form :120): S is
// already exact in its products, P stays f32 and enters O += P.V as its
// hi, mid and lo bf16 terms (acc_to_a16_split), each multiplied by the
// same V tile, the small terms first. P is not rounded, so a softmax block
// wider than one tile would change only the order of f32 sums: the
// softmax steps one 64-key tile at a time (the producer loads each tile's
// K, then its V), no scores wait in the stash, and per tile a consumer
// runs S, the online softmax, O *= alpha, the split (48 registers of
// fragments; S's 32 die as they are split) and twelve m64n256k16
// products. Every tile of the item's causal range is taken by both
// consumers, so that the products stay on one path; one past a consumer's
// diagonal is wholly masked (its P 0). Four bf16 passes of 2 D flops a
// causal pair bound it: operations, 0.070 ms at the head_dim-256 phase's
// shape.
template <int Form, bool Split>
__device__ __forceinline__ void fwd_d256_body(
    const CUtensorMap& map_q, const CUtensorMap& map_k,
    const CUtensorMap& map_v, const CUtensorMap& map_o,
    float* __restrict__ lse, int BH, int H, int L, float scale, int causal,
    int kv_len) {
  using Smem = FwdD256Smem;
  constexpr int D = kWideD, C = D / kSeg, T = Smem::kT, NS = Smem::kSlots;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = align_1024(smem_raw);      // [consumer]
  unsigned char* ring = q_s + 2 * T;              // [slot]
  unsigned char* stash_s = ring + NS * T;         // [consumer][8][kWG]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(stash_s + 2 * Smem::kStash);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_empty + 1;
  uint64_t* empty = full + NS;

  const int num_t = (L + kBig - 1) / kBig;
  const int n_items = BH * num_t;
  // the 64-key tiles of query tile qt's causal range
  auto key_tiles = [&](int qt) {
    return causal ? min(2 * qt + 2, L / 64) : L / 64;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2);             // one thread of each consumer
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    // ---- producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int n = 0;   // slots loaded so far
      int bh, rank;
      for (int it = 0; work_item(it, BH, n_items, bh, rank); ++it) {
        const int b = bh / H, h = bh % H, qt = num_t - 1 - rank;
        const int q0 = qt * kBig, nk = key_tiles(qt);
        const int nw = min(2, (L - q0) / 64);   // consumers with rows
        if (it >= 1) mbar_wait(q_empty, (it - 1) & 1);
        mbar_expect_tx(q_full, nw * T);
        for (int w = 0; w < nw; ++w)
          for (int c = 0; c < C; ++c)
            tma_load(q_s + w * T + c * kChunk, &map_q, q_full,
                     h * D + c * kSeg, b * L + q0 + 64 * w);
        // a block's K tiles, then its V tiles (Split: blocks of one tile)
        constexpr int BT = Split ? 1 : 2;
        for (int j0 = 0; j0 < nk; j0 += BT) {
          const int nt = min(BT, nk - j0);
          for (int op = 0; op < 2; ++op)
            for (int j = j0; j < j0 + nt; ++j, ++n) {
              const int s = n % NS;
              unsigned char* dst = ring + s * T;
              if (n >= NS) mbar_wait(&empty[s], (n / NS - 1) & 1);
              mbar_expect_tx(&full[s], T);
              if (Form == kNN && op == 0) {
                tma_load(dst, &map_k, &full[s], j * 64, bh * D);
              } else {
                for (int c = 0; c < C; ++c)
                  tma_load(dst + c * kChunk, op ? &map_v : &map_k, &full[s],
                           h * D + c * kSeg, b * L + j * 64);
              }
            }
        }
      }
    }
  } else {
    // ---- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int w = threadIdx.x / kWG - 1;
    const int t = threadIdx.x & 3;
    const int r_lo = 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
    const uint32_t qa = smem_addr(q_s + w * T);
    const int tid = threadIdx.x & (kWG - 1);
    float4* stash = reinterpret_cast<float4*>(stash_s) + w * 8 * kWG;
    const float scale_log2 = scale * kLog2e;
    auto wait_full = [&](int i) { mbar_wait(&full[i % NS], (i / NS) & 1); };
    auto release = [&](int i) { mbar_arrive(&empty[i % NS]); };
    int n = 0;                               // slots consumed so far
    for (int it = 0;; ++it) {
      int bh, rank;
      if (!work_item(it, BH, n_items, bh, rank)) break;
      const int qt = num_t - 1 - rank;
      const int r0 = qt * kBig + 64 * w;     // this consumer's first row
      const int nk = key_tiles(qt);
      mbar_wait(q_full, it & 1);
      if (r0 >= L) {   // rows past L: walk the ring only
        for (int i = 0; i < 2 * nk; ++i, ++n) {
          wait_full(n);
          release(n);
        }
        if (tid == 0) mbar_arrive(q_empty);
        continue;
      }
      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

      // S = Q.K^T of the K tile in slot i (loaded: the caller waits before
      // the wgmma fence, since a wait between fence and products made
      // ptxas serialize every wgmma)
      auto issue_s = [&](float (&sc)[32], int i) {
        const uint32_t kb = smem_addr(ring + (i % NS) * T);
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t row_step = (ks / 4) * kChunk + (ks % 4) * 32;
          if constexpr (Form == kStd)
            wgmma_ss<0, 0>(sc, desc(qa + row_step), desc(kb + row_step), ks);
          else
            wgmma_ss<0, 1>(sc, desc(qa + row_step),
                           desc(kb + ks * 16 * kRowBytes), ks);
        }
      };
      // -inf at keys at and past this thread's rows' limits (past the
      // causal diagonal, at and past kv_len) in key tile j's scores; a
      // branch around the loop, taken where the tile passes the
      // consumer's first limit, so only edge tiles pay
      const int lim0 = causal ? min(r0 + r_lo + 1, kv_len) : kv_len;
      const int lim1 = causal ? min(r0 + r_lo + 9, kv_len) : kv_len;
      const int edge = causal ? min(r0 + 1, kv_len) : kv_len;
      auto mask = [&](float (&sc)[32], int j) {
        const int k0 = j * 64;
        if (k0 + 64 > edge) {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int key = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
            if (key >= ((e >> 1) & 1 ? lim1 : lim0)) sc[e] = -INFINITY;
          }
        }
      };

      if constexpr (Split) {
        // One 64-key tile a step, its K in slot n and its V in slot n + 1.
        for (int j = 0; j < nk; ++j, n += 2) {
          float sc[32];
          wait_full(n);
          wgmma_fence();
          issue_s(sc, n);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc);
          release(n);
          if (j == nk - 1) {   // the item's last S: this consumer's Q rows
            named_sync(1 + w, kWG);   // are free for the next item's
            if (tid == 0) mbar_arrive(q_empty);
          }
          mask(sc, j);   // keys past the row or at and past kv_len

          // The online softmax over the tile's keys, as below: P (f32)
          // against the running max m of the scores scaled by scale
          // log2(e); alpha rescales the O of earlier tiles.
          float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
          for (int e = 0; e < 32; ++e)
            mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
          float alpha[2], neg_m[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float m_new = fmaxf(m[r], quad_max(mx[r]) * scale_log2);
            alpha[r] = ex2(m[r] - m_new);
            m[r] = m_new;
            neg_m[r] = -m_new;
          }
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int r = (e >> 1) & 1;
            sc[e] = ex2(fmaf(sc[e], scale_log2, neg_m[r]));
            sum[r] += sc[e];
          }
#pragma unroll
          for (int r = 0; r < 2; ++r)
            l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
          for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
          uint32_t pa[3 * 4][4];   // P's terms, [term][kk]: lo, mid, hi
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            acc_to_a16_split(pa[8 + kk], pa[4 + kk], pa[kk], sc, kk);

          // O += P.V, V's row tile read MN-major, the small terms first
          const uint32_t vb = smem_addr(ring + ((n + 1) % NS) * T);
          wait_full(n + 1);
          wgmma_fence();
#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_rs<1>(o, pa[4 * p + kk],
                          desc(vb + kk * 16 * kRowBytes, kChunk));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(o);
          fence_regs(pa);
          release(n + 1);
        }
      } else {
        for (int j0 = 0; j0 < nk; j0 += 2) {
          const int i0 = n;
          // The block's nt K tiles sit in slots i0 .., its V tiles after
          // them. Both tiles' products are always issued, so that no
          // accumulator is defined on one path only: a second tile that this
          // consumer does not need (past its diagonal) or that the block
          // lacks (L = 64 mod 128: tile j0's slots are read again) is wholly
          // masked below, its P 0, and its P.V adds zeros. The two tiles' S
          // run one after the other in the same 32 registers, tile j0's
          // scores parked in this thread's stash meanwhile: O and both
          // tiles' scores at once (192 registers) spilled 40-60 bytes even
          // with 240 registers a consumer.
          const int nt = min(2, nk - j0);
          const int i_k1 = i0 + nt - 1, i_v1 = i0 + 2 * nt - 1;
          float sc[32], mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int i = u ? i_k1 : i0;
            wait_full(i);
            wgmma_fence();
            issue_s(sc, i);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(sc);
            mask(sc, j0 + u);   // keys past the row or at and past kv_len
#pragma unroll
            for (int e = 0; e < 32; ++e)
              mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
            if (u == 0)
#pragma unroll
              for (int j = 0; j < 8; ++j)
                stash[j * kWG + tid] =
                    make_float4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2],
                                sc[4 * j + 3]);
          }
          for (int i = i0; i < i0 + nt; ++i) release(i);
          if (j0 + 2 >= nk) {   // the item's last S: this consumer's Q rows
            named_sync(1 + w, kWG);   // are free for the next item's
            if (tid == 0) mbar_arrive(q_empty);
          }

          // The online softmax over the block's 128 keys: P (f32) against
          // the running max m of the scores scaled by scale log2(e), the
          // scale folded into the exponent's FMA; alpha rescales the O of
          // earlier blocks. Tile j0 + 1's P is packed first, then tile j0's
          // scores come back from the stash.
          float alpha[2], neg_m[2], sum[2] = {0.f, 0.f};
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float m_new = fmaxf(m[r], quad_max(mx[r]) * scale_log2);
            alpha[r] = ex2(m[r] - m_new);
            m[r] = m_new;
            neg_m[r] = -m_new;
          }
          uint32_t pa[8][4];   // P in bf16, [tile][kk]: A of P.V
#pragma unroll
          for (int u = 1; u >= 0; --u) {
            if (u == 0)
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const float4 v4 = stash[j * kWG + tid];
                sc[4 * j] = v4.x;
                sc[4 * j + 1] = v4.y;
                sc[4 * j + 2] = v4.z;
                sc[4 * j + 3] = v4.w;
              }
#pragma unroll
            for (int e = 0; e < 32; ++e) {
              const int r = (e >> 1) & 1;
              sc[e] = ex2(fmaf(sc[e], scale_log2, neg_m[r]));
              sum[r] += sc[e];
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) acc_to_a16(pa[4 * u + kk], sc, kk);
          }
#pragma unroll
          for (int r = 0; r < 2; ++r)
            l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
          for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

          // O += P.V of both tiles, V's row tile read MN-major (its 64-column
          // chunks kChunk apart)
          wait_full(i0 + nt);
          wait_full(i_v1);
          wgmma_fence();
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const uint32_t vb =
                smem_addr(ring + ((u ? i_v1 : i0 + nt) % NS) * T);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_rs<1>(o, pa[4 * u + kk],
                          desc(vb + kk * 16 * kRowBytes, kChunk));
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(o);
          fence_regs(pa);
          for (int i = i0 + nt; i < i0 + 2 * nt; ++i) release(i);
          n += 2 * nt;
        }
      }

      // O = acc / l in bf16 (one reciprocal a row, not 128 IEEE divisions a
      // thread with their slow-path branches), leaving by TMA stores of two
      // 128-column halves staged in this consumer's stash (as the store
      // map's swizzled boxes), since its Q rows already take the next
      // item's (plain 4-byte stores of the quads' column pairs were one of
      // the kernel's largest costs)
      const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
      const int b = bh / H, h = bh % H;
      unsigned char* out_s = stash_s + w * Smem::kStash;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int j8 = 0; j8 < D / 16; ++j8)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int c = 8 * j8 + 2 * t, i = 4 * (j8 + D / 16 * half) + 2 * r;
            *reinterpret_cast<uint32_t*>(
                out_s + (c / kSeg) * kChunk + swz(r_lo + 8 * r, c % kSeg)) =
                pack_bf16(o[i] * inv_l[r], o[i + 1] * inv_l[r]);
          }
        fence_async_smem();
        named_sync(1 + w, kWG);
        if (tid == 0) {
          for (int c = 0; c < 2; ++c)
            tma_store(&map_o, out_s + c * kChunk,
                      h * D + (2 * half + c) * kSeg, b * L + r0);
          tma_store_wait();          // the stash may take the other half
        }
        named_sync(1 + w, kWG);
      }
      if (t == 0)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          lse[(size_t)bh * L + r0 + r_lo + 8 * r] =
              m[r] * (1.f / kLog2e) + logf(l[r]);
    }
  }
}

// Shared memory of the kF32 forward at D = 256: its consumer's 64 Q rows in
// three terms (one buffer, 96 KB), a ring of kSlots slots, each one term of
// a 64-key K or V tile (32 KB), P's three bf16 terms (3 x 8 KB), then the
// barriers: 96 + 96 + 24 KB. FwdF32Smem's slots of a tile's three terms
// would take 96 KB each here.
struct FwdF32D256Smem {
  static constexpr int kT = kChunk * (kWideD / kSeg);   // 64 rows, 32 KB
  static constexpr int kSlots = 3;
  static constexpr int kP = 64 * kRowBytes;             // one term of P
  static constexpr size_t kBytes =
      (size_t)(3 + kSlots) * kT + 3 * kP + 8 * (2 + 2 * kSlots) + 1024;
  static_assert(kBytes >= kOneBlockSmem, "one block per SM");
  static_assert(kBytes <= 227 * 1024, "fits in a block's shared memory");
};

// kF32 at D = 256 (f32 storage, _fwd_kernel :83 for every strategy): the
// kF32 forward's arithmetic with one consumer of 64 rows, whose three Q
// terms alone take 96 KB. Q, K and V arrive as the hi, mid and lo bf16
// terms of flash_split_kernel (nn and nn2 split K^T into the same terms,
// so they give kStd's results bitwise). A persistent grid walks the (head,
// 64-row query tile) items heaviest causal tile first, numbered head by
// head where all heads' K and V terms pass three times L2's 50 MB, else
// rank by rank (as dq_d256_body, with its own switch: each item streams
// its causal range's K and V from L2, 192 KB a tile; see `item`); the
// producer loads each item's Q terms into the one
// buffer and each key tile's K terms, then its V terms, into the ring,
// one term a slot, lo first. Per 64-key tile the consumer runs S = Q.K^T
// as six wgmma passes of term pairs (m64n64k16 from shared memory, 16
// depth steps each) in pass_a/pass_b's order taken slot by slot (K's lo
// term: hi.lo; mid: mid.mid, hi.mid; hi: lo.hi, mid.hi, hi.hi), small
// weights first, each slot's passes a commit group so that the slot goes
// back to the producer as soon as they are done; then the scores in f32
// as the plain version forms them (the causal mask and the keys at and
// past kv_len at -inf), the online softmax with P = expf of the plain
// version's argument (P is not rounded, so the softmax steps one tile at
// a time: a wider block would change only the order of f32 sums), O *=
// alpha, P split (split_pair) into three swizzled bf16 tiles in shared
// memory, and per V term slot and 64-column chunk of O that slot's passes
// (both operands from shared memory) into a fresh accumulator that is
// added to O in f32 (promotion: the tensor cores' own rounding over L / 16
// steps is past f32's check). O is 128 registers a thread and the
// promotion accumulator 32; P's fragments in registers beside them (48
// more) spilled 628 bytes at 255 registers, so P goes through shared
// memory, and the ring keeps three slots (each reloads while the other two
// are read). The Q buffer is released after the item's last S; O leaves
// in f32 by plain stores, LSE (natural log) as [B, H, L]. Twelve bf16
// passes of 2 D flops a causal pair bound it:
// operations, 0.209 ms at the head_dim-256 phase's shape (B*H = 64, L =
// 1024, causal).
__device__ __forceinline__ void fwd_f32_d256_body(
    const CUtensorMap& map_q, const CUtensorMap& map_k,
    const CUtensorMap& map_v, float* __restrict__ lse,
    float* __restrict__ o_f32, int BH, int H, int L, float scale,
    int causal, int kv_len) {
  using Smem = FwdF32D256Smem;
  constexpr int D = kWideD, C = D / kSeg, T = Smem::kT, NS = Smem::kSlots;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = align_1024(smem_raw);      // [term]
  unsigned char* ring = q_s + 3 * T;              // [slot]
  unsigned char* p_s = ring + NS * T;             // [term]: hi, mid, lo
  uint64_t* q_full = reinterpret_cast<uint64_t*>(p_s + 3 * Smem::kP);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_empty + 1;
  uint64_t* empty = full + NS;

  const int num_t = L / 64, n_items = BH * num_t;
  const int BL = BH / H * L;           // rows of one term
  // the key tiles of query tile qt: through its diagonal tile under causal
  auto key_tiles = [&](int qt) { return causal ? qt + 1 : num_t; };
  // Item `it` of this block: head by head where all heads' K and V terms
  // (six 64 x 256 bf16 tiles a 64-key tile) pass three times L2's 50 MB,
  // else rank by rank. Measured (PERF.md, PR 10): rank order 1.3-1.7x
  // faster at 48 MB (B*H = 16, L = 1024; 8 x 2048) and 1.4x at 96 MB (16
  // x 2048), where dQ's switch at 50 MB would go head by head; head order
  // 4-9% faster at 192 MB (64 x 1024, 32 x 2048).
  constexpr long long kL2Bytes = 50ll << 20;
  const bool by_head =
      (long long)n_items * 64 * D * 2 * 6 > 3 * kL2Bytes;
  auto item = [&](int it, int& bh, int& qt) {
    int a, c;
    if (!work_item(it, by_head ? num_t : BH, n_items, a, c)) return false;
    bh = by_head ? c : a;
    qt = num_t - 1 - (by_head ? a : c);
    return true;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 1);             // the consumer's first thread
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    // ---- producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int n = 0;   // slots loaded so far
      int bh, qt;
      for (int it = 0; item(it, bh, qt); ++it) {
        const int b = bh / H, h = bh % H;
        if (it >= 1) mbar_wait(q_empty, (it - 1) & 1);
        mbar_expect_tx(q_full, 3 * T);
        for (int term = 0; term < 3; ++term)
          for (int c = 0; c < C; ++c)
            tma_load(q_s + term * T + c * kChunk, &map_q, q_full,
                     h * D + c * kSeg, term * BL + b * L + qt * 64);
        for (int j = 0; j < key_tiles(qt); ++j)
          for (int op = 0; op < 2; ++op)             // K's terms, then V's
            for (int term = 2; term >= 0; --term, ++n) {   // lo first
              const int s = n % NS;
              if (n >= NS) mbar_wait(&empty[s], (n / NS - 1) & 1);
              mbar_expect_tx(&full[s], T);
              for (int c = 0; c < C; ++c)
                tma_load(ring + s * T + c * kChunk, op ? &map_v : &map_k,
                         &full[s], h * D + c * kSeg,
                         term * BL + b * L + j * 64);
            }
      }
    }
  } else {
    // ---- consumer
    setmaxnreg_inc<kSoleConsumerRegs>();
    const bool leader = threadIdx.x == kWG;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r_lo = 16 * warp + g;          // rows r_lo and r_lo + 8
    const uint32_t qa = smem_addr(q_s), p_addr = smem_addr(p_s);
    auto wait_full = [&](int i) { mbar_wait(&full[i % NS], (i / NS) & 1); };
    auto release = [&](int i) { mbar_arrive(&empty[i % NS]); };
    int n = 0;                               // slots consumed so far
    int bh, qt;
    for (int it = 0; item(it, bh, qt); ++it) {
      const int b = bh / H, h = bh % H, r0 = qt * 64, nk = key_tiles(qt);
      mbar_wait(q_full, it & 1);
      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

      // Tile j: K's terms lo, mid, hi in slots n .. n + 2, V's in n + 3 ..
      for (int j = 0; j < nk; ++j, n += 6) {
        // S = Q.K^T: pass p multiplies term pass_a(p) of Q by term
        // pass_b(p) of K (read K-major), the passes grouped by K's slot
        float sc[32];
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          const int term = 2 - u;
          const uint32_t kb = smem_addr(ring + ((n + u) % NS) * T);
          wait_full(n + u);
          wgmma_fence();
#pragma unroll
          for (int p = 0; p < kPasses; ++p) {
            if (pass_b(p) != term) continue;
            // (unrolled by 4, not 16: ptxas, holding the descriptors of
            // all of a tile's S products, spilled 20 bytes at 255
            // registers; a second accumulator for the depth's second
            // half spilled 128 at any unrolling)
#pragma unroll 4
            for (int ks = 0; ks < D / 16; ++ks) {
              const uint32_t step = (ks / 4) * kChunk + (ks % 4) * 32;
              // (the lo slot has one pass: the first product zeroes S)
              wgmma_ss<0, 0>(sc, desc(qa + pass_a(p) * T + step),
                             desc(kb + step), u > 0 || ks > 0);
            }
          }
          wgmma_commit();
        }
        wgmma_wait<2>();
        release(n);
        wgmma_wait<1>();
        release(n + 1);
        wgmma_wait<0>();
        fence_regs(sc);
        release(n + 2);
        if (j == nk - 1) {   // the item's last S: Q is free for the next
          named_sync(1, kWG);
          if (leader) mbar_arrive(q_empty);
        }

        // the scaled scores in f32 as the plain version forms them; -inf
        // past the causal diagonal and at and past kv_len
        const int k0 = j * 64;
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] *= scale;
        if ((causal && k0 + 64 > r0) || k0 + 64 > kv_len) {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int key = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
            const int row = r0 + r_lo + 8 * ((e >> 1) & 1);
            if ((causal && key > row) || key >= kv_len) sc[e] = -INFINITY;
          }
        }
        // online softmax over the tile's keys: m, l and P (f32) against
        // the running max; alpha rescales the O of earlier tiles
        float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 32; ++e)
          mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
        float alpha[2];
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          const float m_new = fmaxf(m[r2], quad_max(mx[r2]));
          alpha[r2] = expf(m[r2] - m_new);
          m[r2] = m_new;
        }
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int r2 = (e >> 1) & 1;
          sc[e] = expf(sc[e] - m[r2]);
          sum[r2] += sc[e];
        }
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2)
          l[r2] = l[r2] * alpha[r2] + quad_sum(sum[r2]);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        // P's hi, mid and lo terms as swizzled 64 x 64 bf16 tiles: rows
        // r_lo, r_lo + 8, key pairs 8 j8 + 2 t (the previous tile's
        // products on them are done)
#pragma unroll
        for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2) {
            const int e = 4 * j8 + 2 * r2;
            uint32_t hi, mid, lo;
            split_pair(sc[e], sc[e + 1], hi, mid, lo);
            unsigned char* at = p_s + swz(r_lo + 8 * r2, 8 * j8 + 2 * t);
            *reinterpret_cast<uint32_t*>(at) = hi;
            *reinterpret_cast<uint32_t*>(at + Smem::kP) = mid;
            *reinterpret_cast<uint32_t*>(at + 2 * Smem::kP) = lo;
          }
        fence_async_smem();
        named_sync(1, kWG);              // every thread's P is in

        // O += P.V: per V term slot (lo first) and 64-column chunk of O,
        // the slot's passes (P's term tile read K-major, V's row tile
        // MN-major) into a fresh accumulator, added to O in f32
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          const int term = 2 - u;
          const uint32_t vb = smem_addr(ring + ((n + 3 + u) % NS) * T);
          wait_full(n + 3 + u);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            float acc[32];
            int scale_d = 0;             // the first product zeroes acc
            wgmma_fence();
#pragma unroll
            for (int p = 0; p < kPasses; ++p) {
              if (pass_b(p) != term) continue;
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                wgmma_ss<0, 1>(acc,
                               desc(p_addr + pass_a(p) * Smem::kP + kk * 32),
                               desc(vb + c * kChunk + kk * 16 * kRowBytes,
                                    kChunk),
                               scale_d);
                scale_d = 1;
              }
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
#pragma unroll
            for (int e = 0; e < 32; ++e) o[32 * c + e] += acc[e];
          }
          release(n + 3 + u);
        }
      }

      // O = acc / l in f32, rows of [B, L, H, D]; LSE
      const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
      for (int j8 = 0; j8 < D / 8; ++j8)
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          const int row = r0 + r_lo + 8 * r2, c = 8 * j8 + 2 * t;
          *reinterpret_cast<float2*>(
              o_f32 + ((size_t)(b * L + row) * H + h) * D + c) =
              make_float2(o[4 * j8 + 2 * r2] * inv_l[r2],
                          o[4 * j8 + 2 * r2 + 1] * inv_l[r2]);
        }
      if (t == 0)
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2)
          lse[(size_t)bh * L + r0 + r_lo + 8 * r2] = m[r2] + logf(l[r2]);
    }
  }
}

// The forward: its bf16-storage body (kBf16, kSplit; at D = 256
// fwd_d256_body) or the kF32 body (at D = 256 fwd_f32_d256_body). o_out is
// kF32's output, O in f32 by plain stores (map_o unused there); the others
// store O through map_o.
template <int D, int Form, int Mode = kBf16>
__global__ void __launch_bounds__(kFwdThreads<D, Mode>, 1)
flash_fwd_mma_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_o,
                     float* __restrict__ lse, void* __restrict__ o_out,
                     int BH, int H, int L, float scale, int causal,
                     int kv_len) {
  if constexpr (Mode == kF32) {
    static_assert(Form == kStd, "kF32 reads split terms as rows");
    if constexpr (D == kWideD)
      fwd_f32_d256_body(map_q, map_k, map_v, lse, static_cast<float*>(o_out),
                        BH, H, L, scale, causal, kv_len);
    else
      fwd_f32_body<D>(map_q, map_k, map_v, lse, static_cast<float*>(o_out),
                      BH, H, L, scale, causal, kv_len);
  } else if constexpr (D == kWideD) {
    fwd_d256_body<Form, Mode == kSplit>(map_q, map_k, map_v, map_o, lse, BH,
                                        H, L, scale, causal, kv_len);
  } else {
    fwd_bf16_body<D, Form, Mode == kSplit>(map_q, map_k, map_v, map_o, lse,
                                          BH, H, L, scale, causal, kv_len);
  }
}

// Shared memory of the dQ and dK/dV kernels by operand mode. A block's
// resident rows (dQ: the Q and dO rows of its consumers, with their LSE and
// delta runs; dK/dV: their K and V rows) sit in kNB buffers (round u uses
// buffer u % kNB, so with two the next round's rows load while this one
// finishes); the streamed tiles (dQ: 64-key K and V tiles; dK/dV: 64-query
// Q and dO tiles with their LSE and delta runs) pass through kStages ring
// stages; each operand is kNT bf16 terms. kF32's terms triple the tiles,
// so it keeps one buffer; at D = 128 even that leaves room for the rows of
// one consumer only, so a block has one consumer there, which takes an
// item's two 64-row halves in turn (two rounds). Bytes: kBf16, kSplit at
// D = 64 dQ 2 x 33 + 4 x 16 KB, dK/dV 2 x 32 + 4 x 16.5 KB; at D = 128 dQ
// 2 x 65 + 2 x 32 KB, dK/dV 2 x 64 + 2 x 32.5 KB. kF32 at D = 64 (two
// consumers) dQ 97 + 2 x 48 KB, dK/dV 96 + 2 x 48.5 KB; at D = 128 (one
// consumer) dQ 96.5 + 96 KB, dK/dV 96 + 96.5 KB.
template <int D, int Mode>
struct BwdSmem {
  static constexpr bool F32 = Mode == kF32;
  static constexpr int kNC = F32 && D == 128 ? 1 : 2;   // consumers
  static constexpr int kNB = F32 ? 1 : 2;               // resident buffers
  static constexpr int kNT = F32 ? 3 : 1;               // terms an operand
  static constexpr int kStages = F32 ? (D == 64 ? 2 : 1) : (D == 64 ? 4 : 2);
  static constexpr int kT = kChunk * (D / kSeg);   // 64 rows of one term
  static constexpr int kStats = 2 * 64 * sizeof(float);   // LSE, delta
  static constexpr size_t kBytes = kNB * kNC * (2 * kNT * kT + kStats) +
                                   kStages * (2 * kNT * kT + kStats) +
                                   8 * (2 * kNB + 2 * kStages) + 1024;
  static_assert(kBytes >= kOneBlockSmem, "one block per SM");
  static_assert(kBytes <= 227 * 1024, "fits in a block's shared memory");
};

// kF32 dQ: this lane's share (columns lane, lane + 32, ..) of the f64 dot
// of row ra of a split-term tile at a and row rb of one at b (three terms
// each, T bytes apart, rows of D columns under the swizzle), each value
// rebuilt exactly as hi + mid + lo and each product of two f32 values exact
// in f64; warp_sum adds the lanes' shares. kExactP: the P above which dQ
// takes dP that way.
constexpr float kExactP = 1.f / 4;
template <int D, int T>
__device__ __forceinline__ double exact_dot_share(const unsigned char* a,
                                                  int ra,
                                                  const unsigned char* b,
                                                  int rb, int lane) {
  double acc = 0.0;
#pragma unroll
  for (int c = lane; c < D; c += 32) {
    const int oa = (c / kSeg) * kChunk + swz(ra, c % kSeg);
    const int ob = (c / kSeg) * kChunk + swz(rb, c % kSeg);
    double x = 0.0, y = 0.0;
#pragma unroll
    for (int term = 0; term < 3; ++term) {
      x += (double)__bfloat162float(
          *reinterpret_cast<const bf16*>(a + term * T + oa));
      y += (double)__bfloat162float(
          *reinterpret_cast<const bf16*>(b + term * T + ob));
    }
    acc = fma(x, y, acc);
  }
  return acc;
}
__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Threads of a dQ or dK/dV block: the producer and the consumers. A block
// with one consumer is compiled for its 256 threads, so that ptxas may give
// the consumer's code up to 255 registers (the sole consumer's 256 of
// setmaxnreg), where 384 threads would hold it to 168.
template <int D, int Mode>
constexpr int bwd_threads() {
  if constexpr (D == kWideD) return kHopperThreads;   // two consumers
  else return (1 + BwdSmem<D, Mode>::kNC) * kWG;
}
template <int D, int Mode>
constexpr int kBwdThreads = bwd_threads<D, Mode>();

// dK, dV (_dkv_kernel :233; kNN2: _dkv_kernel_nn2 :289). Bound:
// operations, 0.035 ms at the training shape (8 D flops per causal pair,
// four products). A persistent grid, one block per SM, walks the (head,
// 128-key tile) items heaviest causal tile (key tile 0) first
// (work_item); a block owns its key tile's dK and dV, so no atomics. The
// producer loads each item's K and V into one of two buffers and, per
// 64-query tile from the causal start, Q, dO and their 256-byte LSE and
// delta runs into the ring, across item boundaries. A consumer (64 keys)
// runs, per query tile, S^T = K.Q^T and dP^T = V.dO^T (wgmma from shared
// memory, Q and dO read K-major as B), P^T = exp(S^T - LSE) and dS^T =
// P^T (dP^T - delta) in registers (the causal mask only on the diagonal
// tile, tiles wholly above it skipped), then dV += P^T.dO and dK +=
// dS^T.Q with P^T and dS^T as register A fragments and the same Q and dO
// tiles read MN-major through the transpose bit: each of Q and dO is read
// once per tile. kNN reads K^T and V^T as MN-major A; kNN2 also takes Q^T
// and dO^T, whose transpose bits are the other way round, and writes dK^T
// and dV^T. dK and dV leave through the consumer's K and V rows and TMA
// stores. Keys past L (L = 64 mod 128) are skipped by their consumer,
// which still walks the ring. Maps: [B*L, H*D] with boxes of 64 rows for
// the operands that arrive as rows, [B*H*D, L] with boxes of D rows for
// the transposed ones. dK/dV needs no mask of keys past the true length of
// zero-padded inputs: those keys' rows are cut off by the caller, and a
// padded query, whose dO is 0, adds nothing to any row.
//
// kSplit (strategy f32 on bf16 storage, _dkv_kernel's f32 form :275-278):
// S^T and dP^T stay one bf16 wgmma each (their products are exact in f32);
// P^T and dS^T stay f32 and are each split into three bf16 terms
// (acc_to_a16_split), so dV += P^T.dO and dK += dS^T.Q take three passes
// each against the same dO and Q tiles, the small terms first. Each
// split is 48 registers of fragments beside dK and dV (D floats) and the
// f32 scores S^T and dP^T (32 floats each). At D = 64 that fits: both are
// packed before dV's and dK's passes are issued together, as in the bf16
// instances. At D = 128 it does not, even with dV's passes retired before
// dS^T is packed (dK, dV, dS^T's f32 and P^T's fragments, 208 registers
// before any address: ptxas spilled 28 bytes). So that instance takes each
// 64-query tile in two halves of 32 queries (m64n32 products for S^T and
// dP^T, 24 registers of fragments each, about 128 + 48 at the peak): the
// same products, dV and dK summed half by half, with twice the issues of
// S^T and dP^T. Eight bf16 passes of 2 D flops a causal pair bound it:
// operations, 0.070 ms at the training shape.
//
// kF32 (f32 storage, every strategy): K, V, Q and dO arrive as split terms
// (BwdSmem: one resident buffer; one consumer at D = 128). S^T and dP^T
// are six passes each over the term tiles, P^T and dS^T are split in
// registers as in kSplit (the D = 128 halves too), and dV and dK take six
// passes each. The tensor cores sum a product's f32 terms in their own
// order and rounding, so those six passes land in a fresh accumulator per
// query step and 64-column chunk of dV or dK, which is then added to dV or
// dK on the CUDA cores in f32 ("promotion"): each output sums its L / 64
// query steps as f32 additions, and only a step's own 6 x 4 passes run in
// the tensor cores' accumulator. dK and dV leave in f32 by plain stores
// (dK^T and dV^T where `out_t` is set, for nn2). 24 bf16 passes of 2 D
// flops a causal pair bound it: operations, 0.209 ms at the training
// shape. (The kernel's body at D = 64 and 128; at D = 256 dkv_d256_body
// and dkv_f32_d256_body.)
template <int D, int Form, int Mode>
__device__ __forceinline__ void dkv_mma_body(
    const CUtensorMap& map_q, const CUtensorMap& map_k,
    const CUtensorMap& map_v, const CUtensorMap& map_do,
    const CUtensorMap& map_dk, const CUtensorMap& map_dv,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk_f32, float* __restrict__ dv_f32, int out_t,
    int BH, int H, int L, float scale, int causal) {
  using Smem = BwdSmem<D, Mode>;
  constexpr bool Split = Mode != kBf16, F32 = Mode == kF32;
  constexpr int C = D / kSeg, S = Smem::kStages, T = Smem::kT;
  constexpr int NC = Smem::kNC, NB = Smem::kNB, NT = Smem::kNT;
  constexpr int NR = 2 / NC;           // rounds of an item
  constexpr int kKt = Form != kStd;    // K, V arrive as K^T, V^T
  constexpr int kQt = Form == kNN2;    // Q, dO as Q^T, dO^T; dK^T, dV^T out
  constexpr int NP = Split ? 3 : 1;    // bf16 terms of P^T and of dS^T
  constexpr int NS = F32 ? kPasses : 1;   // passes of S^T and of dP^T
  constexpr int UP = kUnrollPasses<D, Mode>;
  // queries of one step: Split at D = 128 takes a query tile in two halves
  // (see above)
  constexpr int NQ = Split && D == 128 ? 32 : 64;
  constexpr int KK = NQ / 16;          // depth steps of P^T.dO, dS^T.Q
  static_assert(!Split || Form == kStd, "Split reads Q and dO as rows");
  extern __shared__ unsigned char smem_raw[];
  // [buffer][consumer][term] resident rows, [stage][term] ring tiles
  unsigned char* k_s = align_1024(smem_raw);
  unsigned char* v_s = k_s + NB * NC * NT * T;
  unsigned char* q_s = v_s + NB * NC * NT * T;
  unsigned char* do_s = q_s + S * NT * T;
  float* stats = reinterpret_cast<float*>(do_s + S * NT * T);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + S * 128);
  uint64_t* kv_empty = kv_full + NB;
  uint64_t* full = kv_empty + NB;
  uint64_t* empty = full + S;

  const int num_t = (L + kBig - 1) / kBig;
  const int n_items = BH * num_t;
  const int BL = BH / H * L;           // rows of one term

  if (threadIdx.x == 0) {
    for (int i = 0; i < NB; ++i) {
      mbar_init(&kv_full[i], 1);
      mbar_init(&kv_empty[i], NC);      // one thread of each consumer
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * kWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    // ---- producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int n = 0, u = 0;   // query tiles and rounds loaded so far
      int bh, rank;
      for (int it = 0; work_item(it, BH, n_items, bh, rank); ++it) {
        const int b = bh / H, h = bh % H;
        for (int r = 0; r < NR; ++r) {
          const int k0 = rank * kBig + 64 * NC * r;   // the round's keys
          if (k0 >= L) break;
          const int qstart = causal ? k0 / 64 : 0, n_tiles = L / 64 - qstart;
          const int kb = u % NB;
          if (u >= NB) mbar_wait(&kv_empty[kb], (u / NB - 1) & 1);
          ++u;
          mbar_expect_tx(&kv_full[kb], 2 * NC * NT * T);
          for (int w = 0; w < NC; ++w) {
            const int kw0 = k0 + w * 64;
            for (int term = 0; term < NT; ++term) {
              unsigned char* kd = k_s + ((kb * NC + w) * NT + term) * T;
              unsigned char* vd = v_s + ((kb * NC + w) * NT + term) * T;
              if constexpr (kKt) {
                tma_load(kd, &map_k, &kv_full[kb], kw0, bh * D);
                tma_load(vd, &map_v, &kv_full[kb], kw0, bh * D);
              } else {
                const int row = term * BL + b * L + kw0;
                for (int c = 0; c < C; ++c) {
                  tma_load(kd + c * kChunk, &map_k, &kv_full[kb],
                           h * D + c * kSeg, row);
                  tma_load(vd + c * kChunk, &map_v, &kv_full[kb],
                           h * D + c * kSeg, row);
                }
              }
            }
          }
          for (int i = 0; i < n_tiles; ++i, ++n) {
            const int s = n % S, q0 = (qstart + i) * 64;
            if (n >= S) mbar_wait(&empty[s], (n / S - 1) & 1);
            mbar_expect_tx(&full[s], 2 * NT * T + Smem::kStats);
            for (int term = 0; term < NT; ++term) {
              unsigned char* qd = q_s + (s * NT + term) * T;
              unsigned char* dod = do_s + (s * NT + term) * T;
              if constexpr (kQt) {
                tma_load(qd, &map_q, &full[s], q0, bh * D);
                tma_load(dod, &map_do, &full[s], q0, bh * D);
              } else {
                const int row = term * BL + b * L + q0;
                for (int c = 0; c < C; ++c) {
                  tma_load(qd + c * kChunk, &map_q, &full[s],
                           h * D + c * kSeg, row);
                  tma_load(dod + c * kChunk, &map_do, &full[s],
                           h * D + c * kSeg, row);
                }
              }
            }
            bulk_load(stats + s * 128, lse + (size_t)bh * L + q0, 256,
                      &full[s]);
            bulk_load(stats + s * 128 + 64, delta + (size_t)bh * L + q0, 256,
                      &full[s]);
          }
        }
      }
    }
  } else {
    // ---- consumers
    setmaxnreg_inc<NC == 1 ? kSoleConsumerRegs : kConsumerRegs>();
    const int w = threadIdx.x / kWG - 1;
    const bool leader = (threadIdx.x & (kWG - 1)) == 0;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r_lo = 16 * warp + g;        // key rows r_lo and r_lo + 8
    int n = 0, u = 0;                      // query tiles, rounds consumed
    int bh, rank;
    for (int it = 0; work_item(it, BH, n_items, bh, rank); ++it) {
      const int b = bh / H, h = bh % H;
#pragma unroll 1
      for (int r = 0; r < NR; ++r) {
        const int k0 = rank * kBig + 64 * NC * r, kw0 = k0 + w * 64;
        if (k0 >= L) break;
        const int qstart = causal ? k0 / 64 : 0, n_tiles = L / 64 - qstart;
        const int kb = u % NB, n0 = n;
        mbar_wait(&kv_full[kb], (u / NB) & 1);
        ++u;
        n += n_tiles;
        if (kw0 >= L) {   // keys past L: walk the ring only
          for (int i = 0; i < n_tiles; ++i) {
            mbar_wait(&full[(n0 + i) % S], ((n0 + i) / S) & 1);
            mbar_arrive(&empty[(n0 + i) % S]);
          }
          if (leader) mbar_arrive(&kv_empty[kb]);
          continue;
        }
        unsigned char* my_k = k_s + (kb * NC + w) * NT * T;
        unsigned char* my_v = v_s + (kb * NC + w) * NT * T;
        const uint32_t ka = smem_addr(my_k), va = smem_addr(my_v);

        float dk[D / 2], dv[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

        for (int i = 0; i < n_tiles; ++i) {
          const int s = (n0 + i) % S, q0 = (qstart + i) * 64;
          mbar_wait(&full[s], ((n0 + i) / S) & 1);
          if (causal && q0 + 64 <= kw0) {   // every query before every key
            mbar_arrive(&empty[s]);
            continue;
          }
          const uint32_t qb = smem_addr(q_s + s * NT * T);
          const uint32_t dob = smem_addr(do_s + s * NT * T);
          const float* lse_s = stats + s * 128;
          const float* delta_s = lse_s + 64;
          const bool diag = causal && q0 == kw0;
#pragma unroll 1
          for (int hq = 0; hq < 64 / NQ; ++hq) {
            // S^T and dP^T of queries hq NQ .. hq NQ + NQ-1: their rows of
            // Q and dO, a 16-row step each in a row tile (kQt has one step)
            const uint32_t q_off = hq * NQ * kRowBytes;
            float st[NQ / 2], dpt[NQ / 2];
            wgmma_fence();
#pragma unroll (UP)
            for (int p = 0; p < NS; ++p)
#pragma unroll
              for (int ks = 0; ks < D / 16; ++ks) {
                // depth d = 16 ks .. 16 ks + 15: a column step in a row
                // tile, a 16-row step in a transposed one; kF32's pass p
                // multiplies term pass_a(p) of K by term pass_b(p) of Q
                const uint32_t row_step = (ks / 4) * kChunk + (ks % 4) * 32;
                const uint32_t col_step = ks * 16 * kRowBytes;
                const uint32_t a_off =
                    (F32 ? pass_a(p) * T : 0) + (kKt ? col_step : row_step);
                const uint32_t b_off = (F32 ? pass_b(p) * T : 0) + q_off +
                                       (kQt ? col_step : row_step);
                wgmma_ss<kKt, kQt>(st, desc(ka + a_off), desc(qb + b_off),
                                   p > 0 || ks > 0);
              }
#pragma unroll (UP)
            for (int p = 0; p < NS; ++p)
#pragma unroll
              for (int ks = 0; ks < D / 16; ++ks) {
                const uint32_t row_step = (ks / 4) * kChunk + (ks % 4) * 32;
                const uint32_t col_step = ks * 16 * kRowBytes;
                const uint32_t a_off =
                    (F32 ? pass_a(p) * T : 0) + (kKt ? col_step : row_step);
                const uint32_t b_off = (F32 ? pass_b(p) * T : 0) + q_off +
                                       (kQt ? col_step : row_step);
                wgmma_ss<kKt, kQt>(dpt, desc(va + a_off), desc(dob + b_off),
                                   p > 0 || ks > 0);
              }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(st);
            fence_regs(dpt);

#pragma unroll
            for (int e = 0; e < NQ / 2; ++e) {
              const int col = hq * NQ + 8 * (e >> 2) + 2 * t + (e & 1);  // query
              const int row = r_lo + 8 * ((e >> 1) & 1);                 // key
              // kF32: exp(S scale - LSE) rounded where the plain version
              // rounds it, in expf (ex2.approx of a base-2 argument moves P
              // by a few units of its last place, past f32's check)
              const float x = st[e] * scale - lse_s[col];
              float p = F32 ? expf(x) : ex2(x * kLog2e);
              if (diag && col < row) p = 0.f;                 // masked: -1e30
              dpt[e] = p * (dpt[e] - delta_s[col]) * scale;   // dS^T
              st[e] = p;                                      // P^T
            }
            if constexpr (F32) {
              // out += A.B promoted: per 64-column chunk c of the dO or Q
              // tile (read MN-major, depth queries hq NQ + 16 kk ..), the
              // six passes into a fresh accumulator, then added in f32
              auto promoted = [&](float (&out)[D / 2],
                                  const uint32_t (&a)[3 * KK][4], uint32_t bt) {
#pragma unroll
                for (int c = 0; c < C; ++c) {
                  float acc[32];
#pragma unroll
                  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
                  wgmma_fence();
#pragma unroll
                  for (int p = 0; p < kPasses; ++p)
#pragma unroll
                    for (int kk = 0; kk < KK; ++kk)
                      wgmma_rs<1>(acc, a[pass_a(p) * KK + kk],
                                  desc(bt + pass_b(p) * T + c * kChunk +
                                           (hq * KK + kk) * 16 * kRowBytes,
                                       kChunk));
                  wgmma_commit();
                  wgmma_wait<0>();
                  fence_regs(acc);
#pragma unroll
                  for (int e = 0; e < 32; ++e) out[32 * c + e] += acc[e];
                }
              };
              // P^T, then dS^T, as hi, mid and lo fragments ([term][kk]),
              // dS^T packed once dV's passes are done with P^T's
              uint32_t pa[3 * KK][4];
#pragma unroll
              for (int kk = 0; kk < KK; ++kk)
                acc_to_a16_split(pa[kk], pa[KK + kk], pa[2 * KK + kk], st, kk);
              promoted(dv, pa, dob);
              fence_regs(pa);
              uint32_t dsa[3 * KK][4];
#pragma unroll
              for (int kk = 0; kk < KK; ++kk)
                acc_to_a16_split(dsa[kk], dsa[KK + kk], dsa[2 * KK + kk], dpt,
                                 kk);
              promoted(dk, dsa, qb);
              fence_regs(dsa);
            } else {
              // P^T and dS^T in bf16 (kSplit: their lo, mid and hi terms),
              // the A fragments of P^T.dO and dS^T.Q
              uint32_t pa[NP * KK][4], dsa[NP * KK][4];
#pragma unroll
              for (int kk = 0; kk < KK; ++kk) {
                if constexpr (Split) {
                  acc_to_a16_split(pa[2 * KK + kk], pa[KK + kk], pa[kk], st,
                                   kk);
                  acc_to_a16_split(dsa[2 * KK + kk], dsa[KK + kk], dsa[kk],
                                   dpt, kk);
                } else {
                  acc_to_a16(pa[kk], st, kk);
                  acc_to_a16(dsa[kk], dpt, kk);
                }
              }
              fence_regs(dv);
              fence_regs(dk);
              wgmma_fence();
              // acc += A.B, the small terms first. Depth: queries hq NQ +
              // 16 kk .. + 15, a 16-row step in a row tile of Q or dO (read
              // MN-major), a column step in a transposed one.
              auto issue = [&](float (&acc)[D / 2],
                               const uint32_t (&a)[NP * KK][4], uint32_t bt) {
#pragma unroll
                for (int p = 0; p < NP; ++p)
#pragma unroll
                  for (int kk = 0; kk < KK; ++kk) {
                    const int kq = hq * KK + kk;
                    wgmma_rs<1 - kQt>(
                        acc, a[p * KK + kk],
                        desc(bt + (kQt ? kq * 32 : kq * 16 * kRowBytes),
                             kChunk));
                  }
              };
              issue(dv, pa, dob);
              issue(dk, dsa, qb);
              wgmma_commit();
              wgmma_wait<0>();
              fence_regs(dv);
              fence_regs(dk);
              fence_regs(pa);
              fence_regs(dsa);
            }
          }
          mbar_arrive(&empty[s]);
        }

        if constexpr (F32) {
          // dK, dV in f32 from registers: rows (keys) of [B, L, H, D], or
          // columns of dK^T, dV^T's [B, H, D, L] where out_t is set
#pragma unroll
          for (int j8 = 0; j8 < D / 8; ++j8)
#pragma unroll
            for (int r2 = 0; r2 < 2; ++r2) {
              const int key = kw0 + r_lo + 8 * r2, c = 8 * j8 + 2 * t;
              const int i0 = 4 * j8 + 2 * r2;
              if (out_t) {
                const size_t o = ((size_t)bh * D + c) * L + key;
                dk_f32[o] = dk[i0];
                dk_f32[o + L] = dk[i0 + 1];
                dv_f32[o] = dv[i0];
                dv_f32[o + L] = dv[i0 + 1];
              } else {
                const size_t o = ((size_t)(b * L + key) * H + h) * D + c;
                *reinterpret_cast<float2*>(dk_f32 + o) =
                    make_float2(dk[i0], dk[i0 + 1]);
                *reinterpret_cast<float2*>(dv_f32 + o) =
                    make_float2(dv[i0], dv[i0 + 1]);
              }
            }
          named_sync(1 + w, kWG);      // every thread is done with K and V
          if (leader) mbar_arrive(&kv_empty[kb]);
        } else {
          // dK, dV in bf16, staged in this consumer's K and V rows (free
          // since its last product) as the store maps' swizzled boxes:
          // [D/64][64][64] for rows, [D][64] for kNN2's transposed stores
#pragma unroll
          for (int j8 = 0; j8 < D / 8; ++j8)
#pragma unroll
            for (int r2 = 0; r2 < 2; ++r2) {
              const int key = r_lo + 8 * r2, c = 8 * j8 + 2 * t;
              const int i0 = 4 * j8 + 2 * r2;
              if constexpr (kQt) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int off = swz(c + e, key);   // row d, column key
                  *reinterpret_cast<bf16*>(my_k + off) =
                      __float2bfloat16_rn(dk[i0 + e]);
                  *reinterpret_cast<bf16*>(my_v + off) =
                      __float2bfloat16_rn(dv[i0 + e]);
                }
              } else {
                const int off = (c / kSeg) * kChunk + swz(key, c % kSeg);
                *reinterpret_cast<uint32_t*>(my_k + off) =
                    pack_bf16(dk[i0], dk[i0 + 1]);
                *reinterpret_cast<uint32_t*>(my_v + off) =
                    pack_bf16(dv[i0], dv[i0 + 1]);
              }
            }
          fence_async_smem();
          named_sync(1 + w, kWG);
          if (leader) {
            if constexpr (kQt) {
              tma_store(&map_dk, my_k, kw0, bh * D);
              tma_store(&map_dv, my_v, kw0, bh * D);
            } else {
              for (int c = 0; c < C; ++c) {
                tma_store(&map_dk, my_k + c * kChunk, h * D + c * kSeg,
                          b * L + kw0);
                tma_store(&map_dv, my_v + c * kChunk, h * D + c * kSeg,
                          b * L + kw0);
              }
            }
            tma_store_wait();          // the buffers may take the next K, V
            mbar_arrive(&kv_empty[kb]);
          }
        }
      }
    }
  }
}

// Shared memory of dK/dV at D = 256: the item's K and V rows (one buffer,
// 2 x 32 KB), kStages ring stages of a 64-query Q tile and dO tile with
// their LSE and delta runs (2 x 64.5 KB), the P^T exchange (64 x 64 f32,
// 16 KB), then the barriers.
struct DkvD256Smem {
  static constexpr int kT = kChunk * (kWideD / kSeg);   // 64 rows, 32 KB
  static constexpr int kStages = 2;
  static constexpr int kStats = 2 * 64 * sizeof(float);   // LSE, delta
  static constexpr int kExchange = 64 * 64 * sizeof(float);
  static constexpr size_t kBytes = 2 * kT + kStages * (2 * kT + kStats) +
                                   kExchange + 8 * (2 + 2 * kStages) + 1024;
  static_assert(kBytes >= kOneBlockSmem, "one block per SM");
  static_assert(kBytes <= 227 * 1024, "fits in a block's shared memory");
};

// dK, dV at D = 256 (_dkv_kernel :233, kNN reads K^T and V^T; kNN2:
// _dkv_kernel_nn2 :289), bf16 storage, strategies bf16, nn and nn2 (and, as
// Split, f32: see the end of this note). Bound:
// operations, 0.070 ms at the head_dim-256 phase's shape (B*H = 64,
// L = 1024, causal). dK and dV of 64 keys are 64 x 256 f32 each, 128
// registers a thread: one warpgroup cannot hold both, so the two consumers
// split the outputs, not the keys. A persistent grid walks the (head,
// 64-key tile) items heaviest causal tile (key tile 0) first (work_item);
// the producer loads each item's K and V rows into the one resident buffer
// and, per 64-query tile from the causal start, Q, dO and their 256-byte
// LSE and delta runs into the ring, across item boundaries. Per query
// tile the dV consumer (warpgroup 1) forms S^T = K.Q^T (m64n64k16 from
// shared memory, 16 depth steps) and P^T = exp(S^T scale - LSE) (the
// causal mask only on the diagonal tile), writes P^T in f32 to the
// exchange in its own fragment order (so that thread i of the other
// consumer reads the 32 values it needs as 8 conflict-free 16-byte loads),
// signals named barrier 3 and runs dV += bf16(P^T).dO (m64n256k16, P^T's
// fragments as A, dO's row tile read MN-major). The dK consumer
// (warpgroup 2) forms dP^T = V.dO^T beside it, waits for P^T, forms dS^T =
// P^T (dP^T - delta) scale in f32, frees the exchange (named barrier 4)
// and runs dK += bf16(dS^T).Q. Each consumer issues two of the four
// products (4 D flops a pair), so the tensor work stays the bound's 8 D a
// pair (forming S^T in both would cost 10 D). Both read each Q and dO
// stage, whose empty barrier counts both. kNN reads K^T and V^T as
// MN-major A; kNN2 also takes Q^T and dO^T, whose transpose bits are the
// other way round, and writes dK^T and dV^T: the tensor cores see bf16's
// products in bf16's order, so nn and nn2 give bf16's results bitwise. dV
// leaves through the K buffer, which only the dV consumer reads, dK
// through the V buffer, each by TMA stores; the producer loads the next
// item's K and V once both are out. Keys past the true length of
// zero-padded inputs need no mask (see dkv_mma_body). Maps as for
// dkv_mma_body.
//
// Split (strategy f32 on bf16 storage, _dkv_kernel's f32 form :275-278):
// the same kernel with P^T and dS^T unrounded. S^T and dP^T are already
// exact in their products; the dV consumer splits P^T, the dK consumer
// dS^T, into hi, mid and lo bf16 fragments (acc_to_a16_split, as the
// forward's Split splits P) and runs three passes of its output's products
// against the same dO (or Q) stage, the small terms first. The f32 scores
// die as they are split, so the peak is the 128 output registers and 48
// of fragments, the D = 256 Split forward's shape; shared memory does not
// change. Eight bf16 passes of 2 D flops a causal pair bound it:
// operations, 0.139 ms at the head_dim-256 phase's shape.
template <int Form, bool Split>
__device__ __forceinline__ void dkv_d256_body(
    const CUtensorMap& map_q, const CUtensorMap& map_k,
    const CUtensorMap& map_v, const CUtensorMap& map_do,
    const CUtensorMap& map_dk, const CUtensorMap& map_dv,
    const float* __restrict__ lse, const float* __restrict__ delta, int BH,
    int H, int L, float scale, int causal) {
  using Smem = DkvD256Smem;
  constexpr int D = kWideD, C = D / kSeg, T = Smem::kT, S = Smem::kStages;
  constexpr int kKt = Form != kStd;    // K, V arrive as K^T, V^T
  constexpr int kQt = Form == kNN2;    // Q, dO as Q^T, dO^T; dK^T, dV^T out
  constexpr int kFull = 3, kFree = 4;  // named barriers of the exchange
  constexpr int NP = Split ? 3 : 1;    // bf16 terms of P^T and of dS^T
  static_assert(!Split || Form == kStd, "Split reads Q and dO as rows");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* k_s = align_1024(smem_raw);
  unsigned char* v_s = k_s + T;
  unsigned char* q_s = v_s + T;                      // [stage]
  unsigned char* do_s = q_s + S * T;                 // [stage]
  float* stats = reinterpret_cast<float*>(do_s + S * T);   // [stage][128]
  float4* exch = reinterpret_cast<float4*>(stats + S * 128);   // [8][kWG]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(exch + 8 * kWG);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* full = kv_empty + 1;
  uint64_t* empty = full + S;

  const int n_items = BH * (L / 64);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 2);            // one thread of each consumer
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    // ---- producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int n = 0;   // query tiles loaded so far
      int bh, rank;
      for (int it = 0; work_item(it, BH, n_items, bh, rank); ++it) {
        const int b = bh / H, h = bh % H, k0 = rank * 64;
        const int qstart = causal ? rank : 0, n_tiles = L / 64 - qstart;
        if (it >= 1) mbar_wait(kv_empty, (it - 1) & 1);
        mbar_expect_tx(kv_full, 2 * T);
        if constexpr (kKt) {
          tma_load(k_s, &map_k, kv_full, k0, bh * D);
          tma_load(v_s, &map_v, kv_full, k0, bh * D);
        } else {
          for (int c = 0; c < C; ++c) {
            tma_load(k_s + c * kChunk, &map_k, kv_full, h * D + c * kSeg,
                     b * L + k0);
            tma_load(v_s + c * kChunk, &map_v, kv_full, h * D + c * kSeg,
                     b * L + k0);
          }
        }
        for (int i = 0; i < n_tiles; ++i, ++n) {
          const int s = n % S, q0 = (qstart + i) * 64;
          if (n >= S) mbar_wait(&empty[s], (n / S - 1) & 1);
          mbar_expect_tx(&full[s], 2 * T + Smem::kStats);
          if constexpr (kQt) {
            tma_load(q_s + s * T, &map_q, &full[s], q0, bh * D);
            tma_load(do_s + s * T, &map_do, &full[s], q0, bh * D);
          } else {
            for (int c = 0; c < C; ++c) {
              tma_load(q_s + s * T + c * kChunk, &map_q, &full[s],
                       h * D + c * kSeg, b * L + q0);
              tma_load(do_s + s * T + c * kChunk, &map_do, &full[s],
                       h * D + c * kSeg, b * L + q0);
            }
          }
          bulk_load(stats + s * 128, lse + (size_t)bh * L + q0, 256,
                    &full[s]);
          bulk_load(stats + s * 128 + 64, delta + (size_t)bh * L + q0, 256,
                    &full[s]);
        }
      }
    }
  } else {
    // ---- consumers: w = 0 holds dV (reads K), w = 1 holds dK (reads V)
    setmaxnreg_inc<kConsumerRegs>();
    const int w = threadIdx.x / kWG - 1;
    const int tid = threadIdx.x & (kWG - 1);
    const bool leader = tid == 0;
    const int warp = tid >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r_lo = 16 * warp + g;        // key rows r_lo and r_lo + 8
    unsigned char* mine = w == 0 ? k_s : v_s;   // resident operand, output
    const uint32_t ra = smem_addr(mine);
    int n = 0, ex = 0;                     // query tiles, exchanges so far
    int bh, rank;
    for (int it = 0; work_item(it, BH, n_items, bh, rank); ++it) {
      const int b = bh / H, h = bh % H, k0 = rank * 64;
      const int qstart = causal ? rank : 0, n_tiles = L / 64 - qstart;
      const int n0 = n;
      n += n_tiles;
      mbar_wait(kv_full, it & 1);
      float acc[D / 2];                    // dV or dK of the item's keys
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

      for (int i = 0; i < n_tiles; ++i) {
        const int s = (n0 + i) % S, q0 = (qstart + i) * 64;
        mbar_wait(&full[s], ((n0 + i) / S) & 1);
        const uint32_t qb = smem_addr(q_s + s * T);
        const uint32_t dob = smem_addr(do_s + s * T);
        const float* lse_s = stats + s * 128;
        const float* delta_s = lse_s + 64;
        const bool diag = causal && q0 == k0;
        // S^T = K.Q^T (dV consumer) or dP^T = V.dO^T (dK consumer): depth
        // d = 16 ks .., a column step in a row tile, a 16-row step in a
        // transposed one
        float x[32];
        const uint32_t bt = w == 0 ? qb : dob;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t row_step = (ks / 4) * kChunk + (ks % 4) * 32;
          const uint32_t col_step = ks * 16 * kRowBytes;
          wgmma_ss<kKt, kQt>(x, desc(ra + (kKt ? col_step : row_step)),
                             desc(bt + (kQt ? col_step : row_step)), ks);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(x);
        // P^T or dS^T in bf16 (Split: its lo, mid and hi terms, [term][kk]):
        // A of the output product
        uint32_t fa[NP * 4][4];
        if (w == 0) {
          // P^T (0 past the causal diagonal: a masked score is -1e30)
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int col = 8 * (e >> 2) + 2 * t + (e & 1);   // query
            const int row = r_lo + 8 * ((e >> 1) & 1);        // key
            const float p = ex2((x[e] * scale - lse_s[col]) * kLog2e);
            x[e] = diag && col < row ? 0.f : p;
          }
          if (ex > 0) named_sync(kFree, 2 * kWG);   // the last P^T is read
#pragma unroll
          for (int j = 0; j < 8; ++j)
            exch[j * kWG + tid] =
                make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2],
                            x[4 * j + 3]);
          named_arrive(kFull, 2 * kWG);
        } else {
          named_sync(kFull, 2 * kWG);    // this tile's P^T is in
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 p4 = exch[j * kWG + tid];
            const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int e = 4 * j + u;
              const int col = 8 * (e >> 2) + 2 * t + (e & 1);
              x[e] = p[u] * (x[e] - delta_s[col]) * scale;   // dS^T
            }
          }
          named_arrive(kFree, 2 * kWG);
        }
        ++ex;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if constexpr (Split)
            acc_to_a16_split(fa[8 + kk], fa[4 + kk], fa[kk], x, kk);
          else
            acc_to_a16(fa[kk], x, kk);
        }
        // dV += P^T.dO or dK += dS^T.Q, the small terms first. Depth:
        // queries 16 kk .. 16 kk + 15, a 16-row step in a row tile (read
        // MN-major), a column step in a transposed one
        const uint32_t ot = w == 0 ? dob : qb;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs<1 - kQt>(acc, fa[4 * p + kk],
                              desc(ot + (kQt ? kk * 32 : kk * 16 * kRowBytes),
                                   kChunk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(fa);
        mbar_arrive(&empty[s]);
      }

      // dV or dK in bf16, staged in this consumer's resident buffer (free
      // since its last product) as the store map's swizzled boxes:
      // [D/64][64][64] for rows, [D][64] for kNN2's transposed stores
#pragma unroll
      for (int j8 = 0; j8 < D / 8; ++j8)
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          const int key = r_lo + 8 * r2, c = 8 * j8 + 2 * t;
          const int i0 = 4 * j8 + 2 * r2;
          if constexpr (kQt) {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              *reinterpret_cast<bf16*>(mine + swz(c + e, key)) =
                  __float2bfloat16_rn(acc[i0 + e]);
          } else {
            *reinterpret_cast<uint32_t*>(
                mine + (c / kSeg) * kChunk + swz(key, c % kSeg)) =
                pack_bf16(acc[i0], acc[i0 + 1]);
          }
        }
      fence_async_smem();
      named_sync(1 + w, kWG);
      if (leader) {
        const CUtensorMap* map_out = w == 0 ? &map_dv : &map_dk;
        if constexpr (kQt) {
          tma_store(map_out, mine, k0, bh * D);
        } else {
          for (int c = 0; c < C; ++c)
            tma_store(map_out, mine + c * kChunk, h * D + c * kSeg,
                      b * L + k0);
        }
        tma_store_wait();              // the buffer may take the next K, V
        mbar_arrive(kv_empty);
      }
    }
  }
}

// ------------------------------ kF32 dQ and dK/dV at D = 256 (f32 storage)
// Terms triple a tile: 64 rows of one operand at D = 256 are 64 KB in f32
// and 96 KB as three bf16 terms, so the D = 128 layout (every operand as
// resident terms) does not fit: the item's two resident operands alone
// would take 192 KB of a block's 227. These kernels keep the item's own
// operands (Q and dO for dQ, K and V for dK/dV) in f32, 128 KB, and stream
// the other two as terms in pieces: 64 rows x 128 columns (two 64-column
// chunks) of one term, 16 KB. Each product is still six bf16 passes of
// term pairs, with promotion:
// - the resident rows are the A operand of S and dP (S^T and dP^T): per
//   k-step each thread reads its fragment's eight f32 values and splits
//   them in registers (split_pair, flash_split_kernel's terms), then issues
//   the passes as register-A wgmma against the streamed piece (K-major);
// - the output products read the streamed piece MN-major, and per piece
//   and 64-column chunk the piece's passes land in a fresh accumulator that
//   is added to the output in f32.
// The resident rows arrive as terms too (the kernels read only the split
// terms, so nn and nn2, which split their transposed operands into the same
// terms, run the same instance and give kStd's results bitwise): each
// thread rebuilds its own share in f32 as (hi + mid) + lo, exactly the value
// that was split, in the order of a 64 x 256 wgmma accumulator, which is
// also the order of the A fragments it feeds (float4 j of thread tid's
// share holds its elements 4 j .. 4 j + 3), so a thread reads back only
// what it wrote, as conflict-free 16-byte loads. Two consumers run the same
// products on different operands (a wgmma on a branch on the consumer
// serializes every wgmma of the kernel, PR 9); the producer deals the
// pieces to them in turn, two slots each, so that a consumer's next piece
// loads while it works on one. Beside dK/dV's 128-register output the
// consumers have no register to spare: the ring, its barriers and stats go
// by 32-bit shared addresses, and each promotion's accumulator is chained
// to the last one's adds (piece_out_products).

constexpr int kPiece = 2 * kChunk;   // 64 rows x 128 columns of one term

__device__ __forceinline__ float2 lds2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
}
// two bf16 at a, as f32
__device__ __forceinline__ float2 lds_bf16x2(uint32_t a) {
  uint32_t u;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(u) : "r"(a));
  const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&u);
  return make_float2(__low2float(p), __high2float(p));
}

// A consumer's share of the piece ring (shared addresses): its i-th piece
// sits in slot 2 (i % 2) + w (the producer deals the pieces to consumers 0
// and 1 in turn), with that slot's run of 64 floats of LSE or delta where
// the producer loaded one.
struct PieceRing {
  uint32_t ring, stats, full, empty;
  int w;
  __device__ __forceinline__ int slot(int i) const { return 2 * (i & 1) + w; }
  __device__ __forceinline__ uint32_t wait(int i) const {
    mbar_wait_at(full + 8 * slot(i), (i >> 1) & 1);
    return ring + slot(i) * kPiece;
  }
  __device__ __forceinline__ uint32_t stats_of(int i) const {
    return stats + slot(i) * 64 * sizeof(float);
  }
  __device__ __forceinline__ void release(int i) const {
    mbar_arrive_at(empty + 8 * slot(i));
  }
};

// Float4 j of thread tid's share of a 64-row f32 tile kept in accumulator
// order at base: [j][kWG] float4s. (Plain loads and stores of these let
// ptxas fold j's offset into the instruction; an address register a j
// would be hoisted out of the loops, one register each.)
__device__ __forceinline__ float4* share_at(float4* base, int j, int tid) {
  return base + j * kWG + tid;
}

// One piece of a resident operand's term (`term`: 0 hi, 1 mid, 2 lo;
// columns 128 half ..) added into this thread's f32 share of the operand
// (rows r_lo, r_lo + 8): the terms come hi, mid, lo, so each value is
// (hi + mid) + lo.
__device__ __forceinline__ void rebuild_piece(float4* res, uint32_t piece,
                                              int half, int term, int tid,
                                              int r_lo, int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * t;   // column in the piece
    const uint32_t at = piece + (c / kSeg) * kChunk + swz(r_lo, c % kSeg);
    const float2 u0 = lds_bf16x2(at), u1 = lds_bf16x2(at + 8 * kRowBytes);
    float4 x = make_float4(u0.x, u0.y, u1.x, u1.y);
    float4* r = share_at(res, 16 * half + j, tid);
    if (term > 0) {
      const float4 y = *r;
      x = make_float4(y.x + x.x, y.y + x.y, y.z + x.z, y.w + x.w);
    }
    *r = x;
  }
}

// Fragment k-step ks of an f32 share in accumulator order (res, or an
// exchange tile), split into its hi, mid and lo bf16 fragments.
__device__ __forceinline__ void split_fragment(uint32_t (&f)[3][4],
                                               float4* a, int ks, int tid) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 v = *share_at(a, 2 * ks + h, tid);
    split_pair(v.x, v.y, f[0][2 * h], f[1][2 * h], f[2][2 * h]);
    split_pair(v.z, v.w, f[0][2 * h + 1], f[1][2 * h + 1], f[2][2 * h + 1]);
  }
}

// The passes of one piece by its term (0 hi, 1 mid, 2 lo), as bits p of a
// mask: those whose B term is the piece's (pass_b), and of the hi term the
// small ones apart from hi.hi.
__host__ __device__ constexpr int piece_passes(int term) {
  return term == 2 ? 0b000010 : term == 1 ? 0b010100 : 0b101001;
}
constexpr int kHiHi = 0b100000, kHiSmall = 0b001001;   // of the hi term

// acc += the passes in `mask` of one piece (its slot at b; depth columns
// 128 half ..), A this consumer's f32 share (res) split per k-step into
// hi, mid and lo fragments (m64n64k16, the piece read K-major). The
// fragments go to NB register sets in turn, each k-step its own commit
// group, so that a set is rewritten only once the products that read it
// are done (NB = 1: each k-step waits for the last); returns with every
// product done.
template <int NB>
__device__ __forceinline__ void piece_products(float (&acc)[32], int mask,
                                               float4* res, int tid, int half,
                                               uint32_t b) {
  uint32_t a[NB][3][4];
#pragma unroll
  for (int k8 = 0; k8 < 8; ++k8) {
    split_fragment(a[k8 % NB], res, 8 * half + k8, tid);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < kPasses; ++p)
      if ((mask >> p) & 1)
        wgmma_rs<0>(acc, a[k8 % NB][pass_a(p)],
                    desc(b + (k8 / 4) * kChunk + (k8 % 4) * 32));
    wgmma_commit();
    wgmma_wait<NB - 1>();
    fence_regs(a[(k8 + 1) % NB]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int k = 0; k < NB; ++k) fence_regs(a[k]);
}

// x = A.B^T over D = 256 (S, dP, S^T or dP^T of a 64 x 64 tile): A this
// consumer's resident rows (res), B the 64 rows whose terms stream as its
// pieces i0 .. i0 + 5 (lo, mid, hi; each term's two halves), six passes by
// piece (piece_products); each piece goes back once its products are done.
// The tensor cores' f32 sums truncate: 96 products into one accumulator
// put dQ and dK at 1.5e-5 to 1.8e-5 against f64 (the limit 1e-5) on the
// card. So a hi piece's hi.hi pass runs after its small passes, and the
// sum is promoted once: the lo and mid pieces and the first hi piece (its
// hi.hi last) into one accumulator, stored to xs, this consumer's f32 tile
// in shared memory (in accumulator order, so each thread reads back only
// its own entries), the second hi piece into a fresh one, added to xs's in
// f32. Every hi.hi step then adds to a sum of at most 8 depth steps, the
// small passes to a small sum. Before the store, a consumer whose xs
// another one reads waits for it at named barrier `free_bar` (0: none).
// Returns with piece i0 + 5 still held, for the stats that came with it.
template <int NB>
__device__ __forceinline__ void scores_by_piece(float (&x)[32], float4* xs,
                                                float4* res, int tid, int i0,
                                                const PieceRing& rg,
                                                int free_bar) {
#pragma unroll
  for (int e = 0; e < 32; ++e) x[e] = 0.f;
  fence_regs(x);
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const int term = 2 - q / 2, half = q % 2;
    const uint32_t b = rg.wait(i0 + q);
    if (q == 5) {   // the second hi piece: a fresh accumulator
      if (free_bar) named_sync(free_bar, 2 * kWG);
#pragma unroll
      for (int j4 = 0; j4 < 8; ++j4)
        *share_at(xs, j4, tid) = make_float4(x[4 * j4], x[4 * j4 + 1],
                                             x[4 * j4 + 2], x[4 * j4 + 3]);
#pragma unroll
      for (int e = 0; e < 32; ++e) x[e] *= 0.f;   // fresh, after the stores
    }
    if (term > 0) {
      piece_products<NB>(x, piece_passes(term), res, tid, half, b);
    } else {
      piece_products<NB>(x, kHiSmall, res, tid, half, b);
      piece_products<NB>(x, kHiHi, res, tid, half, b);
    }
    if (q < 5) rg.release(i0 + q);
  }
#pragma unroll
  for (int j4 = 0; j4 < 8; ++j4) {
    const float4 v = *share_at(xs, j4, tid);
    x[4 * j4] = v.x + x[4 * j4];
    x[4 * j4 + 1] = v.y + x[4 * j4 + 1];
    x[4 * j4 + 2] = v.z + x[4 * j4 + 2];
    x[4 * j4 + 3] = v.w + x[4 * j4 + 3];
  }
}

// out[:, 64 c0 ..] += A.B for one streamed piece (term `term`, its slot at
// b): A this consumer's 64 x 64 f32 tile in accumulator order (xa: dS, P^T
// or dS^T), its fragments split per k-step as in piece_products (NB
// register sets); B the piece's two chunks, read MN-major (depth: the
// streamed rows). Per chunk the piece's passes land in a fresh
// accumulator, added to out in f32. The accumulator starts as 0 times the
// entries of out that the last chunk's adds wrote: ptxas, which moves the
// adds past the next chunk's products and then holds two accumulators
// beside out (and spills), has to finish them first.
template <int NB, int N>
__device__ __forceinline__ void piece_out_products(float (&out)[N], int c0,
                                                   int term, float4* xa,
                                                   int tid, uint32_t b) {
#pragma unroll
  for (int cc = 0; cc < 2; ++cc) {
    const int last = (c0 + cc - 1 + N / 32) % (N / 32);
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = out[32 * last + e] * 0.f;
    uint32_t a[NB][3][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      split_fragment(a[kk % NB], xa, kk, tid);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < kPasses; ++p)
        if (pass_b(p) == term)
          wgmma_rs<1>(acc, a[kk % NB][pass_a(p)],
                      desc(b + cc * kChunk + kk * 16 * kRowBytes, kChunk));
      wgmma_commit();
      wgmma_wait<NB - 1>();
      fence_regs(a[(kk + 1) % NB]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int k = 0; k < NB; ++k) fence_regs(a[k]);
#pragma unroll
    for (int e = 0; e < 32; ++e) out[32 * (c0 + cc) + e] += acc[e];
  }
}

// Whether the kF32 dQ and dK/dV at D = 256 walk their n_items (head,
// 64-row tile) items head by head: where all heads' streamed terms (six
// 64 x 256 bf16 tiles a 64-row tile) pass three times L2's 50 MB (the kF32
// forward's switch); else rank by rank.
__device__ __forceinline__ bool f32_by_head(int n_items) {
  constexpr long long kL2Bytes = 50ll << 20;
  return (long long)n_items * 64 * kWideD * 2 * 6 > 3 * kL2Bytes;
}
// Item `it` of this block in that order: (head, 64-row tile `rank`, 0 the
// heaviest causal tile).
__device__ __forceinline__ bool f32_item(int it, int BH, int num_t,
                                         bool by_head, int& bh, int& rank) {
  int a, c;
  if (!work_item(it, by_head ? num_t : BH, BH * num_t, a, c)) return false;
  bh = by_head ? c : a;
  rank = by_head ? a : c;
  return true;
}

// Shared memory of the kF32 dK/dV at D = 256: the piece ring (four 16 KB
// slots) with a 256-byte stats run a slot, K and V in f32 (2 x 64 KB), P^T
// and dS^T in f32 (2 x 16 KB), then the barriers.
struct DkvF32D256Smem {
  static constexpr int kSlots = 4;
  static constexpr int kRes = 64 * kWideD * sizeof(float);
  static constexpr int kX = 64 * 64 * sizeof(float);
  static constexpr size_t kBytes = kSlots * (kPiece + 64 * sizeof(float)) +
                                   2 * kRes + 2 * kX + 8 * 2 * kSlots + 1024;
  static_assert(kBytes >= kOneBlockSmem, "one block per SM");
  static_assert(kBytes <= 227 * 1024, "fits in a block's shared memory");
};

// dK, dV at D = 256 on f32 storage (_dkv_kernel :233 for every strategy;
// nn2's _dkv_kernel_nn2 :289 stores dK^T and dV^T): the kF32 arithmetic of
// dkv_mma_body with dkv_d256_body's split of the outputs (dV and dK of 64
// keys are 128 registers a thread each). A persistent grid walks the (head,
// 64-key tile) items (f32_item); per item the producer deals K's and V's
// terms (hi, mid, lo) to the dV consumer (warpgroup 1) and the dK consumer
// (warpgroup 2), which rebuild them in f32, then per 64-query tile from the
// causal start Q's and dO's terms, twice:
// - S^T = K.Q^T (dV consumer) beside dP^T = V.dO^T (dK consumer), by piece
//   (scores_by_piece), LSE and delta coming with the last pieces. The dV
//   consumer forms P^T = exp(S^T scale - LSE) (0 past the causal diagonal)
//   and hands it over in f32 (exchange x_p, named barrier 3); the dK
//   consumer forms dS^T = P^T (dP^T - delta) scale in f32 into its own tile
//   x_ds and frees x_p (barrier 4);
// - dV += P^T.dO beside dK += dS^T.Q (piece_out_products), each from its
//   own f32 tile.
// That loads Q's and dO's terms twice a tile (384 KB from L2 a 64 x 64 tile
// pair): the pieces that fit beside 128 KB of f32 rows are too few to hold
// a tile's terms. dK and dV leave in f32 by plain stores (dK^T and dV^T
// where `out_t`). Keys past the true length of zero-padded inputs need no
// mask (see dkv_mma_body). 24 bf16 passes of 2 D flops a causal pair bound
// it: operations, 0.417 ms at the head_dim-256 phase's shape (B*H = 64,
// L = 1024, causal).
__device__ __forceinline__ void dkv_f32_d256_body(
    const CUtensorMap& map_q, const CUtensorMap& map_k,
    const CUtensorMap& map_v, const CUtensorMap& map_do,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk_f32, float* __restrict__ dv_f32, int out_t,
    int BH, int H, int L, float scale, int causal) {
  using Smem = DkvF32D256Smem;
  constexpr int D = kWideD, NS = Smem::kSlots;
  constexpr int kPIn = 3, kPFree = 4;  // named barriers of x_p
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);                    // [slot]
  float* stats = reinterpret_cast<float*>(ring + NS * kPiece);   // [slot][64]
  float4* k_res = reinterpret_cast<float4*>(stats + NS * 64);    // [32][kWG]
  float4* v_res = k_res + 32 * kWG;
  // P^T and dS^T (their running sums S^T, dP^T before): [8][kWG]
  float4* x_p = v_res + 32 * kWG;
  float4* x_ds = x_p + 8 * kWG;
  uint64_t* full = reinterpret_cast<uint64_t*>(x_ds + 8 * kWG);
  uint64_t* empty = full + NS;

  const int num_t = L / 64, BL = BH / H * L;   // BL: rows of one term
  const bool by_head = f32_by_head(BH * num_t);

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWG);       // a slot has one consumer
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    // ---- producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int n = 0;   // pieces loaded so far
      // columns 128 half .. of term `term` of an operand's 64 rows from r0,
      // with the 256-byte run of `run` (LSE or delta) where it is given
      auto put = [&](const CUtensorMap* map, int bh, int term, int r0,
                     int half, const float* run) {
        const int s = n % NS, b = bh / H, h = bh % H;
        if (n >= NS) mbar_wait(&empty[s], (n / NS - 1) & 1);
        mbar_expect_tx(&full[s], kPiece + (run ? 256 : 0));
        for (int c = 0; c < 2; ++c)
          tma_load(ring + s * kPiece + c * kChunk, map, &full[s],
                   h * D + (2 * half + c) * kSeg, term * BL + b * L + r0);
        if (run)
          bulk_load(stats + s * 64, run + (size_t)bh * L + r0, 256,
                    &full[s]);
        ++n;
      };
      int bh, kt;
      for (int it = 0; f32_item(it, BH, num_t, by_head, bh, kt); ++it) {
        const int k0 = kt * 64;
        for (int term = 0; term < 3; ++term)     // K, V: hi, mid, lo
          for (int half = 0; half < 2; ++half) {
            put(&map_k, bh, term, k0, half, nullptr);
            put(&map_v, bh, term, k0, half, nullptr);
          }
        for (int qt = causal ? kt : 0; qt < num_t; ++qt) {
          const int q0 = qt * 64;
          for (int term = 2; term >= 0; --term)  // S^T, dP^T: Q, dO
            for (int half = 0; half < 2; ++half) {
              const bool last = term == 0 && half == 1;
              put(&map_q, bh, term, q0, half, last ? lse : nullptr);
              put(&map_do, bh, term, q0, half, last ? delta : nullptr);
            }
          for (int term = 2; term >= 0; --term)  // dV, dK: dO, Q
            for (int half = 0; half < 2; ++half) {
              put(&map_do, bh, term, q0, half, nullptr);
              put(&map_q, bh, term, q0, half, nullptr);
            }
        }
      }
    }
  } else {
    // ---- consumers: w = 0 holds dV (reads K), w = 1 holds dK (reads V)
    setmaxnreg_inc<kConsumerRegs>();
    const int w = threadIdx.x / kWG - 1;
    const int tid = threadIdx.x & (kWG - 1);
    const int warp = tid >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r_lo = 16 * warp + g;        // key rows r_lo and r_lo + 8
    float4* res = w == 0 ? k_res : v_res;
    float4* mine = w == 0 ? x_p : x_ds;    // P^T or dS^T
    const PieceRing rg{smem_addr(ring), smem_addr(stats), smem_addr(full),
                       smem_addr(empty), w};
    int i = 0, ex = 0;                     // pieces, exchanges so far
    int bh, kt;
    for (int it = 0; f32_item(it, BH, num_t, by_head, bh, kt); ++it) {
      const int b = bh / H, h = bh % H, k0 = kt * 64;
      for (int q = 0; q < 6; ++q, ++i) {
        rebuild_piece(res, rg.wait(i), q % 2, q / 2, tid, r_lo, t);
        rg.release(i);
      }
      float out[D / 2];                    // dV or dK of the item's keys
#pragma unroll
      for (int e = 0; e < D / 2; ++e) out[e] = 0.f;

      for (int qt = causal ? kt : 0; qt < num_t; ++qt, ++ex) {
        const bool diag = causal && qt == kt;
        float x[32];                       // S^T or dP^T
        scores_by_piece<1>(x, mine, res, tid, i, rg,
                           w == 0 && ex > 0 ? kPFree : 0);
        const uint32_t run = rg.stats_of(i + 5);   // LSE or delta
        // entries 4 j4 .. 4 j4 + 3 of x: key rows r_lo, r_lo + 8, queries
        // 8 j4 + 2 t and + 1, whose LSE or delta is at run + 4 col
        if (w == 0) {
          // P^T (0 past the causal diagonal: a masked score is -1e30),
          // handed over in f32
#pragma unroll
          for (int j4 = 0; j4 < 8; ++j4) {
            const int col = 8 * j4 + 2 * t;
            const float2 l2 = lds2(run + 4 * col);
            float p[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int row = r_lo + 8 * (u >> 1);
              p[u] = expf(x[4 * j4 + u] * scale - ((u & 1) ? l2.y : l2.x));
              if (diag && col + (u & 1) < row) p[u] = 0.f;
            }
            *share_at(x_p, j4, tid) = make_float4(p[0], p[1], p[2], p[3]);
          }
          rg.release(i + 5);
          named_arrive(kPIn, 2 * kWG);
        } else {
          // dS^T = P^T (dP^T - delta) scale into this consumer's tile
#pragma unroll
          for (int j4 = 0; j4 < 8; ++j4) {
            const float2 d2 = lds2(run + 4 * (8 * j4 + 2 * t));
#pragma unroll
            for (int u = 0; u < 4; ++u) x[4 * j4 + u] -= (u & 1) ? d2.y : d2.x;
          }
          rg.release(i + 5);
          named_sync(kPIn, 2 * kWG);       // this tile's P^T is in
#pragma unroll
          for (int j4 = 0; j4 < 8; ++j4) {
            const float4 p4 = *share_at(x_p, j4, tid);
            *share_at(mine, j4, tid) = make_float4(p4.x * x[4 * j4] * scale,
                                                   p4.y * x[4 * j4 + 1] * scale,
                                                   p4.z * x[4 * j4 + 2] * scale,
                                                   p4.w * x[4 * j4 + 3] * scale);
          }
          named_arrive(kPFree, 2 * kWG);
        }
        i += 6;
        // dV += P^T.dO or dK += dS^T.Q: dO's or Q's pieces, out's columns
        // 128 half ..
#pragma unroll
        for (int q = 0; q < 6; ++q, ++i) {
          piece_out_products<1>(out, 2 * (q % 2), 2 - q / 2, mine, tid,
                                rg.wait(i));
          rg.release(i);
        }
      }

      // dV or dK in f32: rows (keys) of [B, L, H, D], or columns of
      // [B, H, D, L] where out_t is set
#pragma unroll
      for (int j8 = 0; j8 < D / 8; ++j8)
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          const int key = k0 + r_lo + 8 * r2, c = 8 * j8 + 2 * t;
          const int i0 = 4 * j8 + 2 * r2;
          float* dst = w == 0 ? dv_f32 : dk_f32;
          if (out_t) {
            const size_t o = ((size_t)bh * D + c) * L + key;
            dst[o] = out[i0];
            dst[o + L] = out[i0 + 1];
          } else {
            *reinterpret_cast<float2*>(
                dst + ((size_t)(b * L + key) * H + h) * D + c) =
                make_float2(out[i0], out[i0 + 1]);
          }
        }
    }
  }
}

// dK/dV: dkv_mma_body at D = 64 and 128; at 256 dkv_d256_body (kBf16,
// kSplit) and dkv_f32_d256_body (kF32).
template <int D, int Form, int Mode = kBf16>
__global__ void __launch_bounds__(kBwdThreads<D, Mode>, 1)
flash_dkv_mma_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do,
                     const __grid_constant__ CUtensorMap map_dk,
                     const __grid_constant__ CUtensorMap map_dv,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dk_f32, float* __restrict__ dv_f32,
                     int out_t, int BH, int H, int L, float scale,
                     int causal) {
  if constexpr (D == kWideD && Mode == kF32) {
    static_assert(Form == kStd, "kF32 reads split terms as rows");
    dkv_f32_d256_body(map_q, map_k, map_v, map_do, lse, delta, dk_f32,
                      dv_f32, out_t, BH, H, L, scale, causal);
  } else if constexpr (D == kWideD) {
    dkv_d256_body<Form, Mode == kSplit>(map_q, map_k, map_v, map_do, map_dk,
                                        map_dv, lse, delta, BH, H, L, scale,
                                        causal);
  } else {
    dkv_mma_body<D, Form, Mode>(map_q, map_k, map_v, map_do, map_dk, map_dv,
                                lse, delta, dk_f32, dv_f32, out_t, BH, H, L,
                                scale, causal);
  }
}

// dQ (_dq_kernel :174; kNN: _dq_kernel_nn :203). Bound: operations, 0.026
// ms at the training shape (6 D flops per causal pair, three products).
// The forward's sibling: a persistent grid, one block per SM, walks the
// (head, 128-row query tile) items heaviest causal tile first (work_item);
// a block owns its query tile's dQ, so no atomics, and dQ's f32 sums keep
// one order from run to run. The producer loads each item's Q and dO rows
// into one of two buffers, with their 256-byte LSE and delta runs, and
// every 64-key K and V tile of the item's causal range into the ring,
// across item boundaries. A consumer (64 query rows) runs, per key tile,
// S = Q.K^T and dP = dO.V^T (wgmma from shared memory), P = exp(S scale -
// LSE) and dS = P (dP - delta) scale in registers (the causal mask, and
// the mask of keys at and past kv_len, the true length of zero-padded
// inputs, only on the tile that needs it, behind one branch; tiles wholly
// above the diagonal skipped), then dQ += dS.K with dS rounded to bf16 as
// the register A fragment and the same K tile read MN-major through the
// transpose bit: K is loaded once and needs no transposed copy. The two
// consumers overlap each other's softmax with their products; issuing the
// next tile's S and dP behind this tile's dQ product, or taking turns at
// issuing as the forward's consumers do, gained nothing or lost (PERF.md).
// kNN reads K^T and V^T by TMA in their own layout with the transpose bits
// swapped (one K^T tile serves S and dS.K; `k` goes unused): the tensor
// cores see the same products in the same order, so dQ is bitwise kStd's.
// dQ leaves through the consumer's Q rows and a TMA store. Rows past L (L
// = 64 mod 128) are skipped by their consumer, which still walks the ring.
// Maps: map_q, map_do, map_dq [B*L, H*D] with boxes of 64 rows; map_k,
// map_v the same (kStd) or K^T, V^T as [B*H*D, L] with boxes of D rows
// (kNN).
//
// kSplit (strategy f32 on bf16 storage, _dq_kernel's f32 form :194): S and
// dP stay one bf16 wgmma each (their products are exact in f32); dS stays
// f32 and is split into three bf16 terms (acc_to_a16_split), each
// multiplied by the same K tile into dQ, the small terms first. The three
// fragment sets (48 registers) fit beside dQ (32 or 64 floats), so nothing
// else changes. Five bf16 passes of 2 D flops a causal pair bound it:
// operations, 0.044 ms at the training shape.
//
// kF32 (f32 storage, every strategy): Q, dO, K and V arrive as split terms
// (BwdSmem: one resident buffer; one consumer at D = 128, which takes the
// item's halves in turn). S and dP are six passes each over the term
// tiles; dS is split in registers and dQ's six passes (dS term by K term)
// land in a fresh accumulator per key tile, which is added to dQ on the
// CUDA cores in f32 (promotion, as in dK/dV): dQ sums its L / 64 key tiles
// as f32 additions. Where P exceeds kExactP, dP - delta is taken in f64
// from the terms in shared memory (the warp shares each such entry's
// columns, exact_dot_share): in a row whose P gathers on a few keys, as a
// causal head's first rows, dP - delta cancels and dP's own f32 rounding
// (the tensor cores', or any f32 sum's) would reach dQ unweighted. dQ
// leaves in f32 by plain stores. 18 bf16 passes of 2 D flops a causal pair
// bound it: operations, 0.157 ms at the training shape. (The kernel's body
// at D = 64 and 128; at D = 256 dq_d256_body and dq_f32_d256_body.)
template <int D, int Form, int Mode>
__device__ __forceinline__ void dq_mma_body(
    const CUtensorMap& map_q, const CUtensorMap& map_k,
    const CUtensorMap& map_v, const CUtensorMap& map_do,
    const CUtensorMap& map_dq, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq_f32, int BH,
    int H, int L, float scale, int causal, int kv_len) {
  using Smem = BwdSmem<D, Mode>;
  constexpr bool Split = Mode != kBf16, F32 = Mode == kF32;
  constexpr int C = D / kSeg, S = Smem::kStages, T = Smem::kT;
  constexpr int NC = Smem::kNC, NB = Smem::kNB, NT = Smem::kNT;
  constexpr int NR = 2 / NC;           // rounds of an item
  constexpr int kKt = Form != kStd;    // K, V arrive as K^T, V^T
  constexpr int NP = Split ? 3 : 1;    // bf16 terms of dS
  constexpr int NS = F32 ? kPasses : 1;   // passes of S and of dP
  constexpr int UP = kUnrollPasses<D, Mode>;
  static_assert(!F32 || Form == kStd, "kF32 reads split terms as rows");
  extern __shared__ unsigned char smem_raw[];
  // [buffer][consumer][term] resident rows, [stage][term] ring tiles
  unsigned char* q_s = align_1024(smem_raw);
  unsigned char* do_s = q_s + NB * NC * NT * T;
  unsigned char* k_s = do_s + NB * NC * NT * T;
  unsigned char* v_s = k_s + S * NT * T;
  float* stats = reinterpret_cast<float*>(v_s + S * NT * T);  // [buf][cons]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(stats + NB * NC * 128);
  uint64_t* q_empty = q_full + NB;
  uint64_t* full = q_empty + NB;
  uint64_t* empty = full + S;

  const int num_t = (L + kBig - 1) / kBig;
  const int n_items = BH * num_t;
  const int BL = BH / H * L;           // rows of one term

  if (threadIdx.x == 0) {
    for (int i = 0; i < NB; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], NC);       // one thread of each consumer
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * kWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    // ---- producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int n = 0, u = 0;   // K/V tiles and rounds loaded so far
      int bh, rank;
      for (int it = 0; work_item(it, BH, n_items, bh, rank); ++it) {
        const int b = bh / H, h = bh % H;
        for (int r = 0; r < NR; ++r) {
          const int q0 = (num_t - 1 - rank) * kBig + 64 * NC * r;
          if (q0 >= L) break;
          const int kmax = causal ? min(q0 / 64 + NC, L / 64) : L / 64;
          const int nw = min(NC, (L - q0) / 64);   // consumers with rows
          const int qb = u % NB;
          if (u >= NB) mbar_wait(&q_empty[qb], (u / NB - 1) & 1);
          ++u;
          mbar_expect_tx(&q_full[qb], nw * (2 * NT * T + Smem::kStats));
          for (int w = 0; w < nw; ++w) {
            const int slot = NC * qb + w, r0 = q0 + 64 * w;
            for (int term = 0; term < NT; ++term) {
              const int row = term * BL + b * L + r0;
              for (int c = 0; c < C; ++c) {
                tma_load(q_s + (slot * NT + term) * T + c * kChunk, &map_q,
                         &q_full[qb], h * D + c * kSeg, row);
                tma_load(do_s + (slot * NT + term) * T + c * kChunk, &map_do,
                         &q_full[qb], h * D + c * kSeg, row);
              }
            }
            bulk_load(stats + slot * 128, lse + (size_t)bh * L + r0, 256,
                      &q_full[qb]);
            bulk_load(stats + slot * 128 + 64, delta + (size_t)bh * L + r0,
                      256, &q_full[qb]);
          }
          for (int j = 0; j < kmax; ++j, ++n) {
            const int s = n % S, k0 = j * 64;
            if (n >= S) mbar_wait(&empty[s], (n / S - 1) & 1);
            mbar_expect_tx(&full[s], 2 * NT * T);
            for (int term = 0; term < NT; ++term) {
              unsigned char* kd = k_s + (s * NT + term) * T;
              unsigned char* vd = v_s + (s * NT + term) * T;
              if constexpr (kKt) {
                tma_load(kd, &map_k, &full[s], k0, bh * D);
                tma_load(vd, &map_v, &full[s], k0, bh * D);
              } else {
                const int row = term * BL + b * L + k0;
                for (int c = 0; c < C; ++c) {
                  tma_load(kd + c * kChunk, &map_k, &full[s],
                           h * D + c * kSeg, row);
                  tma_load(vd + c * kChunk, &map_v, &full[s],
                           h * D + c * kSeg, row);
                }
              }
            }
          }
        }
      }
    }
  } else {
    // ---- consumers
    setmaxnreg_inc<NC == 1 ? kSoleConsumerRegs : kConsumerRegs>();
    const int w = threadIdx.x / kWG - 1;
    const bool leader = (threadIdx.x & (kWG - 1)) == 0;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r_lo = 16 * warp + g;          // rows r_lo and r_lo + 8
    const float scale_log2 = scale * kLog2e;
    int n = 0, u = 0;                        // K/V tiles, rounds consumed
    int bh, rank;
    for (int it = 0; work_item(it, BH, n_items, bh, rank); ++it) {
      const int b = bh / H, h = bh % H;
#pragma unroll 1
      for (int r = 0; r < NR; ++r) {
        const int q0 = (num_t - 1 - rank) * kBig + 64 * NC * r;
        if (q0 >= L) break;
        const int r0 = q0 + 64 * w;            // this consumer's first row
        const int kmax = causal ? min(q0 / 64 + NC, L / 64) : L / 64;
        // key tiles this consumer needs: 0 .. kend-1, the last one its
        // diagonal tile under causal; the round's last is wholly above the
        // diagonal for consumer 0 of two
        const int kend = causal ? r0 / 64 + 1 : kmax;
        const int qb = u % NB, slot = NC * qb + w, n0 = n;
        mbar_wait(&q_full[qb], (u / NB) & 1);
        ++u;
        n += kmax;
        if (r0 >= L) {   // rows past L: walk the ring only
          for (int j = 0; j < kmax; ++j) {
            mbar_wait(&full[(n0 + j) % S], ((n0 + j) / S) & 1);
            mbar_arrive(&empty[(n0 + j) % S]);
          }
          if (leader) mbar_arrive(&q_empty[qb]);
          continue;
        }
        unsigned char* my_q = q_s + slot * NT * T;
        const uint32_t qa = smem_addr(my_q);
        const uint32_t doa = smem_addr(do_s + slot * NT * T);
        const float* lse_s = stats + slot * 128;
        float row_lse[2], neg_lse[2], row_delta[2];
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          row_lse[r2] = lse_s[r_lo + 8 * r2];
          neg_lse[r2] = -row_lse[r2] * kLog2e;
          row_delta[r2] = lse_s[64 + r_lo + 8 * r2];
        }

        float dq[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
        for (int j = 0; j < kmax; ++j) {
          const int s = (n0 + j) % S, k0 = j * 64;
          mbar_wait(&full[s], ((n0 + j) / S) & 1);
          if (j >= kend) {          // wholly above the diagonal
            mbar_arrive(&empty[s]);
            continue;
          }
          const uint32_t kb = smem_addr(k_s + s * NT * T);
          const uint32_t vb = smem_addr(v_s + s * NT * T);
          // S = Q.K^T, dP = dO.V^T. Depth d = 16 ks .. 16 ks + 15: a column
          // step in a row tile, a 16-row step in a transposed one; kF32's
          // pass p multiplies term pass_a(p) of Q (dO) by term pass_b(p) of
          // K (V).
          float st[32], dp[32];
          wgmma_fence();
#pragma unroll (UP)
          for (int p = 0; p < NS; ++p)
#pragma unroll
            for (int ks = 0; ks < D / 16; ++ks) {
              const uint32_t row_step = (ks / 4) * kChunk + (ks % 4) * 32;
              const uint32_t a_off = (F32 ? pass_a(p) * T : 0) + row_step;
              const uint32_t b_off = (F32 ? pass_b(p) * T : 0) +
                                     (kKt ? ks * 16 * kRowBytes : row_step);
              wgmma_ss<0, kKt>(st, desc(qa + a_off), desc(kb + b_off),
                               p > 0 || ks > 0);
            }
#pragma unroll (UP)
          for (int p = 0; p < NS; ++p)
#pragma unroll
            for (int ks = 0; ks < D / 16; ++ks) {
              const uint32_t row_step = (ks / 4) * kChunk + (ks % 4) * 32;
              const uint32_t a_off = (F32 ? pass_a(p) * T : 0) + row_step;
              const uint32_t b_off = (F32 ? pass_b(p) * T : 0) +
                                     (kKt ? ks * 16 * kRowBytes : row_step);
              wgmma_ss<0, kKt>(dp, desc(doa + a_off), desc(vb + b_off),
                               p > 0 || ks > 0);
            }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(st);
          fence_regs(dp);

          // the causal diagonal tile (key > row) and the tile with keys at
          // and past kv_len
          if ((causal && j == kend - 1) || k0 + 64 > kv_len) {
#pragma unroll
            for (int e = 0; e < 32; ++e) {
              const int key = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
              const int row = r0 + r_lo + 8 * ((e >> 1) & 1);
              if ((causal && key > row) || key >= kv_len) st[e] = -INFINITY;
            }
          }
          if constexpr (F32) {
            // P = exp(S scale - LSE) as the plain version rounds it (see
            // dK/dV), dP - delta, and dS. An entry whose P is large carries
            // dP's own f32 rounding into dQ unattenuated where dP - delta
            // cancels (a row whose P gathers on a few keys, as a causal
            // head's first rows): there dP - delta is taken in f64 from
            // the operands' exact f32 values (exact_dot); elsewhere the
            // rounding is weighted by P.
            float p_max = 0.f;
#pragma unroll
            for (int e = 0; e < 32; ++e) {
              const int r2 = (e >> 1) & 1;
              st[e] = expf(st[e] * scale - row_lse[r2]);
              dp[e] -= row_delta[r2];
              p_max = fmaxf(p_max, st[e]);
            }
            if (__any_sync(0xffffffffu, p_max > kExactP)) {
              // the warp takes each such entry in turn, D / 32 columns a
              // lane, and hands the sum to the entry's lane
              const unsigned char* do_t = do_s + slot * NT * T;
              const unsigned char* v_t = v_s + s * NT * T;
#pragma unroll
              for (int e = 0; e < 32; ++e) {
                uint32_t lanes = __ballot_sync(0xffffffffu, st[e] > kExactP);
                while (lanes) {
                  const int src = __ffs(lanes) - 1;
                  lanes &= lanes - 1;
                  const double dpx = warp_sum(exact_dot_share<D, T>(
                      do_t, 16 * warp + (src >> 2) + 8 * ((e >> 1) & 1), v_t,
                      8 * (e >> 2) + 2 * (src & 3) + (e & 1), lane));
                  if (lane == src)
                    dp[e] = (float)(dpx - (double)row_delta[(e >> 1) & 1]);
                }
              }
            }
#pragma unroll
            for (int e = 0; e < 32; ++e) dp[e] = st[e] * dp[e] * scale;
          } else {
#pragma unroll
            for (int e = 0; e < 32; ++e) {
              const int r2 = (e >> 1) & 1;
              const float p = ex2(fmaf(st[e], scale_log2, neg_lse[r2]));
              dp[e] = p * (dp[e] - row_delta[r2]) * scale;   // dS
            }
          }
          if constexpr (F32) {
            // dS as hi, mid and lo fragments ([term][kk]); dQ += dS.K
            // promoted: per 64-column chunk c of K's row tile (read
            // MN-major, depth keys 16 kk ..), the six passes into a fresh
            // accumulator, then added in f32
            uint32_t dsa[3 * 4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              acc_to_a16_split(dsa[kk], dsa[4 + kk], dsa[8 + kk], dp, kk);
#pragma unroll
            for (int c = 0; c < C; ++c) {
              float acc[32];
#pragma unroll
              for (int e = 0; e < 32; ++e) acc[e] = 0.f;
              wgmma_fence();
#pragma unroll
              for (int p = 0; p < kPasses; ++p)
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                  wgmma_rs<1>(acc, dsa[pass_a(p) * 4 + kk],
                              desc(kb + pass_b(p) * T + c * kChunk +
                                       kk * 16 * kRowBytes,
                                   kChunk));
              wgmma_commit();
              wgmma_wait<0>();
              fence_regs(acc);
#pragma unroll
              for (int e = 0; e < 32; ++e) dq[32 * c + e] += acc[e];
            }
            fence_regs(dsa);
          } else {
            // dS in bf16 (kSplit: its lo, mid and hi terms), the A
            // fragments of dS.K
            uint32_t dsa[NP * 4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              if constexpr (Split)
                acc_to_a16_split(dsa[8 + kk], dsa[4 + kk], dsa[kk], dp, kk);
              else
                acc_to_a16(dsa[kk], dp, kk);
            }
            fence_regs(dq);
            wgmma_fence();
            // dQ += dS.K, the small terms first. Depth: keys 16 kk .. 16 kk
            // + 15, a 16-row step in K's row tile (read MN-major), a column
            // step in K^T's tile (read K-major).
#pragma unroll
            for (int p = 0; p < NP; ++p)
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wgmma_rs<1 - kKt>(
                    dq, dsa[p * 4 + kk],
                    desc(kb + (kKt ? kk * 32 : kk * 16 * kRowBytes), kChunk));
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dq);
            fence_regs(dsa);
          }
          mbar_arrive(&empty[s]);
        }

        if constexpr (F32) {
          // dQ in f32 from registers, rows of [B, L, H, D]
#pragma unroll
          for (int j8 = 0; j8 < D / 8; ++j8)
#pragma unroll
            for (int r2 = 0; r2 < 2; ++r2) {
              const int row = r0 + r_lo + 8 * r2, c = 8 * j8 + 2 * t;
              *reinterpret_cast<float2*>(
                  dq_f32 + ((size_t)(b * L + row) * H + h) * D + c) =
                  make_float2(dq[4 * j8 + 2 * r2], dq[4 * j8 + 2 * r2 + 1]);
            }
          named_sync(1 + w, kWG);      // every thread is done with Q and dO
          if (leader) mbar_arrive(&q_empty[qb]);
        } else {
          // dQ in bf16, staged in this consumer's Q rows (free since its
          // last S product) as the store map's swizzled boxes
#pragma unroll
          for (int j8 = 0; j8 < D / 8; ++j8)
#pragma unroll
            for (int r2 = 0; r2 < 2; ++r2) {
              const int c = 8 * j8 + 2 * t;
              *reinterpret_cast<uint32_t*>(
                  my_q + (c / kSeg) * kChunk + swz(r_lo + 8 * r2, c % kSeg)) =
                  pack_bf16(dq[4 * j8 + 2 * r2], dq[4 * j8 + 2 * r2 + 1]);
            }
          fence_async_smem();
          named_sync(1 + w, kWG);
          if (leader) {
            for (int c = 0; c < C; ++c)
              tma_store(&map_dq, my_q + c * kChunk, h * D + c * kSeg,
                        b * L + r0);
            tma_store_wait();          // the buffer may take the next Q, dO
            mbar_arrive(&q_empty[qb]);
          }
        }
      }
    }
  }
}

// Shared memory of dQ at D = 256: the item's Q and dO rows (one buffer,
// 2 x 32 KB) and their LSE and delta runs, kStages ring stages of a 64-key
// K tile and V tile (2 x 64 KB), the dS tile (64 x 64: bf16, 8 KB; Split
// f32, 16 KB), the P exchange (64 x 64 f32, 16 KB), then the barriers:
// 222,768 bytes, Split 230,960 of the 232,448 a block may have.
template <bool Split>
struct DqD256Smem {
  static constexpr int kT = kChunk * (kWideD / kSeg);   // 64 rows, 32 KB
  static constexpr int kStages = 2;
  static constexpr int kStats = 2 * 64 * sizeof(float);   // LSE, delta
  static constexpr int kDS = Split ? 64 * 64 * sizeof(float) : 64 * kRowBytes;
  static constexpr int kExchange = 64 * 64 * sizeof(float);
  static constexpr size_t kBytes = 2 * kT + kStats + kStages * 2 * kT + kDS +
                                   kExchange + 8 * (2 + 2 * kStages) + 1024;
  static_assert(kBytes >= kOneBlockSmem, "one block per SM");
  static_assert(kBytes <= 227 * 1024, "fits in a block's shared memory");
};

// dQ at D = 256 (_dq_kernel :174; kNN: _dq_kernel_nn :203), bf16 storage,
// strategies bf16, nn and nn2 (and, as Split, f32: see the end of this
// note). Bound: operations, 0.052 ms at the
// head_dim-256 phase's shape (B*H = 64, L = 1024, causal; 6 D flops a
// pair), with the bytes' 0.050 ms close behind. dQ of 64 rows is 64 x 256
// f32, 128 registers a thread, and S and dP of a 64-key tile 32 more each:
// one warpgroup holding all of it spilled in the forward's like case, so
// the two consumers split the outputs, as dK/dV at D = 256 does. A
// persistent grid walks the (head, 64-row query tile) items, head by head
// where all heads' K and V overflow L2, else rank by rank (see `item`),
// heaviest causal tile first; the producer loads each item's Q and dO rows
// and their 256-byte LSE and delta runs into the one resident buffer and
// each 64-key K and V tile of the item's causal range into the ring,
// across item boundaries (kNN: K^T and V^T as [D][64] boxes). Per key tile
// the P consumer (warpgroup 1) forms S = Q.K^T (m64n64k16 from shared
// memory, 16 depth steps), masks the causal diagonal tile and the keys at
// and past kv_len, forms P = exp(S scale - LSE) in f32, writes it to the
// exchange in the fragment order both consumers share (8 conflict-free
// 16-byte stores a thread) and signals named barrier 3. The dS consumer
// (warpgroup 2) forms dP = dO.V^T beside it, waits for P, forms dS = P (dP
// - delta) scale in f32, rounds it to bf16 as the reference does, and
// writes it as a swizzled 64 x 64 tile; after named barrier 4 each
// consumer runs its half of dQ += dS.K, dQ[:, 128 w ..] as m64n128k16
// products with the dS tile as A (both read it from shared memory) and the
// K tile's columns 128 w .. read MN-major through the transpose bit (K^T's
// rows read K-major under kNN): 64 accumulator registers a consumer. Each
// consumer issues 3 D flops a pair, the bound's 6 D with no product formed
// twice (PERF.md: issuing the next tile's S and dP right behind the dQ
// products, or Q and dO as register fragments, gained nothing or lost).
// dQ has no softmax block, so 64-key tiles keep the reference's rounding
// points; only the order of the f32 sums differs. The barriers
// also order the buffers: the P consumer writes the next P only after
// barrier 4 (this P was read), the dS consumer the next dS only after the
// next barrier 3, which the P consumer reaches after its dQ product. kNN
// issues the same products in the same order, so dQ is bitwise kStd's.
// dQ leaves in bf16 through each consumer's own resident operand (Q's
// chunks 0-1 for the P consumer, dO's chunks 2-3 for the dS consumer, each
// read by that consumer alone) by TMA stores; the producer loads the next
// item's Q and dO once both halves are out. Maps as for dq_mma_body.
//
// Split (strategy f32 on bf16 storage, _dq_kernel's f32 form :194): the
// same kernel with dS unrounded in dQ += dS.K. S and dP are already exact
// in their products; the dS consumer writes dS in f32 (16 KB, where the
// bf16 tile took 8: three bf16 term tiles would need 8 KB more than the
// block has) in the accumulator order both consumers share, as the P
// exchange is written, so that each thread reads back only the entries of
// its own fragments, as 16-byte loads. After barrier 4 each consumer
// splits its fragments of every k-step into hi, mid and lo in registers
// (split_fragment, 48 registers beside its 64 of dQ) and runs three passes
// of its half of dQ as register-A m64n128k16 products against the same K
// tile, the small terms first. The barriers order the f32 tile as they
// order the bf16 one. Five bf16 passes of 2 D flops a causal pair bound
// it: operations, 0.087 ms at the head_dim-256 phase's shape.
template <int Form, bool Split>
__device__ __forceinline__ void dq_d256_body(
    const CUtensorMap& map_q, const CUtensorMap& map_k,
    const CUtensorMap& map_v, const CUtensorMap& map_do,
    const CUtensorMap& map_dq, const float* __restrict__ lse,
    const float* __restrict__ delta, int BH, int H, int L, float scale,
    int causal, int kv_len) {
  using Smem = DqD256Smem<Split>;
  constexpr int D = kWideD, C = D / kSeg, T = Smem::kT, S = Smem::kStages;
  constexpr int kKt = Form != kStd;    // K, V arrive as K^T, V^T
  constexpr int kPIn = 3, kDSIn = 4;   // named barriers: P, then dS, are in
  static_assert(!Split || Form == kStd, "Split reads K as rows");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = align_1024(smem_raw);
  unsigned char* do_s = q_s + T;
  unsigned char* k_s = do_s + T;                     // [stage]
  unsigned char* v_s = k_s + S * T;                  // [stage]
  unsigned char* ds_s = v_s + S * T;   // [64][64] bf16; Split [8][kWG] float4
  float4* exch = reinterpret_cast<float4*>(ds_s + Smem::kDS);   // [8][kWG]
  float* stats = reinterpret_cast<float*>(exch + 8 * kWG);   // LSE, delta
  uint64_t* q_full = reinterpret_cast<uint64_t*>(stats + 128);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_empty + 1;
  uint64_t* empty = full + S;

  const int num_t = L / 64, n_items = BH * num_t;
  // the key tiles of query tile qt: through its diagonal tile under causal
  auto key_tiles = [&](int qt) { return causal ? qt + 1 : num_t; };
  // Item `it` of this block in work_item's snake order. Each item streams
  // the K and V of its head's causal range from L2. Numbered rank by rank
  // (every head's heaviest tile first), the blocks at work at once read
  // every head's K and V, 64 KB an item; where that overflows L2's 50 MB
  // the items go head by head (each head's tiles heaviest first), so that
  // they read about G / num_t heads' (at B*H = 64, L = 1024: 8 MB against
  // 64 MB). Where it fits, rank order costs no L2 and deals the blocks
  // more equal work. Measured (PERF.md): at 32 MB (B*H = 16, L =
  // 2048) rank order 1.47-1.51x faster; at 64 MB head order as fast (B*H
  // = 32, L = 2048) or 12-15% faster (B*H = 64, L = 1024).
  constexpr long long kL2Bytes = 50ll << 20;
  const bool by_head = (long long)n_items * 64 * D * 2 * 2 > kL2Bytes;
  auto item = [&](int it, int& bh, int& qt) {
    int a, c;
    if (!work_item(it, by_head ? num_t : BH, n_items, a, c)) return false;
    bh = by_head ? c : a;
    qt = num_t - 1 - (by_head ? a : c);
    return true;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2);             // one thread of each consumer
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    // ---- producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int n = 0;   // K/V tiles loaded so far
      int bh, qt;
      for (int it = 0; item(it, bh, qt); ++it) {
        const int b = bh / H, h = bh % H;
        const int q0 = qt * 64, nk = key_tiles(qt);
        if (it >= 1) mbar_wait(q_empty, (it - 1) & 1);
        mbar_expect_tx(q_full, 2 * T + Smem::kStats);
        for (int c = 0; c < C; ++c) {
          tma_load(q_s + c * kChunk, &map_q, q_full, h * D + c * kSeg,
                   b * L + q0);
          tma_load(do_s + c * kChunk, &map_do, q_full, h * D + c * kSeg,
                   b * L + q0);
        }
        bulk_load(stats, lse + (size_t)bh * L + q0, 256, q_full);
        bulk_load(stats + 64, delta + (size_t)bh * L + q0, 256, q_full);
        for (int j = 0; j < nk; ++j, ++n) {
          const int s = n % S, k0 = j * 64;
          if (n >= S) mbar_wait(&empty[s], (n / S - 1) & 1);
          mbar_expect_tx(&full[s], 2 * T);
          if constexpr (kKt) {
            tma_load(k_s + s * T, &map_k, &full[s], k0, bh * D);
            tma_load(v_s + s * T, &map_v, &full[s], k0, bh * D);
          } else {
            for (int c = 0; c < C; ++c) {
              tma_load(k_s + s * T + c * kChunk, &map_k, &full[s],
                       h * D + c * kSeg, b * L + k0);
              tma_load(v_s + s * T + c * kChunk, &map_v, &full[s],
                       h * D + c * kSeg, b * L + k0);
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: w = 0 forms P (reads Q), w = 1 forms dS (reads dO);
    // each holds dQ's columns 128 w .. 128 w + 127
    setmaxnreg_inc<kConsumerRegs>();
    const int w = threadIdx.x / kWG - 1;
    const int tid = threadIdx.x & (kWG - 1);
    const bool leader = tid == 0;
    const int warp = tid >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r_lo = 16 * warp + g;        // rows r_lo and r_lo + 8
    unsigned char* mine = w == 0 ? q_s : do_s;   // resident operand, dQ out
    const uint32_t ra = smem_addr(mine);
    const uint32_t dsa = smem_addr(ds_s);   // the bf16 dS tile
    const float scale_log2 = scale * kLog2e;
    int n = 0;                             // K/V tiles consumed so far
    int bh, qt;
    for (int it = 0; item(it, bh, qt); ++it) {
      const int b = bh / H, h = bh % H;
      const int q0 = qt * 64, nk = key_tiles(qt);
      mbar_wait(q_full, it & 1);
      // -LSE log2(e) of this thread's rows (P consumer) or their delta
      float row_stat[2];
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2)
        row_stat[r2] = w == 0 ? -stats[r_lo + 8 * r2] * kLog2e
                              : stats[64 + r_lo + 8 * r2];
      // keys at and past these limits are masked in this thread's rows:
      // past the causal diagonal, at and past kv_len; only a tile that
      // passes the item's first limit (`edge`) takes the mask loop
      const int lim0 = causal ? min(q0 + r_lo + 1, kv_len) : kv_len;
      const int lim1 = causal ? min(q0 + r_lo + 9, kv_len) : kv_len;
      const int edge = causal ? min(q0 + 1, kv_len) : kv_len;
      float dq[D / 4];
#pragma unroll
      for (int i = 0; i < D / 4; ++i) dq[i] = 0.f;

      for (int j = 0; j < nk; ++j, ++n) {
        const int s = n % S, k0 = j * 64;
        mbar_wait(&full[s], (n / S) & 1);
        const uint32_t kb = smem_addr(k_s + s * T);
        const uint32_t bt = w == 0 ? kb : smem_addr(v_s + s * T);
        // S = Q.K^T (P consumer) or dP = dO.V^T (dS consumer). Depth d =
        // 16 ks ..: a column step in a row tile, a 16-row step in a
        // transposed one
        float x[32];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t row_step = (ks / 4) * kChunk + (ks % 4) * 32;
          wgmma_ss<0, kKt>(x, desc(ra + row_step),
                           desc(bt + (kKt ? ks * 16 * kRowBytes : row_step)),
                           ks);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(x);
        if (w == 0) {
          if (k0 + 64 > edge) {
#pragma unroll
            for (int e = 0; e < 32; ++e) {
              const int key = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
              if (key >= ((e >> 1) & 1 ? lim1 : lim0)) x[e] = -INFINITY;
            }
          }
          // P, the scale folded into the exponent's FMA; a masked score
          // gives 0
#pragma unroll
          for (int e = 0; e < 32; ++e)
            x[e] = ex2(fmaf(x[e], scale_log2, row_stat[(e >> 1) & 1]));
#pragma unroll
          for (int j4 = 0; j4 < 8; ++j4)
            exch[j4 * kWG + tid] = make_float4(x[4 * j4], x[4 * j4 + 1],
                                               x[4 * j4 + 2], x[4 * j4 + 3]);
          named_arrive(kPIn, 2 * kWG);
        } else {
          named_sync(kPIn, 2 * kWG);     // this tile's P is in
#pragma unroll
          for (int j4 = 0; j4 < 8; ++j4) {
            const float4 p4 = exch[j4 * kWG + tid];
            const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int e = 4 * j4 + u;
              x[e] = p[u] * (x[e] - row_stat[(e >> 1) & 1]) * scale;   // dS
            }
          }
          if constexpr (Split) {
            // dS in f32, float4 j4 of this thread's accumulator order
#pragma unroll
            for (int j4 = 0; j4 < 8; ++j4)
              *share_at(reinterpret_cast<float4*>(ds_s), j4, tid) =
                  make_float4(x[4 * j4], x[4 * j4 + 1], x[4 * j4 + 2],
                              x[4 * j4 + 3]);
          } else {
            // dS in bf16 as the A tile of dQ += dS.K: rows r_lo, r_lo + 8,
            // key pairs 8 j8 + 2 t
#pragma unroll
            for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
              for (int r2 = 0; r2 < 2; ++r2) {
                const int e = 4 * j8 + 2 * r2;
                *reinterpret_cast<uint32_t*>(
                    ds_s + swz(r_lo + 8 * r2, 8 * j8 + 2 * t)) =
                    pack_bf16(x[e], x[e + 1]);
              }
            fence_async_smem();
          }
        }
        named_sync(kDSIn, 2 * kWG);      // this tile's dS is in
        // dQ[:, 128 w ..] += dS.K[:, 128 w ..]. Depth: keys 16 kk .., a
        // column step in the dS tile; a 16-row step in K's row tile (its
        // chunks 2 w, 2 w + 1, read MN-major, kChunk apart), a column step
        // in K^T's rows 128 w .. (read K-major)
        if constexpr (Split) {
          // dS's hi, mid and lo fragments ([kk][term]), lo's passes first
          uint32_t fr[4][3][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            split_fragment(fr[kk], reinterpret_cast<float4*>(ds_s), kk, tid);
          fence_regs(dq);
          wgmma_fence();
#pragma unroll
          for (int term = 2; term >= 0; --term)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_rs<1>(dq, fr[kk][term],
                          desc(kb + 2 * w * kChunk + kk * 16 * kRowBytes,
                               kChunk));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dq);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) fence_regs(fr[kk]);
        } else {
          fence_regs(dq);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<0, 1 - kKt>(
                dq, desc(dsa + kk * 32),
                desc(kb + (kKt ? 128 * w * kRowBytes + kk * 32
                               : 2 * w * kChunk + kk * 16 * kRowBytes),
                     kChunk),
                1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dq);
        }
        mbar_arrive(&empty[s]);
      }

      // dQ[:, 128 w ..] in bf16, staged in this consumer's resident operand
      // (its last product on it is done) as the store map's swizzled boxes
#pragma unroll
      for (int j8 = 0; j8 < D / 16; ++j8)
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          const int c = 128 * w + 8 * j8 + 2 * t, i0 = 4 * j8 + 2 * r2;
          *reinterpret_cast<uint32_t*>(
              mine + (c / kSeg) * kChunk + swz(r_lo + 8 * r2, c % kSeg)) =
              pack_bf16(dq[i0], dq[i0 + 1]);
        }
      fence_async_smem();
      named_sync(1 + w, kWG);
      if (leader) {
        for (int c = 2 * w; c < 2 * w + 2; ++c)
          tma_store(&map_dq, mine + c * kChunk, h * D + c * kSeg, b * L + q0);
        tma_store_wait();              // the buffer may take the next Q, dO
        mbar_arrive(q_empty);
      }
    }
  }
}

// Shared memory of the kF32 dQ at D = 256: the piece ring (four 16 KB
// slots), Q and dO in f32 (2 x 64 KB), the exchange and the dS consumer's
// running sum of dP (64 x 64 f32 each, 2 x 16 KB), the item's LSE and
// delta runs, then the barriers.
struct DqF32D256Smem {
  static constexpr int kSlots = 4;
  static constexpr int kRes = 64 * kWideD * sizeof(float);
  static constexpr int kX = 64 * 64 * sizeof(float);
  static constexpr int kStats = 2 * 64 * sizeof(float);
  static constexpr size_t kBytes =
      kSlots * kPiece + 2 * kRes + 2 * kX + kStats + 8 * (2 * kSlots + 2) +
      1024;
  static_assert(kBytes >= kOneBlockSmem, "one block per SM");
  static_assert(kBytes <= 227 * 1024, "fits in a block's shared memory");
};

// kF32 dQ at D = 256: this lane's share (columns 8 lane .. 8 lane + 7) of
// the f64 dot of row `row` of the dS consumer's dO (its f32 share in
// accumulator order, res; the row is this warp's) and the key row of V at
// v_row, rebuilt from its three terms in global memory (n elements apart):
// each product of two f32 values is exact in f64.
__device__ __forceinline__ double exact_dp_share(const float4* res, int row,
                                                 const bf16* __restrict__ v_row,
                                                 size_t n, int lane) {
  // element (row, d): float4 d / 8, thread 4 (row % 16 % 8) + (d % 8) / 2
  // of the row's warp, component 2 (row / 8 % 2) + d % 2
  const int base = lane * kWG + 32 * (row >> 4) + 4 * (row & 7);
  const bool upper = (row >> 3) & 1;
  uint4 vt[3];
#pragma unroll
  for (int term = 0; term < 3; ++term)
    vt[term] = *reinterpret_cast<const uint4*>(v_row + term * n + 8 * lane);
  double acc = 0.0;
#pragma unroll
  for (int i2 = 0; i2 < 4; ++i2) {
    const float4 f = res[base + i2];
    double v0 = 0.0, v1 = 0.0;
#pragma unroll
    for (int term = 0; term < 3; ++term) {
      const uint32_t u = (&vt[term].x)[i2];
      const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&u);
      v0 += (double)__low2float(p);
      v1 += (double)__high2float(p);
    }
    acc = fma((double)(upper ? f.z : f.x), v0, acc);
    acc = fma((double)(upper ? f.w : f.y), v1, acc);
  }
  return acc;
}

// dQ at D = 256 on f32 storage (_dq_kernel :174 for every strategy, the
// nn forms' _dq_kernel_nn :203 too): the kF32 arithmetic of dq_mma_body
// with dq_d256_body's split of the output (each consumer holds dQ's columns
// 128 w ..). A persistent grid walks the (head, 64-row query tile) items
// (f32_item); per item the producer loads the rows' LSE and delta and deals
// Q's and dO's terms (hi, mid, lo) to the P consumer (warpgroup 1) and the
// dS consumer (warpgroup 2), which rebuild them in f32; then per 64-key
// tile of the causal range:
// - S = Q.K^T (P consumer) beside dP = dO.V^T (dS consumer), by piece
//   (scores_by_piece). The P consumer masks the causal diagonal tile and
//   the keys at and past kv_len, forms P = exp(S scale - LSE) in f32 (expf,
//   as the plain version rounds it) and hands it over through the exchange
//   (named barrier 3); the dS consumer takes dP - delta in f32 or, where P
//   exceeds kExactP, in f64 (exact_dp_share: in a row whose P gathers on a
//   few keys, as a causal head's first rows, dP - delta cancels and dP's
//   own rounding would reach dQ unweighted), forms dS = P (dP - delta)
//   scale and hands it back in the exchange's place (barrier 4), keeping
//   a copy in its own tile;
// - each consumer runs its half of dQ += dS.K (piece_out_products: dS's
//   fragments split per k-step from the f32 tile; held in registers, 48 of
//   them, they pushed dQ's accumulator into spills) from K's terms dealt
//   again, its half of each (K is needed before and after dS, so it is
//   loaded twice: 288 KB from L2 a 64 x 64 tile pair), per K term and
//   64-column chunk promoted.
// dQ leaves in f32 by plain stores. 18 bf16 passes of 2 D flops a causal
// pair bound it: operations, 0.313 ms at the head_dim-256 phase's shape
// (B*H = 64, L = 1024, causal).
__device__ __forceinline__ void dq_f32_d256_body(
    const CUtensorMap& map_q, const CUtensorMap& map_k,
    const CUtensorMap& map_v, const CUtensorMap& map_do,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq_f32, const bf16* __restrict__ terms, int BH,
    int H, int L, float scale, int causal, int kv_len) {
  using Smem = DqF32D256Smem;
  constexpr int D = kWideD, NS = Smem::kSlots;
  constexpr int kPIn = 3, kDSIn = 4;   // named barriers: P, then dS, are in
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);                     // [slot]
  float4* q_res = reinterpret_cast<float4*>(ring + NS * kPiece);  // [32][kWG]
  float4* do_res = q_res + 32 * kWG;
  // [8][kWG]: the exchange (S's running sum, then P, then dS) and the dS
  // consumer's own tile (dP's running sum, then dS)
  float4* exch = do_res + 32 * kWG;
  float4* dp_sum = exch + 8 * kWG;
  float* stats = reinterpret_cast<float*>(dp_sum + 8 * kWG);   // LSE, delta
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + 128);
  uint64_t* empty = full + NS;
  uint64_t* st_full = empty + NS;
  uint64_t* st_empty = st_full + 1;

  const int num_t = L / 64, BL = BH / H * L;   // BL: rows of one term
  const size_t n_term = (size_t)BL * H * D;    // elements of one term
  const bool by_head = f32_by_head(BH * num_t);
  // the key tiles of query tile qt: through its diagonal tile under causal
  auto key_tiles = [&](int qt) { return causal ? qt + 1 : num_t; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWG);       // a slot has one consumer
    }
    mbar_init(st_full, 1);
    mbar_init(st_empty, 2 * kWG);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    // ---- producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int n = 0;   // pieces loaded so far
      // columns 128 half .. of term `term` of an operand's 64 rows from r0
      auto put = [&](const CUtensorMap* map, int bh, int term, int r0,
                     int half) {
        const int s = n % NS, b = bh / H, h = bh % H;
        if (n >= NS) mbar_wait(&empty[s], (n / NS - 1) & 1);
        mbar_expect_tx(&full[s], kPiece);
        for (int c = 0; c < 2; ++c)
          tma_load(ring + s * kPiece + c * kChunk, map, &full[s],
                   h * D + (2 * half + c) * kSeg, term * BL + b * L + r0);
        ++n;
      };
      int bh, rank;
      for (int it = 0; f32_item(it, BH, num_t, by_head, bh, rank); ++it) {
        const int qt = num_t - 1 - rank, q0 = qt * 64;
        if (it >= 1) mbar_wait(st_empty, (it - 1) & 1);
        mbar_expect_tx(st_full, Smem::kStats);
        bulk_load(stats, lse + (size_t)bh * L + q0, 256, st_full);
        bulk_load(stats + 64, delta + (size_t)bh * L + q0, 256, st_full);
        for (int term = 0; term < 3; ++term)     // Q, dO: hi, mid, lo
          for (int half = 0; half < 2; ++half) {
            put(&map_q, bh, term, q0, half);
            put(&map_do, bh, term, q0, half);
          }
        for (int j = 0; j < key_tiles(qt); ++j) {
          for (int term = 2; term >= 0; --term)  // S, dP: K, V
            for (int half = 0; half < 2; ++half) {
              put(&map_k, bh, term, j * 64, half);
              put(&map_v, bh, term, j * 64, half);
            }
          for (int term = 2; term >= 0; --term)  // dQ: K's two halves
            for (int half = 0; half < 2; ++half)
              put(&map_k, bh, term, j * 64, half);
        }
      }
    }
  } else {
    // ---- consumers: w = 0 forms P (reads Q), w = 1 forms dS (reads dO);
    // each holds dQ's columns 128 w .. 128 w + 127
    setmaxnreg_inc<kConsumerRegs>();
    const int w = threadIdx.x / kWG - 1;
    const int tid = threadIdx.x & (kWG - 1);
    const int warp = tid >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r_lo = 16 * warp + g;        // rows r_lo and r_lo + 8
    float4* res = w == 0 ? q_res : do_res;
    float4* xe = exch;
    float4* ds_own = dp_sum;               // the dS consumer's own tile
    const PieceRing rg{smem_addr(ring), 0, smem_addr(full), smem_addr(empty),
                       w};
    const bf16* v_terms = terms + 2 * 3 * n_term;   // operand 2: V
    int i = 0;                             // pieces so far
    int bh, rank;
    for (int it = 0; f32_item(it, BH, num_t, by_head, bh, rank); ++it) {
      const int b = bh / H, h = bh % H;
      const int qt = num_t - 1 - rank, q0 = qt * 64, nk = key_tiles(qt);
      mbar_wait(st_full, it & 1);
      // LSE of this thread's rows (P consumer) or their delta
      float row_stat[2];
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2)
        row_stat[r2] = stats[64 * w + r_lo + 8 * r2];
      mbar_arrive(st_empty);
      for (int q = 0; q < 6; ++q, ++i) {
        rebuild_piece(res, rg.wait(i), q % 2, q / 2, tid, r_lo, t);
        rg.release(i);
      }
      __syncwarp();   // the f64 dots read the warp's other lanes' dO
      float dq[D / 4];
#pragma unroll
      for (int e = 0; e < D / 4; ++e) dq[e] = 0.f;

      for (int j = 0; j < nk; ++j) {
        const int k0 = j * 64;
        float x[32];                       // S, then P (P consumer); dP
        scores_by_piece<2>(x, w == 0 ? xe : ds_own, res, tid, i, rg, 0);
        rg.release(i + 5);
        i += 6;
        if (w == 0) {
          // -inf past the causal diagonal and at and past kv_len
          if ((causal && j == nk - 1) || k0 + 64 > kv_len) {
#pragma unroll
            for (int e = 0; e < 32; ++e) {
              const int key = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
              const int row = q0 + r_lo + 8 * ((e >> 1) & 1);
              if ((causal && key > row) || key >= kv_len) x[e] = -INFINITY;
            }
          }
#pragma unroll
          for (int e = 0; e < 32; ++e)
            x[e] = expf(x[e] * scale - row_stat[(e >> 1) & 1]);
#pragma unroll
          for (int j4 = 0; j4 < 8; ++j4)
            *share_at(xe, j4, tid) = make_float4(x[4 * j4], x[4 * j4 + 1],
                                                 x[4 * j4 + 2], x[4 * j4 + 3]);
          named_arrive(kPIn, 2 * kWG);
          named_sync(kDSIn, 2 * kWG);      // this tile's dS is in
        } else {
          named_sync(kPIn, 2 * kWG);       // this tile's P is in
          float p_max = 0.f;
#pragma unroll
          for (int j4 = 0; j4 < 8; ++j4) {
            const float4 p4 = *share_at(xe, j4, tid);
            p_max = fmaxf(fmaxf(p_max, fmaxf(p4.x, p4.y)),
                          fmaxf(p4.z, p4.w));
          }
#pragma unroll
          for (int e = 0; e < 32; ++e) x[e] -= row_stat[(e >> 1) & 1];
          if (__any_sync(0xffffffffu, p_max > kExactP)) {
            // the warp takes each such entry in turn, eight columns a
            // lane, and hands the f64 sum to the entry's lane
#pragma unroll
            for (int e = 0; e < 32; ++e) {
              const float pe =
                  reinterpret_cast<const float*>(share_at(xe, e >> 2, tid))[e & 3];
              uint32_t lanes = __ballot_sync(0xffffffffu, pe > kExactP);
              while (lanes) {
                const int src = __ffs(lanes) - 1;
                lanes &= lanes - 1;
                const int row = 16 * warp + (src >> 2) + 8 * ((e >> 1) & 1);
                const int key = k0 + 8 * (e >> 2) + 2 * (src & 3) + (e & 1);
                const double dpx = warp_sum(exact_dp_share(
                    res, row, v_terms + ((size_t)(b * L + key) * H + h) * D,
                    n_term, lane));
                if (lane == src)
                  x[e] = (float)(dpx - (double)row_stat[(e >> 1) & 1]);
              }
            }
          }
          // dS = P (dP - delta) scale, into the exchange and into this
          // consumer's own tile
#pragma unroll
          for (int j4 = 0; j4 < 8; ++j4) {
            const float4 p4 = *share_at(xe, j4, tid);
            const float4 d4 = make_float4(p4.x * x[4 * j4] * scale,
                                          p4.y * x[4 * j4 + 1] * scale,
                                          p4.z * x[4 * j4 + 2] * scale,
                                          p4.w * x[4 * j4 + 3] * scale);
            *share_at(xe, j4, tid) = d4;
            *share_at(ds_own, j4, tid) = d4;
          }
          named_arrive(kDSIn, 2 * kWG);
        }
        // dQ[:, 128 w ..] += dS.K[:, 128 w ..]: per K term (this
        // consumer's half of it, read MN-major, depth keys 16 kk ..) and
        // 64-column chunk, dS from the f32 tile (the exchange, or the dS
        // consumer's own copy)
#pragma unroll
        for (int u = 0; u < 3; ++u, ++i) {
          piece_out_products<2>(dq, 0, 2 - u, w == 0 ? xe : ds_own, tid,
                                rg.wait(i));
          rg.release(i);
        }
      }

      // dQ[:, 128 w ..] in f32, rows of [B, L, H, D]
#pragma unroll
      for (int j8 = 0; j8 < D / 16; ++j8)
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          const int row = q0 + r_lo + 8 * r2, c = 128 * w + 8 * j8 + 2 * t;
          *reinterpret_cast<float2*>(
              dq_f32 + ((size_t)(b * L + row) * H + h) * D + c) =
              make_float2(dq[4 * j8 + 2 * r2], dq[4 * j8 + 2 * r2 + 1]);
        }
    }
  }
}

// dQ: dq_mma_body at D = 64 and 128; at 256 dq_d256_body (kBf16, kSplit)
// and dq_f32_d256_body (kF32, which also reads V's terms in global memory,
// `terms`).
template <int D, int Form, int Mode = kBf16>
__global__ void __launch_bounds__(kBwdThreads<D, Mode>, 1)
flash_dq_mma_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_dq,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    float* __restrict__ dq_f32,
                    const bf16* __restrict__ terms, int BH, int H, int L,
                    float scale, int causal, int kv_len) {
  if constexpr (D == kWideD && Mode == kF32) {
    static_assert(Form == kStd, "kF32 reads split terms as rows");
    dq_f32_d256_body(map_q, map_k, map_v, map_do, lse, delta, dq_f32, terms,
                     BH, H, L, scale, causal, kv_len);
  } else if constexpr (D == kWideD) {
    dq_d256_body<Form, Mode == kSplit>(map_q, map_k, map_v, map_do, map_dq,
                                       lse, delta, BH, H, L, scale, causal,
                                       kv_len);
  } else {
    dq_mma_body<D, Form, Mode>(map_q, map_k, map_v, map_do, map_dq, lse,
                               delta, dq_f32, BH, H, L, scale, causal,
                               kv_len);
  }
}

// --------------------------------------------------------------- split
// f32 storage: Q, K, V and dO (operands 0 .. 3) each as three bf16 terms,
// hi, mid and lo (split_pair), written as terms[operand][term] of
// [B, L, H, D] bf16, which the kF32 instances of dQ and dK/dV read by TMA
// as they read bf16 operands. Bit `op` of `transposed` marks an operand
// given as [B, H, D, L] (nn and nn2), read across L. A thread splits four
// neighbouring elements of a row (one 16-byte load where the operand is a
// row). Bound: bytes, 4 read and 6 written an element: 0.10 ms for the
// four operands at the training shape.
__global__ void __launch_bounds__(256)
flash_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout, int transposed,
                   bf16* __restrict__ terms, int B, int H, int L, int D) {
  const int op = blockIdx.y;
  const float* src = op == 0 ? q : op == 1 ? k : op == 2 ? v : dout;
  const size_t n = (size_t)B * L * H * D;
  bf16* out = terms + (size_t)op * 3 * n;
  const bool tr = (transposed >> op) & 1;
  for (size_t i = 4 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x); i < n;
       i += 4 * (size_t)gridDim.x * blockDim.x) {
    float x[4];
    if (tr) {
      const size_t row = i / D, b = row / ((size_t)L * H);
      const int d = (int)(i % D), h = (int)(row % H);
      const int l = (int)(row / H % L);
      const float* p = src + ((b * H + h) * D + d) * L + l;
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = p[(size_t)e * L];
    } else {
      const float4 f = *reinterpret_cast<const float4*>(src + i);
      x[0] = f.x;
      x[1] = f.y;
      x[2] = f.z;
      x[3] = f.w;
    }
    uint2 hi, mid, lo;
    split_pair(x[0], x[1], hi.x, mid.x, lo.x);
    split_pair(x[2], x[3], hi.y, mid.y, lo.y);
    *reinterpret_cast<uint2*>(out + i) = hi;
    *reinterpret_cast<uint2*>(out + n + i) = mid;
    *reinterpret_cast<uint2*>(out + 2 * n + i) = lo;
  }
}

// ----------------------------------------------------------------- probe
// On the TPU the probe asked whether the server's Mosaic compiler accepted
// a 128 x 128 f32-out product of bf16 tiles in the NT, TN and NN forms, and
// with an f32 A transposed and cast to bf16 in the kernel. Here every form
// is compiled ahead of time (a form nvcc refused would fail the whole
// build), so the probe asks the card instead: one block per form runs the
// product on the tensor cores (mma.sync m16n8k16 on fragments loaded from
// shared memory) and writes it out; the host holds each against a product
// it knows exactly, which with the compute capability yields the caps
// {nt_bf16, nn_bf16, transpose_f32} that the "auto" strategy is picked
// from (ops/flash_attention.py).
// Bound: 384 KB moved and 1.7e7 flops, about 0.1 us on an H100; it runs
// once per process and card.

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a.b for a 16x16 A (row-major fragment), a 16x8 B (column fragment)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows r .. r+15, columns c .. c+15 of a row-major tile
// (row stride s); g = lane / 4, t = lane % 4.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int s, int r, int c, int g, int t) {
  a[0] = ld32(tile + (r + g) * s + c + 2 * t);
  a[1] = ld32(tile + (r + g + 8) * s + c + 2 * t);
  a[2] = ld32(tile + (r + g) * s + c + 8 + 2 * t);
  a[3] = ld32(tile + (r + g + 8) * s + c + 8 + 2 * t);
}

constexpr int kProbeN = 128;             // the probe's tiles are 128 x 128
constexpr int kProbeS = kProbeN + 8;     // padded row of a bf16 tile in smem
constexpr int kProbeThreads = 256;       // 8 warps, 16 output rows each

// Block f computes form f into out[f] (f32, row-major [m][n]):
//   0  NT: A [m][k] . B [n][k]^T
//   1  TN: A [k][m]^T . B [k][n]
//   2  NN: A [m][k] . B [k][n]
//   3  A32 [k][m] (f32) transposed and cast to bf16, then NN with B [k][n]
// Shared memory holds A as [m][k] and B as [n][k], the layouts the
// fragment loads take; the forms differ in how the tiles get there.
__global__ void __launch_bounds__(kProbeThreads)
flash_probe_kernel(const bf16* __restrict__ a, const float* __restrict__ a32,
                   const bf16* __restrict__ b, float* __restrict__ out) {
  constexpr int N = kProbeN, S = kProbeS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [m][S]
  bf16* Bs = As + N * S;                         // [n][S]
  const int form = blockIdx.x;
  const bool a_t = form == 1 || form == 3, b_t = form != 0;
  for (int i = threadIdx.x; i < N * N; i += kProbeThreads) {
    const int r = i / N, c = i % N;  // element [r][c] of the operand
    const bf16 av = form == 3 ? __float2bfloat16_rn(a32[i]) : a[i];
    As[a_t ? c * S + r : r * S + c] = av;
    Bs[b_t ? c * S + r : r * S + c] = b[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  float acc[N / 8][4] = {};
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks) {
    uint32_t af[4];
    load_a(af, As, S, r0, ks * 16, g, t);
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const bf16* brow = Bs + (n * 8 + g) * S + ks * 16 + 2 * t;
      mma_bf16(acc[n], af, ld32(brow), ld32(brow + 8));
    }
  }
  float* o = out + (size_t)form * N * N;
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[(r0 + g + (e >> 1) * 8) * N + n * 8 + 2 * t + (e & 1)] = acc[n][e];
}
// ---------------------------------------------------------------- launch
// Shared memory above 48 KB has to be allowed per kernel (and card) before
// its first launch; this does it once per kernel instance and card.
template <auto Kernel>
cudaError_t allow_smem(size_t smem) {
  static std::atomic<unsigned> done{0};   // bit d: allowed on card d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// The kernel instance that this thread launched last: its name and
// template arguments as the host compiler spells them (the function's
// name, e.g. "... [with auto Kernel = flash_fwd_mma_kernel<256, 0>]",
// default arguments left out), so that a caller can count the launches of
// each instance.
thread_local const char* g_last_instance = "";
template <auto Kernel>
const char* instance_name() {
  return __PRETTY_FUNCTION__;
}

template <auto Kernel, typename... Args>
cudaError_t launch(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = allow_smem<Kernel>(smem);
  if (err != cudaSuccess) return err;
  Kernel<<<grid, threads, smem, stream>>>(args...);
  g_last_instance = instance_name<Kernel>();
  return cudaGetLastError();
}

// A persistent grid: one block per SM, or per (head, `rows`-row tile)
// where there are fewer of those.
dim3 persistent_grid(int B, int H, int L, int rows = kBig) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 0;
  const long items = (long)B * H * ((L + rows - 1) / rows);
  return dim3((unsigned)(sms > 0 && sms < items ? sms : items));
}

// A TMA map of a 2-D bf16 tensor, `rows` rows of `cols` elements with a
// row stride of `stride` elements, moved in 128-byte-swizzled boxes of
// box_rows rows x 64 columns (128 bytes, the swizzle's span). Boxes that
// cross the tensor's edge are filled with zeros on load and cut on store.
bool encode_map(CUtensorMap* map, const void* ptr, uint64_t cols,
                uint64_t rows, uint64_t stride, uint32_t box_rows) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {stride * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)kSeg, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(ptr), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
// [B, L, H, D] viewed as [B*L, H*D]
bool rows_map(CUtensorMap* map, const void* ptr, int B, int H, int L, int D,
              int box_rows) {
  return encode_map(map, ptr, (uint64_t)H * D, (uint64_t)B * L,
                    (uint64_t)H * D, box_rows);
}
// [B, H, D, L] viewed as [B*H*D, L], boxes of D rows (one head's slab)
bool cols_map(CUtensorMap* map, const void* ptr, int B, int H, int L, int D) {
  return encode_map(map, ptr, (uint64_t)L, (uint64_t)B * H * D, (uint64_t)L,
                    D);
}

typedef const float* cf32;   // an f32 input (split pass operands, LSE, delta)

// kStd: k is K [B, L, H, D]; kNN: K^T [B, H, D, L]. kSplit: the f32-dot
// forward on bf16 storage. At D = 256 K and V move in 64-row tiles.
template <int D, int Form, int Mode = kBf16>
cudaError_t fwd_mma(const void* q, const void* k, const void* v, void* o,
                    void* lse, int B, int H, int L, float scale, int causal,
                    int kv_len, cudaStream_t st) {
  constexpr bool wide = D == kWideD;
  constexpr int kv_rows = wide ? 64 : kBig;
  size_t smem = 0;
  if constexpr (wide) smem = FwdD256Smem::kBytes;
  else smem = FwdSmem<D>::kBytes;
  CUtensorMap mq, mk, mv, mo;
  const bool ok =
      rows_map(&mq, q, B, H, L, D, 64) && rows_map(&mo, o, B, H, L, D, 64) &&
      rows_map(&mv, v, B, H, L, D, kv_rows) &&
      (Form == kStd ? rows_map(&mk, k, B, H, L, D, kv_rows)
                    : cols_map(&mk, k, B, H, L, D));
  if (!ok) return cudaErrorInvalidValue;
  return launch<flash_fwd_mma_kernel<D, Form, Mode>>(
      persistent_grid(B, H, L), kFwdThreads<D, Mode>, smem, st, mq, mk, mv,
      mo, (float*)lse, nullptr, B * H, H, L, scale, causal, kv_len);
}

// kStd: k, v are K, V [B, L, H, D] (kt unused). kNN: kt, v are K^T, V^T
// [B, H, D, L] (k unused). kSplit: the f32-dot dQ on bf16 storage. At
// D = 256 a work item is a 64-row query tile.
template <int D, int Form, int Mode = kBf16>
cudaError_t dq_mma(const void* q, const void* k, const void* kt,
                   const void* v, const void* dout, const void* lse,
                   const void* delta, void* dq, int B, int H, int L,
                   float scale, int causal, int kv_len, cudaStream_t st) {
  CUtensorMap mq, mk, mv, mdo, mdq;
  const bool ok =
      rows_map(&mq, q, B, H, L, D, 64) &&
      rows_map(&mdo, dout, B, H, L, D, 64) &&
      rows_map(&mdq, dq, B, H, L, D, 64) &&
      (Form == kStd ? rows_map(&mk, k, B, H, L, D, 64) &&
                          rows_map(&mv, v, B, H, L, D, 64)
                    : cols_map(&mk, kt, B, H, L, D) &&
                          cols_map(&mv, v, B, H, L, D));
  if (!ok) return cudaErrorInvalidValue;
  constexpr bool wide = D == kWideD;
  size_t smem = 0;
  if constexpr (wide) smem = DqD256Smem<Mode == kSplit>::kBytes;
  else smem = BwdSmem<D, Mode>::kBytes;
  return launch<flash_dq_mma_kernel<D, Form, Mode>>(
      persistent_grid(B, H, L, wide ? 64 : kBig), kBwdThreads<D, Mode>, smem,
      st, mq, mk, mv, mdo, mdq, (const float*)lse, (const float*)delta,
      (float*)nullptr, (const bf16*)nullptr, B * H, H, L, scale, causal,
      kv_len);
}

// kStd: q, k, v, dout, dk, dv all [B, L, H, D] (qt, doutt unused). kNN: k,
// v are K^T, V^T [B, H, D, L]. kNN2: also qt, doutt = Q^T, dO^T (q, dout
// unused), and dk, dv are dK^T, dV^T, all [B, H, D, L]. kSplit: the
// f32-dot dK/dV on bf16 storage. At D = 256 a work item is a
// 64-key tile.
template <int D, int Form, int Mode = kBf16>
cudaError_t dkv_mma(const void* q, const void* qt, const void* k,
                    const void* v, const void* dout, const void* doutt,
                    const void* lse, const void* delta, void* dk, void* dv,
                    int B, int H, int L, float scale, int causal,
                    cudaStream_t st) {
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  auto map = [&](CUtensorMap* m, const void* p, bool transposed) {
    return transposed ? cols_map(m, p, B, H, L, D)
                      : rows_map(m, p, B, H, L, D, 64);
  };
  const bool kt = Form != kStd, qtr = Form == kNN2;
  const bool ok = map(&mq, qtr ? qt : q, qtr) && map(&mk, k, kt) &&
                  map(&mv, v, kt) && map(&mdo, qtr ? doutt : dout, qtr) &&
                  map(&mdk, dk, qtr) && map(&mdv, dv, qtr);
  if (!ok) return cudaErrorInvalidValue;
  constexpr bool wide = D == kWideD;
  size_t smem = 0;
  if constexpr (wide) smem = DkvD256Smem::kBytes;
  else smem = BwdSmem<D, Mode>::kBytes;
  return launch<flash_dkv_mma_kernel<D, Form, Mode>>(
      persistent_grid(B, H, L, wide ? 64 : kBig), kBwdThreads<D, Mode>, smem,
      st, mq, mk, mv, mdo, mdk, mdv, (const float*)lse, (const float*)delta,
      (float*)nullptr, (float*)nullptr, 0, B * H, H, L, scale, causal);
}

// f32 storage (the forward, dQ and dK/dV at every head_dim). split_terms
// runs flash_split_kernel on the
// first n_ops of Q, K, V and dO (bit i of `transposed`: operand i given as
// [B, H, D, L]) into `terms`, [n_ops, 3, B, L, H, D] bf16; the kF32
// instances of the forward, dQ and dK/dV read the terms, each operand's
// three as one [3*B*L, H*D] map.
cudaError_t split_terms(const void* q, const void* k, const void* v,
                        const void* dout, int transposed, int n_ops,
                        void* terms, int B, int H, int L, int D,
                        cudaStream_t st) {
  const size_t quads = (size_t)B * L * H * D / 4;
  const unsigned blocks = (unsigned)((quads + 255) / 256 < 4096
                                         ? (quads + 255) / 256 : 4096);
  return launch<flash_split_kernel>(
      dim3(blocks, n_ops), 256, 0, st, (cf32)q, (cf32)k, (cf32)v,
      (cf32)dout, transposed, (bf16*)terms, B, H, L, D);
}

template <int N>
bool terms_maps(CUtensorMap (&m)[N], const void* terms, int B, int H, int L,
                int D) {
  const size_t n = (size_t)B * L * H * D;
  for (int op = 0; op < N; ++op)
    if (!rows_map(&m[op], (const bf16*)terms + op * 3 * n, 3 * B, H, L, D,
                  64))
      return false;
  return true;
}

// At D = 256 (fwd_f32_d256_body, dq_f32_d256_body, dkv_f32_d256_body) a
// work item is a 64-row tile.
template <int D>
cudaError_t fwd_f32(const void* terms, void* o, void* lse, int B, int H,
                    int L, float scale, int causal, int kv_len,
                    cudaStream_t st) {
  CUtensorMap m[3];   // Q, K, V
  if (!terms_maps(m, terms, B, H, L, D)) return cudaErrorInvalidValue;
  constexpr bool wide = D == kWideD;
  size_t smem = 0;
  if constexpr (wide) smem = FwdF32D256Smem::kBytes;
  else smem = FwdF32Smem<D>::kBytes;
  return launch<flash_fwd_mma_kernel<D, kStd, kF32>>(
      persistent_grid(B, H, L, wide ? 64 : kBig), kFwdThreads<D, kF32>, smem,
      st, m[0], m[1], m[2], m[0], (float*)lse, (float*)o, B * H, H, L, scale,
      causal, kv_len);
}

template <int D>
cudaError_t dq_f32(const void* terms, const void* lse, const void* delta,
                   void* dq, int B, int H, int L, float scale, int causal,
                   int kv_len, cudaStream_t st) {
  CUtensorMap m[4];   // Q, K, V, dO
  if (!terms_maps(m, terms, B, H, L, D)) return cudaErrorInvalidValue;
  constexpr bool wide = D == kWideD;
  size_t smem = 0;
  if constexpr (wide) smem = DqF32D256Smem::kBytes;
  else smem = BwdSmem<D, kF32>::kBytes;
  return launch<flash_dq_mma_kernel<D, kStd, kF32>>(
      persistent_grid(B, H, L, wide ? 64 : kBig), kBwdThreads<D, kF32>, smem,
      st, m[0], m[1], m[2], m[3], m[0], (const float*)lse,
      (const float*)delta, (float*)dq, (const bf16*)terms, B * H, H, L,
      scale, causal, kv_len);
}

template <int D>
cudaError_t dkv_f32(const void* terms, const void* lse, const void* delta,
                    void* dk, void* dv, int out_t, int B, int H, int L,
                    float scale, int causal, cudaStream_t st) {
  CUtensorMap m[4];
  if (!terms_maps(m, terms, B, H, L, D)) return cudaErrorInvalidValue;
  constexpr bool wide = D == kWideD;
  size_t smem = 0;
  if constexpr (wide) smem = DkvF32D256Smem::kBytes;
  else smem = BwdSmem<D, kF32>::kBytes;
  return launch<flash_dkv_mma_kernel<D, kStd, kF32>>(
      persistent_grid(B, H, L, wide ? 64 : kBig), kBwdThreads<D, kF32>, smem,
      st, m[0], m[1], m[2], m[3], m[0], m[0],
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, out_t,
      B * H, H, L, scale, causal);
}

// The forward, dQ and dK/dV on f32 storage: the split first where `split`
// is set (the terms are then this call's; else they are an earlier call's
// of the same operands).
cudaError_t fwd_storage_f32(const void* q, const void* k, const void* v,
                            int transposed, void* o, void* lse, void* terms,
                            int split, int B, int H, int L, int D,
                            float scale, int causal, int kv_len,
                            cudaStream_t st) {
  if (split) {
    const cudaError_t err = split_terms(q, k, v, nullptr, transposed, 3,
                                        terms, B, H, L, D, st);
    if (err != cudaSuccess) return err;
  }
  if (D == 64)
    return fwd_f32<64>(terms, o, lse, B, H, L, scale, causal, kv_len, st);
  if (D == 128)
    return fwd_f32<128>(terms, o, lse, B, H, L, scale, causal, kv_len, st);
  return fwd_f32<kWideD>(terms, o, lse, B, H, L, scale, causal, kv_len, st);
}

cudaError_t dq_storage_f32(const void* q, const void* k, const void* v,
                           const void* dout, int transposed,
                           const void* lse, const void* delta, void* dq,
                           void* terms, int split, int B, int H, int L,
                           int D, float scale, int causal, int kv_len,
                           cudaStream_t st) {
  if (split) {
    const cudaError_t err =
        split_terms(q, k, v, dout, transposed, 4, terms, B, H, L, D, st);
    if (err != cudaSuccess) return err;
  }
  if (D == 64)
    return dq_f32<64>(terms, lse, delta, dq, B, H, L, scale, causal, kv_len,
                      st);
  if (D == 128)
    return dq_f32<128>(terms, lse, delta, dq, B, H, L, scale, causal, kv_len,
                       st);
  return dq_f32<kWideD>(terms, lse, delta, dq, B, H, L, scale, causal,
                        kv_len, st);
}

cudaError_t dkv_storage_f32(const void* q, const void* k, const void* v,
                            const void* dout, int transposed,
                            const void* lse, const void* delta, void* dk,
                            void* dv, int out_t, void* terms, int split,
                            int B, int H, int L, int D, float scale,
                            int causal, cudaStream_t st) {
  if (split) {
    const cudaError_t err =
        split_terms(q, k, v, dout, transposed, 4, terms, B, H, L, D, st);
    if (err != cudaSuccess) return err;
  }
  if (D == 64)
    return dkv_f32<64>(terms, lse, delta, dk, dv, out_t, B, H, L, scale,
                       causal, st);
  if (D == 128)
    return dkv_f32<128>(terms, lse, delta, dk, dv, out_t, B, H, L, scale,
                        causal, st);
  return dkv_f32<kWideD>(terms, lse, delta, dk, dv, out_t, B, H, L, scale,
                         causal, st);
}

bool shape_ok(int B, int H, int L, int D) {
  return B > 0 && H > 0 && L > 0 && L % kTile == 0 && L / kTile <= 65535 &&
         (D == 64 || D == 128 || D == kWideD);
}
// the true key count of zero-padded inputs: keys at and past it are masked
bool keys_ok(int L, int kv_len) { return kv_len > 0 && kv_len <= L; }

constexpr int kBad = (int)cudaErrorInvalidValue;
constexpr int kTransposedK = 0b0010;     // K^T (the nn forward)
constexpr int kTransposedKV = 0b0110;    // K^T, V^T (nn)
constexpr int kTransposedAll = 0b1111;   // Q^T, K^T, V^T, dO^T (nn2)

// The forward, dQ and dK/dV on bf16 storage: the Hopper kernels at every
// head_dim the kernels take, kBf16 for strategies bf16, nn and nn2, kSplit
// for f32.
template <int Form, int Mode = kBf16>
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int H, int L, int D, float scale,
                     int causal, int kv_len, cudaStream_t st) {
  if (D == 64)
    return fwd_mma<64, Form, Mode>(q, k, v, o, lse, B, H, L, scale, causal,
                                   kv_len, st);
  if (D == 128)
    return fwd_mma<128, Form, Mode>(q, k, v, o, lse, B, H, L, scale, causal,
                                    kv_len, st);
  return fwd_mma<kWideD, Form, Mode>(q, k, v, o, lse, B, H, L, scale, causal,
                                     kv_len, st);
}
template <int Form, int Mode = kBf16>
cudaError_t dq_bf16(const void* q, const void* k, const void* kt,
                    const void* v, const void* dout, const void* lse,
                    const void* delta, void* dq, int B, int H, int L, int D,
                    float scale, int causal, int kv_len, cudaStream_t st) {
  if (D == 64)
    return dq_mma<64, Form, Mode>(q, k, kt, v, dout, lse, delta, dq, B, H, L,
                                  scale, causal, kv_len, st);
  if (D == 128)
    return dq_mma<128, Form, Mode>(q, k, kt, v, dout, lse, delta, dq, B, H,
                                   L, scale, causal, kv_len, st);
  return dq_mma<kWideD, Form, Mode>(q, k, kt, v, dout, lse, delta, dq, B, H,
                                    L, scale, causal, kv_len, st);
}
template <int Form, int Mode = kBf16>
cudaError_t dkv_bf16(const void* q, const void* qt, const void* k,
                     const void* v, const void* dout, const void* doutt,
                     const void* lse, const void* delta, void* dk, void* dv,
                     int B, int H, int L, int D, float scale, int causal,
                     cudaStream_t st) {
  if (D == 64)
    return dkv_mma<64, Form, Mode>(q, qt, k, v, dout, doutt, lse, delta, dk,
                                   dv, B, H, L, scale, causal, st);
  if (D == 128)
    return dkv_mma<128, Form, Mode>(q, qt, k, v, dout, doutt, lse, delta, dk,
                                    dv, B, H, L, scale, causal, st);
  return dkv_mma<kWideD, Form, Mode>(q, qt, k, v, dout, doutt, lse, delta,
                                     dk, dv, B, H, L, scale, causal, st);
}

}  // namespace

// C interface, bound with ctypes. dtype: 0 = float32, 1 = bfloat16. On
// bf16 storage the mma kernels' kBf16 instances (strategies bf16, nn and
// nn2) and kSplit instances (f32) at D = 64, 128 and 256. On f32 storage
// (where the storage-dtype
// dots are f32 dots) the kF32 instances of the forward, dQ and dK/dV at
// every head_dim, for every strategy (nn and nn2 split their transposed
// operands into the same terms, so they run the kStd instance and give its
// results bitwise; nn2's dK/dV stores dK^T and dV^T). The forward and dQ
// take kv_len, the true key count of zero-padded inputs. On f32 storage
// every entry point takes `terms`, scratch of [n, 3, B, L, H, D] bf16
// (n = 3 for the forward's Q, K, V; 4 for dQ's and dK/dV's Q, K, V, dO),
// and splits into it first where `split` is set; on bf16 storage both are
// unused. Every launcher returns the
// cudaError_t of its launch (0 on success); paddle_flash_last_instance
// names the kernel instance that the calling thread launched last.
extern "C" {

// Strategy bf16.
int paddle_flash_fwd(const void* q, const void* k, const void* v, void* o,
                     void* lse, void* terms, int B, int H, int L, int D,
                     int dtype, int causal, float scale, int kv_len,
                     int split, void* stream) {
  if (!shape_ok(B, H, L, D) || !keys_ok(L, kv_len)) return kBad;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return fwd_bf16<kStd>(q, k, v, o, lse, B, H, L, D, scale, causal, kv_len,
                          st);
  return fwd_storage_f32(q, k, v, 0, o, lse, terms, split, B, H, L, D, scale,
                         causal, kv_len, st);
}

int paddle_flash_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, void* terms, int B, int H, int L, int D,
                    int dtype, int causal, float scale, int kv_len,
                    int split, void* stream) {
  if (!shape_ok(B, H, L, D) || !keys_ok(L, kv_len)) return kBad;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return dq_bf16<kStd>(q, k, nullptr, v, dout, lse, delta, dq, B, H, L, D,
                         scale, causal, kv_len, st);
  return dq_storage_f32(q, k, v, dout, 0, lse, delta, dq, terms, split, B, H,
                        L, D, scale, causal, kv_len, st);
}

int paddle_flash_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, void* terms, int B, int H, int L,
                     int D, int dtype, int causal, float scale, int split,
                     void* stream) {
  if (!shape_ok(B, H, L, D)) return kBad;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return dkv_bf16<kStd>(q, nullptr, k, v, dout, nullptr, lse, delta, dk,
                          dv, B, H, L, D, scale, causal, st);
  return dkv_storage_f32(q, k, v, dout, 0, lse, delta, dk, dv, 0, terms,
                         split, B, H, L, D, scale, causal, st);
}

// Strategies nn and nn2.
int paddle_flash_fwd_nn(const void* q, const void* kt, const void* v,
                        void* o, void* lse, void* terms, int B, int H, int L,
                        int D, int dtype, int causal, float scale,
                        int kv_len, int split, void* stream) {
  if (!shape_ok(B, H, L, D) || !keys_ok(L, kv_len)) return kBad;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return fwd_bf16<kNN>(q, kt, v, o, lse, B, H, L, D, scale, causal, kv_len,
                         st);
  return fwd_storage_f32(q, kt, v, kTransposedK, o, lse, terms, split, B, H,
                         L, D, scale, causal, kv_len, st);
}

int paddle_flash_dq_nn(const void* q, const void* k, const void* kt,
                       const void* vt, const void* dout, const void* lse,
                       const void* delta, void* dq, void* terms, int B,
                       int H, int L, int D, int dtype, int causal,
                       float scale, int kv_len, int split, void* stream) {
  if (!shape_ok(B, H, L, D) || !keys_ok(L, kv_len)) return kBad;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return dq_bf16<kNN>(q, k, kt, vt, dout, lse, delta, dq, B, H, L, D, scale,
                        causal, kv_len, st);
  return dq_storage_f32(q, kt, vt, dout, kTransposedKV, lse, delta, dq, terms,
                        split, B, H, L, D, scale, causal, kv_len, st);
}

int paddle_flash_dkv_nn(const void* q, const void* kt, const void* vt,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, void* terms, int B, int H, int L,
                        int D, int dtype, int causal, float scale, int split,
                        void* stream) {
  if (!shape_ok(B, H, L, D)) return kBad;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return dkv_bf16<kNN>(q, nullptr, kt, vt, dout, nullptr, lse, delta, dk,
                         dv, B, H, L, D, scale, causal, st);
  return dkv_storage_f32(q, kt, vt, dout, kTransposedKV, lse, delta, dk, dv,
                         0, terms, split, B, H, L, D, scale, causal, st);
}

int paddle_flash_dkv_nn2(const void* q, const void* qt, const void* kt,
                         const void* vt, const void* dout, const void* doutt,
                         const void* lse, const void* delta, void* dkt,
                         void* dvt, void* terms, int B, int H, int L, int D,
                         int dtype, int causal, float scale, int split,
                         void* stream) {
  if (!shape_ok(B, H, L, D)) return kBad;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return dkv_bf16<kNN2>(q, qt, kt, vt, dout, doutt, lse, delta, dkt, dvt,
                          B, H, L, D, scale, causal, st);
  return dkv_storage_f32(qt, kt, vt, doutt, kTransposedAll, lse, delta, dkt,
                         dvt, 1, terms, split, B, H, L, D, scale, causal, st);
}

// Strategy f32: every dot in f32. On bf16 storage the kSplit instances of
// the Hopper kernels; on f32 the kF32 instances of every strategy.
int paddle_flash_fwd_f32dot(const void* q, const void* k, const void* v,
                            void* o, void* lse, void* terms, int B, int H,
                            int L, int D, int dtype, int causal, float scale,
                            int kv_len, int split, void* stream) {
  if (!shape_ok(B, H, L, D) || !keys_ok(L, kv_len)) return kBad;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return fwd_bf16<kStd, kSplit>(q, k, v, o, lse, B, H, L, D, scale, causal,
                                  kv_len, st);
  return fwd_storage_f32(q, k, v, 0, o, lse, terms, split, B, H, L, D, scale,
                         causal, kv_len, st);
}

int paddle_flash_dq_f32dot(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, void* terms, int B,
                           int H, int L, int D, int dtype, int causal,
                           float scale, int kv_len, int split,
                           void* stream) {
  if (!shape_ok(B, H, L, D) || !keys_ok(L, kv_len)) return kBad;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return dq_bf16<kStd, kSplit>(q, k, nullptr, v, dout, lse, delta, dq, B,
                                 H, L, D, scale, causal, kv_len, st);
  return dq_storage_f32(q, k, v, dout, 0, lse, delta, dq, terms, split, B, H,
                        L, D, scale, causal, kv_len, st);
}

int paddle_flash_dkv_f32dot(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv,
                            void* terms, int B, int H, int L, int D,
                            int dtype, int causal, float scale, int split,
                            void* stream) {
  if (!shape_ok(B, H, L, D)) return kBad;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return dkv_bf16<kStd, kSplit>(q, nullptr, k, v, dout, nullptr, lse,
                                  delta, dk, dv, B, H, L, D, scale, causal,
                                  st);
  return dkv_storage_f32(q, k, v, dout, 0, lse, delta, dk, dv, 0, terms,
                         split, B, H, L, D, scale, causal, st);
}

// The dot-form probe. a, b: [128, 128] bf16; a32: [128, 128] f32; out:
// [4, 128, 128] f32.
int paddle_flash_probe(const void* a, const void* a32, const void* b,
                       void* out, void* stream) {
  const size_t smem = sizeof(bf16) * 2 * kProbeN * kProbeS;
  cudaError_t err = allow_smem<flash_probe_kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  flash_probe_kernel<<<4, kProbeThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)a, (const float*)a32, (const bf16*)b, (float*)out);
  return (int)cudaGetLastError();
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

const char* paddle_flash_last_instance() { return g_last_instance; }

}  // extern "C"
