// Flash attention forward and backward for Hopper (sm_90a), written by hand.
//
// Counterparts of the Pallas TPU kernels in
// paddle_tpu/ops/pallas/flash_attention.py, one kernel for each kernel and
// dot strategy (FLAGS_flash_dot_impl) of the reference:
//   _fwd_kernel (:83)       bf16: flash_fwd_mma_kernel<D, kStd>
//                           nn, nn2: flash_fwd_mma_kernel<D, kNN> (reads K^T)
//                           f32: flash_fwd_f32dot_kernel<D, T>
//   _dq_kernel (:174)       bf16: flash_dq_mma_kernel<D, kStd>
//                           f32: flash_dq_f32dot_kernel<D, T>
//   _dq_kernel_nn (:203)    nn, nn2: flash_dq_mma_kernel<D, kNN> (reads K,
//                           K^T and V^T)
//   _dkv_kernel (:233)      bf16: flash_dkv_mma_kernel<D, kStd>
//                           nn: flash_dkv_mma_kernel<D, kNN> (reads K^T, V^T)
//                           f32: flash_dkv_f32dot_kernel<D, T>
//   _dkv_kernel_nn2 (:289)  nn2: flash_dkv_mma_kernel<D, kNN2> (reads K^T,
//                           V^T, Q^T and dO^T, writes dK^T and dV^T)
//   probe's kern (:467)     flash_probe_kernel (the dot-form probe)
// On f32 storage every strategy runs the f32-dot kernels, whose dots are
// the storage dtype's there; nn and nn2 run their Form instances, which
// read the transposed operands as the mma forms do.
// Each computes what its TPU counterpart computes, with the same numerics:
// dots accumulate in f32, sm_scale is applied in f32 after the Q.K dot,
// masked scores are -1e30 (not -inf). Under bf16, nn and nn2, P is rounded
// to the input dtype before P.V, and P and dS are rounded to the input
// dtype only where they enter a dot; the f32-dot kernels (strategy f32)
// load the storage dtype, compute every dot in f32 and round only what they
// store. delta = rowsum(dO * O) comes from the caller, in f32.
//
// Layout: q, k, v, o, dO, dQ, dK, dV are [B, L, H, D] contiguous (the
// public layout, read through strides); the transposed operands of nn and
// nn2 (K^T, V^T, Q^T, dO^T, dK^T, dV^T) are [B, H, D, L] contiguous, made
// and undone by torch transposes outside the kernels, as XLA makes them
// outside the TPU kernels. LSE and delta are [B, H, L] f32. D is 64 or 128;
// L a multiple of 64.
//
// Tiling. The TPU kernels hold a whole K/V row of the head in VMEM; on the
// H100 that is 256 KB at L = 1024, D = 64 in bf16, beyond a block's 227 KB
// of shared memory, so every kernel streams 64-row tiles through shared
// memory. A block owns one 64-row tile of its output (grid (B*H, L/64)):
// dQ is owned per query tile and dK/dV per key tile, so no block reduces
// across blocks and no atomics are needed. The causal loop bounds of the
// TPU kernels (kmax, qstart) are kept. The public gate keeps the TPU's
// 128-row tiles; the 64-row inner tiles change only the order of f32 sums.
//
// Bound. At the GPT-350M training shape (B*H = 128, L = 1024, D = 64,
// causal, bf16) each kernel reads and writes 67-134 MB and does 1.7e10 to
// 3.4e10 flops, so on the tensor cores bytes and flops bound it about
// equally, at 20-40 us. The mma kernels (bf16, nn, nn2) put every dot on
// the tensor cores with mma.sync and read each tile from device memory once
// per block, reusing it 64 times from shared memory; what still keeps them
// from the bound is latency (no copy/compute overlap, a barrier per tile,
// transposes through shared memory), which cp.async or TMA pipelining and
// wgmma are for. The f32-dot kernels run on the CUDA cores (67 TFLOP/s;
// tensor cores have no full-f32 product), operations-bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;  // rows of a query tile and of a key tile
constexpr float kNegInf = -1e30f;

// Which operands arrive transposed ([B, H, D, L]): none (kStd, strategy
// bf16 and f32), K^T and V^T (kNN), also Q^T and dO^T in and dK^T and
// dV^T out of the dK/dV kernel (kNN2).
enum Form { kStd = 0, kNN = 1, kNN2 = 2 };

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// Copy an R x C slab (row strides rs and ds elements, C a multiple of 8,
// rows 16-byte aligned) with NT threads, 16 B a load: global to shared
// memory or back.
template <int R, int C, int NT>
__device__ __forceinline__ void copy_slab(bf16* dst, size_t ds,
                                          const bf16* src, size_t rs) {
  constexpr int V = C / 8;
  for (int i = threadIdx.x; i < R * V; i += NT) {
    const int r = i / V, c = (i % V) * 8;
    *reinterpret_cast<uint4*>(dst + r * ds + c) =
        *reinterpret_cast<const uint4*>(src + r * rs + c);
  }
}

// dst[c][r] = src[r][c] for an R x C slab of global memory (row stride rs,
// C a multiple of 8), into shared memory of row stride ds. Each thread
// reads 16 B of one row; the 32 lanes of a warp take 32 consecutive rows,
// so each of their 2-byte stores lands on 16 consecutive 32-bit words: no
// bank conflict, whatever ds is. R is a multiple of 32.
template <int R, int C, int NT>
__device__ __forceinline__ void load_transposed(bf16* dst, int ds,
                                                const bf16* src, size_t rs) {
  constexpr int V = C / 8;
  for (int i = threadIdx.x; i < R * V; i += NT) {
    const int r = i % R, c = (i / R) * 8;
    const uint4 vec = *reinterpret_cast<const uint4*>(src + r * rs + c);
    const bf16* e = reinterpret_cast<const bf16*>(&vec);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * ds + r] = e[j];
  }
}

// Shared memory above 48 KB has to be allowed per kernel before launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// -------------------------------------------------------- f32-dot path
// Scalar f32 FMAs on tiles of storage type T (float or bf16), converted to
// f32 as they are loaded. Tiles sit in shared memory as f32 rows padded to
// D + 1 floats, so the column walks below hit 32 distinct banks. A block of
// 256 threads: thread (ty, tx) = (tid / 16, tid % 16) owns rows 4*ty ..
// 4*ty+3 of every 64 x 64 score tile and of its output tile, at columns
// tx + 16*j. The 16 threads of a row group are one half-warp, so row
// maxima and sums reduce with four xor-shuffles. P and dS stay f32.
// The Form instances (f32 storage under nn and nn2) load each transposed
// operand into the same row tile, so they give the kStd instance's results
// bitwise; kNN2 writes dK^T and dV^T straight from its accumulators.

constexpr int kThreads = 256;
constexpr int kRowPad = kTile + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// max / sum over the 16 lanes of a half-warp (one row group)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Copy rows row0 .. row0+63 of one head (row stride rs elements) into a
// [64][D + 1] f32 tile in shared memory.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rs) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = to_f32(src[(size_t)(row0 + r) * rs + c]);
  }
}

// The same tile from columns row0 .. row0+63 of one head's [D][L] slab of a
// [B, H, D, L] tensor, read along L.
template <int D, typename T>
__device__ __forceinline__ void load_tile_t(float* dst, const T* src,
                                            int row0, int L) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i % kTile, c = i / kTile;
    dst[r * (D + 1) + c] = to_f32(src[(size_t)c * L + row0 + r]);
  }
}

// Rows row0 .. row0+63 of one head into a [64][D + 1] tile, from a
// [B, L, H, D] tensor (head base `base`) or, `Transposed`, from a
// [B, H, D, L] one (head base `tb`).
template <int D, bool Transposed, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          size_t base, size_t tb, int row0,
                                          int rs, int L) {
  if constexpr (Transposed) load_tile_t<D>(dst, src + tb, row0, L);
  else load_tile<D>(dst, src + base, row0, rs);
}

// Scores of one 64 x 64 tile for this thread's 4 x 4 entries:
// acc[a][c] += sum_d A[4*ty + a][d] * Bt[tx + 16*c][d].
template <int D>
__device__ __forceinline__ void tile_dot_nt(float (&acc)[4][4],
                                            const float* A, const float* Bt,
                                            int ty, int tx) {
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = A[(4 * ty + a) * (D + 1) + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = Bt[(tx + 16 * c) * (D + 1) + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
  }
}

// Forward: streaming softmax over key tiles 0 .. kmax-1. k is K (kStd) or
// K^T (kNN).
template <int D, typename T, int Form>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32dot_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ lse, int H, int L, float scale,
                        int causal) {
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * (D + 1);
  float* Vs = Ks + kTile * (D + 1);
  float* Ps = Vs + kTile * (D + 1);  // [64][65]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kTile;
  const int rs = H * D;
  const size_t base = ((size_t)b * L * H + h) * D;
  const size_t tb = (size_t)bh * D * L;  // head base of a [B, H, D, L] tensor
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<D>(Qs, q + base, q0, rs);

  float acc[4][NJ], m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[a][j] = 0.f;
  }
  const int num_k = L / kTile;
  const int kmax = causal ? min((q0 + kTile + kTile - 1) / kTile, num_k)
                          : num_k;

  for (int kt_i = 0; kt_i < kmax; ++kt_i) {
    const int k0 = kt_i * kTile;
    __syncthreads();  // the previous tile's readers of Ks, Vs, Ps are done
    load_rows<D, Form != kStd>(Ks, k, base, tb, k0, rs, L);
    load_tile<D>(Vs, v + base, k0, rs);
    __syncthreads();

    float s[4][4] = {};
    tile_dot_nt<D>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = q0 + 4 * ty + a;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[a][c] * scale;
        if (causal && row < k0 + tx + 16 * c) x = kNegInf;
        s[a][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[a], group_max(mx));
      const float alpha = expf(m[a] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[a][c] - m_new);
        sum += p;
        Ps[(4 * ty + a) * kRowPad + tx + 16 * c] = p;
      }
      l[a] = l[a] * alpha + group_sum(sum);
      m[a] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[a][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int a = 0; a < 4; ++a) pv[a] = Ps[(4 * ty + a) * kRowPad + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[kk * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[a][j] = fmaf(pv[a], vv[j], acc[a][j]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + 4 * ty + a;
    T* orow = o + base + (size_t)row * rs;
#pragma unroll
    for (int j = 0; j < NJ; ++j) store_f32(orow + tx + 16 * j, acc[a][j] / l[a]);
    if (tx == 0) lse[(size_t)bh * L + row] = m[a] + logf(l[a]);
  }
}

// dQ = sum over key tiles of dS.K, with
// P = exp(S - LSE) and dS = P * (dO.V^T - delta) * scale. kStd: k is K, v
// is V, kt unused. kNN: kt is K^T and v is V^T; one row tile of K serves
// both of its products here, so it is loaded from K^T and k goes unused.
template <int D, typename T, int Form>
__global__ void __launch_bounds__(kThreads)
flash_dq_f32dot_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ kt, const T* __restrict__ v,
                       const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       int H, int L, float scale, int causal) {
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * (D + 1);
  float* Ks = dOs + kTile * (D + 1);
  float* Vs = Ks + kTile * (D + 1);
  float* dSs = Vs + kTile * (D + 1);  // [64][65]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kTile;
  const int rs = H * D;
  const size_t base = ((size_t)b * L * H + h) * D;
  const size_t tb = (size_t)bh * D * L;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<D>(Qs, q + base, q0, rs);
  load_tile<D>(dOs, dout + base, q0, rs);
  float row_lse[4], row_delta[4], acc[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    row_lse[a] = lse[(size_t)bh * L + q0 + 4 * ty + a];
    row_delta[a] = delta[(size_t)bh * L + q0 + 4 * ty + a];
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[a][j] = 0.f;
  }
  const int num_k = L / kTile;
  const int kmax = causal ? min((q0 + kTile + kTile - 1) / kTile, num_k)
                          : num_k;

  for (int kt_i = 0; kt_i < kmax; ++kt_i) {
    const int k0 = kt_i * kTile;
    __syncthreads();
    load_rows<D, Form != kStd>(Ks, Form == kStd ? k : kt, base, tb, k0, rs,
                               L);
    load_rows<D, Form != kStd>(Vs, v, base, tb, k0, rs, L);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    tile_dot_nt<D>(s, Qs, Ks, ty, tx);
    tile_dot_nt<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = q0 + 4 * ty + a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[a][c] * scale;
        if (causal && row < k0 + tx + 16 * c) x = kNegInf;
        const float p = expf(x - row_lse[a]);
        const float ds = p * (dp[a][c] - row_delta[a]) * scale;
        dSs[(4 * ty + a) * kRowPad + tx + 16 * c] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float dsv[4], kv[NJ];
#pragma unroll
      for (int a = 0; a < 4; ++a) dsv[a] = dSs[(4 * ty + a) * kRowPad + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = Ks[kk * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[a][j] = fmaf(dsv[a], kv[j], acc[a][j]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    T* row = dq + base + (size_t)(q0 + 4 * ty + a) * rs;
#pragma unroll
    for (int j = 0; j < NJ; ++j) store_f32(row + tx + 16 * j, acc[a][j]);
  }
}

// dK, dV: for one key tile, walk query tiles from the causal
// start: dV += P^T.dO and dK += dS^T.Q. The pointers are those of
// flash_dkv_mma_kernel: kStd reads q, k, v, dout; kNN k, v as K^T, V^T;
// kNN2 also Q^T, dO^T (qt, doutt; q and dout unused) and writes dK^T, dV^T.
template <int D, typename T, int Form>
__global__ void __launch_bounds__(kThreads)
flash_dkv_f32dot_kernel(const T* __restrict__ q, const T* __restrict__ qt,
                        const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ dout,
                        const T* __restrict__ doutt,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, int H, int L, float scale,
                        int causal) {
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * (D + 1);
  float* Qs = Vs + kTile * (D + 1);
  float* dOs = Qs + kTile * (D + 1);
  float* Ps = dOs + kTile * (D + 1);  // [64][65]
  float* dSs = Ps + kTile * kRowPad;  // [64][65]
  float* lse_s = dSs + kTile * kRowPad;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kTile;
  const int rs = H * D;
  const size_t base = ((size_t)b * L * H + h) * D;
  const size_t tb = (size_t)bh * D * L;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_rows<D, Form != kStd>(Ks, k, base, tb, k0, rs, L);
  load_rows<D, Form != kStd>(Vs, v, base, tb, k0, rs, L);
  float acc_k[4][NJ], acc_v[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[a][j] = acc_v[a][j] = 0.f;

  const int num_q = L / kTile;
  const int qstart = causal ? k0 / kTile : 0;
  for (int qt_i = qstart; qt_i < num_q; ++qt_i) {
    const int q0 = qt_i * kTile;
    __syncthreads();
    load_rows<D, Form == kNN2>(Qs, Form == kNN2 ? qt : q, base, tb, q0, rs,
                               L);
    load_rows<D, Form == kNN2>(dOs, Form == kNN2 ? doutt : dout, base, tb,
                               q0, rs, L);
    if (threadIdx.x < kTile) {
      lse_s[threadIdx.x] = lse[(size_t)bh * L + q0 + threadIdx.x];
      delta_s[threadIdx.x] = delta[(size_t)bh * L + q0 + threadIdx.x];
    }
    __syncthreads();

    // rows of this score tile are queries (4*ty + a), columns keys
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot_nt<D>(s, Qs, Ks, ty, tx);
    tile_dot_nt<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = 4 * ty + a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[a][c] * scale;
        if (causal && q0 + r < k0 + tx + 16 * c) x = kNegInf;
        const float p = expf(x - lse_s[r]);
        const float ds = p * (dp[a][c] - delta_s[r]) * scale;
        Ps[r * kRowPad + tx + 16 * c] = p;
        dSs[r * kRowPad + tx + 16 * c] = ds;
      }
    }
    __syncthreads();

    // this thread's output rows are keys 4*ty + a, columns tx + 16*j
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float pv[4], dsv[4], dov[NJ], qv[NJ];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pv[a] = Ps[r * kRowPad + 4 * ty + a];
        dsv[a] = dSs[r * kRowPad + 4 * ty + a];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        dov[j] = dOs[r * (D + 1) + tx + 16 * j];
        qv[j] = Qs[r * (D + 1) + tx + 16 * j];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc_v[a][j] = fmaf(pv[a], dov[j], acc_v[a][j]);
          acc_k[a][j] = fmaf(dsv[a], qv[j], acc_k[a][j]);
        }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + 4 * ty + a;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      const size_t off = Form == kNN2 ? tb + (size_t)d * L + key
                                      : base + (size_t)key * rs + d;
      store_f32(dk + off, acc_k[a][j]);
      store_f32(dv + off, acc_v[a][j]);
    }
  }
}

// ------------------------------------------------------------ mma path
// Every dot on the tensor cores: mma.sync m16n8k16, bf16 operands, f32
// accumulation. A block of 4 warps owns a 64-row tile of its output and
// each warp 16 of its rows. Tiles sit in shared memory as bf16 rows padded
// to D + 8 elements, so a fragment's 32-bit loads from 8 rows x 4 lanes
// hit 32 distinct banks; an operand read down a column (V for P.V, K for
// dS.K, Q and dO for the dK/dV products) is stored transposed, [D][64 + 8].
// A score tile's accumulator fragments, rounded to bf16 in pairs, are the
// A fragments of the next product (P.V, dS.K, P^T.dO, dS^T.Q) without a
// trip through shared memory. Numerics are those of the f32-dot kernels
// with P and dS rounded to bf16 where they enter a dot: only the order of
// the f32 sums inside a product differs.
//
// The Form parameter says which operands arrive transposed ([B, H, D, L])
// and so how each tile reaches its shared-memory layout:
//   kStd  rows of K and V, Q and dO: straight copies of the rows a tile
//         keeps as rows, transposed loads of those it keeps as columns.
//   kNN   K^T and V^T: the forward and dK/dV kernels transpose them into
//         row tiles as they load them; the dQ kernel copies K^T straight
//         into its column tile for dS.K and transposes V^T for dO.V^T.
//   kNN2  dK/dV only: also Q^T and dO^T, copied straight into the column
//         tiles, and dK^T and dV^T written out through shared memory.
// Every form feeds the tensor cores the same fragments in the same order,
// so nn and nn2 give bitwise the bf16 kernels' results.

constexpr int kMmaThreads = 128;
constexpr int kTRow = kTile + 8;  // row stride of a transposed [D][64] tile

// The A fragment of key (or query) columns 16*kk .. 16*kk+15 of a 16 x 64
// f32 accumulator tile acc[8][4], rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&acc)[8][4], int kk) {
  a[0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
  a[1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
  a[2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
  a[3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
}

// acc[n] (16 x 8 for n = 0..7, a 16 x 64 tile) += A rows r.. of `a_tile`
// times the transpose of rows 0..63 of `b_tile`, both row-major [64][D+8].
template <int D>
__device__ __forceinline__ void tile_dot_nt_mma(float (&acc)[8][4],
                                                const bf16* a_tile,
                                                const bf16* b_tile, int r,
                                                int g, int t) {
  constexpr int S = D + 8;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    load_a(a, a_tile, S, r, ks * 16, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const bf16* brow = b_tile + (n * 8 + g) * S + ks * 16 + 2 * t;
      mma_bf16(acc[n], a, ld32(brow), ld32(brow + 8));
    }
  }
}

// out[dn] (16 x D) += P (16 x 64, the accumulator tile p) times a 64 x D
// operand stored transposed, bt = [D][64 + 8].
template <int D>
__device__ __forceinline__ void tile_dot_acc_mma(float (&out)[D / 8][4],
                                                 const float (&p)[8][4],
                                                 const bf16* bt, int g,
                                                 int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    acc_to_a(a, p, kk);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const bf16* bcol = bt + (dn * 8 + g) * kTRow + kk * 16 + 2 * t;
      mma_bf16(out[dn], a, ld32(bcol), ld32(bcol + 8));
    }
  }
}

// 64 rows of one head of a [B, L, H, D] tensor (from `row0`, stride rs)
// into a [64][D + 8] tile; the same rows transposed into a [D][64 + 8]
// tile; 64 columns (from `col0`) of one head of a [B, H, D, L] tensor
// (head base tb) transposed into a [64][D + 8] tile, and copied straight
// into a [D][64 + 8] tile.
template <int D>
__device__ __forceinline__ void rows_to_rows(bf16* dst, const bf16* src,
                                             int row0, int rs) {
  copy_slab<kTile, D, kMmaThreads>(dst, D + 8, src + (size_t)row0 * rs, rs);
}
template <int D>
__device__ __forceinline__ void rows_to_cols(bf16* dst, const bf16* src,
                                             int row0, int rs) {
  load_transposed<kTile, D, kMmaThreads>(dst, kTRow,
                                         src + (size_t)row0 * rs, rs);
}
template <int D>
__device__ __forceinline__ void cols_to_rows(bf16* dst, const bf16* src,
                                             int col0, int L) {
  load_transposed<D, kTile, kMmaThreads>(dst, D + 8, src + col0, L);
}
template <int D>
__device__ __forceinline__ void cols_to_cols(bf16* dst, const bf16* src,
                                             int col0, int L) {
  copy_slab<D, kTile, kMmaThreads>(dst, kTRow, src + col0, L);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Accumulator element e of n-tile n sits at row g (e < 2) or g + 8, and at
// column 8*n + 2*t + (e & 1) of the 64-column tile.

// k is K [B, L, H, D] (kStd) or K^T [B, H, D, L] (kNN).
template <int D, int Form>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int H, int L, float scale,
                     int causal) {
  constexpr int S = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [64][S]
  bf16* Ks = Qs + kTile * S;                     // [64][S]
  bf16* Vt = Ks + kTile * S;                     // [D][kTRow]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kTile;
  const int rs = H * D;
  const size_t base = ((size_t)b * L * H + h) * D;
  const size_t tb = (size_t)bh * D * L;  // head base of a [B, H, D, L] tensor
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;

  rows_to_rows<D>(Qs, q + base, q0, rs);
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) load_a(qa[ks], Qs, S, r0, ks * 16, g, t);

  float acc[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int rows[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const int num_k = L / kTile;
  const int kmax = causal ? min((q0 + kTile + kTile - 1) / kTile, num_k)
                          : num_k;

  for (int kt = 0; kt < kmax; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    if constexpr (Form == kStd) rows_to_rows<D>(Ks, k + base, k0, rs);
    else cols_to_rows<D>(Ks, k + tb, k0, L);
    rows_to_cols<D>(Vt, v + base, k0, rs);
    __syncthreads();

    float s[8][4] = {};
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const bf16* krow = Ks + (n * 8 + g) * S + ks * 16 + 2 * t;
        mma_bf16(s[n], qa[ks], ld32(krow), ld32(krow + 8));
      }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (causal && rows[e >> 1] < k0 + n * 8 + 2 * t + (e & 1)) x = kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e >> 1]);
        sum[e >> 1] += p;
        s[n][e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(sum[i]);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] *= alpha[e >> 1];

    tile_dot_acc_mma<D>(acc, s, Vt, g, t);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bf16* orow = o + base + (size_t)rows[i] * rs + 2 * t;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(orow + dn * 8) =
          pack_bf16(acc[dn][2 * i] / l[i], acc[dn][2 * i + 1] / l[i]);
    if (t == 0) lse[(size_t)bh * L + rows[i]] = m[i] + logf(l[i]);
  }
}

// kStd: v is V [B, L, H, D] and kt is unused. kNN (_dq_kernel_nn): kt is
// K^T and v is V^T, both [B, H, D, L]; k stays [B, L, H, D], as there.
template <int D, int Form>
__global__ void __launch_bounds__(kMmaThreads)
flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ kt, const bf16* __restrict__ v,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int H, int L, float scale, int causal) {
  constexpr int S = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [64][S]
  bf16* dOs = Qs + kTile * S;                    // [64][S]
  bf16* Ks = dOs + kTile * S;                    // [64][S]
  bf16* Vs = Ks + kTile * S;                     // [64][S]
  bf16* Kt = Vs + kTile * S;                     // [D][kTRow]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kTile;
  const int rs = H * D;
  const size_t base = ((size_t)b * L * H + h) * D;
  const size_t tb = (size_t)bh * D * L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int rows[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  rows_to_rows<D>(Qs, q + base, q0, rs);
  rows_to_rows<D>(dOs, dout + base, q0, rs);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_lse[i] = lse[(size_t)bh * L + rows[i]];
    row_delta[i] = delta[(size_t)bh * L + rows[i]];
  }
  float acc[D / 8][4] = {};
  const int num_k = L / kTile;
  const int kmax = causal ? min((q0 + kTile + kTile - 1) / kTile, num_k)
                          : num_k;

  for (int kt_i = 0; kt_i < kmax; ++kt_i) {
    const int k0 = kt_i * kTile;
    __syncthreads();
    rows_to_rows<D>(Ks, k + base, k0, rs);
    if constexpr (Form == kStd) {
      rows_to_rows<D>(Vs, v + base, k0, rs);
      rows_to_cols<D>(Kt, k + base, k0, rs);
    } else {
      cols_to_rows<D>(Vs, v + tb, k0, L);
      cols_to_cols<D>(Kt, kt + tb, k0, L);
    }
    __syncthreads();

    float s[8][4] = {}, dp[8][4] = {};
    tile_dot_nt_mma<D>(s, Qs, Ks, r0, g, t);
    tile_dot_nt_mma<D>(dp, dOs, Vs, r0, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float x = s[n][e] * scale;
        if (causal && rows[i] < k0 + n * 8 + 2 * t + (e & 1)) x = kNegInf;
        const float p = expf(x - row_lse[i]);
        s[n][e] = p * (dp[n][e] - row_delta[i]) * scale;  // dS
      }
    tile_dot_acc_mma<D>(acc, s, Kt, g, t);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bf16* row = dq + base + (size_t)rows[i] * rs + 2 * t;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(row + dn * 8) =
          pack_bf16(acc[dn][2 * i], acc[dn][2 * i + 1]);
  }
}

// kStd: k, v are K, V and dk, dv are dK, dV, all [B, L, H, D]; qt and
// doutt are unused. kNN: k, v are K^T, V^T [B, H, D, L]. kNN2
// (_dkv_kernel_nn2): also qt, doutt = Q^T, dO^T, and dk, dv are dK^T, dV^T,
// all [B, H, D, L].
template <int D, int Form>
__global__ void __launch_bounds__(kMmaThreads)
flash_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ qt,
                     const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const bf16* __restrict__ doutt,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int L, float scale,
                     int causal) {
  constexpr int S = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [64][S]
  bf16* Vs = Ks + kTile * S;                     // [64][S]
  bf16* Qs = Vs + kTile * S;                     // [64][S]
  bf16* dOs = Qs + kTile * S;                    // [64][S]
  bf16* Qt = dOs + kTile * S;                    // [D][kTRow]
  bf16* dOt = Qt + D * kTRow;                    // [D][kTRow]
  float* lse_s = reinterpret_cast<float*>(dOt + D * kTRow);
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kTile;
  const int rs = H * D;
  const size_t base = ((size_t)b * L * H + h) * D;
  const size_t tb = (size_t)bh * D * L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  // this warp's key rows; the score tiles here are transposed, S^T[key][query]
  const int keys[2] = {k0 + r0 + g, k0 + r0 + g + 8};

  if constexpr (Form == kStd) {
    rows_to_rows<D>(Ks, k + base, k0, rs);
    rows_to_rows<D>(Vs, v + base, k0, rs);
  } else {
    cols_to_rows<D>(Ks, k + tb, k0, L);
    cols_to_rows<D>(Vs, v + tb, k0, L);
  }
  float acc_k[D / 8][4] = {}, acc_v[D / 8][4] = {};
  const int num_q = L / kTile;
  const int qstart = causal ? k0 / kTile : 0;

  for (int qt_i = qstart; qt_i < num_q; ++qt_i) {
    const int q0 = qt_i * kTile;
    __syncthreads();
    rows_to_rows<D>(Qs, q + base, q0, rs);
    rows_to_rows<D>(dOs, dout + base, q0, rs);
    if constexpr (Form == kNN2) {
      cols_to_cols<D>(Qt, qt + tb, q0, L);
      cols_to_cols<D>(dOt, doutt + tb, q0, L);
    } else {
      rows_to_cols<D>(Qt, q + base, q0, rs);
      rows_to_cols<D>(dOt, dout + base, q0, rs);
    }
    if (threadIdx.x < kTile) {
      lse_s[threadIdx.x] = lse[(size_t)bh * L + q0 + threadIdx.x];
      delta_s[threadIdx.x] = delta[(size_t)bh * L + q0 + threadIdx.x];
    }
    __syncthreads();

    float st[8][4] = {}, dpt[8][4] = {};
    tile_dot_nt_mma<D>(st, Ks, Qs, r0, g, t);
    tile_dot_nt_mma<D>(dpt, Vs, dOs, r0, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);  // query within the tile
        float x = st[n][e] * scale;
        if (causal && q0 + c < keys[e >> 1]) x = kNegInf;
        const float p = expf(x - lse_s[c]);
        dpt[n][e] = p * (dpt[n][e] - delta_s[c]) * scale;  // dS^T
        st[n][e] = p;                                        // P^T
      }
    tile_dot_acc_mma<D>(acc_v, st, dOt, g, t);
    tile_dot_acc_mma<D>(acc_k, dpt, Qt, g, t);
  }

  if constexpr (Form == kNN2) {
    // dK^T and dV^T: stage each [D][64] tile in shared memory (the Qt and
    // dOt tiles, free once every warp is past its last product), then
    // write whole 16-byte runs of keys. A warp's 2-byte stores hit banks
    // 8*t + g/2: no conflict.
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = r0 + g + 8 * i;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int d = dn * 8 + 2 * t + j;
          Qt[d * kTRow + key] = __float2bfloat16_rn(acc_k[dn][2 * i + j]);
          dOt[d * kTRow + key] = __float2bfloat16_rn(acc_v[dn][2 * i + j]);
        }
    }
    __syncthreads();
    copy_slab<D, kTile, kMmaThreads>(dk + tb + k0, L, Qt, kTRow);
    copy_slab<D, kTile, kMmaThreads>(dv + tb + k0, L, dOt, kTRow);
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const size_t off = base + (size_t)keys[i] * rs + 2 * t;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        *reinterpret_cast<uint32_t*>(dk + off + dn * 8) =
            pack_bf16(acc_k[dn][2 * i], acc_k[dn][2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + dn * 8) =
            pack_bf16(acc_v[dn][2 * i], acc_v[dn][2 * i + 1]);
      }
    }
  }
}

// ----------------------------------------------------------------- probe
// On the TPU the probe asked whether the server's Mosaic compiler accepted
// a 128 x 128 f32-out product of bf16 tiles in the NT, TN and NN forms, and
// with an f32 A transposed and cast to bf16 in the kernel. Here every form
// is compiled ahead of time (a form nvcc refused would fail the whole
// build), so the probe asks the card instead: one block per form runs the
// product through the flash kernels' mma.sync fragment path and writes it
// out; the host holds each against a product it knows exactly, which with
// the compute capability yields the caps {nt_bf16, nn_bf16, transpose_f32}
// that the "auto" strategy is picked from (ops/flash_attention.py).
// Bound: 384 KB moved and 1.7e7 flops, about 0.1 us on an H100; it runs
// once per process and card.

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
constexpr size_t tile_bytes(int d) { return sizeof(float) * kTile * (d + 1); }
constexpr size_t score_bytes() { return sizeof(float) * kTile * kRowPad; }

// One block per (head, 64-row output tile).
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int threads, size_t smem, int B, int H,
                   int L, cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * H, L / kTile), threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int D, typename T, int Form = kStd>
cudaError_t fwd_f32dot(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int L, float scale,
                       int causal, cudaStream_t st) {
  return launch(flash_fwd_f32dot_kernel<D, T, Form>, kThreads,
                3 * tile_bytes(D) + score_bytes(), B, H, L, st,
                (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse,
                H, L, scale, causal);
}

template <int D, typename T, int Form = kStd>
cudaError_t dq_f32dot(const void* q, const void* k, const void* kt,
                      const void* v, const void* dout, const void* lse,
                      const void* delta, void* dq, int B, int H, int L,
                      float scale, int causal, cudaStream_t st) {
  return launch(flash_dq_f32dot_kernel<D, T, Form>, kThreads,
                4 * tile_bytes(D) + score_bytes(), B, H, L, st,
                (const T*)q, (const T*)k, (const T*)kt, (const T*)v,
                (const T*)dout, (const float*)lse, (const float*)delta,
                (T*)dq, H, L, scale, causal);
}

template <int D, typename T, int Form = kStd>
cudaError_t dkv_f32dot(const void* q, const void* qt, const void* k,
                       const void* v, const void* dout, const void* doutt,
                       const void* lse, const void* delta, void* dk,
                       void* dv, int B, int H, int L, float scale,
                       int causal, cudaStream_t st) {
  return launch(flash_dkv_f32dot_kernel<D, T, Form>, kThreads,
                4 * tile_bytes(D) + 2 * score_bytes() +
                    2 * sizeof(float) * kTile,
                B, H, L, st, (const T*)q, (const T*)qt, (const T*)k,
                (const T*)v, (const T*)dout, (const T*)doutt,
                (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, H,
                L, scale, causal);
}

template <int D, int Form>
cudaError_t fwd_mma(const void* q, const void* k, const void* v, void* o,
                    void* lse, int B, int H, int L, float scale, int causal,
                    cudaStream_t st) {
  return launch(flash_fwd_mma_kernel<D, Form>, kMmaThreads,
                sizeof(bf16) * (2 * kTile * (D + 8) + D * kTRow), B, H, L,
                st, (const bf16*)q, (const bf16*)k, (const bf16*)v,
                (bf16*)o, (float*)lse, H, L, scale, causal);
}

template <int D, int Form>
cudaError_t dq_mma(const void* q, const void* k, const void* kt,
                   const void* v, const void* dout, const void* lse,
                   const void* delta, void* dq, int B, int H, int L,
                   float scale, int causal, cudaStream_t st) {
  return launch(flash_dq_mma_kernel<D, Form>, kMmaThreads,
                sizeof(bf16) * (4 * kTile * (D + 8) + D * kTRow), B, H, L,
                st, (const bf16*)q, (const bf16*)k, (const bf16*)kt,
                (const bf16*)v, (const bf16*)dout, (const float*)lse,
                (const float*)delta, (bf16*)dq, H, L, scale, causal);
}

template <int D, int Form>
cudaError_t dkv_mma(const void* q, const void* qt, const void* k,
                    const void* v, const void* dout, const void* doutt,
                    const void* lse, const void* delta, void* dk, void* dv,
                    int B, int H, int L, float scale, int causal,
                    cudaStream_t st) {
  return launch(flash_dkv_mma_kernel<D, Form>, kMmaThreads,
                sizeof(bf16) * (4 * kTile * (D + 8) + 2 * D * kTRow) +
                    2 * sizeof(float) * kTile,
                B, H, L, st, (const bf16*)q, (const bf16*)qt,
                (const bf16*)k, (const bf16*)v, (const bf16*)dout,
                (const bf16*)doutt, (const float*)lse, (const float*)delta,
                (bf16*)dk, (bf16*)dv, H, L, scale, causal);
}

bool shape_ok(int B, int H, int L, int D) {
  return B > 0 && H > 0 && L > 0 && L % kTile == 0 && L / kTile <= 65535 &&
         (D == 64 || D == 128);
}

constexpr int kBad = (int)cudaErrorInvalidValue;

}  // namespace

// C interface, bound with ctypes. dtype: 0 = float32, 1 = bfloat16: the
// mma kernels on bf16, the f32-dot kernels on f32 storage (where the
// storage-dtype dots are f32 dots), in the Form of the entry point. Every
// launcher returns the cudaError_t of its launch (0 on success).
extern "C" {

// Strategy bf16.
int paddle_flash_fwd(const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int H, int L, int D, int dtype,
                     int causal, float scale, void* stream) {
  if (!shape_ok(B, H, L, D)) return kBad;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return D == 64
        ? fwd_mma<64, kStd>(q, k, v, o, lse, B, H, L, scale, causal, st)
        : fwd_mma<128, kStd>(q, k, v, o, lse, B, H, L, scale, causal, st);
  return D == 64
      ? fwd_f32dot<64, float>(q, k, v, o, lse, B, H, L, scale, causal, st)
      : fwd_f32dot<128, float>(q, k, v, o, lse, B, H, L, scale, causal, st);
}

int paddle_flash_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int B, int H, int L, int D, int dtype,
                    int causal, float scale, void* stream) {
  if (!shape_ok(B, H, L, D)) return kBad;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return D == 64
        ? dq_mma<64, kStd>(q, k, nullptr, v, dout, lse, delta, dq, B, H, L, scale, causal, st)
        : dq_mma<128, kStd>(q, k, nullptr, v, dout, lse, delta, dq, B, H, L, scale, causal, st);
  return D == 64
      ? dq_f32dot<64, float>(q, k, nullptr, v, dout, lse, delta, dq, B, H, L, scale, causal, st)
      : dq_f32dot<128, float>(q, k, nullptr, v, dout, lse, delta, dq, B, H, L, scale, causal, st);
}

int paddle_flash_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int B, int H, int L, int D,
                     int dtype, int causal, float scale, void* stream) {
  if (!shape_ok(B, H, L, D)) return kBad;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return D == 64
        ? dkv_mma<64, kStd>(q, nullptr, k, v, dout, nullptr, lse, delta, dk, dv, B, H, L, scale, causal, st)
        : dkv_mma<128, kStd>(q, nullptr, k, v, dout, nullptr, lse, delta, dk, dv, B, H, L, scale, causal, st);
  return D == 64
      ? dkv_f32dot<64, float>(q, nullptr, k, v, dout, nullptr, lse, delta, dk, dv, B, H, L, scale, causal, st)
      : dkv_f32dot<128, float>(q, nullptr, k, v, dout, nullptr, lse, delta, dk, dv, B, H, L, scale, causal, st);
}

// Strategies nn and nn2.
int paddle_flash_fwd_nn(const void* q, const void* kt, const void* v,
                        void* o, void* lse, int B, int H, int L, int D,
                        int dtype, int causal, float scale, void* stream) {
  if (!shape_ok(B, H, L, D)) return kBad;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return D == 64
        ? fwd_mma<64, kNN>(q, kt, v, o, lse, B, H, L, scale, causal, st)
        : fwd_mma<128, kNN>(q, kt, v, o, lse, B, H, L, scale, causal, st);
  return D == 64
      ? fwd_f32dot<64, float, kNN>(q, kt, v, o, lse, B, H, L, scale, causal, st)
      : fwd_f32dot<128, float, kNN>(q, kt, v, o, lse, B, H, L, scale, causal, st);
}

int paddle_flash_dq_nn(const void* q, const void* k, const void* kt,
                       const void* vt, const void* dout, const void* lse,
                       const void* delta, void* dq, int B, int H, int L,
                       int D, int dtype, int causal, float scale,
                       void* stream) {
  if (!shape_ok(B, H, L, D)) return kBad;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return D == 64
        ? dq_mma<64, kNN>(q, k, kt, vt, dout, lse, delta, dq, B, H, L, scale, causal, st)
        : dq_mma<128, kNN>(q, k, kt, vt, dout, lse, delta, dq, B, H, L, scale, causal, st);
  return D == 64
      ? dq_f32dot<64, float, kNN>(q, k, kt, vt, dout, lse, delta, dq, B, H, L, scale, causal, st)
      : dq_f32dot<128, float, kNN>(q, k, kt, vt, dout, lse, delta, dq, B, H, L, scale, causal, st);
}

int paddle_flash_dkv_nn(const void* q, const void* kt, const void* vt,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int B, int H, int L, int D,
                        int dtype, int causal, float scale, void* stream) {
  if (!shape_ok(B, H, L, D)) return kBad;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return D == 64
        ? dkv_mma<64, kNN>(q, nullptr, kt, vt, dout, nullptr, lse, delta, dk, dv, B, H, L, scale, causal, st)
        : dkv_mma<128, kNN>(q, nullptr, kt, vt, dout, nullptr, lse, delta, dk, dv, B, H, L, scale, causal, st);
  return D == 64
      ? dkv_f32dot<64, float, kNN>(q, nullptr, kt, vt, dout, nullptr, lse, delta, dk, dv, B, H, L, scale, causal, st)
      : dkv_f32dot<128, float, kNN>(q, nullptr, kt, vt, dout, nullptr, lse, delta, dk, dv, B, H, L, scale, causal, st);
}

int paddle_flash_dkv_nn2(const void* q, const void* qt, const void* kt,
                         const void* vt, const void* dout, const void* doutt,
                         const void* lse, const void* delta, void* dkt,
                         void* dvt, int B, int H, int L, int D, int dtype,
                         int causal, float scale, void* stream) {
  if (!shape_ok(B, H, L, D)) return kBad;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return D == 64
        ? dkv_mma<64, kNN2>(q, qt, kt, vt, dout, doutt, lse, delta, dkt, dvt, B, H, L, scale, causal, st)
        : dkv_mma<128, kNN2>(q, qt, kt, vt, dout, doutt, lse, delta, dkt, dvt, B, H, L, scale, causal, st);
  return D == 64
      ? dkv_f32dot<64, float, kNN2>(q, qt, kt, vt, dout, doutt, lse, delta, dkt, dvt, B, H, L, scale, causal, st)
      : dkv_f32dot<128, float, kNN2>(q, qt, kt, vt, dout, doutt, lse, delta, dkt, dvt, B, H, L, scale, causal, st);
}

// Strategy f32: every dot in f32 on the storage dtype, f32 or bf16.
int paddle_flash_fwd_f32dot(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int H, int L, int D,
                            int dtype, int causal, float scale,
                            void* stream) {
  if (!shape_ok(B, H, L, D)) return kBad;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return D == 64
        ? fwd_f32dot<64, bf16>(q, k, v, o, lse, B, H, L, scale, causal, st)
        : fwd_f32dot<128, bf16>(q, k, v, o, lse, B, H, L, scale, causal, st);
  return D == 64
      ? fwd_f32dot<64, float>(q, k, v, o, lse, B, H, L, scale, causal, st)
      : fwd_f32dot<128, float>(q, k, v, o, lse, B, H, L, scale, causal, st);
}

int paddle_flash_dq_f32dot(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int B, int H, int L,
                           int D, int dtype, int causal, float scale,
                           void* stream) {
  if (!shape_ok(B, H, L, D)) return kBad;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return D == 64
        ? dq_f32dot<64, bf16>(q, k, nullptr, v, dout, lse, delta, dq, B, H, L, scale, causal, st)
        : dq_f32dot<128, bf16>(q, k, nullptr, v, dout, lse, delta, dq, B, H, L, scale, causal, st);
  return D == 64
      ? dq_f32dot<64, float>(q, k, nullptr, v, dout, lse, delta, dq, B, H, L, scale, causal, st)
      : dq_f32dot<128, float>(q, k, nullptr, v, dout, lse, delta, dq, B, H, L, scale, causal, st);
}

int paddle_flash_dkv_f32dot(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int B,
                            int H, int L, int D, int dtype, int causal,
                            float scale, void* stream) {
  if (!shape_ok(B, H, L, D)) return kBad;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return D == 64
        ? dkv_f32dot<64, bf16>(q, nullptr, k, v, dout, nullptr, lse, delta, dk, dv, B, H, L, scale, causal, st)
        : dkv_f32dot<128, bf16>(q, nullptr, k, v, dout, nullptr, lse, delta, dk, dv, B, H, L, scale, causal, st);
  return D == 64
      ? dkv_f32dot<64, float>(q, nullptr, k, v, dout, nullptr, lse, delta, dk, dv, B, H, L, scale, causal, st)
      : dkv_f32dot<128, float>(q, nullptr, k, v, dout, nullptr, lse, delta, dk, dv, B, H, L, scale, causal, st);
}

// The dot-form probe. a, b: [128, 128] bf16; a32: [128, 128] f32; out:
// [4, 128, 128] f32.
int paddle_flash_probe(const void* a, const void* a32, const void* b,
                       void* out, void* stream) {
  const size_t smem = sizeof(bf16) * 2 * kProbeN * kProbeS;
  cudaError_t err = allow_smem(flash_probe_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  flash_probe_kernel<<<4, kProbeThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)a, (const float*)a32, (const bf16*)b, (float*)out);
  return (int)cudaGetLastError();
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
