// Flash attention forward and backward for Hopper (sm_90a), written by hand.
//
// Counterparts of the Pallas TPU kernels in
// paddle_tpu/ops/pallas/flash_attention.py, each in a bf16 and an f32 form:
//   flash_fwd_{bf16,f32}_kernel  <- _fwd_kernel  (O and the row logsumexp)
//   flash_dq_{bf16,f32}_kernel   <- _dq_kernel   (dQ)
//   flash_dkv_{bf16,f32}_kernel  <- _dkv_kernel  (dK and dV)
// Each computes what its TPU counterpart computes, with the same numerics:
// dots accumulate in f32, sm_scale is applied in f32 after the Q.K dot,
// masked scores are -1e30 (not -inf), P is rounded to the input dtype
// before P.V, and P and dS are rounded to the input dtype only where they
// enter a dot. delta = rowsum(dO * O) comes from the caller, in f32.
//
// Layout: q, k, v, o, dO, dQ, dK, dV are [B, L, H, D] contiguous (the
// public layout, read through strides, so no transpose is needed); LSE and
// delta are [B, H, L] f32. D is 64 or 128; L a multiple of 64.
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
// causal, bf16) each kernel reads and writes 67-101 MB and does 1.7e10 to
// 3.4e10 flops, so on the tensor cores bytes and flops bound it about
// equally, at 20-35 us. The bf16 kernels (the training path) put every dot
// on the tensor cores with mma.sync and read each tile from device memory
// once per block, reusing it 64 times from shared memory; what still keeps
// them from the bound is latency (no copy/compute overlap, a barrier per
// tile, scalar transposes into shared memory), which cp.async or TMA
// pipelining and wgmma are for. The f32 kernels run on the CUDA cores
// (67 TFLOP/s; tensor cores have no full-f32 product), operations-bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // rows of a query tile and of a key tile
constexpr float kNegInf = -1e30f;

// ------------------------------------------------------------ f32 path
// Scalar f32 FMAs. Tiles sit in shared memory as f32 rows padded to D + 1
// floats, so the column walks below hit 32 distinct banks. A block of 256
// threads: thread (ty, tx) = (tid / 16, tid % 16) owns rows 4*ty .. 4*ty+3
// of every 64 x 64 score tile and of its output tile, at columns tx + 16*j.
// The 16 threads of a row group are one half-warp, so row maxima and sums
// reduce with four xor-shuffles.

constexpr int kThreads = 256;
constexpr int kRowPad = kTile + 1;

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
// [64][D + 1] tile in shared memory.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int rs) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = src[(size_t)(row0 + r) * rs + c];
  }
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

// Forward: streaming softmax over key tiles 0 .. kmax-1.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
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

  for (int kt = 0; kt < kmax; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers of Ks, Vs, Ps are done
    load_tile<D>(Ks, k + base, k0, rs);
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
    float* orow = o + base + (size_t)row * rs;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = acc[a][j] / l[a];
    if (tx == 0) lse[(size_t)bh * L + row] = m[a] + logf(l[a]);
  }
}

// dQ = sum over key tiles of dS.K, with
// P = exp(S - LSE) and dS = P * (dO.V^T - delta) * scale.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_f32_kernel(const float* __restrict__ q,
                    const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
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

  for (int kt = 0; kt < kmax; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<D>(Ks, k + base, k0, rs);
    load_tile<D>(Vs, v + base, k0, rs);
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
    float* row = dq + base + (size_t)(q0 + 4 * ty + a) * rs;
#pragma unroll
    for (int j = 0; j < NJ; ++j) row[tx + 16 * j] = acc[a][j];
  }
}

// dK, dV: for one key tile, walk query tiles from the causal
// start: dV += P^T.dO and dK += dS^T.Q.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_f32_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int L, float scale,
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
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<D>(Ks, k + base, k0, rs);
  load_tile<D>(Vs, v + base, k0, rs);
  float acc_k[4][NJ], acc_v[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[a][j] = acc_v[a][j] = 0.f;

  const int num_q = L / kTile;
  const int qstart = causal ? k0 / kTile : 0;
  for (int qt = qstart; qt < num_q; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<D>(Qs, q + base, q0, rs);
    load_tile<D>(dOs, dout + base, q0, rs);
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
    const size_t off = base + (size_t)(k0 + 4 * ty + a) * rs;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[off + tx + 16 * j] = acc_k[a][j];
      dv[off + tx + 16 * j] = acc_v[a][j];
    }
  }
}

// ----------------------------------------------------------- bf16 path
// Every dot on the tensor cores: mma.sync m16n8k16, bf16 operands, f32 accumulation. A block of
// 4 warps owns a 64-row tile of its output and each warp 16 of its rows.
// Tiles sit in shared memory as bf16 rows padded to D + 8 elements, so a
// fragment's 32-bit loads from 8 rows x 4 lanes hit 32 distinct banks;
// an operand read down a column (V for P.V, K for dS.K, Q and dO for the
// dK/dV products) is also stored transposed, [D][64 + 8]. A score tile's
// accumulator fragments, rounded to bf16 in pairs, are the A fragments of
// the next product (P.V, dS.K, P^T.dO, dS^T.Q) without a trip through
// shared memory. Numerics are those of the scalar kernels: only the order
// of the f32 sums inside a product differs.

constexpr int kMmaThreads = 128;
constexpr int kTRow = kTile + 8;   // row stride of a transposed [D][64] tile

typedef __nv_bfloat16 bf16;

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

// Rows row0 .. row0+63 of one head into a [64][D + 8] tile, 16 B a load.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int rs) {
  constexpr int V = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < kTile * V; i += kMmaThreads) {
    const int r = i / V, c = (i % V) * 8;
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * rs + c);
  }
}

// The same rows stored transposed into a [D][64 + 8] tile.
template <int D>
__device__ __forceinline__ void load_cols(bf16* dst, const bf16* src,
                                          int row0, int rs) {
  constexpr int V = D / 8;
  for (int i = threadIdx.x; i < kTile * V; i += kMmaThreads) {
    const int r = i / V, c = (i % V) * 8;
    const uint4 vec =
        *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * rs + c);
    const bf16* e = reinterpret_cast<const bf16*>(&vec);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * kTRow + r] = e[j];
  }
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

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q,
                      const bf16* __restrict__ k,
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
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;

  load_rows<D>(Qs, q + base, q0, rs);
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
    load_rows<D>(Ks, k + base, k0, rs);
    load_cols<D>(Vt, v + base, k0, rs);
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

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dq_bf16_kernel(const bf16* __restrict__ q,
                     const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
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
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int rows[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  load_rows<D>(Qs, q + base, q0, rs);
  load_rows<D>(dOs, dout + base, q0, rs);
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

  for (int kt = 0; kt < kmax; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_rows<D>(Ks, k + base, k0, rs);
    load_rows<D>(Vs, v + base, k0, rs);
    load_cols<D>(Kt, k + base, k0, rs);
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

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dkv_bf16_kernel(const bf16* __restrict__ q,
                      const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
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
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  // this warp's key rows; the score tiles here are transposed, S^T[key][query]
  const int keys[2] = {k0 + r0 + g, k0 + r0 + g + 8};

  load_rows<D>(Ks, k + base, k0, rs);
  load_rows<D>(Vs, v + base, k0, rs);
  float acc_k[D / 8][4] = {}, acc_v[D / 8][4] = {};
  const int num_q = L / kTile;
  const int qstart = causal ? k0 / kTile : 0;

  for (int qt = qstart; qt < num_q; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_rows<D>(Qs, q + base, q0, rs);
    load_rows<D>(dOs, dout + base, q0, rs);
    load_cols<D>(Qt, q + base, q0, rs);
    load_cols<D>(dOt, dout + base, q0, rs);
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

// ---------------------------------------------------------------- launch
constexpr size_t tile_bytes(int d) { return sizeof(float) * kTile * (d + 1); }
constexpr size_t score_bytes() { return sizeof(float) * kTile * kRowPad; }

// Shared memory above 48 KB has to be allowed per kernel before launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
cudaError_t fwd_f32(const void* q, const void* k, const void* v, void* o,
                    void* lse, int B, int H, int L, float scale, int causal,
                    cudaStream_t stream) {
  const size_t smem = 3 * tile_bytes(D) + score_bytes();
  cudaError_t err = allow_smem(flash_fwd_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, L / kTile);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      (float*)lse, H, L, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dq_f32(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq_, int B, int H, int L, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = 4 * tile_bytes(D) + score_bytes();
  cudaError_t err = allow_smem(flash_dq_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, L / kTile);
  flash_dq_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dq_, H, L, scale,
      causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_f32(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int B, int H, int L, float scale,
                    int causal, cudaStream_t stream) {
  const size_t smem =
      4 * tile_bytes(D) + 2 * score_bytes() + 2 * sizeof(float) * kTile;
  cudaError_t err = allow_smem(flash_dkv_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, L / kTile);
  flash_dkv_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, H, L,
      scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int H, int L, float scale, int causal,
                     cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (2 * kTile * (D + 8) + D * kTRow);
  cudaError_t err = allow_smem(flash_fwd_bf16_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, L / kTile);
  flash_fwd_bf16_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      H, L, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dq_bf16(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq_, int B, int H, int L, float scale, int causal,
                    cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (4 * kTile * (D + 8) + D * kTRow);
  cudaError_t err = allow_smem(flash_dq_bf16_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, L / kTile);
  flash_dq_bf16_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq_, H, L, scale,
      causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_bf16(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int B, int H, int L, float scale,
                     int causal, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (4 * kTile * (D + 8) + 2 * D * kTRow) +
                      2 * sizeof(float) * kTile;
  cudaError_t err = allow_smem(flash_dkv_bf16_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, L / kTile);
  flash_dkv_bf16_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, H, L,
      scale, causal);
  return cudaGetLastError();
}

bool shape_ok(int B, int H, int L, int D) {
  return B > 0 && H > 0 && L > 0 && L % kTile == 0 && L / kTile <= 65535 &&
         (D == 64 || D == 128);
}

}  // namespace

// C interface, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Every launcher returns the cudaError_t of its launch (0 on success).
extern "C" {

int paddle_flash_fwd(const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int H, int L, int D, int dtype,
                     int causal, float scale, void* stream) {
  if (!shape_ok(B, H, L, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return D == 64 ? fwd_bf16<64>(q, k, v, o, lse, B, H, L, scale, causal, st)
                   : fwd_bf16<128>(q, k, v, o, lse, B, H, L, scale, causal, st);
  return D == 64 ? fwd_f32<64>(q, k, v, o, lse, B, H, L, scale, causal, st)
                 : fwd_f32<128>(q, k, v, o, lse, B, H, L, scale, causal, st);
}

int paddle_flash_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq_, int B, int H, int L, int D, int dtype,
                    int causal, float scale, void* stream) {
  if (!shape_ok(B, H, L, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return D == 64 ? dq_bf16<64>(q, k, v, dout, lse, delta, dq_, B, H, L, scale, causal, st)
                   : dq_bf16<128>(q, k, v, dout, lse, delta, dq_, B, H, L, scale, causal, st);
  return D == 64 ? dq_f32<64>(q, k, v, dout, lse, delta, dq_, B, H, L, scale, causal, st)
                 : dq_f32<128>(q, k, v, dout, lse, delta, dq_, B, H, L, scale, causal, st);
}

int paddle_flash_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int B, int H, int L, int D,
                     int dtype, int causal, float scale, void* stream) {
  if (!shape_ok(B, H, L, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return D == 64 ? dkv_bf16<64>(q, k, v, dout, lse, delta, dk, dv, B, H, L, scale, causal, st)
                   : dkv_bf16<128>(q, k, v, dout, lse, delta, dk, dv, B, H, L, scale, causal, st);
  return D == 64 ? dkv_f32<64>(q, k, v, dout, lse, delta, dk, dv, B, H, L, scale, causal, st)
                 : dkv_f32<128>(q, k, v, dout, lse, delta, dk, dv, B, H, L, scale, causal, st);
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
