// Tiled matrix product for Hopper (sm_90a):
//   C (M, N) = A (M, K) . B (K, N), every sum in f32, C written in bf16 or
//   f32 (the wrapper's out_dtype, default A's dtype).
// A is row-major with row stride lda (A(m, k) = a[m * lda + k]); B takes any
// two strides, B(k, n) = b[k * sbk + n * sbn], so a transposed view such as
// R^T of a row-major R (K-major: sbk = 1) is read in place, never copied.
// A and B share one dtype, bf16 or f32.
//
// Replaces repro/kernels/matmul_tiled.py::_matmul_kernel (reached through
// ops.matmul and the two-launch ops.lowrank_matmul_unfused). Same contract
// as the plain version repro_torch/kernels/ref.py::matmul_ref: products and
// sums in f32, one rounding to the output dtype. The TPU kernel pads ragged
// shapes with zeros to its 128 blocks and walks the contraction as a
// sequential grid axis that revisits one f32 VMEM accumulator; here the
// ragged edges are masked in the kernel (zeros in shared memory, the same
// sums), nothing is padded or copied, and the sequential k axis is a loop
// inside the block: each block owns one output tile and loops over all of
// K in a fixed order, with no atomics and no split, so two runs give the
// same bits.
//
// What bounds it on an H100: at the factored sites' shapes the second
// product of the two-launch pair (h . L^T, K = 128 or 256) and every
// product at decode M are bound by BYTES; the first product at large M
// (2048 x 896 x 256) by the tensor cores' OPERATIONS.
//
// bf16: mma.sync m16n8k16 bf16 with f32 accumulators, 8 warps (2 x 4) a
// block, from a shared-memory tile of depth 32 whose rows are padded by 8
// bf16 so fragment reads are free of bank conflicts. 128 x 128 output
// tiles where they fill the card's 132 SMs, else 64 x 64 (a 2048 x 4864 x
// 256 product has 32 tiles of 128 and 128 of 64). Each thread moves 8 bf16
// per load, one 16-byte load where the operand's contiguous dimension is
// aligned (A's rows; B's k for a K-major view such as R^T, or its n for a
// row-major B), else 8 masked element loads; the next k-step's tiles are
// loaded into registers while the tensor cores work on the current one.
// f32: plain FMAs on 64 x 64 tiles, 4 x 4 outputs a thread (no TF32: the
// f32 parity tier), the design of gemm_f32.cuh with B's two strides.
//
// The tensor-core route (entry point matmul_bf16_tc; kernels/
// matmul_tiled.py::matmul_route): bf16 operands whose rows the 16-byte
// copies can read (K and N multiples of 8, 16-byte bases, A with unit
// stride along K, B row-major or a K-major view such as R^T with row
// strides in multiples of 8) take the product of gemm_bf16.cuh with one
// piece: mma.sync from a cp.async ring, ldmatrix.trans for a row-major B,
// 128- or 64-wide tiles and a split of K into fixed-order ranges chosen by
// kernels/lowrank.py::gemm_plan, so a few-tile shape (M = 4, or h L^T at
// K = 128-256) still fills the card. bf16 products are exact in the f32
// accumulators, so the sums differ from the plain version only in order;
// the epilogue writes the output dtype. A qwen2-0.5b training layer's 7
// two-launch pairs (M = 2048) take 0.21 ms on an H100 this way, 2.2x the
// library, against 0.44 ms on the tiled bf16 kernel below (chip_smoke.py
// phase 11). Everything else (f32, other strides) takes the kernels below,
// unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_bf16.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint16_t* p, float v) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int BK = 32;
constexpr int KS = BK + 8;  // shared-memory row stride, in bf16

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_smem_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint16_t lane16(const uint4& v, int q) {
  const uint32_t w = q < 2 ? v.x : q < 4 ? v.y : q < 6 ? v.z : v.w;
  return static_cast<uint16_t>(w >> (16 * (q & 1)));
}

__device__ __forceinline__ uint4 pack8(const uint16_t (&e)[8]) {
  return make_uint4(e[0] | (uint32_t(e[1]) << 16), e[2] | (uint32_t(e[3]) << 16),
                    e[4] | (uint32_t(e[5]) << 16), e[6] | (uint32_t(e[7]) << 16));
}

// One operand as a (rows x K) matrix staged k-contiguous in shared memory,
// S[row][k]: A's rows are m, B's are n. Element (row, k) sits at
// p[row * s_row + k * s_k]. A thread moves 8 bf16 at a time:
//   kmap: 8 consecutive k of one row; with vec, one 16-byte load (s_k = 1,
//         s_row % 8 = 0, p 16-byte aligned), and one 16-byte store;
//   else: 8 consecutive rows at one k; with vec, one 16-byte load (s_row =
//         1, s_k % 8 = 0, p aligned), and 8 two-byte stores.
// Without vec, or at a ragged edge, the same 8 elements come one by one,
// masked to zero outside the matrix.
struct Operand {
  const uint16_t* p;
  long long s_row, s_k;
  int rows;
  int kmap, vec;
};

template <int ROWS>
struct Staged {
  static constexpr int N = ROWS * BK / 8 / THREADS;  // 8-element groups
  uint4 v[N];

  __device__ __forceinline__ void load(const Operand& o, int r0, int k0,
                                       int K, int tid) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int e = tid + j * THREADS;
      int row, k, dr, dk;
      if (o.kmap) {
        row = e / (BK / 8);
        k = (e % (BK / 8)) * 8;
        dr = 0;
        dk = 1;
      } else {
        k = e / (ROWS / 8);
        row = (e % (ROWS / 8)) * 8;
        dr = 1;
        dk = 0;
      }
      const int gr = r0 + row, gk = k0 + k;
      const bool full = o.kmap ? (gr < o.rows && gk + 8 <= K)
                               : (gk < K && gr + 8 <= o.rows);
      if (o.vec && full) {
        v[j] = *reinterpret_cast<const uint4*>(o.p + gr * o.s_row +
                                               gk * o.s_k);
      } else {
        uint16_t el[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int r = gr + q * dr, kk = gk + q * dk;
          el[q] = (r < o.rows && kk < K) ? o.p[r * o.s_row + kk * o.s_k]
                                         : uint16_t(0);
        }
        v[j] = pack8(el);
      }
    }
  }

  __device__ __forceinline__ void store(uint16_t (*S)[KS], int kmap,
                                        int tid) const {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int e = tid + j * THREADS;
      if (kmap) {
        *reinterpret_cast<uint4*>(&S[e / (BK / 8)][(e % (BK / 8)) * 8]) =
            v[j];
      } else {
        const int k = e / (ROWS / 8), row = (e % (ROWS / 8)) * 8;
#pragma unroll
        for (int q = 0; q < 8; ++q) S[row + q][k] = lane16(v[j], q);
      }
    }
  }
};

// grid (ceil(N / TN), ceil(M / TM)). Warps 2 (m) x 4 (n); warp w computes
// rows (w / 4) * TM/2 .. + TM/2 and columns (w % 4) * TN/4 .. + TN/4 of the
// block's tile: (TM/32) x (TN/32) mma tiles. The next k-step's tiles are
// loaded into registers while the tensor cores work on the current one.
template <int TM, int TN, typename TC>
__global__ void __launch_bounds__(THREADS)
    matmul_bf16(Operand A, Operand B, TC* __restrict__ c, int M, int N,
                int K, long long ldc) {
  constexpr int MT = TM / 32, NT = TN / 32;
  __shared__ __align__(16) uint16_t As[TM][KS];   // (m, k)
  __shared__ __align__(16) uint16_t Bs[TN][KS];   // (n, k): the mma's col B
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * (TM / 2), wn = (warp & 3) * (TN / 4);
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  Staged<TM> sa;
  Staged<TN> sb;
  if (K > 0) {
    sa.load(A, m0, 0, K, tid);
    sb.load(B, n0, 0, K, tid);
  }
  for (int k0 = 0; k0 < K; k0 += BK) {
    sa.store(As, A.kmap, tid);
    sb.store(Bs, B.kmap, tid);
    __syncthreads();
    if (k0 + BK < K) {
      sa.load(A, m0, k0 + BK, K, tid);
      sb.load(B, n0, k0 + BK, K, tid);
    }
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = wm + mt * 16 + g;
        af[mt][0] = ld_smem_pair(&As[r][ks + 2 * t]);
        af[mt][1] = ld_smem_pair(&As[r + 8][ks + 2 * t]);
        af[mt][2] = ld_smem_pair(&As[r][ks + 8 + 2 * t]);
        af[mt][3] = ld_smem_pair(&As[r + 8][ks + 8 + 2 * t]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = wn + nt * 8 + g;
        const uint32_t b0 = ld_smem_pair(&Bs[n][ks + 2 * t]);
        const uint32_t b1 = ld_smem_pair(&Bs[n][ks + 8 + 2 * t]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + wm + mt * 16 + g + 8 * h;
        const int gn = n0 + wn + nt * 8 + 2 * t;
        if (gm >= M) continue;
        if (gn < N) store(c + gm * ldc + gn, acc[mt][nt][2 * h]);
        if (gn + 1 < N) store(c + gm * ldc + gn + 1, acc[mt][nt][2 * h + 1]);
      }
}

// ---------------------------------------------------------------------------
// f32: plain FMAs
// ---------------------------------------------------------------------------

constexpr int FM = 64, FN = 64, FK = 16;

// grid (ceil(N / FN), ceil(M / FM)); thread (ty, tx) owns rows ty * 4 ..
// +4 and columns tx * 4 .. +4 of the tile.
template <typename TC>
__global__ void __launch_bounds__(THREADS)
    matmul_f32(const float* __restrict__ a, const float* __restrict__ b,
               TC* __restrict__ c, int M, int N, int K, long long lda,
               long long sbk, long long sbn, long long ldc, int b_kmajor) {
  __shared__ __align__(16) float As[FK][FM + 4];   // (k, m)
  __shared__ __align__(16) float Bs[FK][FN + 4];   // (k, n)
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
    for (int j = 0; j < (FM * FK) / THREADS; ++j) {
      const int e = tid + j * THREADS;
      const int kk = e % FK, mm = e / FK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? a[gm * lda + gk] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < (FN * FK) / THREADS; ++j) {
      const int e = tid + j * THREADS;
      int kk, nn;
      if (b_kmajor) {
        kk = e % FK;
        nn = e / FK;
      } else {
        nn = e % FN;
        kk = e / FN;
      }
      const int gn = n0 + nn, gk = k0 + kk;
      Bs[kk][nn] = (gn < N && gk < K) ? b[gk * sbk + gn * sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) store(c + gm * ldc + gn, acc[i][j]);
    }
  }
}

constexpr int SMS = 132;  // streaming multiprocessors of an H100 SXM

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename TC>
int launch_bf16(const uint16_t* a, const uint16_t* b, TC* c, int M, int N,
                int K, long long lda, long long sbk, long long sbn,
                long long ldc, cudaStream_t stream) {
  const Operand A{a, lda, 1, M, 1, aligned16(a) && lda % 8 == 0};
  Operand B{b, sbn, sbk, N, 1, 0};
  if (sbk == 1) {
    B.vec = aligned16(b) && sbn % 8 == 0;
  } else if (sbn == 1) {
    B.kmap = 0;
    B.vec = aligned16(b) && sbk % 8 == 0;
  }
  // 128 x 128 tiles where they fill the card, else 64 x 64 (4x the blocks)
  const long long big = static_cast<long long>((M + 127) / 128) *
                        ((N + 127) / 128);
  if (big >= SMS) {
    dim3 grid((N + 127) / 128, (M + 127) / 128);
    matmul_bf16<128, 128, TC><<<grid, THREADS, 0, stream>>>(A, B, c, M, N,
                                                           K, ldc);
  } else {
    dim3 grid((N + 63) / 64, (M + 63) / 64);
    matmul_bf16<64, 64, TC><<<grid, THREADS, 0, stream>>>(A, B, c, M, N, K,
                                                         ldc);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TC>
int launch_f32(const float* a, const float* b, TC* c, int M, int N, int K,
               long long lda, long long sbk, long long sbn, long long ldc,
               cudaStream_t stream) {
  // B is read along k where k is its unit stride, else along n
  const int kmajor = sbk == 1 && sbn != 1;
  dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
  matmul_f32<TC><<<grid, THREADS, 0, stream>>>(a, b, c, M, N, K, lda, sbk,
                                               sbn, ldc, kmajor);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype (A and B) and out_dtype: 0 = float32, 1 = bfloat16. C is
// row-major with row stride ldc. Returns the cudaError_t of the launch
// (0 = launched); nothing is launched when M or N is 0.
int matmul_tiled(const void* a, const void* b, void* c, int M, int N, int K,
                 long long lda, long long sbk, long long sbn, long long ldc,
                 int dtype, int out_dtype, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const uint16_t* aa = static_cast<const uint16_t*>(a);
    const uint16_t* bb = static_cast<const uint16_t*>(b);
    return out_dtype == 1
               ? launch_bf16(aa, bb, static_cast<uint16_t*>(c), M, N, K, lda,
                             sbk, sbn, ldc, st)
               : launch_bf16(aa, bb, static_cast<float*>(c), M, N, K, lda,
                             sbk, sbn, ldc, st);
  }
  const float* aa = static_cast<const float*>(a);
  const float* bb = static_cast<const float*>(b);
  return out_dtype == 1
             ? launch_f32(aa, bb, static_cast<uint16_t*>(c), M, N, K, lda,
                          sbk, sbn, ldc, st)
             : launch_f32(aa, bb, static_cast<float*>(c), M, N, K, lda, sbk,
                          sbn, ldc, st);
}

// The tensor-core route: bf16 A (M, K) with row stride lda and B (K, N),
// B(k, n) = b[k * ldb + n] (b_kmajor = 0) or b[n * ldb + k] (b_kmajor =
// 1); C (M, N) contiguous in bf16 (out_bf16 = 1) or f32. tile: 128 or 64;
// splits: ranges of K's 64-deep steps, their f32 partials in ws (splits * M
// * N floats when splits > 1). Returns the cudaError_t of the launches.
int matmul_bf16_tc(const void* a, const void* b, void* c, int M, int N, int K,
                   int lda, int ldb, int b_kmajor, int out_bf16, int tile,
                   int splits, float* ws, void* stream) {
  gemm16::Args g{};
  g.a = static_cast<const uint16_t*>(a);
  g.b = static_cast<const uint16_t*>(b);
  g.M = M;
  g.N = N;
  g.K = K;
  g.lda = lda;
  g.ldb = ldb;
  g.pieces = 1;
  g.mode = out_bf16 ? gemm16::BF16 : gemm16::F32;
  g.c32 = out_bf16 ? nullptr : static_cast<float*>(c);
  g.c16 = out_bf16 ? static_cast<uint16_t*>(c) : nullptr;
  g.ws = ws;
  g.splits = splits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return b_kmajor ? gemm16::matmul<true, true>(g, tile, st)
                  : gemm16::matmul<true, false>(g, tile, st);
}

}  // extern "C"
