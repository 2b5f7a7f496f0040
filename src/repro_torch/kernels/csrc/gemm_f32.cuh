// Tiled f32 matrix product with plain FMAs, shared by the backward, Gram
// and CholeskyQR kernels (lowrank_bwd.cu, gram.cu, choleskyqr.cu).
//
//   C[b](m, n) = sum_k A[b](m, k) * B[b](k, n),  every product and sum in f32
//
// A is row-major (A(m, k) = a[m * lda + k]) or, with A_T, stored transposed
// (A(m, k) = a[k * lda + m]); B is row-major (B(k, n) = b[k * ldb + n]).
// Inputs are bf16 (uint16_t bits) or f32 and are widened to f32 as they are
// staged in shared memory, so a bf16 x bf16 product is exact and the sum is
// an f32 sum, the contract of the TPU kernels' preferred_element_type=f32.
// One operand of every product here is f32 (h, dh, C^-1, G), which has no
// exact tensor-core path; plain FMAs keep the f32 semantics the reference
// demands, and they bound these kernels by operations at the card's f32
// rate (67 TFLOP/s on an H100 SXM), not by bytes.
//
// Tiles: 64 x 64 outputs per block, 256 threads, 4 x 4 outputs per thread,
// a reduction step of 16 staged k-major in shared memory and read as float4.
// Loads are mapped so that consecutive threads read consecutive addresses of
// whichever dimension of the operand is contiguous. Ragged edges are masked;
// nothing is padded or copied.
//
// Reductions are never split across blocks with atomics. A block owns its
// output tile and loops over its share of the reduction in a fixed order;
// with splits > 1 the reduction is cut into `splits` contiguous ranges, each
// block writes an f32 partial tile to a workspace, and reduce_splits sums the
// partials in split order. Two runs give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gemm {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint16_t* p, float v) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// grid (ceil(N / BN), ceil(M / BM), batch * splits); blockIdx.z = b * splits
// + s. Split s covers k in [s * kchunk, min(K, (s + 1) * kchunk)).
template <typename TA, typename TB, typename TC, bool A_T>
__global__ void __launch_bounds__(THREADS)
    gemm_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                TC* __restrict__ c, float* __restrict__ ws, int M, int N,
                int K, int lda, int ldb, int ldc, long long sa, long long sb,
                long long sc, int splits, int kchunk) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int bz = blockIdx.z;
  const int bi = bz / splits, s = bz % splits;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = s * kchunk;
  const int k_end = min(K, k_begin + kchunk);
  a += bi * sa;
  b += bi * sb;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int j = 0; j < (BM * BK) / THREADS; ++j) {
      const int e = tid + j * THREADS;
      int mm, kk;
      if constexpr (A_T) {
        mm = e % BM;
        kk = e / BM;
      } else {
        kk = e % BK;
        mm = e / BK;
      }
      const int gm = m0 + mm, gk = k0 + kk;
      float v = 0.f;
      if (gm < M && gk < k_end)
        v = to_f32(A_T ? a[static_cast<size_t>(gk) * lda + gm]
                       : a[static_cast<size_t>(gm) * lda + gk]);
      As[kk][mm] = v;
    }
#pragma unroll
    for (int j = 0; j < (BN * BK) / THREADS; ++j) {
      const int e = tid + j * THREADS;
      const int nn = e % BN, kk = e / BN;
      const int gn = n0 + nn, gk = k0 + kk;
      Bs[kk][nn] = (gn < N && gk < k_end)
                       ? to_f32(b[static_cast<size_t>(gk) * ldb + gn])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
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
      if (gn >= N) continue;
      if (splits == 1)
        store(c + bi * sc + static_cast<size_t>(gm) * ldc + gn, acc[i][j]);
      else
        ws[static_cast<size_t>(bz) * M * N + static_cast<size_t>(gm) * N +
           gn] = acc[i][j];
    }
  }
}

// C[b](m, n) = sum over s in order of the partials ws[b * splits + s](m, n)
template <typename TC>
__global__ void reduce_splits(const float* __restrict__ ws,
                              TC* __restrict__ c, int M, int N, int ldc,
                              long long sc, int splits, int batch) {
  const size_t mn = static_cast<size_t>(M) * N;
  const size_t total = mn * batch;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) +
                    threadIdx.x;
       idx < total; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t bi = idx / mn, r = idx % mn;
    const float* p = ws + bi * splits * mn + r;
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += p[s * mn];
    const int m = static_cast<int>(r / N), n = static_cast<int>(r % N);
    store(c + bi * sc + static_cast<size_t>(m) * ldc + n, sum);
  }
}

// Launch C = A B (batched) on `stream`. With splits > 1, `ws` must hold
// batch * splits * M * N floats. Returns the cudaError_t of the launches.
template <typename TA, typename TB, typename TC, bool A_T>
int matmul(const TA* a, const TB* b, TC* c, float* ws, int M, int N, int K,
           int lda, int ldb, int ldc, long long sa, long long sb,
           long long sc, int batch, int splits, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || batch <= 0) return 0;
  if (splits < 1) splits = 1;
  int kchunk = (K + splits - 1) / splits;
  kchunk = (kchunk + BK - 1) / BK * BK;
  if (kchunk <= 0) kchunk = BK;
  splits = K > 0 ? (K + kchunk - 1) / kchunk : 1;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch * splits);
  gemm_kernel<TA, TB, TC, A_T><<<grid, THREADS, 0, stream>>>(
      a, b, c, ws, M, N, K, lda, ldb, ldc, sa, sb, sc, splits, kchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(M) * N * batch;
  const int blocks = static_cast<int>((total + 255) / 256 < 4096
                                          ? (total + 255) / 256
                                          : 4096);
  reduce_splits<TC><<<blocks, 256, 0, stream>>>(ws, c, M, N, ldc, sc, splits,
                                                batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemm
