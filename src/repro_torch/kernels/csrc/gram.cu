// Tall-skinny Gram matrix for Hopper (sm_90a): G[b] = Y[b]^T Y[b] in f32.
//
// Replaces repro/kernels/gram.py::_gram_kernel (reached through gram_tiled),
// the reduction stage of CholeskyQR and phase 0 of every WSI refresh's
// CholeskyQR. Y (B, M, K) row-major, bf16 or f32; G (B, K, K) f32. Same
// contract as the oracle repro_torch/kernels/ref.py::gram_ref, batched over
// the leading dim. The TPU kernel walks the row blocks of M in order and
// accumulates one revisited (K, K) f32 VMEM tile; here blocks run in
// parallel over (stack index, output tile, range of M), and one launch
// covers the whole stack: a refresh passes all 24 layers' L (24, O, K) of a
// site at once. Two routes, chosen by the wrapper (kernels/gram.py::
// gram_route):
//
//   * tensor_core (bf16 Y, K a multiple of 8, 16-byte aligned base):
//     gram_bf16, one product on gemm_bf16.cuh with A = Y^T read M-major and
//     B = Y read N-major as stored (ldmatrix.trans, no copy), batched over
//     the stack, with its TRI option: only the T (T + 1) / 2 upper-triangle
//     64 x 64 tiles of G run (10 of 16 at K = 256), and each
//     value is stored at (i, j) and (j, i) from one register. A bf16 x bf16
//     product is exact in the f32 accumulator, so G is the f32 sum of exact
//     products, the plain version's contract; the reduction splits come
//     from kernels/gram.py::gram_plan.
//   * fma (f32 Y; bf16 with K not a multiple of 8): gram, G cut into 64 x
//     64 tiles, each looping over all M rows on f32 FMAs (gemm_f32.cuh with
//     A = Y^T read in place); G[i][j] and G[j][i] are the same sum in the
//     same order.
//
// Where the stack holds few tiles, the M reduction is cut into contiguous
// ranges and a second pass sums the f32 partials in split order; no
// atomics, so G is the same bits on every run, and exactly symmetric,
// which the Cholesky of choleskyqr_blocked.cu relies on.
//
// What bounds it: 2 B M K^2 flops on 2 B M K bytes of bf16 Y, for the 24
// stacked (4864, 256) L of mlp/gate 15.3 GFLOP against 60 MB: 18 us of
// bytes at 3.35 TB/s, 15 us of flops at the bf16 tensor-core rate (the
// triangle halves both flops and the L2 reads). On f32 FMAs the flops alone
// take 228 us at 67 TFLOP/s, the fma route's bound; the tensor-core route
// runs within ~3.5x of the byte bound (64 us on an H100), held there by
// mma.sync (not wgmma) re-reading Y from L2 for each tile of a row and by
// grids of 72-240 blocks (see gram_plan).

#include "gemm_bf16.cuh"
#include "gemm_f32.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. splits: contiguous ranges of the M
// reduction (1 = none); ws holds B * splits * K * K floats when splits > 1.
// Returns the cudaError_t of the launches (0 = launched).
int gram(const void* y, float* g, float* ws, int B, int M, int K, int dtype,
         int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long sy = static_cast<long long>(M) * K;
  const long long sg = static_cast<long long>(K) * K;
  // G (K, K) = Y^T (K, M) . Y (M, K); Y^T(k, m) = y[m * K + k]
  if (dtype == 1) {
    const uint16_t* yy = static_cast<const uint16_t*>(y);
    return gemm::matmul<uint16_t, uint16_t, float, true>(
        yy, yy, g, ws, K, K, M, K, K, K, sy, sy, sg, B, splits, st);
  }
  const float* yy = static_cast<const float*>(y);
  return gemm::matmul<float, float, float, true>(yy, yy, g, ws, K, K, M, K, K,
                                                 K, sy, sy, sg, B, splits, st);
}

// The tensor-core route: bf16 Y (B, M, K) with K % 8 == 0 and a 16-byte
// aligned base; G's upper-triangle 64 x 64 tiles, `splits` ranges of M's
// steps (ws: splits * B * K * K floats when splits > 1).
int gram_bf16(const void* y, float* g, float* ws, int B, int M, int K,
              int splits, void* stream) {
  gemm16::ArgsX ax{};
  gemm16::Args& a = ax.g;
  // C (K, K) = A (K, M) . B (M, K): A(i, m) = y[m * K + i] (M-major),
  // B(m, j) = y[m * K + j] (N-major)
  a.a = static_cast<const uint16_t*>(y);
  a.b = static_cast<const uint16_t*>(y);
  a.M = K;
  a.N = K;
  a.K = M;
  a.lda = K;
  a.ldb = K;
  a.pieces = 1;
  a.mode = gemm16::F32;
  a.c32 = g;
  a.ws = ws;
  a.splits = splits;
  ax.batch = B;
  ax.a_bs = static_cast<long long>(M) * K;
  ax.b_bs = ax.a_bs;
  ax.c_bs = static_cast<long long>(K) * K;
  using Tri = gemm16::Config<64, 64, 2, 2, 3, gemm16::BK, 4, false, false,
                             false, true, true>;
  return gemm16::launch<Tri>(ax, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
