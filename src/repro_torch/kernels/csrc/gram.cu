// Tall-skinny Gram matrix for Hopper (sm_90a): G[b] = Y[b]^T Y[b] in f32.
//
// Replaces repro/kernels/gram.py::_gram_kernel (reached through gram_tiled),
// the reduction stage of CholeskyQR and phase 0 of choleskyqr.cu's refresh.
// Y (B, M, K) row-major, bf16 or f32; G (B, K, K) f32. Same contract as the
// oracle repro_torch/kernels/ref.py::gram_ref, batched over the leading dim.
//
// The TPU kernel walks the row blocks of M in order and accumulates one
// revisited (K, K) f32 VMEM tile. Here G is cut into 64 x 64 tiles, one
// block per (stack index, tile), each looping over all M rows in a fixed
// order (gemm_f32.cuh with A = Y^T read in place). One launch covers the
// whole stack: the WSI refresh of one site passes all 24 layers' L (24, O, K)
// at once. Where the stack holds few tiles (a single 2-D Y), the wrapper
// splits the M reduction into contiguous ranges and a second pass sums the
// f32 partials in order; no atomics, so G is the same bits on every run, and
// G[i][j] and G[j][i] are the same sum in the same order: G is exactly
// symmetric, which the Cholesky of choleskyqr.cu relies on.
//
// What bounds it: 2 B M K^2 flops, 15.3 GFLOP for the 24 stacked
// (4864, 256) L of mlp/gate, against 60 MB of bf16 Y. The card could do
// that in 18 us (bytes at 3.35 TB/s; the flops at the bf16 tensor-core rate
// take 15 us), but this kernel runs the exact bf16 products as f32 FMAs,
// where the flops take 228 us at 67 TFLOP/s: it is bound by operations, and
// tensor cores (mma.sync on the bf16 operands) are the lever, for a later
// change.

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

}  // extern "C"
