// Shifted CholeskyQR with its mixing matrix, for Hopper (sm_90a), batched
// over a leading stack dim:
//   G = Y^T Y                       (gram.cu, launched by the wrapper first)
//   C = chol(G + 1e-6 tr(G)/K I)    lower triangular
//   X = C^-1,  mix = X G (K, K) f32,  Q = Y X^T (M, K) in Y's dtype
// Y (B, M, K) row-major, bf16 or f32. Q has orthonormal columns spanning
// those of Y, and mix = Q^T Y, the matrix the WSI refresh folds into R.
//
// Replaces repro/kernels/qr.py::_choleskyqr_kernel (reached through
// choleskyqr_tiled) with its in-kernel _masked_cholesky (qr.py:47) and
// _tril_inverse (qr.py:66) at ranks above 288 (kernels/qr.py::qr_route's
// "global" factor; lower ranks take choleskyqr_blocked.cu). The TPU kernel is
// one launch with a two-phase sequential grid: phase 0 accumulates G in VMEM
// and factors it at its last step, phase 1 applies C^-T per row block. CUDA
// blocks are not ordered, so the phases become launches on one stream: the Gram
// launch (gram.cu), then here a factor launch (one block per stack index) and
// two product launches (gemm_f32.cuh): mix = X G and Q = Y X^T. The reference's
// refresh sends a stacked (24, O, K) operand to its jnp fallback; this kernel
// takes the stack as a grid axis, so one call refreshes all 24 layers of a
// site.
//
// The factor launch follows the Pallas body step for step: the K-step
// column loop of _masked_cholesky with its sqrt(max(v, 1e-30)) guard, then
// forward substitution row by row as _tril_inverse with its
// max(c_ii, 1e-30) guard. Two differences, both taken from
// repro/core/orthogonal.py::cholesky_qr_mix_ref, the function the
// reference's refresh runs on a stacked operand:
//   * the shift's trace is divided by the true K, not by the lane-padded K
//     of the Pallas kernel (which pads K to 128 and spreads the shift over
//     the pad);
//   * the shift ladder of _shifted_cholesky: a stack index where a pivot
//     v[j] of the first factorization is not positive (where LAPACK's
//     Cholesky fails and the reference's first factor is NaN) is factored
//     again in the same block with a 1e4-times larger shift. The guards
//     stay for the second factorization, where the reference keeps NaN.
//     retried[b] records which shift index b took.
//
// Where G, C and X live: at K = 256 one f32 K x K matrix is 256 KB, more than
// one block's 227 KB of shared memory, so the factor step works from global
// memory held in the 50 MB L2 (G, C^T and X of the 24-layer stack are 19 MB
// in all at K = 256). C is kept transposed (ct[p][i] = C[i][p]) and X row
// major, so that the threads of a warp, one per row (Cholesky) or one per
// column (inverse), read consecutive addresses; the one row of C that every
// thread needs at a step is staged in shared memory.
//
// What bounds it: the two products and the Gram are 4 B M K^2 + 2 B K^3
// flops (30 GFLOP for the 24 stacked L of mlp/gate) on the f32 FMA path,
// the operations bound of this design; the factor step is K dependent
// steps per stack index, bound by latency (its K^3 / 3 flops per index are
// few), and runs once per refresh per site.

#include "gemm_f32.cuh"

namespace {

constexpr int FT = 256;  // threads of the factor block

// Cholesky of G + sh I into ct (transposed), one column per step
// (_masked_cholesky):
//   v = G[:, j] + sh e_j - C[:, :j] C[j, :j]^T,  C[i, j] = v[i] / sqrt(v[j])
// G is exactly symmetric (gram.cu), so its column j is read as row j.
// Returns, uniformly over the block, whether some pivot v[j] was not
// positive (NaN included).
__device__ bool cholesky_cols(const float* __restrict__ g, float* ct,
                              float* v, float* crow, int K, float sh) {
  __shared__ int failed;
  const int tid = threadIdx.x;
  if (tid == 0) failed = 0;
  __syncthreads();
  for (int j = 0; j < K; ++j) {
    for (int p = tid; p < j; p += FT) crow[p] = ct[static_cast<size_t>(p) * K + j];
    __syncthreads();
    for (int i = j + tid; i < K; i += FT) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      int p = 0;
      for (; p + 4 <= j; p += 4) {
        s0 = fmaf(ct[static_cast<size_t>(p) * K + i], crow[p], s0);
        s1 = fmaf(ct[static_cast<size_t>(p + 1) * K + i], crow[p + 1], s1);
        s2 = fmaf(ct[static_cast<size_t>(p + 2) * K + i], crow[p + 2], s2);
        s3 = fmaf(ct[static_cast<size_t>(p + 3) * K + i], crow[p + 3], s3);
      }
      for (; p < j; ++p) s0 = fmaf(ct[static_cast<size_t>(p) * K + i], crow[p], s0);
      v[i] = g[static_cast<size_t>(j) * K + i] + (i == j ? sh : 0.f) -
             ((s0 + s1) + (s2 + s3));
    }
    __syncthreads();
    if (tid == 0 && !(v[j] > 0.f)) failed = 1;
    const float d = sqrtf(fmaxf(v[j], 1e-30f));
    for (int i = j + tid; i < K; i += FT)
      ct[static_cast<size_t>(j) * K + i] = v[i] / d;
    __syncthreads();
  }
  const bool out = failed != 0;
  __syncthreads();  // every thread has read the flag before a next reset
  return out;
}

// One block per stack index. ws: ct, x, xt (each B x K x K f32) in order.
__global__ void __launch_bounds__(FT)
    chol_factor(const float* __restrict__ g_all, float* ct_all, float* x_all,
                float* xt_all, int* __restrict__ retried, int K,
                float shift) {
  extern __shared__ float sm[];
  float* v = sm;         // [K] column j of the shifted Schur complement
  float* crow = sm + K;  // [K] the row of C a step needs
  __shared__ float red[FT];
  const int tid = threadIdx.x;
  const size_t kk = static_cast<size_t>(K) * K;
  const float* g = g_all + blockIdx.x * kk;
  float* ct = ct_all + blockIdx.x * kk;
  float* x = x_all + blockIdx.x * kk;
  float* xt = xt_all + blockIdx.x * kk;

  // shift = 1e-6 * max(tr(G) / K, 1e-30), tree sum in a fixed order
  float t = 0.f;
  for (int i = tid; i < K; i += FT) t += g[static_cast<size_t>(i) * K + i];
  red[tid] = t;
  __syncthreads();
  for (int s = FT / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const float sh = shift * fmaxf(red[0] / K, 1e-30f);

  for (size_t e = tid; e < kk; e += FT) {
    ct[e] = 0.f;
    x[e] = 0.f;
  }
  __syncthreads();

  // the shift ladder of _shifted_cholesky: a failed first factorization
  // is redone with a 1e4-times larger shift (every entry of the lower
  // triangle of ct is written again; the upper stays zero)
  const bool again = cholesky_cols(g, ct, v, crow, K, sh);
  if (again) cholesky_cols(g, ct, v, crow, K, 1e4f * sh);
  if (tid == 0) retried[blockIdx.x] = again ? 1 : 0;

  // X = C^-1 by forward substitution, one row per step (_tril_inverse):
  //   X[i, c] = (delta_ic - sum_{c <= p < i} C[i, p] X[p, c]) / C[i, i]
  for (int i = 0; i < K; ++i) {
    for (int p = tid; p <= i; p += FT) crow[p] = ct[static_cast<size_t>(p) * K + i];
    __syncthreads();
    const float cii = fmaxf(crow[i], 1e-30f);
    for (int c = tid; c <= i; c += FT) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      int p = c;
      for (; p + 4 <= i; p += 4) {
        s0 = fmaf(crow[p], x[static_cast<size_t>(p) * K + c], s0);
        s1 = fmaf(crow[p + 1], x[static_cast<size_t>(p + 1) * K + c], s1);
        s2 = fmaf(crow[p + 2], x[static_cast<size_t>(p + 2) * K + c], s2);
        s3 = fmaf(crow[p + 3], x[static_cast<size_t>(p + 3) * K + c], s3);
      }
      for (; p < i; ++p) s0 = fmaf(crow[p], x[static_cast<size_t>(p) * K + c], s0);
      x[static_cast<size_t>(i) * K + c] =
          ((i == c ? 1.f : 0.f) - ((s0 + s1) + (s2 + s3))) / cii;
    }
    __syncthreads();
  }

  // X^T for the apply product Q = Y X^T
  for (size_t e = tid; e < kk; e += FT) {
    const size_t i = e / K, c = e % K;
    xt[c * K + i] = x[e];
  }
}

template <typename T>
int run(const T* y, const float* g, T* q, float* mix, float* ws, int* retried,
        int B, int M, int K, float shift, cudaStream_t st) {
  const size_t kk = static_cast<size_t>(K) * K;
  float* ct = ws;
  float* x = ws + B * kk;
  float* xt = ws + 2 * B * kk;
  chol_factor<<<B, FT, 2 * K * sizeof(float), st>>>(g, ct, x, xt, retried, K,
                                                    shift);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long skk = static_cast<long long>(kk);
  const long long smk = static_cast<long long>(M) * K;
  // mix (K, K) = X (K, K) . G (K, K)
  err = gemm::matmul<float, float, float, false>(x, g, mix, nullptr, K, K, K,
                                                 K, K, K, skk, skk, skk, B, 1,
                                                 st);
  if (err) return err;
  // Q (M, K) = Y (M, K) . X^T (K, K), stored in Y's dtype
  return gemm::matmul<T, float, T, false>(y, xt, q, nullptr, M, K, K, K, K, K,
                                          smk, skk, smk, B, 1, st);
}

}  // namespace

extern "C" {

// y (B, M, K), g = gram(y) (B, K, K) f32 -> q (B, M, K) in y's dtype, mix
// (B, K, K) f32, retried (B,) int32: 1 where the 1e4-times larger shift was
// taken. ws: 3 * B * K * K floats. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launches (0 = launched).
int choleskyqr(const void* y, const float* g, void* q, float* mix, float* ws,
               int* retried, int B, int M, int K, int dtype, float shift,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || K <= 0) return 0;
  if (dtype == 1)
    return run<uint16_t>(static_cast<const uint16_t*>(y), g,
                         static_cast<uint16_t*>(q), mix, ws, retried, B, M, K,
                         shift, st);
  return run<float>(static_cast<const float*>(y), g, static_cast<float*>(q),
                    mix, ws, retried, B, M, K, shift, st);
}

}  // extern "C"
