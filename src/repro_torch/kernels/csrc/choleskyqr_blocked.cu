// Shifted CholeskyQR with its mixing matrix for Hopper (sm_90a), the route
// for ranks whose factor fits one block's shared memory (K <= 288; the
// main path's ranks are 128 and 256):
//   G = Y^T Y                       (gram.cu, launched by the wrapper first)
//   C = chol(G + 1e-6 tr(G)/K I)    lower triangular
//   X = C^-1,  mix = X G (K, K) f32,  Q = Y X^T (M, K) in Y's dtype
// Y (B, M, K) row-major, bf16 or f32. The function, guards and shift ladder
// are choleskyqr.cu's (the route for larger K, kernels/qr.py::qr_route).
//
// Replaces repro/kernels/qr.py::_choleskyqr_kernel (reached through
// choleskyqr_tiled) with its _masked_cholesky (qr.py:47) and _tril_inverse
// (qr.py:66), as choleskyqr.cu does; what changes is where the factor
// lives. choleskyqr.cu's factor takes K dependent column steps for the
// Cholesky and K more for the inverse, each with block barriers and reads
// of C from global memory (a K = 256 f32 matrix, 256 KB, does not fit one
// block's 227 KB of shared memory). Its lower triangle does: here the
// factor block holds it as 32 x 32 f32 blocks, packed (block (i, k), k <=
// i, at i (i + 1) / 2 + k; rows padded to 33 floats so that a lane per row
// or per column reads distinct banks), 36 blocks at K = 256, plus the
// inverses of the nb diagonal blocks: 186 KB. Between the launches that
// hold G and X nothing goes through device memory.
//
// Factor (one block of 8 warps per stack index):
//   * right-looking blocked Cholesky, for each block column j: warp 0
//     factors the diagonal block in registers (a lane per row, shuffles,
//     no block barrier; the guard sqrt(max(v, 1e-30)) of _masked_cholesky)
//     and inverts it (a lane per column, forward substitution with the
//     guard max(c_ii, 1e-30) of _tril_inverse); the panel below is C_ij =
//     A_ij X_jj^T; the trailing triangle takes A_ik -= C_ij C_kj^T, warp 0
//     first updating and factoring the next diagonal block (look-ahead)
//     while the others update the rest. Each 32 x 32 product is one
//     warp's: a lane holds a 4 x 8 tile of the output in registers. Two
//     barriers a block column.
//   * the triangular inverse in place (LAPACK's trtri order, from the last
//     block column back): X_ij = -(sum_{k=j+1..i} X_ik C_kj) X_jj, one warp
//     per block row i, two barriers a block column.
//   * a pivot that is not positive (NaN included) at any real diagonal
//     entry ends the first factorization; the index is factored again from
//     G with a 1e4-times larger shift (_shifted_cholesky's ladder), and
//     retried[b] says so. The shift's trace is divided by the true K; a
//     ragged K is padded with the identity, which factors and inverts to
//     itself and couples to nothing.
//   * the factor writes X (f32, for mix = X G on gemm_f32.cuh) and, for
//     the apply, the two bf16 pieces of X (bf16 Y whose rows the 16-byte
//     copies read) or X^T (f32 Y, other bf16 widths).
// Apply: bf16 Y on the tensor cores, Q = sum_p Y X_p^T over the two pieces
// of X (gemm_bf16.cuh batched over the stack: a piece error of 2^-17 of
// each term, far below Q's one bf16 rounding); f32 Y on gemm_f32.cuh.
// Barriers per index: about 35 at K = 256, against about 1,300 in
// choleskyqr.cu's factor.
//
// What bounds it: the Gram (gram.cu) and the apply are the bytes and flops
// of the call; the factor is latency, K^3 / 3 flops twice per index on one
// SM, 24 of the 132 SMs busy for a 24-layer stack.
// No atomics: two runs give the same bits. The kernel allocates nothing;
// the C entry point returns cudaGetLastError() of its launches.

#include "gemm_bf16.cuh"
#include "gemm_f32.cuh"

namespace {

constexpr int T = 32;            // block edge
constexpr int LD = 33;           // padded row stride of a block (floats)
constexpr int BLK = T * LD;      // floats a block takes
constexpr int NB_MAX = 9;        // blocks along K: K <= 288
constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int nblocks(int K) { return (K + T - 1) / T; }
__host__ __device__ inline int tri(int nb) { return nb * (nb + 1) / 2; }
__host__ __device__ inline int smem_bytes(int K) {
  const int nb = nblocks(K);
  return (tri(nb) + nb) * BLK * static_cast<int>(sizeof(float));
}

// block (i, k) of the packed lower triangle; the inverse of diagonal block j
__device__ __forceinline__ float* blk(float* s, int i, int k) {
  return s + (i * (i + 1) / 2 + k) * BLK;
}
__device__ __forceinline__ float* dinv(float* s, int nb, int j) {
  return s + (tri(nb) + j) * BLK;
}

// acc[q][e] += sum_c A[4a + q][c] B'[c][8b + e] over the 32-block, lane =
// 4 a + b; B' = B^T (NT) or B (NN). The reads of a quarter warp fall in
// distinct banks (row stride 33) or are broadcasts.
template <bool NT>
__device__ __forceinline__ void block_mma(float (&acc)[4][8], const float* A,
                                          const float* B, int a, int b) {
#pragma unroll 4
  for (int c = 0; c < T; ++c) {
    float av[4], bv[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) av[q] = A[(4 * a + q) * LD + c];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      bv[e] = NT ? B[(8 * b + e) * LD + c] : B[c * LD + 8 * b + e];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[q][e] = fmaf(av[q], bv[e], acc[q][e]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][8]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[q][e] = 0.f;
}

// S[4a + q][8b + e] = sign * acc[q][e]
__device__ __forceinline__ void put(float* S, const float (&acc)[4][8], int a,
                                    int b, float sign) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      S[(4 * a + q) * LD + 8 * b + e] = sign * acc[q][e];
}

// One warp: the Cholesky of the 32-block S in place, a lane per row (the
// lower triangle becomes C_jj, the upper zeros), column by column as
// _masked_cholesky: pivot v = S[c][c], C[r][c] = S[r][c] / sqrt(max(v,
// 1e-30)) (here times its reciprocal square root), then S[r][c2] -= C[r][c]
// C[c2][c]; rd[c] keeps that reciprocal for the panel. Returns, uniformly
// over the warp, whether a pivot of the first `nvalid` rows was not
// positive.
__device__ bool chol_diag(float* S, float* rd, int nvalid) {
  const int lane = threadIdx.x % 32;
  float a[T];
#pragma unroll
  for (int c = 0; c < T; ++c) a[c] = S[lane * LD + c];
  bool bad = false;
  float mine = 0.f;
#pragma unroll
  for (int c = 0; c < T; ++c) {
    const float piv = __shfl_sync(FULL, a[c], c);
    bad |= c < nvalid && !(piv > 0.f);
    const float inv_d = rsqrtf(fmaxf(piv, 1e-30f));
    if (lane == c) mine = inv_d;
    const float l = lane >= c ? a[c] * inv_d : 0.f;
    a[c] = l;
#pragma unroll
    for (int c2 = c + 1; c2 < T; ++c2)
      a[c2] = fmaf(-l, __shfl_sync(FULL, l, c2), a[c2]);
  }
#pragma unroll
  for (int c = 0; c < T; ++c) S[lane * LD + c] = a[c];
  rd[lane] = mine;
  return __any_sync(FULL, bad);
}

// One thread: row r of the panel block A (in place) becomes row r of
// C_ij = A_ij C_jj^-T, by the substitution the unblocked column steps make
// (C[r][c] = (A[r][c] - sum_{c' < c} C[r][c'] C[c][c']) / d_c), right-
// looking so that each step's updates are independent.
__device__ void panel_row(float* A, const float* C, const float* rd) {
  float x[T];
#pragma unroll
  for (int c = 0; c < T; ++c) x[c] = A[c];
#pragma unroll
  for (int c = 0; c < T; ++c) {
    x[c] *= rd[c];
#pragma unroll
    for (int c2 = c + 1; c2 < T; ++c2)
      x[c2] = fmaf(-x[c], C[c2 * LD + c], x[c2]);
  }
#pragma unroll
  for (int c = 0; c < T; ++c) A[c] = x[c];
}

// One warp: D = S^-1 for the lower-triangular 32-block S, a lane per
// column c, forward substitution by rows as _tril_inverse: X[i][c] =
// (delta_ic - sum_{p < i} S[i][p] X[p][c]) / max(S[i][i], 1e-30) (times
// the reciprocal, computed first); the upper triangle comes out zero.
__device__ void inv_diag(const float* S, float* D) {
  const int c = threadIdx.x % 32;
  float x[T], rc[T];
#pragma unroll
  for (int i = 0; i < T; ++i) rc[i] = 1.f / fmaxf(S[i * LD + i], 1e-30f);
#pragma unroll
  for (int i = 0; i < T; ++i) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int p = 0; p < i; ++p) {
      if (p % 2 == 0)
        s0 = fmaf(S[i * LD + p], x[p], s0);
      else
        s1 = fmaf(S[i * LD + p], x[p], s1);
    }
    x[i] = ((i == c ? 1.f : 0.f) - (s0 + s1)) * rc[i];
  }
#pragma unroll
  for (int i = 0; i < T; ++i) D[i * LD + c] = x[i];
}

// G + s I into the packed blocks; outside K the identity. A warp takes
// ROWS rows of G at a time, a lane a column of each block, so that every
// load of the group is in flight before the first store.
__device__ void load_g(float* sm, const float* __restrict__ g, int K, int nb,
                       float s) {
  constexpr int ROWS = 4;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r0 = warp; r0 < nb * T; r0 += ROWS * WARPS) {
    float v[ROWS][NB_MAX];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int gi = r0 + u * WARPS, bi = gi / T;
#pragma unroll
      for (int q = 0; q < NB_MAX; ++q) {
        const int gc = q * T + lane;
        v[u][q] = gi < K && gc < K && q <= bi
                      ? g[static_cast<size_t>(gi) * K + gc] +
                            (gi == gc ? s : 0.f)
                      : (gi == gc ? 1.f : 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int gi = r0 + u * WARPS, bi = gi / T;
#pragma unroll
      for (int q = 0; q < NB_MAX; ++q)
        if (gi < nb * T && q <= bi)
          blk(sm, bi, q)[(gi % T) * LD + lane] = v[u][q];
    }
  }
  __syncthreads();
}

// Warp 0: factor diagonal block j; a pivot that is not positive sets the
// flag.
__device__ void diag_step(float* sm, float* rd, int K, int j, int* bad_flag) {
  const bool bad = chol_diag(blk(sm, j, j), rd, min(T, K - j * T));
  if (threadIdx.x == 0 && bad) *bad_flag = 1;
}

// The blocked Cholesky in place. Returns, uniformly over the
// block, whether a real pivot was not positive; with `stop` the
// factorization ends there (a first one, to be redone), else it runs on
// under the guards (the ladder's last). Look-ahead: in block column j's
// trailing update warp 0 takes block (j + 1, j + 1) first and factors it
// while the other warps update the rest, so the next column starts with
// its diagonal block done (two barriers a block column).
__device__ bool factor(float* sm, float* rd, int K, int nb, int* bad_flag,
                       bool stop) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int a = lane / 4, b = lane % 4;
  if (warp == 0) diag_step(sm, rd, K, 0, bad_flag);
  __syncthreads();
  for (int j = 0; j < nb; ++j) {
    if (stop && *bad_flag) return true;
    // panel: C_ij = A_ij C_jj^-T, a thread per row (nb - 1 - j <= 8
    // blocks of 32 rows)
    if (j + 1 + warp < nb)
      panel_row(blk(sm, j + 1 + warp, j) + lane * LD, blk(sm, j, j), rd);
    __syncthreads();
    // trailing triangle: A_ik -= C_ij C_kj^T, j < k <= i; job 0 is block
    // (j + 1, j + 1), warp 0's, then its factor; warps 1-7 take the rest
    const int t = nb - 1 - j;
    for (int job = warp == 0 ? 0 : warp; job < tri(t);
         job += warp == 0 ? tri(t) : WARPS - 1) {
      int ii = 0;
      while (tri(ii + 1) <= job) ++ii;
      const int i = j + 1 + ii, k = j + 1 + (job - tri(ii));
      float acc[4][8];
      zero(acc);
      block_mma<true>(acc, blk(sm, i, j), blk(sm, k, j), a, b);
      float* S = blk(sm, i, k);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          S[(4 * a + q) * LD + 8 * b + e] -= acc[q][e];
    }
    if (warp == 0 && t > 0) {
      __syncwarp();
      diag_step(sm, rd, K, j + 1, bad_flag);
    }
    __syncthreads();
  }
  return *bad_flag != 0;
}

// X = C^-1: the inverses of the diagonal blocks into dinv (a warp each),
// then in place from the last block column back: X_ij = -(sum_{k=j+1..i}
// X_ik C_kj) X_jj; block row i of column j is warp i - j - 1's (nb - 1 <= 8
// rows: one each).
__device__ void invert(float* sm, int nb) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int a = lane / 4, b = lane % 4;
  for (int d = warp; d < nb; d += WARPS)
    inv_diag(blk(sm, d, d), dinv(sm, nb, d));
  __syncthreads();
  for (int j = nb - 2; j >= 0; --j) {
    const int i = j + 1 + warp;
    float acc[4][8];
    zero(acc);
    if (i < nb)
      for (int k = j + 1; k <= i; ++k)
        block_mma<false>(acc, k == i ? dinv(sm, nb, i) : blk(sm, i, k),
                         blk(sm, k, j), a, b);
    __syncthreads();   // every C_kj of column j is read
    if (i < nb) {
      float* S = blk(sm, i, j);
      put(S, acc, a, b, 1.f);
      __syncwarp();
      zero(acc);
      block_mma<false>(acc, S, dinv(sm, nb, j), a, b);
      __syncwarp();
      put(S, acc, a, b, -1.f);
    }
    __syncthreads();
  }
}

// One block per stack index. x: X (B, K, K) f32 row-major; xt: X^T or null;
// xp: the two bf16 pieces of X, (B, 2, K, K), or null.
__global__ void __launch_bounds__(THREADS)
    chol_blocked(const float* __restrict__ g_all, float* __restrict__ x_all,
                 float* __restrict__ xt_all, uint16_t* __restrict__ xp_all,
                 int* __restrict__ retried, int K, float shift) {
  extern __shared__ float sm[];
  __shared__ float red[THREADS];
  __shared__ float rd[T];
  __shared__ int bad_flag;
  const int tid = threadIdx.x, nb = nblocks(K);
  const size_t kk = static_cast<size_t>(K) * K;
  const float* g = g_all + blockIdx.x * kk;

  // shift = 1e-6 * max(tr(G) / K, 1e-30), tree sum in a fixed order (the
  // order of choleskyqr.cu's, which has as many threads)
  float t = 0.f;
  for (int i = tid; i < K; i += THREADS)
    t += g[static_cast<size_t>(i) * K + i];
  red[tid] = t;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const float sh = shift * fmaxf(red[0] / K, 1e-30f);

  bool again = false;
  for (int attempt = 0; attempt < 2; ++attempt) {
    load_g(sm, g, K, nb, attempt == 0 ? sh : 1e4f * sh);
    if (tid == 0) bad_flag = 0;
    __syncthreads();
    const bool failed = factor(sm, rd, K, nb, &bad_flag, attempt == 0);
    if (attempt == 0 && !failed) break;
    again = true;
  }
  if (tid == 0) retried[blockIdx.x] = again ? 1 : 0;
  invert(sm, nb);

  float* x = x_all + blockIdx.x * kk;
  if (K % 4 == 0 && xt_all == nullptr) {
    // four consecutive columns a thread (one block row segment): a 16-byte
    // store of X and an 8-byte store of each piece
    const int q4 = K / 4;
    for (int idx = tid; idx < K * q4; idx += THREADS) {
      const int r = idx / q4, c = (idx - r * q4) * 4;
      const int bi = r / T, bk = c / T;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (bk <= bi) {
        const float* S = (bi == bk ? dinv(sm, nb, bi) : blk(sm, bi, bk)) +
                         (r % T) * LD + c % T;
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = S[u];
      }
      const size_t e = static_cast<size_t>(r) * K + c;
      *reinterpret_cast<float4*>(x + e) = make_float4(v[0], v[1], v[2], v[3]);
      uint16_t p[4][3];
#pragma unroll
      for (int u = 0; u < 4; ++u) gemm16::split_bf16(v[u], 2, p[u]);
#pragma unroll
      for (int q = 0; q < 2; ++q)
        *reinterpret_cast<uint2*>(xp_all + (2 * blockIdx.x + q) * kk + e) =
            make_uint2(p[0][q] | (static_cast<uint32_t>(p[1][q]) << 16),
                       p[2][q] | (static_cast<uint32_t>(p[3][q]) << 16));
    }
  } else {
    for (int r = 0; r < K; ++r)
      for (int c = tid; c < K; c += THREADS) {
        const size_t e = static_cast<size_t>(r) * K + c;
        float v = 0.f;
        if (c <= r) {
          const int bi = r / T, bk = c / T;
          const float* S = bi == bk ? dinv(sm, nb, bi) : blk(sm, bi, bk);
          v = S[(r % T) * LD + c % T];
        }
        x[e] = v;
        if (xt_all != nullptr)
          xt_all[blockIdx.x * kk + static_cast<size_t>(c) * K + r] = v;
        if (xp_all != nullptr) {
          uint16_t p[3];
          gemm16::split_bf16(v, 2, p);
          xp_all[2 * blockIdx.x * kk + e] = p[0];
          xp_all[(2 * blockIdx.x + 1) * kk + e] = p[1];
        }
      }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of the factor block at rank K (the wrapper's rule,
// kernels/qr.py::blocked_smem_bytes, mirrors it).
int choleskyqr_blocked_smem_bytes(int K) { return smem_bytes(K); }

// y (B, M, K), g = gram(y) (B, K, K) f32 -> q (B, M, K) in y's dtype, mix
// (B, K, K) f32, retried (B,) int32. x: B K K f32 scratch; xt: B K K f32
// scratch (apply on gemm_f32.cuh) or xp: B 2 K K bf16 scratch (apply on
// the tensor cores, tc = 1), the other null; ws: f32 split partials of the
// tensor-core apply (tile, splits: kernels/qr.py's plan). dtype: 0 =
// float32, 1 = bfloat16. K <= 288. Returns the cudaError_t of the launches.
int choleskyqr_blocked(const void* y, const float* g, void* q, float* mix,
                       float* x, float* xt, void* xp, float* ws,
                       int* retried, int B, int M, int K, int dtype, int tc,
                       float shift, int tile, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || K <= 0) return 0;
  if (nblocks(K) > NB_MAX) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        chol_blocked, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes(NB_MAX * T));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  chol_blocked<<<B, THREADS, smem_bytes(K), st>>>(
      g, x, tc ? nullptr : xt, tc ? static_cast<uint16_t*>(xp) : nullptr,
      retried, K, shift);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long skk = static_cast<long long>(K) * K;
  const long long smk = static_cast<long long>(M) * K;
  // mix (K, K) = X (K, K) . G (K, K)
  err = gemm::matmul<float, float, float, false>(x, g, mix, nullptr, K, K, K,
                                                 K, K, K, skk, skk, skk, B, 1,
                                                 st);
  if (err) return err;
  if (tc) {
    // Q (M, K) = sum_p Y (M, K) . X_p^T, bf16, batched over the stack
    gemm16::ArgsX ax{};
    gemm16::Args& a = ax.g;
    a.a = static_cast<const uint16_t*>(y);
    a.b = static_cast<const uint16_t*>(xp);
    a.M = M;
    a.N = K;
    a.K = K;
    a.lda = K;
    a.ldb = K;
    a.b_ps = skk;
    a.pieces = 2;
    a.mode = gemm16::BF16;
    a.c16 = static_cast<uint16_t*>(q);
    a.ws = ws;
    a.splits = splits;
    ax.batch = B;
    ax.a_bs = smk;
    ax.b_bs = 2 * skk;
    ax.c_bs = smk;
    return gemm16::matmul<true, true, false, true>(ax, tile, st);
  }
  // Q (M, K) = Y (M, K) . X^T (K, K), stored in Y's dtype
  if (dtype == 1)
    return gemm::matmul<uint16_t, float, uint16_t, false>(
        static_cast<const uint16_t*>(y), xt, static_cast<uint16_t*>(q),
        nullptr, M, K, K, K, K, K, smk, skk, smk, B, 1, st);
  return gemm::matmul<float, float, float, false>(
      static_cast<const float*>(y), xt, static_cast<float*>(q), nullptr, M,
      K, K, K, K, K, smk, skk, smk, B, 1, st);
}

}  // extern "C"
