// Backward of the fused low-rank linear for Hopper (sm_90a):
//   dh = dy L        (M, K) f32
//   dx = dh R        (M, I) in x's dtype
//   dL = dy^T h      (O, K) f32
//   dR = dh^T x      (K, I) f32
// with dy (M, O), x (M, I) of one dtype (bf16 or f32), h (M, K) the f32 sketch
// x R^T saved by the forward, L (O, K) and R (K, I) in x's dtype. All math
// is f32, as in the oracle repro_torch/kernels/ref.py::lowrank_bwd_ref.
//
// Replaces repro/kernels/lowrank.py::_lowrank_bwd_kernel (reached through
// lowrank_bwd_tiled). The TPU kernel walks the row blocks of M in order on
// one core, keeps dh in VMEM, and accumulates dL (O, K) and dR (K, I) in
// revisited f32 VMEM tiles. On this card blocks run in parallel and in no
// order, and one block has 227 KB of shared memory: dL of mlp/gate|up and
// dR of mlp/down at qwen2-0.5b widths are 4864 x 256 f32 = 4.98 MB each.
// So each product is its own launch, every output tile owned by one block
// that loops over its share of the reduction in a fixed order; where an
// output has few tiles, the wrapper splits the reduction into contiguous
// ranges whose f32 partials a second pass sums in split order. No float
// atomics, so two runs give the same gradients bit for bit.
//
// Two routes, chosen by the wrapper (kernels/lowrank.py):
//
// lowrank_bwd_bf16, bf16 inputs (the training path): the tensor-core
// product of gemm_bf16.cuh (mma.sync m16n8k16 fed by ldmatrix from a
// cp.async ring of 3-4 stages), five launches and their split reduces:
//   1. dh = dy L, one bf16 piece; the epilogue writes dh's first 3 bf16
//      pieces (no f32 dh: nothing reads it);
//   2. the split pass: the saved f32 h into its first 3 bf16 pieces;
//   3. dx = sum_p dh_p R over 2 pieces (a bf16 output: 2^-17 of each term
//      is far below its one rounding);
//   4. dL = sum_p dy^T h_p and 5. dR = sum_p dh_p^T x over 3 pieces (f32
//      outputs: three pieces give h and dh exactly, so every product is
//      exact and only the order of the f32 sums differs from the plain
//      version).
//   What bounds it: operations. One qwen2-0.5b training layer (7 sites, M
//   = 2048) is 45.9 GFLOP of products and 101.6 GFLOP of bf16 mma with
//   these pieces (0.10 ms at 989 TFLOP/s), against ~180 MB of bytes
//   (0.054 ms). The pieces (3 MB each at M = 2048, K = 256) are scratch
//   from the wrapper, written once and read by two products.
//
// lowrank_bwd, f32 inputs and bf16 shapes the 16-byte copies cannot read
// (the f32 route): four launches of the tiled f32 FMA product of
// gemm_f32.cuh, in this order: dh, dx, dL, dR. dh is written to device
// memory once and read back by dx and dR. Bound by operations at the f32
// rate (67 TFLOP/s): 4 M K (O + I) flops.
//
// The kernels allocate nothing: dh, the pieces and the split workspace come
// from the wrapper. The C entry points return cudaGetLastError() of the
// launches.

#include "gemm_bf16.cuh"
#include "gemm_f32.cuh"

namespace {

template <typename T>
int run(const T* dy, const T* x, const float* h, const T* l, const T* r,
        T* dx, float* dl, float* dr, float* dh, float* ws, int M, int I,
        int K, int O, int s_dh, int s_dx, int s_dl, int s_dr,
        cudaStream_t st) {
  int err;
  // dh (M, K) = dy (M, O) . L (O, K)
  err = gemm::matmul<T, T, float, false>(dy, l, dh, ws, M, K, O, O, K, K, 0,
                                         0, 0, 1, s_dh, st);
  if (err) return err;
  // dx (M, I) = dh (M, K) . R (K, I)
  err = gemm::matmul<float, T, T, false>(dh, r, dx, ws, M, I, K, K, I, I, 0,
                                         0, 0, 1, s_dx, st);
  if (err) return err;
  // dL (O, K) = dy^T (O, M) . h (M, K); dy^T(o, m) = dy[m * O + o]
  err = gemm::matmul<T, float, float, true>(dy, h, dl, ws, O, K, M, O, K, K,
                                            0, 0, 0, 1, s_dl, st);
  if (err) return err;
  // dR (K, I) = dh^T (K, M) . x (M, I); dh^T(k, m) = dh[m * K + k]
  return gemm::matmul<float, T, float, true>(dh, x, dr, ws, K, I, M, K, I, I,
                                             0, 0, 0, 1, s_dr, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (dy, x, L, R, dx). s_*: how many
// contiguous ranges each product's reduction is split into (1 = none);
// ws must hold max over the split products of splits * rows * cols floats.
// Returns the cudaError_t of the launches (0 = launched).
int lowrank_bwd(const void* dy, const void* x, const float* h, const void* l,
                const void* r, void* dx, float* dl, float* dr, float* dh,
                float* ws, int M, int I, int K, int O, int dtype, int s_dh,
                int s_dx, int s_dl, int s_dr, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return run<uint16_t>(static_cast<const uint16_t*>(dy),
                         static_cast<const uint16_t*>(x), h,
                         static_cast<const uint16_t*>(l),
                         static_cast<const uint16_t*>(r),
                         static_cast<uint16_t*>(dx), dl, dr, dh, ws, M, I, K,
                         O, s_dh, s_dx, s_dl, s_dr, st);
  return run<float>(static_cast<const float*>(dy),
                    static_cast<const float*>(x), h,
                    static_cast<const float*>(l),
                    static_cast<const float*>(r), static_cast<float*>(dx), dl,
                    dr, dh, ws, M, I, K, O, s_dh, s_dx, s_dl, s_dr, st);
}

// The tensor-core route, bf16 dy, x, L, R, dx. dhp (3, M, K) and hp
// (p_dl, M, K) bf16 scratch for the pieces of dh and h; ws f32 scratch
// for split partials. tile_*: 64 or 128; s_*: reduction ranges; p_*:
// pieces of the f32 operand in dx, dL and dR (p_dx, p_dr <= 3 = the
// pieces dh's epilogue writes).
int lowrank_bwd_bf16(const void* dy, const void* x, const float* h,
                     const void* l, const void* r, void* dx, float* dl,
                     float* dr, void* dhp, void* hp, float* ws, int M, int I,
                     int K, int O, int tile_dh, int s_dh, int tile_dx,
                     int s_dx, int p_dx, int tile_dl, int s_dl, int p_dl,
                     int tile_dr, int s_dr, int p_dr, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long mk = static_cast<long long>(M) * K;
  const uint16_t* dy16 = static_cast<const uint16_t*>(dy);
  const uint16_t* dh16 = static_cast<const uint16_t*>(dhp);
  // dh (M, K) = dy (M, O) . L (O, K): A k-major, B (O, K) n-major
  gemm16::Args a{};
  a.a = dy16;
  a.b = static_cast<const uint16_t*>(l);
  a.M = M;
  a.N = K;
  a.K = O;
  a.lda = O;
  a.ldb = K;
  a.pieces = 1;
  a.mode = gemm16::PIECES;
  a.cp = static_cast<uint16_t*>(dhp);
  a.out_pieces = 3;
  a.cp_ps = mk;
  a.ws = ws;
  a.splits = s_dh;
  int err = gemm16::matmul<true, false>(a, tile_dh, st);
  if (err) return err;
  err = gemm16::split(h, static_cast<uint16_t*>(hp), mk, p_dl, st);
  if (err) return err;
  // dx (M, I) = sum_p dh_p (M, K) . R (K, I)
  gemm16::Args b{};
  b.a = dh16;
  b.b = static_cast<const uint16_t*>(r);
  b.M = M;
  b.N = I;
  b.K = K;
  b.lda = K;
  b.ldb = I;
  b.a_ps = mk;
  b.pieces = p_dx;
  b.mode = gemm16::BF16;
  b.c16 = static_cast<uint16_t*>(dx);
  b.ws = ws;
  b.splits = s_dx;
  err = gemm16::matmul<true, false>(b, tile_dx, st);
  if (err) return err;
  // dL (O, K) = sum_p dy^T (O, M) . h_p (M, K); dy^T(o, m) = dy[m * O + o]
  gemm16::Args c{};
  c.a = dy16;
  c.b = static_cast<const uint16_t*>(hp);
  c.M = O;
  c.N = K;
  c.K = M;
  c.lda = O;
  c.ldb = K;
  c.b_ps = mk;
  c.pieces = p_dl;
  c.mode = gemm16::F32;
  c.c32 = dl;
  c.ws = ws;
  c.splits = s_dl;
  err = gemm16::matmul<false, false>(c, tile_dl, st);
  if (err) return err;
  // dR (K, I) = sum_p dh_p^T (K, M) . x (M, I); dh_p^T(k, m) = dh_p[m * K + k]
  gemm16::Args d{};
  d.a = dh16;
  d.b = static_cast<const uint16_t*>(x);
  d.M = K;
  d.N = I;
  d.K = M;
  d.lda = K;
  d.ldb = I;
  d.a_ps = mk;
  d.pieces = p_dr;
  d.mode = gemm16::F32;
  d.c32 = dr;
  d.ws = ws;
  d.splits = s_dr;
  return gemm16::matmul<false, false>(d, tile_dr, st);
}

}  // extern "C"
