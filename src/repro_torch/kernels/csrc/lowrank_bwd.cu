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
//
// Design. Four launches of one tiled f32 product (gemm_f32.cuh) on the
// caller's stream, in this order: dh, dx, dL, dR. Every output tile is
// owned by one block, which loops over the whole reduction (O for dh, K for
// dx, M for dL and dR) in a fixed order; where an output has few tiles (the
// rank-K dR of attn/wq at 4 x 14 tiles, dL of attn/wk|wv at 2 x 2), the
// wrapper asks for the M reduction to be split into contiguous ranges whose
// f32 partials a second pass sums in split order. No float atomics, so two
// runs give the same gradients bit for bit.
//   * dh is written to device memory once (M x K f32, 2.1 MB at M = 2048,
//     K = 256) and read back by dx and dR. This trades the TPU kernel's
//     on-chip dh for one write and two reads of it, about 6 MB per site,
//     against some 35 MB the function must move at an mlp site in bf16.
//   * What bounds it: operations. Every product has an f32 operand (h, dh)
//     or, for dh = dy L, runs with the others on the same FMA path, at the
//     card's f32 rate (67 TFLOP/s on an H100 SXM): 4 M K (O + I) flops,
//     12 GFLOP for one mlp/gate site at M = 2048 (180 us at that rate),
//     against 35 MB of bytes (10 us at 3.35 TB/s). Tensor cores (mma.sync
//     for the bf16 dh = dy L; TF32x3 or wgmma for the f32 products) are the
//     next step, for a later change.
// The kernel allocates nothing: dh and the split workspace come from the
// wrapper. The C entry point returns cudaGetLastError() of the launches.

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

}  // extern "C"
