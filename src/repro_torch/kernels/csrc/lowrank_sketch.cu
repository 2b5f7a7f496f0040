// The sketch-saving forward of the fused low-rank linear for Hopper
// (sm_90a), bf16 operands:
//   h (M, K) = x (M, I) . R^T    f32, saved by the training forward
//   y (M, O) = h . L^T           bf16
// with x (M, I), R (K, I), L (O, K) bf16, every product and sum in f32 as in
// the plain version repro_torch/kernels/ref.py::lowrank_sketch_ref.
//
// Replaces repro/kernels/lowrank.py::_lowrank_sketch_kernel (reached
// through lowrank_fused_tiled(save_sketch=True)). The TPU kernel keeps h in
// VMEM between its two products and writes it once. Training writes h to
// device memory anyway, so here the two products are two launches of the
// tensor-core product of gemm_bf16.cuh on the caller's stream:
//   A: h = x R^T, one bf16 x bf16 piece (exact products, f32 sums); the
//      epilogue stores the f32 h and its first `pieces` bf16 pieces into
//      scratch the wrapper allocates (2 MB a piece at M = 2048, K = 256);
//   B: y = sum_p h_p L^T over those pieces, stored as bf16.
// The f32 sketch kernel (lowrank_fwd.cu, lowrank_fwd_sketch) stays the
// route for f32 inputs and for bf16 shapes whose rows the 16-byte copies
// cannot read (kernels/lowrank.py::tensor_core_route).
//
// The same entry point with h = null is kernel #1's tensor-core route
// (serving, M above the decode route's rows; kernels/lowrank.py::
// forward_route, replacing repro/kernels/lowrank.py::_lowrank_kernel there):
// product A then stores only the pieces of h, and no rank has to fit on
// chip, so zamba2-7b's rank 896 runs the same tiles as qwen2-0.5b's 256.
//
// What bounds it on an H100: as computed here, operations. One qwen2-0.5b
// training layer (7 sites, M = 2048) is 23.0 GFLOP of the function and
// 36.1 GFLOP of bf16 mma with two pieces of h for y: 0.037 ms at 989
// TFLOP/s, beside 0.035 ms for its bytes at 3.35 TB/s. The design:
// mma.sync m16n8k16 from a cp.async ring (gemm_bf16.cuh; why not wgmma
// is said there); output tiles and K splits chosen by the wrapper so the
// few-tile products (h at rank 128-256: 32 tiles of 128 x 128) still
// fill the 132 SMs.
// The kernel allocates nothing. The C entry point returns cudaGetLastError()
// of the launches.

#include "gemm_bf16.cuh"

extern "C" {

// x (M, I), r (K, I), l (O, K) bf16; y (M, O) bf16; h (M, K) f32 or null
// (not stored); hp
// (pieces, M, K) bf16 scratch; ws f32 scratch for split partials (the
// wrapper sizes it). tile_*: 64 or 128; split_*: ranges of the reduction.
int lowrank_sketch_bf16(const void* x, const void* r, const void* l, void* y,
                        float* h, void* hp, float* ws, int M, int I, int K,
                        int O, int pieces, int tile_h, int split_h, int tile_y,
                        int split_y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gemm16::Args a{};
  a.a = static_cast<const uint16_t*>(x);
  a.b = static_cast<const uint16_t*>(r);
  a.M = M;
  a.N = K;
  a.K = I;
  a.lda = I;
  a.ldb = I;
  a.pieces = 1;
  a.mode = gemm16::PIECES;
  a.c32 = h;
  a.cp = static_cast<uint16_t*>(hp);
  a.out_pieces = pieces;
  a.cp_ps = static_cast<long long>(M) * K;
  a.ws = ws;
  a.splits = split_h;
  int err = gemm16::matmul<true, true>(a, tile_h, st);
  if (err) return err;

  gemm16::Args b{};
  b.a = static_cast<const uint16_t*>(hp);
  b.b = static_cast<const uint16_t*>(l);
  b.M = M;
  b.N = O;
  b.K = K;
  b.lda = K;
  b.ldb = K;
  b.a_ps = static_cast<long long>(M) * K;
  b.pieces = pieces;
  b.mode = gemm16::BF16;
  b.c16 = static_cast<uint16_t*>(y);
  b.ws = ws;
  b.splits = split_y;
  return gemm16::matmul<true, true>(b, tile_y, st);
}

}  // extern "C"
