// The decode route of the fused low-rank forward for Hopper (sm_90a):
//   h (M, K) = x (M, I) . R^T    f32
//   y (M, O) = h . L^T           in x's dtype
// for the few rows of a decode step (the kernel takes M <= 32; the route
// rule sends it M <= 8), bf16 or f32, with every
// product and sum in f32 and one rounding of y, as the plain version
// repro_torch/kernels/ref.py::lowrank_matmul_ref.
//
// Replaces, for small M, repro/kernels/lowrank.py::_lowrank_kernel (reached
// through lowrank_fused_tiled); kernels/lowrank.py::forward_route sends a
// call here when M <= DECODE_MAX_M and every width is a multiple of 8 with
// 16-byte aligned bases. Larger M takes the tensor-core product of
// lowrank_sketch.cu (bf16) or lowrank_fwd.cu (f32, other shapes).
//
// What bounds it on an H100: BYTES. R and L are read once (2 (K I + O K)
// bytes in bf16: 0.9 MB at qwen2-0.5b's attn/wq, 32 MB at zamba2-7b's
// in_proj), x, h and y are a few KB. The work is 2 M K (I + O) flops, M <=
// 32 of them per weight element: far below the 295 flops a byte at which
// the tensor cores, not the memory, would be the limit.
//
// Design: two launches on the caller's stream, one per product (the second
// a programmatic dependent launch: it starts while the first runs, loads
// its first slices of L, and only then waits for h), each a
// "skinny" product out (M, N) = B (M, J) . A (N, J)^T with the weight A (R,
// then L) as the 16-row side of mma.sync m16n8k16 and the few rows of B (x,
// then h) as its 8-column side (one to four n8 tiles cover M):
//   * A is read straight from device memory into registers, 16 bytes a
//     lane, never staged: lane (g, t) of a warp loads rows g and g + 8 of
//     its 16-row tile at columns [j0 + 8 t, j0 + 8 t + 8) of a 32-deep
//     slice. The reduction order inside a slice is free (every product is
//     exact, only the f32 sums' order moves), so those 8 columns are
//     assigned to the fragment positions the lane holds in two k16 steps
//     (words 0, 1 in step 0, words 2, 3 in step 1), and B is loaded with
//     the same assignment: one 16-byte load of B a lane and n8 tile. No
//     ldmatrix, no shared-memory tile, no bank conflicts, and four slices'
//     loads are issued before the first multiplies, so each warp keeps 128
//     (bf16) bytes a lane in flight.
//   * f32 operands enter as three bf16 pieces (hi, mid, lo: exact, see
//     gemm_bf16.cuh): a f32 x R^T sums the 9 exact piece products, h . L^T
//     sums 3 (bf16 L) or 9 (f32 L); bf16 x R^T is one exact product. So
//     every product is exact (a bf16 one is what the plain version forms,
//     an f32 one what it rounds once) and only the f32 sums' order
//     differs.
//   * A block is 8 warps: 8 / wk row tiles of 16 times wk warps that split
//     the block's reduction range. Their partials are summed through shared
//     memory in warp order.
//   * h = x R^T: where the rank alone gives too few blocks (K = 128-256 at
//     qwen2-0.5b, 896 with zamba2-7b's 56 row tiles) the reduction I is
//     also split over the `cluster` blocks of a thread-block cluster, whose
//     partial tiles are summed in rank order through distributed shared
//     memory; each rank stores its share of h (f32, M x K, to device
//     memory: a few KB).
//   * y = h L^T: each block first stages h, cut into its three pieces, in
//     shared memory (rows padded so the 16-byte reads are conflict-free),
//     then reads L as above.
// What holds it back (chip_smoke.py phase 3 on an H100): a qwen2-0.5b
// decode layer's 7 sites take 0.064 ms, 1.2x two library matmuls, 7-10 us
// a site however few its bytes (two dependent launches, a cluster barrier,
// three dependent memory round trips); zamba2-7b's in_proj at M = 4 pulls
// 1.3 TB/s. More than 8 rows (two or four n8 tiles) cost more than the
// tensor-core route from the large shapes on.
// The kernels live in lowrank_decode.cuh, templated on the weight type, so
// that kernel #6's decode route (lowrank_q8_routes.cu) runs the same code
// with int8 factors.
// No atomics anywhere: two runs give the same bits. The wrapper
// (kernels/lowrank.py::decode_plan) picks wk, the cluster size and the n8
// tiles; the kernel allocates nothing and returns cudaGetLastError() of
// its launches.

#include "lowrank_decode.cuh"

extern "C" {

// Bytes of dynamic shared memory the second launch takes (the wrapper
// checks it against the card's limit).
int lowrank_decode_smem_bytes(int nt, int K) {
  return decode::smem_bytes<uint16_t>(nt, K);
}

// x (M, I), r (K, I), l (O, K) row-major, one dtype (0 = float32, 1 =
// bfloat16); y (M, O) in that dtype; h (M, K) f32 scratch. nt: n8 tiles
// (1, 2 or 4; 8 nt >= M). wk_h, wk_y: warps along the reduction in a block
// of each launch (1, 2, 4 or 8). cluster: blocks of a cluster along I in
// the first launch (1-8). Widths multiples of 8, bases 16-byte aligned.
int lowrank_decode(const void* x, const void* r, const void* l, void* y,
                   float* h, int M, int I, int K, int O, int dtype, int nt,
                   int wk_h, int cluster, int wk_y, void* stream) {
  if (M <= 0 || O <= 0) return 0;
  if (int err = decode::check(M, nt, cluster)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  decode::Args gh{r, x, h, M, K, I, wk_h, 0, nullptr};
  decode::Args gy{l, h, y, M, O, K, wk_y, dtype == 1, nullptr};
  using decode::launch;
  using bf16 = uint16_t;
  const bool f32 = dtype == 0;
  switch (nt) {
    case 1:
      return f32 ? launch<float, float, 1, 2, 2>(gh, gy, cluster, st)
                 : launch<bf16, bf16, 1, 4, 4>(gh, gy, cluster, st);
    case 2:
      return f32 ? launch<float, float, 2, 2, 2>(gh, gy, cluster, st)
                 : launch<bf16, bf16, 2, 4, 4>(gh, gy, cluster, st);
    default:
      return f32 ? launch<float, float, 4, 2, 2>(gh, gy, cluster, st)
                 : launch<bf16, bf16, 4, 4, 4>(gh, gy, cluster, st);
  }
}

}  // extern "C"
