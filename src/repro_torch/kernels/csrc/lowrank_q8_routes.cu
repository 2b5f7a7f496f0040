// The decode and tensor-core routes of the int8 low-rank forward for Hopper
// (sm_90a), kernel #6 redesigned onto kernel #1's two designs:
//   h = (x . Rq^T) * sR     (M, K) f32
//   y = (h . Lq^T) * sL     (M, O) in x's dtype
// x (M, I) bf16 or f32; Rq int8 (K, I), Lq int8 (O, K), sR (K,) and sL
// (O,) f32, all row-major. The contract of the plain version
// repro_torch/kernels/ref.py::lowrank_q8_ref: the factors are converted
// (exactly: an int8 is exact in bf16) and the activation never is (x is
// not quantized, no int8 tensor core runs), both products sum in f32, and
// no dequantized weight is written to device memory: an int8 value
// becomes bf16 in registers (decode) or in a shared-memory tile (tensor
// cores).
//
// Replaces repro/kernels/quant.py::_lowrank_q8_kernel (reached through
// lowrank_q8_tiled) where kernels/quant.py::q8_route sends a call here;
// the one-launch kernel of lowrank_q8.cu stays for f32 x above the
// decode threshold and for widths these routes do not take.
//
// What bounds it on an H100: at decode BYTES, the int8 factors read once
// (1.4 MB at qwen2-0.5b's mlp/gate, half of kernel #1's bf16 bytes); at a
// prefill's M = 1,024 the OPERATIONS of the two products on the tensor
// cores, the second over two bf16 pieces of h.
//
// decode (M <= Q8_DECODE_MAX_M, I and K multiples of 16, 16-byte bases):
//   lowrank_decode.cuh with W = int8_t: the weight is the mma's 16-row
//   side; each lane loads 16 bytes of Rq or Lq (16 values, a 64-deep slice
//   over a row's four lanes, four k16 steps) straight from device memory
//   into registers and converts them to bf16 fragments there; x is loaded
//   under the same assignment of k to fragment positions. h's f32 partials
//   are summed in rank order over the cluster through distributed shared
//   memory, then multiplied by sR; the second launch stages h as three
//   exact bf16 pieces and multiplies its f32 sums by sL at the store.
// tensor_core (bf16 x above the threshold; I, K multiples of 16, O of 8):
//   two products of gemm_bf16.cuh with an int8 B operand (16 values a
//   cp.async, converted to a bf16 tile in shared memory once a step has
//   landed): h = x Rq^T, whose epilogue multiplies by sR and stores the
//   two bf16 pieces of h sR that a bf16 y needs (no f32 h is stored), then
//   y = sum_p (h sR)_p Lq^T with sL on the f32 sum.
// No atomics: two runs give the same bits. The wrapper (kernels/quant.py)
// picks the route, the grid (lowrank.decode_plan) and the tiles and splits
// (lowrank.sketch_plan), and allocates the scratch; the kernels allocate
// nothing and the C entry points return cudaGetLastError() of their
// launches.

#include "lowrank_decode.cuh"

extern "C" {

// Bytes of dynamic shared memory the decode route's second launch takes.
int lowrank_q8_decode_smem_bytes(int nt, int K) {
  return decode::smem_bytes<int8_t>(nt, K);
}

// The decode route. x (M, I) in dtype (0 = float32, 1 = bfloat16); rq, lq
// int8; rs, ls f32; y (M, O) in x's dtype; h (M, K) f32 scratch. nt, wk_h,
// cluster, wk_y as lowrank_decode's.
int lowrank_q8_decode(const void* x, const void* rq, const float* rs,
                      const void* lq, const float* ls, void* y, float* h,
                      int M, int I, int K, int O, int dtype, int nt, int wk_h,
                      int cluster, int wk_y, void* stream) {
  if (M <= 0 || O <= 0) return 0;
  if (int err = decode::check(M, nt, cluster)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  decode::Args gh{rq, x, h, M, K, I, wk_h, 0, rs};
  decode::Args gy{lq, h, y, M, O, K, wk_y, dtype == 1, ls};
  using decode::launch;
  using i8 = int8_t;
  using bf16 = uint16_t;
  const bool f32 = dtype == 0;
  // loads in flight: four 64-deep slices a warp (two with four n8 tiles of
  // bf16 x, one with f32 x, whose 16 values take 64 bytes a row)
  switch (nt) {
    case 1:
      return f32 ? launch<i8, float, 1, 1, 4>(gh, gy, cluster, st)
                 : launch<i8, bf16, 1, 4, 4>(gh, gy, cluster, st);
    case 2:
      return f32 ? launch<i8, float, 2, 1, 4>(gh, gy, cluster, st)
                 : launch<i8, bf16, 2, 4, 4>(gh, gy, cluster, st);
    default:
      return f32 ? launch<i8, float, 4, 1, 4>(gh, gy, cluster, st)
                 : launch<i8, bf16, 4, 2, 4>(gh, gy, cluster, st);
  }
}

// The tensor-core route. x (M, I) bf16; rq int8 (K, I), rs (K,); lq int8
// (O, K), ls (O,); y (M, O) bf16; hp (pieces, M, K) bf16 scratch; ws f32
// scratch for split partials (the wrapper sizes it). tile_*: 64 or 128;
// split_*: ranges of the reduction.
int lowrank_q8_tc(const void* x, const void* rq, const float* rs,
                  const void* lq, const float* ls, void* y, void* hp,
                  float* ws, int M, int I, int K, int O, int pieces,
                  int tile_h, int split_h, int tile_y, int split_y,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gemm16::ArgsX ax{};
  gemm16::Args& a = ax.g;
  a.a = static_cast<const uint16_t*>(x);
  ax.b8 = static_cast<const int8_t*>(rq);
  a.M = M;
  a.N = K;
  a.K = I;
  a.lda = I;
  a.ldb = I;
  a.pieces = 1;
  a.mode = gemm16::PIECES;
  a.cp = static_cast<uint16_t*>(hp);
  a.out_pieces = pieces;
  a.cp_ps = static_cast<long long>(M) * K;
  a.ws = ws;
  a.splits = split_h;
  ax.col_scale = rs;
  int err = gemm16::matmul<true, true, true>(ax, tile_h, st);
  if (err) return err;

  gemm16::ArgsX bx{};
  gemm16::Args& b = bx.g;
  b.a = static_cast<const uint16_t*>(hp);
  bx.b8 = static_cast<const int8_t*>(lq);
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
  bx.col_scale = ls;
  return gemm16::matmul<true, true, true>(bx, tile_y, st);
}

}  // extern "C"
