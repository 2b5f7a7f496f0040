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
// No atomics anywhere: two runs give the same bits. The wrapper
// (kernels/lowrank.py::decode_plan) picks wk, the cluster size and the n8
// tiles; the kernel allocates nothing and returns cudaGetLastError() of
// its launches.

#include <cooperative_groups.h>

#include "gemm_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int SLICE = 32;     // reduction depth of one lane load (2 k16 steps)
constexpr int MAX_NT = 4;     // n8 tiles: M <= 32
constexpr int MAX_ROWS = 16 * WARPS;   // rows of A a block covers (wk = 1)
constexpr int MAX_CLUSTER = 8;
// static shared memory of either launch per n8 tile: red and tile, 4 KB each
constexpr int STATIC_SMEM = 8192;

// 8 consecutive values of an operand row as the bf16 words a lane feeds
// the mma: w[q][e] holds elements 2e, 2e + 1 of piece q.
template <bool F32, int P>
struct Chunk {
  uint4 raw[F32 ? 2 : 1];
  __device__ __forceinline__ void load(const void* base, size_t at,
                                       bool valid) {
    if constexpr (F32) {
      const uint4* p = reinterpret_cast<const uint4*>(
          static_cast<const float*>(base) + at);
      raw[0] = valid ? __ldg(p) : make_uint4(0, 0, 0, 0);
      raw[1] = valid ? __ldg(p + 1) : make_uint4(0, 0, 0, 0);
    } else {
      const uint4* p = reinterpret_cast<const uint4*>(
          static_cast<const uint16_t*>(base) + at);
      raw[0] = valid ? __ldg(p) : make_uint4(0, 0, 0, 0);
    }
  }
  __device__ __forceinline__ void words(uint32_t (&w)[P][4]) const {
    if constexpr (!F32) {
      w[0][0] = raw[0].x;
      w[0][1] = raw[0].y;
      w[0][2] = raw[0].z;
      w[0][3] = raw[0].w;
    } else {
      const uint32_t u[8] = {raw[0].x, raw[0].y, raw[0].z, raw[0].w,
                             raw[1].x, raw[1].y, raw[1].z, raw[1].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint16_t p0[3], p1[3];
        gemm16::split_bf16(__uint_as_float(u[2 * e]), P, p0);
        gemm16::split_bf16(__uint_as_float(u[2 * e + 1]), P, p1);
#pragma unroll
        for (int q = 0; q < P; ++q)
          w[q][e] = p0[q] | (static_cast<uint32_t>(p1[q]) << 16);
      }
    }
  }
};

// acc[nt] += A (16 rows, 32 deep) . B (8 rows of n8 tile nt)^T over every
// pair of pieces, in a fixed order.
template <int PA, int PB, int NT>
__device__ __forceinline__ void slice_mma(float (&acc)[NT][4],
                                          const uint32_t (&a0)[PA][4],
                                          const uint32_t (&a1)[PA][4],
                                          const uint32_t (&b)[NT][PB][4]) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int qa = 0; qa < PA; ++qa) {
      const uint32_t af[4] = {a0[qa][2 * s], a1[qa][2 * s],
                              a0[qa][2 * s + 1], a1[qa][2 * s + 1]};
#pragma unroll
      for (int qb = 0; qb < PB; ++qb)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          gemm16::mma_bf16(acc[nt], af, b[nt][qb][2 * s],
                           b[nt][qb][2 * s + 1]);
    }
}

// The slices [u0, u1) of warp `wkk` of `wk` within range [t0, t1).
__device__ __forceinline__ void warp_range(int t0, int t1, int wkk, int wk,
                                           int& u0, int& u1) {
  const int n = t1 - t0;
  u0 = t0 + wkk * n / wk;
  u1 = t0 + (wkk + 1) * n / wk;
}

// Sum the wk warps' accumulators of each row tile in warp order into
// tile[m][r] (m < 8 NT, r < 16 * 8 / wk). Ends with the block synchronized.
template <int NT>
__device__ __forceinline__ void reduce_warps(const float (&acc)[NT][4],
                                             float (*red)[32], float* tile,
                                             int wk) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) red[warp * NT * 4 + nt * 4 + i][lane] =
        acc[nt][i];
  __syncthreads();
  const int rows = 16 * (WARPS / wk);
  for (int e = threadIdx.x; e < 8 * NT * rows; e += THREADS) {
    const int m = e / rows, r = e % rows;
    const int wr = r / 16, rr = r % 16;
    const int lane_of = (rr % 8) * 4 + (m % 8) / 2;
    const int i = (m % 2) + 2 * (rr / 8);
    float v = 0.f;
    for (int q = 0; q < wk; ++q)
      v += red[(wr * wk + q) * NT * 4 + (m / 8) * 4 + i][lane_of];
    tile[e] = v;
  }
  __syncthreads();
}

struct Args {
  const void* a;   // (N, J) row-major: R, then L
  const void* b;   // (M, J) row-major: x (first product), h f32 (second)
  void* out;       // h f32 (M, N) (first), y (M, N) in x's dtype (second)
  int M, N, J;
  int wk;          // warps along J in a block (1, 2, 4 or 8)
  int out_bf16;
};

// h (M, K) = x R^T. grid (cluster, ceil(K / (16 * 8 / wk))), clusters of
// `cluster` blocks along x; block rank c takes range c of the reduction.
template <bool F32, int NT, int U>
__global__ void __launch_bounds__(THREADS) decode_h(const Args g) {
  constexpr int P = F32 ? 3 : 1;
  __shared__ float red[WARPS * NT * 4][32];
  __shared__ float tile[8 * NT * MAX_ROWS];
  // let the second launch (y = h L^T) start loading L now
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int rows = 16 * (WARPS / g.wk);
  const int n0 = blockIdx.y * rows + (warp / g.wk) * 16;
  const int slices = (g.J + SLICE - 1) / SLICE;
  int u0, u1;
  warp_range(rank * slices / ranks, (rank + 1) * slices / ranks,
             warp % g.wk, g.wk, u0, u1);

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  const int ra = n0 + gq, rb = n0 + gq + 8;
  for (int u = u0; u < u1; u += U) {
    Chunk<F32, P> a0[U], a1[U], b[U][NT];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int j = (u + q) * SLICE + 8 * tq;
      const bool in = u + q < u1 && j < g.J;
      a0[q].load(g.a, static_cast<size_t>(ra) * g.J + j, in && ra < g.N);
      a1[q].load(g.a, static_cast<size_t>(rb) * g.J + j, in && rb < g.N);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int m = nt * 8 + gq;
        b[q][nt].load(g.b, static_cast<size_t>(m) * g.J + j, in && m < g.M);
      }
    }
#pragma unroll
    for (int q = 0; q < U; ++q) {
      uint32_t w0[P][4], w1[P][4], wb[NT][P][4];
      a0[q].words(w0);
      a1[q].words(w1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) b[q][nt].words(wb[nt]);
      slice_mma<P, P, NT>(acc, w0, w1, wb);
    }
  }
  reduce_warps<NT>(acc, red, tile, g.wk);

  // rank c stores its share of the block's h tile, summed over the ranks
  cluster.sync();
  const int count = g.M * rows;
  float* h = static_cast<float*>(g.out);
  for (int e = rank * count / ranks + threadIdx.x;
       e < (rank + 1) * count / ranks; e += THREADS) {
    const int m = e / rows, r = e % rows;
    const int col = blockIdx.y * rows + r;
    float v = 0.f;
    for (int c = 0; c < ranks; ++c) v += cluster.map_shared_rank(tile, c)[e];
    if (col < g.N) h[static_cast<size_t>(m) * g.N + col] = v;
  }
  cluster.sync();   // no block leaves while a peer reads its tile
}

// Row stride (bf16) of the staged pieces of h: rows of 32 + 64 c elements,
// so the 16-byte reads of 8 lanes (two rows x four columns) hit 8 banks
// groups apart.
__host__ __device__ inline int staged_stride(int J) {
  return (J + 63) / 64 * 64 + 32;
}

// y (M, O) = h L^T. grid ceil(O / (16 * 8 / wk)); dynamic shared memory:
// 3 pieces x 8 NT rows x staged_stride(K) bf16.
template <bool F32, int NT, int U>
__global__ void __launch_bounds__(THREADS) decode_y(const Args g) {
  constexpr int PA = F32 ? 3 : 1, PB = 3;
  __shared__ float red[WARPS * NT * 4][32];
  __shared__ float tile[8 * NT * MAX_ROWS];
  extern __shared__ __align__(16) uint16_t hs[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int rows = 16 * (WARPS / g.wk);
  const int n0 = blockIdx.x * rows + (warp / g.wk) * 16;
  const int slices = (g.J + SLICE - 1) / SLICE;
  const int stride = staged_stride(g.J), span = slices * SLICE;
  const float* h = static_cast<const float*>(g.b);
  int u0, u1;
  warp_range(0, slices, warp % g.wk, g.wk, u0, u1);
  const int ra = n0 + gq, rb = n0 + gq + 8;
  Chunk<F32, PA> a0[U], a1[U];
  auto load_a = [&](int u) {
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int j = (u + q) * SLICE + 8 * tq;
      const bool in = u + q < u1 && j < g.J;
      a0[q].load(g.a, static_cast<size_t>(ra) * g.J + j, in && ra < g.N);
      a1[q].load(g.a, static_cast<size_t>(rb) * g.J + j, in && rb < g.N);
    }
  };
  // L does not depend on h: the first slices load while the first launch
  // still runs (this launch is a programmatic dependent of it)
  load_a(u0);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // stage the pieces of h: hs[(q * 8 NT + m) * stride + j], zeros past M, J
  for (int e = threadIdx.x; e < 8 * NT * span; e += THREADS) {
    const int m = e / span, j = e % span;
    const float v = m < g.M && j < g.J ? h[static_cast<size_t>(m) * g.J + j]
                                       : 0.f;
    uint16_t p[3];
    gemm16::split_bf16(v, PB, p);
#pragma unroll
    for (int q = 0; q < PB; ++q) hs[(q * 8 * NT + m) * stride + j] = p[q];
  }
  __syncthreads();

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  for (int u = u0; u < u1; u += U) {
    if (u != u0) load_a(u);
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int j = (u + q) * SLICE + 8 * tq;
      uint32_t w0[PA][4], w1[PA][4], wb[NT][PB][4];
      a0[q].words(w0);
      a1[q].words(w1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int qb = 0; qb < PB; ++qb) {
          // a slice past u1 has A = 0 and adds nothing; its read stays
          // inside the staged rows
          const uint4 v = *reinterpret_cast<const uint4*>(
              hs + (qb * 8 * NT + nt * 8 + gq) * stride +
              (u + q < u1 ? j : 0));
          wb[nt][qb][0] = v.x;
          wb[nt][qb][1] = v.y;
          wb[nt][qb][2] = v.z;
          wb[nt][qb][3] = v.w;
        }
      slice_mma<PA, PB, NT>(acc, w0, w1, wb);
    }
  }
  reduce_warps<NT>(acc, red, tile, g.wk);

  for (int e = threadIdx.x; e < g.M * rows; e += THREADS) {
    const int m = e / rows, r = e % rows;
    const int col = blockIdx.x * rows + r;
    if (col >= g.N) continue;
    const size_t at = static_cast<size_t>(m) * g.N + col;
    if (g.out_bf16)
      static_cast<uint16_t*>(g.out)[at] = gemm16::bf16_bits(tile[e]);
    else
      static_cast<float*>(g.out)[at] = tile[e];
  }
}

template <bool F32, int NT>
int launch(const Args& gh, const Args& gy, int cluster, cudaStream_t st) {
  constexpr int U = F32 ? 2 : 4;
  const int rows_h = 16 * (WARPS / gh.wk), rows_y = 16 * (WARPS / gy.wk);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster, (gh.N + rows_h - 1) / rows_h);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, decode_h<F32, NT, U>, gh);
  if (err != cudaSuccess) return static_cast<int>(err);

  // the second launch may start as soon as every block of the first has
  // started (griddepcontrol.launch_dependents); it waits for the first's
  // h (griddepcontrol.wait) only after loading its first slices of L
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3((gy.N + rows_y - 1) / rows_y);
  cfg.dynamicSmemBytes = 3 * 8 * NT * staged_stride(gy.J) * 2;

  static bool attr_set = false;
  if (!attr_set) {
    err = cudaFuncSetAttribute(decode_y<F32, NT, U>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               227 * 1024 - STATIC_SMEM * NT);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  err = cudaLaunchKernelEx(&cfg, decode_y<F32, NT, U>, gy);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the second launch takes (the wrapper
// checks it against the card's limit).
int lowrank_decode_smem_bytes(int nt, int K) {
  return 3 * 8 * nt * staged_stride(K) * 2;
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
  if (nt < 1 || nt > MAX_NT || 8 * nt < M || cluster < 1 ||
      cluster > MAX_CLUSTER)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args gh{r, x, h, M, K, I, wk_h, 0};
  Args gy{l, h, y, M, O, K, wk_y, dtype == 1};
  const bool f32 = dtype == 0;
  switch (nt) {
    case 1:
      return f32 ? launch<true, 1>(gh, gy, cluster, st)
                 : launch<false, 1>(gh, gy, cluster, st);
    case 2:
      return f32 ? launch<true, 2>(gh, gy, cluster, st)
                 : launch<false, 2>(gh, gy, cluster, st);
    default:
      return f32 ? launch<true, 4>(gh, gy, cluster, st)
                 : launch<false, 4>(gh, gy, cluster, st);
  }
}

}  // extern "C"
