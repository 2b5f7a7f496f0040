// The decode route's two skinny products, shared by kernel #1's decode route
// (lowrank_decode.cu: bf16 or f32 factors) and kernel #6's
// (lowrank_q8_routes.cu: int8 factors with per-row f32 scales). The design
// is said in lowrank_decode.cu; what the weight type changes is said here.
//
// Template parameters: W, the weight's element type (uint16_t = bf16 bits,
// float, int8_t), and X, the activation's (uint16_t or float). A lane loads
// V consecutive values of a weight row, 16 bytes of bf16 or int8 or 32 of
// f32: V = 8 for bf16 and f32 weights (a 32-deep slice over the warp's four
// lanes of a row, two k16 steps), V = 16 for int8 weights (one 16-byte load
// covers 16 values: a 64-deep slice, four k16 steps). The V values become
// V / 2 bf16 words w[e] (elements 2e, 2e + 1), and k16 step s takes words
// 2s, 2s + 1; the other operand (x, or the staged pieces of h) is loaded
// under the same assignment, so each product is a permutation of the
// reduction that the two sides agree on. An int8 is exact in bf16 (|v| <=
// 127 needs 7 significand bits), so an int8 weight is one exact piece and
// only the order of the f32 sums differs from the plain version's. With
// int8 weights the sums of h = x Rq^T are scaled by sR once, after the
// cluster's rank-ordered sum, and y = h Lq^T by sL at the store.
// kernels/lowrank.py::decode_plan (its `slice` is 4 V) and decode_smem_bytes
// mirror the grid and the staged bytes.
//
// The weight's rows may lie further apart than its width (Args::lda): a
// rank draft reads the leading K' columns of the resident L (O, K) where
// they lie, rows K apart, with no copy. Each lane's 16-byte load then
// needs lda to keep 16-byte rows: a multiple of 8 elements for bf16 and
// f32 weights, of 16 for int8 (kernels/lowrank.py::aligned, quant.py's
// q8_route).
#pragma once

#include <cooperative_groups.h>

#include "gemm_bf16.cuh"

namespace decode {
namespace {

namespace cg = cooperative_groups;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_NT = 4;     // n8 tiles: M <= 32
constexpr int MAX_ROWS = 16 * WARPS;   // rows of A a block covers (wk = 1)
constexpr int MAX_CLUSTER = 8;
// static shared memory of either launch per n8 tile: red and tile, 4 KB each
constexpr int STATIC_SMEM = 8192;

// values of a weight row a lane loads per slice, and bf16 pieces per value
template <typename W>
__host__ __device__ constexpr int lane_values() {
  return sizeof(W) == 1 ? 16 : 8;
}
template <typename T>
__host__ __device__ constexpr int pieces() {
  return sizeof(T) == 4 ? 3 : 1;
}

// V consecutive values of an operand row as the bf16 words a lane feeds
// the mma: w[q][e] holds elements 2e, 2e + 1 of piece q.
template <typename T, int V>
struct Chunk {
  static constexpr int P = pieces<T>();
  static constexpr int RAW = V * static_cast<int>(sizeof(T)) / 16;
  uint4 raw[RAW];
  __device__ __forceinline__ void load(const void* base, size_t at,
                                       bool valid) {
    const uint4* p =
        reinterpret_cast<const uint4*>(static_cast<const T*>(base) + at);
#pragma unroll
    for (int r = 0; r < RAW; ++r)
      raw[r] = valid ? __ldg(p + r) : make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ void words(uint32_t (&w)[P][V / 2]) const {
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int r = 0; r < RAW; ++r) {
        w[0][4 * r] = raw[r].x;
        w[0][4 * r + 1] = raw[r].y;
        w[0][4 * r + 2] = raw[r].z;
        w[0][4 * r + 3] = raw[r].w;
      }
    } else if constexpr (sizeof(T) == 1) {
#pragma unroll
      for (int r = 0; r < RAW; ++r) {
        gemm16::i8x4_bf16(raw[r].x, w[0][8 * r], w[0][8 * r + 1]);
        gemm16::i8x4_bf16(raw[r].y, w[0][8 * r + 2], w[0][8 * r + 3]);
        gemm16::i8x4_bf16(raw[r].z, w[0][8 * r + 4], w[0][8 * r + 5]);
        gemm16::i8x4_bf16(raw[r].w, w[0][8 * r + 6], w[0][8 * r + 7]);
      }
    } else {
      uint32_t u[4 * RAW];
#pragma unroll
      for (int r = 0; r < RAW; ++r) {
        u[4 * r] = raw[r].x;
        u[4 * r + 1] = raw[r].y;
        u[4 * r + 2] = raw[r].z;
        u[4 * r + 3] = raw[r].w;
      }
#pragma unroll
      for (int e = 0; e < V / 2; ++e) {
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

// acc[nt] += A (16 rows, 4 V deep) . B (8 rows of n8 tile nt)^T over every
// pair of pieces, in a fixed order: k16 step, A's piece, B's piece, tile.
template <int PA, int PB, int NT, int V>
__device__ __forceinline__ void slice_mma(float (&acc)[NT][4],
                                          const uint32_t (&a0)[PA][V / 2],
                                          const uint32_t (&a1)[PA][V / 2],
                                          const uint32_t (&b)[NT][PB][V / 2]) {
#pragma unroll
  for (int s = 0; s < V / 4; ++s)
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
  const void* a;   // (N, J) rows lda apart: R, then L
  const void* b;   // (M, J) row-major: x (first product), h f32 (second)
  void* out;       // h f32 (M, N) (first), y (M, N) in x's dtype (second)
  int M, N, J;
  int wk;          // warps along J in a block (1, 2, 4 or 8)
  int out_bf16;
  const float* scale;  // int8 weights: the per-row scales of a (N,)
  int lda;         // row stride of a in elements, >= J: J for a contiguous
                   // factor, the full rank for a rank draft's L[:, :K']
};

// h (M, K) = x R^T. grid (cluster, ceil(K / (16 * 8 / wk))), clusters of
// `cluster` blocks along x; block rank c takes range c of the reduction.
template <typename W, typename X, int NT, int U>
__global__ void __launch_bounds__(THREADS) decode_h(const Args g) {
  constexpr int V = lane_values<W>(), SLICE = 4 * V;
  constexpr int PA = pieces<W>(), PB = pieces<X>();
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
    Chunk<W, V> a0[U], a1[U];
    Chunk<X, V> b[U][NT];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int j = (u + q) * SLICE + V * tq;
      const bool in = u + q < u1 && j < g.J;
      a0[q].load(g.a, static_cast<size_t>(ra) * g.lda + j, in && ra < g.N);
      a1[q].load(g.a, static_cast<size_t>(rb) * g.lda + j, in && rb < g.N);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int m = nt * 8 + gq;
        b[q][nt].load(g.b, static_cast<size_t>(m) * g.J + j, in && m < g.M);
      }
    }
#pragma unroll
    for (int q = 0; q < U; ++q) {
      uint32_t w0[PA][V / 2], w1[PA][V / 2], wb[NT][PB][V / 2];
      a0[q].words(w0);
      a1[q].words(w1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) b[q][nt].words(wb[nt]);
      slice_mma<PA, PB, NT, V>(acc, w0, w1, wb);
    }
  }
  reduce_warps<NT>(acc, red, tile, g.wk);

  // rank c stores its share of the block's h tile, summed over the ranks
  // (and, for int8 weights, then scaled by sR)
  cluster.sync();
  const int count = g.M * rows;
  float* h = static_cast<float*>(g.out);
  for (int e = rank * count / ranks + threadIdx.x;
       e < (rank + 1) * count / ranks; e += THREADS) {
    const int m = e / rows, r = e % rows;
    const int col = blockIdx.y * rows + r;
    float v = 0.f;
    for (int c = 0; c < ranks; ++c) v += cluster.map_shared_rank(tile, c)[e];
    if (col < g.N) {
      if constexpr (sizeof(W) == 1) v *= g.scale[col];
      h[static_cast<size_t>(m) * g.N + col] = v;
    }
  }
  cluster.sync();   // no block leaves while a peer reads its tile
}

// Row stride (bf16) of the staged pieces of h, so that the 16-byte reads of
// a quarter warp (two rows x four lanes) hit distinct banks: rows of 64 c +
// 32 elements when a lane reads 8 values at 16 tq (64 bytes between rows
// mod 128), 64 c + 8 when it reads 16 at 32 tq (16 bytes mod 128).
template <int V>
__host__ __device__ inline int staged_stride(int J) {
  return (J + 63) / 64 * 64 + (V == 8 ? 32 : 8);
}

// y (M, O) = h L^T. grid ceil(O / (16 * 8 / wk)); dynamic shared memory:
// 3 pieces x 8 NT rows x staged_stride(K) bf16.
template <typename W, int NT, int U>
__global__ void __launch_bounds__(THREADS) decode_y(const Args g) {
  constexpr int V = lane_values<W>(), SLICE = 4 * V;
  constexpr int PA = pieces<W>(), PB = 3;
  __shared__ float red[WARPS * NT * 4][32];
  __shared__ float tile[8 * NT * MAX_ROWS];
  extern __shared__ __align__(16) uint16_t hs[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int rows = 16 * (WARPS / g.wk);
  const int n0 = blockIdx.x * rows + (warp / g.wk) * 16;
  const int slices = (g.J + SLICE - 1) / SLICE;
  const int stride = staged_stride<V>(g.J), span = slices * SLICE;
  const float* h = static_cast<const float*>(g.b);
  int u0, u1;
  warp_range(0, slices, warp % g.wk, g.wk, u0, u1);
  const int ra = n0 + gq, rb = n0 + gq + 8;
  Chunk<W, V> a0[U], a1[U];
  auto load_a = [&](int u) {
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int j = (u + q) * SLICE + V * tq;
      const bool in = u + q < u1 && j < g.J;
      a0[q].load(g.a, static_cast<size_t>(ra) * g.lda + j, in && ra < g.N);
      a1[q].load(g.a, static_cast<size_t>(rb) * g.lda + j, in && rb < g.N);
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
      const int j = (u + q) * SLICE + V * tq;
      uint32_t w0[PA][V / 2], w1[PA][V / 2], wb[NT][PB][V / 2];
      a0[q].words(w0);
      a1[q].words(w1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int qb = 0; qb < PB; ++qb)
#pragma unroll
          for (int r = 0; r < V / 8; ++r) {
            // a slice past u1 has A = 0 and adds nothing; its read stays
            // inside the staged rows
            const uint4 v = *reinterpret_cast<const uint4*>(
                hs + (qb * 8 * NT + nt * 8 + gq) * stride +
                (u + q < u1 ? j : 0) + 8 * r);
            wb[nt][qb][4 * r] = v.x;
            wb[nt][qb][4 * r + 1] = v.y;
            wb[nt][qb][4 * r + 2] = v.z;
            wb[nt][qb][4 * r + 3] = v.w;
          }
      slice_mma<PA, PB, NT, V>(acc, w0, w1, wb);
    }
  }
  reduce_warps<NT>(acc, red, tile, g.wk);

  for (int e = threadIdx.x; e < g.M * rows; e += THREADS) {
    const int m = e / rows, r = e % rows;
    const int col = blockIdx.x * rows + r;
    if (col >= g.N) continue;
    const size_t at = static_cast<size_t>(m) * g.N + col;
    float v = tile[e];
    if constexpr (sizeof(W) == 1) v *= g.scale[col];
    if (g.out_bf16)
      static_cast<uint16_t*>(g.out)[at] = gemm16::bf16_bits(v);
    else
      static_cast<float*>(g.out)[at] = v;
  }
}

// Bytes of dynamic shared memory the second launch takes.
template <typename W>
inline int smem_bytes(int nt, int K) {
  return 3 * 8 * nt * staged_stride<lane_values<W>()>(K) * 2;
}

// The two launches on `st`: UH and UY slices' loads in flight per warp.
template <typename W, typename X, int NT, int UH, int UY>
int launch(const Args& gh, const Args& gy, int cluster, cudaStream_t st) {
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
  cudaError_t err = cudaLaunchKernelEx(&cfg, decode_h<W, X, NT, UH>, gh);
  if (err != cudaSuccess) return static_cast<int>(err);

  // the second launch may start as soon as every block of the first has
  // started (griddepcontrol.launch_dependents); it waits for the first's
  // h (griddepcontrol.wait) only after loading its first slices of L
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3((gy.N + rows_y - 1) / rows_y);
  cfg.dynamicSmemBytes = smem_bytes<W>(NT, gy.J);

  static bool attr_set = false;
  if (!attr_set) {
    err = cudaFuncSetAttribute(decode_y<W, NT, UY>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               227 * 1024 - STATIC_SMEM * NT);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  err = cudaLaunchKernelEx(&cfg, decode_y<W, NT, UY>, gy);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Check the launch shape both entry points share (0 = fine): the row
// stride of L holds its K values.
inline int check(int M, int nt, int cluster, int K, int ldl) {
  if (nt < 1 || nt > MAX_NT || 8 * nt < M || cluster < 1 ||
      cluster > MAX_CLUSTER || ldl < K)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace
}  // namespace decode
