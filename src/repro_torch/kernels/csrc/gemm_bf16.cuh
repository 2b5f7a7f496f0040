// Tensor-core matrix product over bf16 pieces, shared by the bf16 sketch
// forward (lowrank_sketch.cu) and the bf16 backward (lowrank_bwd.cu):
//
//   C (M, N) = sum over p < P of A_p (M, K) . B_p (K, N)
//
// with bf16 operands and f32 accumulators. A_p = a + p * a_ps and B_p = b +
// p * b_ps, so one operand may be a stack of P bf16 pieces of an f32 matrix
// (piece stride M * K) while the other is shared (stride 0). Either operand
// may be stored in either major order:
//   A_K: A(m, k) = a[m * lda + k] (k contiguous), else A(m, k) = a[k * lda + m]
//   B_K: B(k, n) = b[n * ldb + k] (k contiguous), else B(k, n) = b[k * ldb + n]
// so the backward's dy^T, dh^T, R and L are read as stored.
//
// Why pieces. An f32 value v splits into bf16 pieces hi = bf16(v), mid =
// bf16(v - hi), lo = bf16(v - hi - mid); each subtraction is exact, and
// three pieces give v exactly (two give v within 2^-17 |v|). A bf16 x bf16
// product is exact in the f32 accumulator, so sum_p A_p B is an f32 sum of
// exact products of the bf16 operand and the f32 one: the f32 contract of
// the plain versions (ref.py), on the bf16 tensor cores at P times the
// product's flops. split_bf16 is the one splitting rule; every epilogue
// and the split pass call it, so pieces always sum to the stored f32.
//
// Design: mma.sync m16n8k16 (bf16 in, f32 accumulate), fed by ldmatrix
// (.trans for an M-major A or an N-major B) from a ring of shared-memory
// tiles filled by cp.async (16 bytes a copy, zero-filled outside the
// matrix, so ragged M needs no masks in the math); each 16-deep slice's
// fragments load while the previous slice multiplies. Tile rows are
// padded by 8 bf16, which keeps every ldmatrix phase free of bank
// conflicts. Steps are BK = 64 deep. Two tile shapes, picked per product
// by the wrapper (kernels/lowrank.py::gemm_plan, from a sweep of tile
// shapes, depths and splits on an H100): 128 x 128 (8 warps of 64 x 32,
// a 3-stage ring, 110.6 KB, two blocks an SM) and 64 x 64 (4 warps of 32
// x 32, a 4-stage ring, 73.7 KB, three blocks an SM). wgmma would reach
// further, but needs MN-major shared-memory descriptors with a matching
// swizzle for the two transposed operands and a compiler to check them
// against; mma.sync takes all four layouts through ldmatrix. What holds
// it back: at qwen2-0.5b's training shapes it runs 40-176 TFLOP/s of mma
// (chip_smoke.py phase 6 on an H100); the short reductions of y and dx
// (K = 256-512) leave each block few steps, splits add a pass over the
// partials, and a warp of 64 x 32 issues 6 ldmatrix.x4 for every 16 mma.
//
// Reductions: the P pieces are concatenated along K, so the reduction is P
// * ceil(K / BK) steps of depth BK. With splits > 1 those steps are cut into
// `splits` contiguous ranges of floor or ceil(steps / splits); each block
// writes its f32 partial tile to the workspace and reduce_splits sums the
// partials in split order before the epilogue. No float atomics: two runs
// give the same bits.
//
// Epilogues: F32 stores C in f32; BF16 stores bf16(C); PIECES stores C in
// f32 (when c32 is not null) and its first out_pieces bf16 pieces at
// cp + q * cp_ps. Outputs are contiguous (row stride N).
//
// Two options, for the products that need them and only for those (the
// others are compiled from exactly the code and kernel parameters they had
// before the options: a larger parameter struct alone changed their
// register allocation and cost them 5% on an H100):
//   * B_I8 (kernel #6's tensor-core route, lowrank_q8_routes.cu): B is
//     stored k-contiguous as int8, and a 16-byte cp.async carries 16 of its
//     values, so the ring holds B's steps in half the bytes. ldmatrix on an
//     int8 tile would give a lane four consecutive k, not the k pairs
//     m16n8k16 wants; so once a step has landed, the block converts its
//     int8 B tile to a bf16 tile in shared memory (every int8 is exact in
//     bf16), one more barrier, and the ldmatrix path reads that tile as it
//     reads a bf16 one. col_scale multiplies column n of the f32 sum before
//     the epilogue (after the split partials are summed): the per-row scale
//     of the int8 factor.
//   * BATCH (kernel #4's apply, Q = Y X^T over a stack): grid.z is batch x
//     splits; operand and output pointers step by a_bs, b_bs and c_bs
//     elements per batch index.
//   * TRI (kernel #5, the Gram G = Y^T Y over a stack, with BATCH): C is
//     symmetric, so only the T (T + 1) / 2 tiles (i, j), i <= j, of its
//     T x T grid of square tiles run (grid.x enumerates them row by row),
//     and the F32 epilogue stores each value at (row, col) and at (col,
//     row) from the same register; a diagonal tile stores its upper half
//     so. C is exactly symmetric by construction, at half the flops. It
//     adds no field: the tile map needs only N.
// Their fields ride in ArgsX after the Args every product reads.
//
// Requirements (checked by the wrappers, kernels/lowrank.py): every extent
// along a contiguous axis (K of a K-major operand, M of an M-major A, N of
// an N-major B, and N of C) and every leading dimension a multiple of 8,
// and every base pointer 16-byte aligned, so each 16-byte copy lies wholly
// inside or wholly outside its matrix. The row count along a strided axis
// is free (M = 1 and M = 1000 are fine).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Everything below has internal linkage (an unnamed namespace): several
// kernel libraries include this header and are loaded into one process,
// and a template's static local (launch's attr_set) would otherwise be one
// object for all of them (the linker unifies such symbols process-wide),
// so the first library to launch a configuration would leave the others
// without their shared-memory attribute.
namespace gemm16 {
namespace {

constexpr int BK = 64;       // reduction depth of one step (lowrank.py: STEP)
constexpr int PAD = 8;       // bf16 of padding per shared-memory row

enum Epilogue { F32 = 0, BF16 = 1, PIECES = 2 };

struct Args {
  const uint16_t* a;
  const uint16_t* b;
  int M, N, K;             // C (M, N); reduction depth K per piece
  int lda, ldb;            // row strides, in elements
  long long a_ps, b_ps;    // element offset between pieces (0: shared)
  int pieces;              // P
  int mode;                // Epilogue
  float* c32;              // F32, PIECES (may be null for PIECES)
  uint16_t* c16;           // BF16
  uint16_t* cp;            // PIECES: out_pieces bf16 pieces of C
  int out_pieces;
  long long cp_ps;
  float* ws;               // (batch x) splits * M * N floats if splits > 1
  int splits;
};

// The kernel parameters of a product with an option: Args, then the
// options' fields.
struct ArgsX {
  Args g;
  const int8_t* b8;        // B_I8: B as int8 (g.b unused)
  const float* col_scale;  // B_I8: (N,) scales of B's columns
  int batch;               // BATCH: products in the launch
  long long a_bs, b_bs, c_bs;  // BATCH: element offsets between them
};

__host__ __device__ __forceinline__ const Args& base(const Args& a) {
  return a;
}
__host__ __device__ __forceinline__ const Args& base(const ArgsX& a) {
  return a.g;
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf16_value(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

// The first n <= 3 bf16 pieces of v: piece q = bf16(v - pieces 0..q-1),
// each remainder exact in f32.
__device__ __forceinline__ void split_bf16(float v, int n,
                                           uint16_t (&out)[3]) {
  float rest = v;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    out[q] = q < n ? bf16_bits(rest) : 0;
    rest = rest - bf16_value(out[q]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const uint16_t* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if constexpr (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory tile of one operand: ROWS x BK (k contiguous) or BK x ROWS
// (rows contiguous), rows padded by PAD.
template <int ROWS, bool KMAJ, int BK>
struct Tile {
  static constexpr int STRIDE = KMAJ ? BK + PAD : ROWS + PAD;
  static constexpr int ELEMS = KMAJ ? ROWS * STRIDE : BK * STRIDE;
  static constexpr int CHUNKS = ROWS * BK / 8;   // 16-byte copies

  // Copy rows [r0, r0 + ROWS) x k [k0, k0 + BK) of piece base p (row count
  // `rows`, depth K, leading dimension ld) into s, zeros outside.
  template <int THREADS>
  __device__ __forceinline__ static void load(uint16_t* s, const uint16_t* p,
                                              int ld, int rows, int K, int r0,
                                              int k0, int tid) {
#pragma unroll
    for (int j = 0; j < CHUNKS / THREADS; ++j) {
      const int c = tid + j * THREADS;
      int row, k, off;
      if constexpr (KMAJ) {
        row = c / (BK / 8);
        k = (c % (BK / 8)) * 8;
        off = row * STRIDE + k;
      } else {
        k = c / (ROWS / 8);
        row = (c % (ROWS / 8)) * 8;
        off = k * STRIDE + row;
      }
      const int gr = r0 + row, gk = k0 + k;
      const bool valid = gr < rows && gk < K;
      const uint16_t* src =
          valid ? (KMAJ ? p + static_cast<size_t>(gr) * ld + gk
                        : p + static_cast<size_t>(gk) * ld + gr)
                : p;
      cp_async16(s + off, src, valid);
    }
  }
};

// An int8 B tile, ROWS x BK k-contiguous, unpadded (the 16-byte reads of
// the conversion pass fall in distinct banks as they are).
template <int ROWS, int BK>
struct Tile8 {
  static constexpr int BYTES = ROWS * BK;
  static constexpr int CHUNKS = ROWS * BK / 16;

  template <int THREADS>
  __device__ __forceinline__ static void load(int8_t* s, const int8_t* p,
                                              int ld, int rows, int K, int r0,
                                              int k0, int tid) {
#pragma unroll
    for (int j = 0; j < CHUNKS / THREADS; ++j) {
      const int c = tid + j * THREADS;
      const int row = c / (BK / 16), k = (c % (BK / 16)) * 16;
      const int gr = r0 + row, gk = k0 + k;
      const bool valid = gr < rows && gk < K;
      cp_async16(s + row * BK + k,
                 valid ? p + static_cast<size_t>(gr) * ld + gk : p, valid);
    }
  }
};

// bf16 bits of four int8 packed in a word, two words out (elements 0, 1 in
// lo, 2, 3 in hi): each byte, made unsigned by flipping its sign bit, sits
// in the low byte of the f32 2^23 + u, from which 2^23 + 128 is subtracted
// exactly; the f32 result is the int8's value, and its high half its bf16.
__device__ __forceinline__ void i8x4_bf16(uint32_t v, uint32_t& lo,
                                          uint32_t& hi) {
  const uint32_t u = v ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7650 + b)) -
           8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// BM x BN output tiles, WARPS_M x WARPS_N warps, at least MIN_BLOCKS
// blocks an SM (so at most 65536 / (32 * warps * MIN_BLOCKS) registers a
// thread), steps of depth BK, a ring of STAGES steps.
template <int BM_, int BN_, int WARPS_M, int WARPS_N, int MIN_BLOCKS_,
          int BK_, int STAGES_, bool A_K_, bool B_K_, bool B_I8_ = false,
          bool BATCH_ = false, bool TRI_ = false>
struct Config {
  static constexpr int BM = BM_, BN = BN_, WN = WARPS_N;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int BK = BK_, STAGES = STAGES_;
  static constexpr bool A_K = A_K_, B_K = B_K_;
  static constexpr bool B_I8 = B_I8_, BATCH = BATCH_, TRI = TRI_;
  static_assert(!B_I8 || B_K, "an int8 B is k-contiguous");
  static_assert(!TRI || (BATCH && BM == BN), "a symmetric C: square tiles");
  // the kernel's parameters
  using A = std::conditional_t<B_I8 || BATCH, ArgsX, Args>;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int TM = BM / WARPS_M, TN = BN / WARPS_N;  // warp tile
  static constexpr int MI = TM / 16, NI = TN / 8;
  using TA = Tile<BM, A_K, BK>;
  using TB = Tile<BN, B_K, BK>;
  using TB8 = Tile8<BN, BK>;
  // a ring stage (bf16 elements): A's tile and B's, int8 B in half the
  // room; with int8 B one bf16 B tile after the ring
  static constexpr int STAGE = TA::ELEMS + (B_I8 ? TB8::BYTES / 2 : TB::ELEMS);
  static constexpr int SMEM = (STAGES * STAGE + (B_I8 ? TB::ELEMS : 0)) * 2;
};

// Store C(row, col) and C(row, col + 1) by the epilogue; col is even and
// col + 1 < N (N is a multiple of 8). bi: the batch index (BATCH); with an
// int8 B, the columns' scales first.
template <class C>
__device__ __forceinline__ void store_pair(const typename C::A& ax, int bi,
                                           int row, int col, float v0,
                                           float v1) {
  const Args& g = base(ax);
  if constexpr (C::B_I8) {
    v0 *= ax.col_scale[col];
    v1 *= ax.col_scale[col + 1];
  }
  if constexpr (C::TRI) {
    // (row, col) of the upper triangle, and its mirror (col, row)
    float* c = g.c32 + static_cast<size_t>(bi) * ax.c_bs;
    if (row <= col) {
      c[static_cast<size_t>(row) * g.N + col] = v0;
      c[static_cast<size_t>(col) * g.N + row] = v0;
    }
    if (row <= col + 1) {
      c[static_cast<size_t>(row) * g.N + col + 1] = v1;
      c[static_cast<size_t>(col + 1) * g.N + row] = v1;
    }
    return;
  }
  size_t at = static_cast<size_t>(row) * g.N + col;
  if constexpr (C::BATCH) at += static_cast<size_t>(bi) * ax.c_bs;
  if (g.mode == BF16) {
    *reinterpret_cast<uint32_t*>(g.c16 + at) =
        bf16_bits(v0) | (static_cast<uint32_t>(bf16_bits(v1)) << 16);
    return;
  }
  if (g.c32 != nullptr)
    *reinterpret_cast<float2*>(g.c32 + at) = make_float2(v0, v1);
  if (g.mode == PIECES) {
    uint16_t p0[3], p1[3];
    split_bf16(v0, g.out_pieces, p0);
    split_bf16(v1, g.out_pieces, p1);
#pragma unroll
    for (int q = 0; q < 3; ++q)
      if (q < g.out_pieces)
        *reinterpret_cast<uint32_t*>(g.cp + q * g.cp_ps + at) =
            p0[q] | (static_cast<uint32_t>(p1[q]) << 16);
  }
}

// TRI: the origin of upper-triangle tile t of a T x T grid (T = ceil(N /
// BN)), tiles (i, j >= i) numbered row by row.
template <class C>
__device__ __forceinline__ void tri_tile(int N, int t, int& m0, int& n0) {
  const int tiles = (N + C::BN - 1) / C::BN;
  int i = 0;
  while (t >= tiles - i) {
    t -= tiles - i;
    ++i;
  }
  m0 = i * C::BM;
  n0 = (i + t) * C::BN;
}

// grid (ceil(N / BN), ceil(M / BM), (batch x) splits); TRI: (T (T + 1) /
// 2, 1, batch x splits)
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
    gemm_kernel(const typename C::A ax) {
  const Args& g = base(ax);
  extern __shared__ __align__(16) uint16_t smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / C::WN, wn = warp % C::WN;
  int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  if constexpr (C::TRI) tri_tile<C>(g.N, blockIdx.x, m0, n0);
  const int ksteps = (g.K + C::BK - 1) / C::BK;
  const int total = g.pieces * ksteps;
  int s = blockIdx.z, bi = 0;
  if constexpr (C::BATCH) {
    s = blockIdx.z % g.splits;
    bi = blockIdx.z / g.splits;
  }
  const int t0 = static_cast<int>(static_cast<long long>(s) * total / g.splits);
  const int t1 =
      static_cast<int>(static_cast<long long>(s + 1) * total / g.splits);
  const int nt = t1 - t0;

  auto load_step = [&](int t, int stage) {
    const int p = t / ksteps, k0 = (t % ksteps) * C::BK;
    uint16_t* sa = smem + stage * C::STAGE;
    uint16_t* sb = sa + C::TA::ELEMS;
    if constexpr (C::BATCH) {
      C::TA::template load<C::THREADS>(sa, g.a + bi * ax.a_bs + p * g.a_ps,
                                       g.lda, g.M, g.K, m0, k0, tid);
    } else {
      C::TA::template load<C::THREADS>(sa, g.a + p * g.a_ps, g.lda, g.M,
                                       g.K, m0, k0, tid);
    }
    if constexpr (C::B_I8) {
      const long long bb = C::BATCH ? bi * ax.b_bs : 0;
      C::TB8::template load<C::THREADS>(reinterpret_cast<int8_t*>(sb),
                                        ax.b8 + bb + p * g.b_ps, g.ldb, g.N,
                                        g.K, n0, k0, tid);
    } else if constexpr (C::BATCH) {
      C::TB::template load<C::THREADS>(sb, g.b + bi * ax.b_bs + p * g.b_ps,
                                       g.ldb, g.N, g.K, n0, k0, tid);
    } else {
      C::TB::template load<C::THREADS>(sb, g.b + p * g.b_ps, g.ldb, g.N,
                                       g.K, n0, k0, tid);
    }
  };

  float acc[C::MI][C::NI][4];
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < C::NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int st = 0; st < C::STAGES - 1; ++st) {
    if (st < nt) load_step(t0 + st, st);
    cp_async_commit();
  }

  const int r8 = lane % 8, j4 = lane / 8;
  for (int it = 0; it < nt; ++it) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    if (it + C::STAGES - 1 < nt)
      load_step(t0 + it + C::STAGES - 1, (it + C::STAGES - 1) % C::STAGES);
    cp_async_commit();

    const uint16_t* sa = smem + (it % C::STAGES) * C::STAGE;
    const uint16_t* sb = sa + C::TA::ELEMS;
    if constexpr (C::B_I8) {
      // the landed int8 B step -> the bf16 tile after the ring; the barrier
      // at the top of the next step keeps it until every warp has read it
      const int8_t* s8 = reinterpret_cast<const int8_t*>(sb);
      uint16_t* sbf = smem + C::STAGES * C::STAGE;
      for (int c = tid; c < C::TB8::CHUNKS; c += C::THREADS) {
        const int row = c / (C::BK / 16), k = (c % (C::BK / 16)) * 16;
        const uint4 v = *reinterpret_cast<const uint4*>(s8 + row * C::BK + k);
        uint4 o0, o1;
        i8x4_bf16(v.x, o0.x, o0.y);
        i8x4_bf16(v.y, o0.z, o0.w);
        i8x4_bf16(v.z, o1.x, o1.y);
        i8x4_bf16(v.w, o1.z, o1.w);
        uint16_t* d = sbf + row * C::TB::STRIDE + k;
        *reinterpret_cast<uint4*>(d) = o0;
        *reinterpret_cast<uint4*>(d + 8) = o1;
      }
      __syncthreads();
      sb = sbf;
    }
    // fragments of the 16-deep slice kk: A (MI m16 tiles), B (NI n8 tiles)
    auto load_frags = [&](uint32_t (&af)[C::MI][4], uint32_t (&bf)[C::NI][2],
                          int kk) {
#pragma unroll
      for (int i = 0; i < C::MI; ++i) {
        const int mrow = wm * C::TM + i * 16;
        if constexpr (C::A_K)
          ldmatrix_x4<false>(af[i], sa + (mrow + lane % 16) * C::TA::STRIDE +
                                        kk + (lane / 16) * 8);
        else
          ldmatrix_x4<true>(af[i], sa + (kk + r8 + (j4 / 2) * 8) *
                                            C::TA::STRIDE +
                                        mrow + (j4 % 2) * 8);
      }
#pragma unroll
      for (int j = 0; j < C::NI; j += 2) {
        const int ncol = wn * C::TN + j * 8;
        uint32_t r[4];
        if constexpr (C::B_K)
          ldmatrix_x4<false>(r, sb + (ncol + r8 + (j4 / 2) * 8) *
                                         C::TB::STRIDE +
                                     kk + (j4 % 2) * 8);
        else
          ldmatrix_x4<true>(r, sb + (kk + r8 + (j4 % 2) * 8) * C::TB::STRIDE +
                                   ncol + (j4 / 2) * 8);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
    };
    // two fragment buffers: slice kk + 16 loads while slice kk multiplies
    uint32_t af[2][C::MI][4], bfr[2][C::NI][2];
    load_frags(af[0], bfr[0], 0);
#pragma unroll
    for (int ks = 0; ks < C::BK / 16; ++ks) {
      if (ks + 1 < C::BK / 16)
        load_frags(af[(ks + 1) % 2], bfr[(ks + 1) % 2], (ks + 1) * 16);
#pragma unroll
      for (int i = 0; i < C::MI; ++i)
#pragma unroll
        for (int j = 0; j < C::NI; ++j)
          mma_bf16(acc[i][j], af[ks % 2][i], bfr[ks % 2][j][0],
                   bfr[ks % 2][j][1]);
    }
  }
  cp_async_wait<0>();

  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int i = 0; i < C::MI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * C::TM + i * 16 + gq + h * 8;
      if (row >= g.M) continue;
#pragma unroll
      for (int j = 0; j < C::NI; ++j) {
        const int col = n0 + wn * C::TN + j * 8 + 2 * tq;
        if (col >= g.N) continue;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (g.splits > 1)
          // partial blockIdx.z: split s of batch index bi
          *reinterpret_cast<float2*>(
              g.ws + (static_cast<size_t>(C::BATCH ? int(blockIdx.z) : s) *
                          g.M + row) * g.N + col) = make_float2(v0, v1);
        else
          store_pair<C>(ax, bi, row, col, v0, v1);
      }
    }
  }
}

// C = sum over s in order of ws[s], then the epilogue; two columns a thread.
// Templated on the product's Config only so that its name, as a profiler
// shows it, carries the product's layout.
template <class C>
__global__ void reduce_splits(const typename C::A ax) {
  const Args& g = base(ax);
  const size_t mn = static_cast<size_t>(g.M) * g.N;
  size_t all = mn;
  if constexpr (C::BATCH) all *= ax.batch > 1 ? ax.batch : 1;
  for (size_t e = 2 * (blockIdx.x * static_cast<size_t>(blockDim.x) +
                       threadIdx.x);
       e < all; e += 2 * static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t bi = C::BATCH ? e / mn : 0, r = C::BATCH ? e % mn : e;
    // TRI: only the upper triangle's partials were written
    if constexpr (C::TRI)
      if (r / g.N > r % g.N + 1) continue;
    float v0 = 0.f, v1 = 0.f;
    for (int s = 0; s < g.splits; ++s) {
      const float2 p = *reinterpret_cast<const float2*>(
          g.ws + (bi * g.splits + s) * mn + r);
      v0 += p.x;
      v1 += p.y;
    }
    store_pair<C>(ax, static_cast<int>(bi), static_cast<int>(r / g.N),
                  static_cast<int>(r % g.N), v0, v1);
  }
}

// The split pass: the first n bf16 pieces of an f32 array of `count`
// values (a multiple of 4), piece q at out + q * count.
__global__ void split_pieces(const float* __restrict__ v,
                             uint16_t* __restrict__ out, long long count,
                             int n) {
  for (long long e = 4 * (blockIdx.x * static_cast<long long>(blockDim.x) +
                          threadIdx.x);
       e < count; e += 4 * static_cast<long long>(gridDim.x) * blockDim.x) {
    const float4 x = *reinterpret_cast<const float4*>(v + e);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    uint16_t p[4][3];
#pragma unroll
    for (int c = 0; c < 4; ++c) split_bf16(xs[c], n, p[c]);
#pragma unroll
    for (int q = 0; q < 3; ++q)
      if (q < n)
        *reinterpret_cast<uint2*>(out + q * count + e) = make_uint2(
            p[0][q] | (static_cast<uint32_t>(p[1][q]) << 16),
            p[2][q] | (static_cast<uint32_t>(p[3][q]) << 16));
  }
}

inline int grid_for(size_t work, int threads) {
  const size_t blocks = (work + threads - 1) / threads;
  return static_cast<int>(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096);
}

template <class C>
int launch(const typename C::A& ax, cudaStream_t st) {
  const Args& g = base(ax);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  int batch = 1;
  if constexpr (C::BATCH) batch = ax.batch > 1 ? ax.batch : 1;
  dim3 grid((g.N + C::BN - 1) / C::BN, (g.M + C::BM - 1) / C::BM,
            batch * g.splits);
  if constexpr (C::TRI) {
    grid.x = grid.x * (grid.x + 1) / 2;
    grid.y = 1;
  }
  gemm_kernel<C><<<grid, C::THREADS, C::SMEM, st>>>(ax);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || g.splits == 1) return static_cast<int>(err);
  reduce_splits<C><<<grid_for(static_cast<size_t>(g.M) * g.N * batch / 2,
                              256),
                     256, 0, st>>>(ax);
  return static_cast<int>(cudaGetLastError());
}

// C = sum_p A_p B_p on `st` with output tiles of `tile` (128 or 64);
// B_I8: B is int8 with column scales, BATCH: ax.batch products (both take
// ArgsX). Returns the cudaError_t of the launches (0 = launched).
template <bool A_K, bool B_K, bool B_I8 = false, bool BATCH = false>
int matmul(const std::conditional_t<B_I8 || BATCH, ArgsX, Args>& ax,
           int tile, cudaStream_t st) {
  if (base(ax).M <= 0 || base(ax).N <= 0) return 0;
  using C128 = Config<128, 128, 2, 4, 2, BK, 3, A_K, B_K, B_I8, BATCH>;
  using C64 = Config<64, 64, 2, 2, 3, BK, 4, A_K, B_K, B_I8, BATCH>;
  return tile == 128 ? launch<C128>(ax, st) : launch<C64>(ax, st);
}

// The first n pieces of v (count values) into out, on `st`.
inline int split(const float* v, uint16_t* out, long long count, int n,
                 cudaStream_t st) {
  if (count <= 0) return 0;
  split_pieces<<<grid_for(static_cast<size_t>(count) / 4, 256), 256, 0,
                 st>>>(v, out, count, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace gemm16
