// Flash attention forward for Hopper (sm_90a): online-softmax attention
// with a causal, a sliding-window or no mask, grouped-query heads.
//
//   q (B, Sq, H, dh), k and v (B, Sk, KVH, dh), H a multiple of KVH;
//   o (B, Sq, H, dh) contiguous, in q's dtype.
//   s = q . k^T * scale (f32), key kpos visible to query qpos where
//   kpos < Sk, and with causal kpos <= qpos, and with window > 0
//   kpos > qpos - window (query positions start at 0);
//   o = softmax(s) . v, divided by max(l, 1e-30) at the end.
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel (reached through
// repro/kernels/ops.py::flash_attention). Same function as the plain
// version repro_torch/kernels/ref.py::flash_attention_ref. The TPU kernel
// pads dh to 128 lanes, expands the KV heads by a gather and folds heads
// into its grid, then walks the keys as a sequential grid axis that
// carries the running max, the normaliser and an f32 accumulator in VMEM
// scratch. Here nothing is padded or copied in device memory: the kernel
// reads q, k and v through their (B, S, H) strides, maps query head h to
// KV head h / (H / KVH), and masks the ragged Sq and Sk itself.
//
// Design (the FlashAttention-2 layout on mma.sync m16n8k16, bf16 in, f32
// accumulate). One block owns one (head, batch, query tile of BQ = 64
// rows, or 128 on the f32 route); each of its BQ / 16 warps owns 16 query
// rows and keeps their
// running max m, normaliser l and output accumulator in registers, and
// the score accumulators are repacked in registers as the A operand of p .
// v. The block walks only the key tiles of BK keys that some of its rows
// can see (the reference's pl.when skip, flash_attention.py:40-49); the
// query tile is the grid's slowest axis, causal tiles heaviest first, so
// the light ones fill the tail. Per tile:
//   * K/V ring. bf16: a ring of 2-3 steps of K/V tiles in shared memory,
//     filled by cp.async 16 bytes at a time (q too, in a group of its own;
//     plain loads into the same ring where a row start is not 16-byte
//     aligned); step t + stages - 1 is in flight while step t multiplies.
//     f32: the raw f32 tile of t + 1 lands by cp.async while tile t
//     multiplies from its converted pieces.
//   * Fragments from ldmatrix: K (key, d) as stored for q . k^T, V (key,
//     d) through ldmatrix.trans for p . v (no transpose in memory); rows
//     padded by 8 bf16, so no ldmatrix phase has a bank conflict. q's
//     fragments are loaded once into registers (in shared memory where
//     they would take more than 48 registers a thread). For each operand
//     piece, a warp loads the fragments of every n-tile first and then
//     issues its mma over the n-tiles in turn: consecutive mma write
//     independent accumulators.
//   * Masks only where needed: a warp runs visible() only on a tile that
//     holds its diagonal, its window's edge or the ragged end of Sk; 8-key
//     n-tiles that none of its rows can see are not multiplied, and a warp
//     whose 16 rows all lie past Sq does no math. Exponents are exp2f with
//     log2(e) folded into the scale; row max and sum reduce as trees.
//   * Key groups (bf16, BQ 64, grids below 1.5 blocks an SM): with KS = 2
//     the block holds 8 warps, two groups of 4 on the same rows walking
//     the even and the odd key tiles of each ring step; at the end the odd
//     group hands its m, l and o through shared memory and the even one
//     merges them. A prefill of 2 x 256 tokens and 14 heads is 112
//     blocks: twice the warps on them.
//   * bf16: p is rounded to bf16 before p . v, as the TPU kernel does
//     (p.astype(v.dtype)); the normaliser sums p unrounded.
//   * f32 (no TF32: the f32 parity tier): exact bf16 pieces on the tensor
//     cores, the split_bf16 rule of gemm_bf16.cuh. q (once), k and v (per
//     tile, by the whole block, from the landed f32 tile) go into shared
//     memory as 3 bf16 pieces each, p (f32, in registers) is split the
//     same way, and each product sums the 6 pairs of pieces whose indices
//     sum to <= 2: the terms dropped are below 2^-23 of each product, the
//     rounding of an f32 product itself (tests/test_torch_gram_flash_
//     routes.py emulates the route; 2 pieces miss the f32 tolerance). 6
//     products on the bf16 tensor cores cost less than one on the f32
//     CUDA cores (989 against 67 TFLOP/s).
//
// What bounds it on an H100: 4 B H Sq Sk_vis dh flops against 4 B S H dh
// bytes, ~S / 2 flops a byte: the byte bound at the paths' few hundred
// tokens in bf16 (the f32 route's 6 products a flop reach the operations
// bound). Neither is what holds it: a block walks at most 4-8 key tiles,
// so latency and issue hold it (the chain of dependent mma, ldmatrix and
// row reductions of each tile, 12 warps an SM at most at bf16's ~170
// registers a thread, 8 on the f32 route with its 3 pieces of q in
// registers and the K/V conversion between two barriers a tile) and the
// tail of a grid of 112-1,536 blocks. flash_plan picks BQ, the key groups
// and the ring depth per shape from a sweep (chip_smoke.py phase 13).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
// f32: bf16 pieces of each operand; the products keep the pairs whose
// piece indices sum to < PIECES
constexpr int PIECES = 3;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, H, KVH, dh;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal, window, vec, stages;
  float scale;  // dh^-0.5 log2(e): scores in base 2
};

// Shapes of one instantiation: DP = dh padded to 32, 64, 128 or 256; F32:
// the pieced f32 route.
template <int DP, bool F32>
struct Geo {
  static constexpr int P = F32 ? PIECES : 1;  // bf16 pieces of an operand
  static constexpr int BK = !F32 || DP <= 64 ? 64 : (DP == 128 ? 32 : 16);
  static constexpr int ST = DP + 8;       // padded bf16 row in shared memory
  static constexpr int TILE = BK * ST;    // bf16 of one K or V tile (piece)
  static constexpr bool QREG = P * DP <= 192;  // q's fragments in registers
  // bf16 elements of shared memory: bf16, `stages` steps of ks K/V tiles
  // (q staged in the last before its fragments load), then q where it
  // stays; f32, the raw f32 K and V tiles, their 6 pieces (q staged
  // there), then q's pieces where they stay
  __host__ __device__ static int elems(int bq, int stages, int ks) {
    const int qs = QREG ? 0 : P * bq * ST;
    return F32 ? 4 * BK * DP + 6 * TILE + qs : stages * ks * 2 * TILE + qs;
  }
};

__device__ __forceinline__ bool visible(const Args& a, int qpos, int kpos) {
  bool ok = kpos < a.Sk;
  if (a.causal) ok = ok && kpos <= qpos;
  if (a.window > 0) ok = ok && kpos > qpos - a.window;
  return ok;
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

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The first P bf16 pieces of the pair (lo, hi), each packed lo | hi << 16:
// piece q = bf16(v - pieces 0..q-1), every remainder exact in f32
// (gemm_bf16.cuh's split_bf16).
template <int P>
__device__ __forceinline__ void split_pair(float lo, float hi,
                                           uint32_t (&out)[P]) {
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const uint32_t l = bf16_bits(lo), u = bf16_bits(hi);
    out[q] = l | (u << 16);
    lo -= __uint_as_float(l << 16);
    hi -= __uint_as_float(u << 16);
  }
}

// 8 consecutive bf16 (d % 8 == 0) of a row at p[off], without 16-byte
// alignment; zeros outside the rows or past dh.
__device__ __forceinline__ uint4 load8(const uint16_t* p, long long off,
                                       bool in) {
  if (!in) return make_uint4(0u, 0u, 0u, 0u);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = static_cast<uint32_t>(p[off + 2 * i]) |
           (static_cast<uint32_t>(p[off + 2 * i + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 4 consecutive f32 of a row at p[off]; zeros outside.
__device__ __forceinline__ float4 load4(const float* p, long long off,
                                        bool in, int vec) {
  if (!in) return make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec) return *reinterpret_cast<const float4*>(p + off);
  return make_float4(p[off], p[off + 1], p[off + 2], p[off + 3]);
}

// Keys [k0, k0 + BK) of one head of k or v (row stride rs) into a bf16
// tile (rows padded to ST), zeros past Sk and dh: 16-byte cp.async where
// rows are aligned, plain loads otherwise.
template <int DP, int BK, int ST, int THREADS>
__device__ __forceinline__ void load_tile_bf16(uint16_t* s, const uint16_t* p,
                                               long long rs, int k0,
                                               const Args& a, int tid) {
  constexpr int CHUNKS = BK * (DP / 8);
#pragma unroll
  for (int i = 0; i < (CHUNKS + THREADS - 1) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    if (CHUNKS % THREADS != 0 && c >= CHUNKS) break;
    const int j = c / (DP / 8), d = (c % (DP / 8)) * 8;
    const bool in = k0 + j < a.Sk && d < a.dh;
    const long long off = (k0 + j) * rs + d;
    if (a.vec)
      cp_async16(s + j * ST + d, in ? p + off : p, in);
    else
      *reinterpret_cast<uint4*>(s + j * ST + d) = load8(p, off, in);
  }
}

// The same for an f32 tile (rows of DP floats, unpadded: the conversion
// pass reads them 16 bytes a thread in order).
template <int DP, int BK, int THREADS>
__device__ __forceinline__ void load_tile_f32(float* s, const float* p,
                                              long long rs, int k0,
                                              const Args& a, int tid) {
  constexpr int CHUNKS = BK * (DP / 4);
#pragma unroll
  for (int i = 0; i < (CHUNKS + THREADS - 1) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    if (CHUNKS % THREADS != 0 && c >= CHUNKS) break;
    const int j = c / (DP / 4), d = (c % (DP / 4)) * 4;
    const bool in = k0 + j < a.Sk && d < a.dh;
    const long long off = (k0 + j) * rs + d;
    if (a.vec)
      cp_async16(s + j * DP + d, in ? p + off : p, in);
    else
      *reinterpret_cast<float4*>(s + j * DP + d) = load4(p, off, in, 0);
  }
}

// q's A fragment of piece p at step kc: from registers (QREG) or from
// the fragments just loaded from shared memory.
template <bool QREG, class QF, class QA>
__device__ __forceinline__ const uint32_t (&qfrag(const QF& qf, const QA& qa,
                                                  int p, int kc))[4] {
  if constexpr (QREG)
    return qf[p][kc];
  else
    return qa[p];
}

// op over v[0..N) as a pairwise tree (N a power of two).
template <int N, class Op>
__device__ __forceinline__ float tree(float (&v)[N], Op op) {
#pragma unroll
  for (int w = N / 2; w >= 1; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i) v[i] = op(v[i], v[i + w]);
  return v[0];
}

// grid (H, B, ceil(Sq / BQ)), BQ * 2 * KS threads: BQ / 16 warps of 16
// rows, times KS key groups (KS = 2, bf16: two warp groups walk the even
// and the odd key tiles of the same rows, and merge their m, l and o at
// the end; a small grid so keeps twice the warps busy). No floor on
// blocks an SM: capping bf16 at 4 blocks (128 registers a thread) cost
// 1.5x at qwen2's and zamba2's shapes on an H100.
template <int DP, int BQ, bool F32, int KS>
__global__ void __launch_bounds__(BQ * 2 * KS) flash_kernel(const Args a) {
  using G = Geo<DP, F32>;
  constexpr int P = G::P, BK = G::BK, ST = G::ST, TILE = G::TILE;
  constexpr int THREADS = BQ * 2 * KS;
  static_assert(KS == 1 || !F32, "the f32 route walks the keys in one group");
  // the key groups' merge (4 + 4 NDT floats a lane) fits in two ring steps
  static_assert(KS == 1 || (BQ / 16) * 32 * (4 + DP / 2) * 4 <=
                               2 * KS * 2 * TILE * 2, "merge buffer");
  constexpr int NKC = DP / 16;  // 16-deep steps of q . k^T
  constexpr int NN = BK / 8;    // 8-key n-tiles of a score tile
  constexpr int NDT = DP / 8;   // 8-wide n-tiles of o
  extern __shared__ __align__(16) uint16_t smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int rw = (tid >> 5) % (BQ / 16);  // this warp's 16 rows
  const int kh = (tid >> 5) / (BQ / 16);  // and its key group
  const int gq = lane >> 2, tq = lane & 3, r8 = lane & 7, j4 = lane >> 3;
  // causal: the query tile is the grid's slowest axis, heaviest (most key
  // tiles) first over every head and batch index, so the light tiles
  // fill the tail
  const int qt = a.causal ? static_cast<int>(gridDim.z - 1 - blockIdx.z)
                          : static_cast<int>(blockIdx.z);
  const int q0 = qt * BQ, h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (a.H / a.KVH);
  const int dh = a.dh;

  // the key tiles some row of the block sees (the reference's skip rule)
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  int kt_lo = 0, kt_hi = (a.Sk + BK - 1) / BK;
  if (a.causal) kt_hi = min(kt_hi, q_last / BK + 1);
  if (a.window > 0 && q0 - a.window + 1 > 0)
    kt_lo = (q0 - a.window + 1) / BK;
  const int nt = kt_hi - kt_lo;
  const int nsteps = (nt + KS - 1) / KS;  // steps of KS tiles

  // this warp's rows
  const int qw0 = q0 + rw * 16;
  const int qw_last = min(qw0 + 15, a.Sq - 1);
  const bool active = qw0 < a.Sq;

  using T = std::conditional_t<F32, float, uint16_t>;
  const T* kbase = static_cast<const T*>(a.k) + b * a.ksb + kvh * a.ksh;
  const T* vbase = static_cast<const T*>(a.v) + b * a.vsb + kvh * a.vsh;

  // shared memory
  float* raw = reinterpret_cast<float*>(smem);          // f32: K, V
  uint16_t* pieces = F32 ? smem + 4 * BK * DP : smem;   // K pieces, V pieces
  uint16_t* qs;  // q's pieces (P tiles of BQ x ST)
  if constexpr (G::QREG)
    qs = F32 ? pieces : smem + (a.stages - 1) * KS * 2 * TILE;
  else
    qs = smem + G::elems(BQ, a.stages, KS) - P * BQ * ST;

  // step i's KS tiles, kt_lo + i KS + t, into ring stage `stage`
  auto load_step = [&](int i, int stage) {
    if constexpr (F32) {
      const int k0 = (kt_lo + i) * BK;
      load_tile_f32<DP, BK, THREADS>(raw, reinterpret_cast<const float*>(
                                              kbase), a.kss, k0, a, tid);
      load_tile_f32<DP, BK, THREADS>(raw + BK * DP,
                                     reinterpret_cast<const float*>(vbase),
                                     a.vss, k0, a, tid);
    } else {
#pragma unroll
      for (int t = 0; t < KS; ++t) {
        const int kt = kt_lo + i * KS + t;
        if (kt >= kt_hi) break;
        uint16_t* sk = smem + (stage * KS + t) * 2 * TILE;
        load_tile_bf16<DP, BK, ST, THREADS>(
            sk, reinterpret_cast<const uint16_t*>(kbase), a.kss, kt * BK, a,
            tid);
        load_tile_bf16<DP, BK, ST, THREADS>(
            sk + TILE, reinterpret_cast<const uint16_t*>(vbase), a.vss,
            kt * BK, a, tid);
      }
    }
  };

  // bf16: q by cp.async, a group of its own before the prologue's
  if constexpr (!F32) {
    const uint16_t* q = static_cast<const uint16_t*>(a.q);
    for (int c = tid; c < BQ * (DP / 8); c += THREADS) {
      const int r = c / (DP / 8), d = (c % (DP / 8)) * 8;
      const bool in = q0 + r < a.Sq && d < dh;
      const long long off = b * a.qsb + (q0 + r) * a.qss + h * a.qsh + d;
      if (a.vec)
        cp_async16(qs + r * ST + d, in ? q + off : q, in);
      else
        *reinterpret_cast<uint4*>(qs + r * ST + d) = load8(q, off, in);
    }
    cp_async_commit();
  }

  // prologue: the first tiles in flight (f32: one raw tile)
  const int ahead = F32 ? 1 : a.stages - 1;
  for (int st = 0; st < ahead; ++st) {
    if (st < nsteps) load_step(st, st);
    cp_async_commit();
  }

  // f32: q -> its pieces in shared memory (once; plain loads)
  if constexpr (F32) {
    const float* q = static_cast<const float*>(a.q);
    for (int c = tid; c < BQ * (DP / 4); c += THREADS) {
      const int r = c / (DP / 4), d = (c % (DP / 4)) * 4;
      const float4 x =
          load4(q, b * a.qsb + (q0 + r) * a.qss + h * a.qsh + d,
                q0 + r < a.Sq && d < dh, a.vec);
      uint32_t lo[P], hi[P];
      split_pair<P>(x.x, x.y, lo);
      split_pair<P>(x.z, x.w, hi);
#pragma unroll
      for (int p = 0; p < P; ++p)
        *reinterpret_cast<uint2*>(qs + (p * BQ + r) * ST + d) =
            make_uint2(lo[p], hi[p]);
    }
  } else {
    // q's cp.async group, the oldest, is complete once no more than the
    // prologue's groups are pending
    if (ahead == 2)
      cp_async_wait<2>();
    else
      cp_async_wait<1>();
  }
  __syncthreads();  // q in shared memory

  // q's A fragments (16 rows x 16 d per step) into registers
  uint32_t qf[G::QREG ? P : 1][G::QREG ? NKC : 1][4];
  if constexpr (G::QREG) {
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int kc = 0; kc < NKC; ++kc)
        ldmatrix_x4<false>(qf[p][kc], qs + (p * BQ + rw * 16 + lane % 16) *
                                               ST + kc * 16 + (lane / 16) * 8);
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;

  for (int it = 0; it < nsteps; ++it) {
    const uint16_t* sk;  // piece 0 of K; piece p at + p * TILE
    const uint16_t* sv;  // piece 0 of V
    if constexpr (F32) {
      cp_async_wait<0>();
      __syncthreads();  // the raw tile landed; every warp is done with the
                        // last tile's pieces (and q's staging)
      // raw f32 K, V -> their bf16 pieces, the whole block at once
      for (int c = tid; c < 2 * BK * (DP / 4); c += THREADS) {
        const int t = c / (BK * (DP / 4)), e = c % (BK * (DP / 4));
        const int j = e / (DP / 4), d = (e % (DP / 4)) * 4;
        const float4 x =
            *reinterpret_cast<const float4*>(raw + (t * BK + j) * DP + d);
        uint32_t lo[P], hi[P];
        split_pair<P>(x.x, x.y, lo);
        split_pair<P>(x.z, x.w, hi);
#pragma unroll
        for (int p = 0; p < P; ++p)
          *reinterpret_cast<uint2*>(pieces + (t * P + p) * TILE + j * ST +
                                    d) = make_uint2(lo[p], hi[p]);
      }
      __syncthreads();  // pieces ready, the raw tile free
      if (it + 1 < nt) load_step(it + 1, 0);
      cp_async_commit();
      sk = pieces;
      sv = pieces + P * TILE;
    } else {
      if (a.stages == 3)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();  // step it landed; every warp is done with step
                        // it - 1's stage (and q's staging)
      if (it + a.stages - 1 < nsteps)
        load_step(it + a.stages - 1, (it + a.stages - 1) % a.stages);
      cp_async_commit();
      sk = smem + ((it % a.stages) * KS + kh) * 2 * TILE;
      sv = sk + TILE;
    }
    const int kt = kt_lo + it * KS + kh, k0 = kt * BK;

    if (!active || kt >= kt_hi) continue;
    // warp-uniform: the n-tiles [nlo, nhi) some of this warp's rows see,
    // and whether any score of the tile needs visible()
    const int hi_key = a.causal ? min(a.Sk, qw_last + 1) : a.Sk;
    if (hi_key <= k0) continue;
    const int nhi = min(NN, (hi_key - k0 + 7) / 8);
    int nlo = 0;
    if (a.window > 0) {
      const int lo_key = qw0 - a.window + 1;
      if (lo_key >= k0 + BK) continue;
      if (lo_key > k0) nlo = (lo_key - k0) / 8;
    }
    const bool masked = k0 + BK > a.Sk || (a.causal && k0 + BK - 1 > qw0) ||
                        (a.window > 0 && k0 <= qw_last - a.window);

    // s (16 x BK) = q . k^T over the kept pairs of pieces; for each k
    // piece, its fragments of every n-tile load once, then each kept q
    // piece multiplies them into the NN independent accumulators in turn
    float s[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int kc = 0; kc < NKC; ++kc) {
      if (kc * 16 >= dh) break;  // zero padding past dh
      uint32_t qa[G::QREG ? 1 : P][4];
      if constexpr (!G::QREG) {
#pragma unroll
        for (int p = 0; p < P; ++p)
          ldmatrix_x4<false>(qa[p], qs + (p * BQ + rw * 16 + lane % 16) *
                                             ST + kc * 16 + (lane / 16) * 8);
      }
#pragma unroll
      for (int pk = 0; pk < P; ++pk) {
        uint32_t kb[NN / 2][4];  // n-tiles 2 j and 2 j + 1
#pragma unroll
        for (int j = 0; j < NN / 2; ++j)
          if (2 * j + 1 >= nlo && 2 * j < nhi)
            ldmatrix_x4<false>(kb[j], sk + pk * TILE +
                                          (j * 16 + r8 + (j4 / 2) * 8) * ST +
                                          kc * 16 + (j4 % 2) * 8);
#pragma unroll
        for (int pq = 0; pq + pk < P; ++pq) {
          const uint32_t(&af)[4] = qfrag<G::QREG>(qf, qa, pq, kc);
#pragma unroll
          for (int j = 0; j < NN / 2; ++j)
            if (2 * j + 1 >= nlo && 2 * j < nhi) {
              mma_bf16(s[2 * j], af, kb[j][0], kb[j][1]);
              mma_bf16(s[2 * j + 1], af, kb[j][2], kb[j][3]);
            }
        }
      }
    }

    // scale (base 2), mask, online softmax: element c of n-tile n sits at
    // row qw0 + gq + 8 (c / 2), key k0 + 8 n + 2 tq + c % 2; a row's keys
    // are spread over the 4 lanes tq of a quad
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qpos = qw0 + gq + 8 * hh;
      float t[NN];
#pragma unroll
      for (int n = 0; n < NN; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[n][2 * hh + c];
          if (masked)
            x = visible(a, qpos, k0 + 8 * n + 2 * tq + c) ? x * a.scale
                                                          : NEG_INF;
          else
            x *= a.scale;
        }
        t[n] = fmaxf(s[n][2 * hh], s[n][2 * hh + 1]);
      }
      float mx = tree<NN>(t, [](float u, float w) { return fmaxf(u, w); });
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      const float alpha = exp2f(m[hh] - m_new);
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        float& x0 = s[n][2 * hh];
        float& x1 = s[n][2 * hh + 1];
        x0 = exp2f(x0 - m_new);
        x1 = exp2f(x1 - m_new);
        t[n] = x0 + x1;
      }
      // this thread's share of the row sum; the quad's are summed at the end
      l[hh] = l[hh] * alpha +
              tree<NN>(t, [](float u, float w) { return u + w; });
      m[hh] = m_new;
#pragma unroll
      for (int n = 0; n < NDT; ++n) {
        o[n][2 * hh] *= alpha;
        o[n][2 * hh + 1] *= alpha;
      }
    }

    // o += p . v: the score accumulators of n-tiles 2c and 2c + 1 are the
    // A fragment of key step c (keys 16 c .. +16); bf16: p rounded once,
    // f32: its P pieces. For each v piece and group of up to 8 n-tiles of
    // o, the fragments load once, then each kept p piece multiplies them
    // into the group's independent accumulators in turn.
    constexpr int NG = NDT < 8 ? NDT : 8;  // n-tiles of o in a group
#pragma unroll
    for (int c = 0; c < NN / 2; ++c) {
      if (2 * c + 1 < nlo || 2 * c >= nhi) continue;
      uint32_t pa[P][4];
      {
        uint32_t w[4][P];
        split_pair<P>(s[2 * c][0], s[2 * c][1], w[0]);
        split_pair<P>(s[2 * c][2], s[2 * c][3], w[1]);
        split_pair<P>(s[2 * c + 1][0], s[2 * c + 1][1], w[2]);
        split_pair<P>(s[2 * c + 1][2], s[2 * c + 1][3], w[3]);
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int r = 0; r < 4; ++r) pa[p][r] = w[r][p];
      }
#pragma unroll
      for (int n0 = 0; n0 < NDT; n0 += NG) {
        if (n0 * 8 >= dh) break;
#pragma unroll
        for (int pv = 0; pv < P; ++pv) {
          uint32_t vb[NG / 2][4];  // n-tiles n0 + 2 j and n0 + 2 j + 1
#pragma unroll
          for (int j = 0; j < NG / 2; ++j)
            if ((n0 + 2 * j) * 8 < dh)
              ldmatrix_x4<true>(vb[j], sv + pv * TILE +
                                           (c * 16 + r8 + (j4 % 2) * 8) * ST +
                                           (n0 + 2 * j) * 8 + (j4 / 2) * 8);
#pragma unroll
          for (int pp = 0; pp + pv < P; ++pp)
#pragma unroll
            for (int j = 0; j < NG / 2; ++j) {
              const int n = n0 + 2 * j;
              if (n * 8 < dh) mma_bf16(o[n], pa[pp], vb[j][0], vb[j][1]);
              if ((n + 1) * 8 < dh)
                mma_bf16(o[n + 1], pa[pp], vb[j][2], vb[j][3]);
            }
        }
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (KS == 2) {
    // the odd key group hands its m, l and o to the even one through the
    // ring (every copy has landed), which merges them
    constexpr int W = 4 + 4 * NDT;  // floats a lane hands over
    float* x = reinterpret_cast<float*>(smem) + (rw * 32 + lane) * W;
    __syncthreads();
    if (kh == 1) {
      x[0] = m[0];
      x[1] = m[1];
      x[2] = l[0];
      x[3] = l[1];
#pragma unroll
      for (int n = 0; n < NDT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) x[4 + 4 * n + c] = o[n][c];
    }
    __syncthreads();
    if (kh == 1) return;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m[hh], x[hh]);
      const float a0 = exp2f(m[hh] - m_new), a1 = exp2f(x[hh] - m_new);
      l[hh] = l[hh] * a0 + x[2 + hh] * a1;
#pragma unroll
      for (int n = 0; n < NDT; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          o[n][2 * hh + c] = o[n][2 * hh + c] * a0 +
                             x[4 + 4 * n + 2 * hh + c] * a1;
    }
  }

  if (!active) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float li = l[hh];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int qpos = qw0 + gq + 8 * hh;
    if (qpos >= a.Sq) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    const long long row = ((static_cast<long long>(b) * a.Sq + qpos) * a.H +
                           h) * dh;
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      const int d = n * 8 + 2 * tq;
      if (d >= dh) break;
      const float v0 = o[n][2 * hh] * inv, v1 = o[n][2 * hh + 1] * inv;
      if constexpr (F32)
        *reinterpret_cast<float2*>(static_cast<float*>(a.o) + row + d) =
            make_float2(v0, v1);
      else
        *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(a.o) + row + d) =
            bf16_bits(v0) | (bf16_bits(v1) << 16);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int DP, bool F32>
int smem_bytes(int bq, int stages, int ks) {
  return Geo<DP, F32>::elems(bq, stages, ks) * 2;
}

template <int DP, int BQ, bool F32, int KS>
int launch(const Args& a, cudaStream_t stream) {
  const int smem = smem_bytes<DP, F32>(BQ, a.stages, KS);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<DP, BQ, F32, KS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(a.H, a.B, (a.Sq + BQ - 1) / BQ);
  flash_kernel<DP, BQ, F32, KS><<<grid, BQ * 2 * KS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The instantiated plans (kernels/flash_attention.py::plans, among which
// flash_plan picks): BQ 64, one key group; f32 at DP <= 64 also BQ 128
// (one raw tile); bf16 rings of 2 or 3 steps (DP 256: 2) and, at DP <=
// 128, also two key groups.
template <int DP, bool F32>
int launch_dp(const Args& a, int bq, int ks, cudaStream_t stream) {
  const bool ring_ok = F32 ? a.stages == 1
                           : (a.stages == 2 || (a.stages == 3 && DP <= 128));
  if (!ring_ok) return static_cast<int>(cudaErrorInvalidValue);
  if (bq == 64 && ks == 1) return launch<DP, 64, F32, 1>(a, stream);
  if constexpr (F32 && DP <= 64)
    if (bq == 128 && ks == 1) return launch<DP, 128, F32, 1>(a, stream);
  if constexpr (!F32 && DP <= 128)
    if (bq == 64 && ks == 2) return launch<DP, 64, F32, 2>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool F32>
int launch_dtype(const Args& a, int dp, int bq, int ks,
                 cudaStream_t stream) {
  switch (dp) {
    case 32: return launch_dp<32, F32>(a, bq, ks, stream);
    case 64: return launch_dp<64, F32>(a, bq, ks, stream);
    case 128: return launch_dp<128, F32>(a, bq, ks, stream);
    case 256: return launch_dp<256, F32>(a, bq, ks, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of a plan (the wrapper's mirror,
// kernels/flash_attention.py::flash_smem_bytes, is tested against it).
int flash_attn_smem_bytes(int dp, int dtype, int bq, int stages, int ks) {
  const bool f32 = dtype == 0;
  switch (dp) {
    case 32: return f32 ? smem_bytes<32, true>(bq, stages, ks)
                        : smem_bytes<32, false>(bq, stages, ks);
    case 64: return f32 ? smem_bytes<64, true>(bq, stages, ks)
                        : smem_bytes<64, false>(bq, stages, ks);
    case 128: return f32 ? smem_bytes<128, true>(bq, stages, ks)
                         : smem_bytes<128, false>(bq, stages, ks);
    case 256: return f32 ? smem_bytes<256, true>(bq, stages, ks)
                         : smem_bytes<256, false>(bq, stages, ks);
  }
  return -1;
}

// dtype (q, k, v and o): 0 = float32, 1 = bfloat16. Strides in elements;
// each tensor's dh axis has unit stride and o is contiguous. ``vec`` says
// every row start is 16-byte aligned (pointers and strides), so rows load
// 16 bytes at a time. The plan: dp (dh padded: 32, 64, 128 or 256), bq
// (query rows a block), ks (key groups), stages (bf16: steps of ks K/V
// tiles in the ring; f32: 1).
// Returns the cudaError_t of the launch (0 = launched;
// cudaErrorInvalidValue for a plan that is not instantiated); the wrapper
// checks shapes (dh % 8 == 0, dh <= 256, H % KVH == 0, Sq > 0, Sk > 0).
int flash_attn(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Sk, int H, int KVH, int dh, long long qsb,
               long long qss, long long qsh, long long ksb, long long kss,
               long long ksh, long long vsb, long long vss, long long vsh,
               int causal, int window, float scale, int vec, int dtype,
               int dp, int bq, int ks, int stages, void* stream) {
  const Args a{q, k, v, o, B, Sq, Sk, H, KVH, dh,
               qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
               causal, window, vec, stages, scale * LOG2E};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_dtype<false>(a, dp, bq, ks, st)
                    : launch_dtype<true>(a, dp, bq, ks, st);
}

}  // extern "C"
