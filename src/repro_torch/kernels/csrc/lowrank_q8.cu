// Fused int8 low-rank forward for Hopper (sm_90a): the factored linear of an
// int8 deployment, in one launch,
//   h = (f32(x) . f32(Rq)^T) * sR      (M, K), kept in f32 on chip
//   y = (h . f32(Lq)^T) * sL           (M, O), cast to x's dtype on store
// x (M, I) bf16 or f32; Rq int8 (K, I) with per-row scales sR f32 (K,);
// Lq int8 (O, K) with per-row scales sL f32 (O,); all row-major.
//
// Replaces repro/kernels/quant.py::_lowrank_q8_kernel (reached through
// lowrank_q8_tiled) where kernels/quant.py::q8_route sends a call here:
// f32 x above the decode threshold and widths the 16-byte loads of the
// decode and tensor-core routes (lowrank_q8_routes.cu) cannot read. Same
// contract as the plain version
// repro_torch/kernels/ref.py::lowrank_q8_ref: the factors are converted,
// never the activation; both products accumulate in f32; sR scales the
// rank-K intermediate and sL the output. No dequantized (K, I) or (O, K)
// weight is written anywhere: the int8 -> bf16/f32 convert happens in
// registers (phase 1) and in the shared-memory tile (phase 2).
//
// What bounds it on an H100: at decode (M = a few serve slots) the BYTES of
// the int8 factors, about 1.4 MB for mlp/gate against 2.8 MB of bf16 for
// kernel #1 (csrc/lowrank_fwd.cu); at large prefill M the OPERATIONS of the
// second product, f32 FMAs because h stays f32.
//
// Design: kernel #1's, not a block-by-block copy of the TPU kernel (which
// computes h once per row block at program_id(1) == 0 and reuses its VMEM
// scratch for later O blocks, an ordered grid CUDA does not have). A
// thread-block CLUSTER of CL = 8 CTAs shares h through distributed shared
// memory:
//   phase 1: cluster rank r computes k-slice r of h for its BM rows over
//            the whole I. bf16 x: mma.sync m16n8k16 bf16 with f32
//            accumulators, the B operand converted from int8 to bf16 in
//            registers (every int8 in [-127, 127] is exact in bf16, so the
//            product is the f32 one). f32 x: plain FMAs. The 8 warps split
//            I and sum their partials in a fixed order, then sR multiplies
//            the sum (sR of a padded k is taken as 0, so pads add nothing).
//   gather:  after cluster.sync() every CTA copies the CL slices out of its
//            peers' shared memory into its own f32 h tile.
//   phase 2: each CTA owns a disjoint range of OC output columns,
//            y[:, range] = (h Lq[range]^T) * sL[range], f32 FMAs from a
//            shared-memory tile of Lq converted to f32.
// Ragged M, I, K and O are masked in the kernel. Where I is a multiple of
// 16 (every site of the model), bf16 phase 1 takes a branch-free path with
// U steps' loads in flight, an Rq pair one aligned 16-bit word. An int8 row
// of ragged I is not 2-byte aligned, so the general path loads a pair as
// one 16-bit word only where it is aligned and inside the row, else byte by
// byte; nothing is padded or copied. The kernel allocates nothing and does
// not synchronize; the C entry point returns cudaGetLastError() of the
// launch.
//
// Not yet done (later PRs): TMA/cp.async pipelining, loads of the int8
// rows wider than 16 bits, wgmma, a faster f32 second product.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int CL = 8;          // CTAs per cluster (portable cluster size)
constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int KC = 32;         // phase-1 k-chunk (4 mma n-tiles of 8)
constexpr int TO = 64;         // phase-2 output-column tile
constexpr int TK = 32;         // phase-2 reduction tile
constexpr int LS = TO + 4;     // row stride of the k-major L tile in smem

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint16_t* p, float v) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// bf16 bits of an int8 value (exact: |v| <= 127 fits bf16's significand)
__device__ __forceinline__ uint32_t i8_bf16(int v) {
  return static_cast<uint32_t>(
      __bfloat16_as_ushort(__float2bfloat16_rn(static_cast<float>(v))));
}

// Two consecutive bf16 of one x row, (row[i], row[i+1]) packed low/high,
// anything past the row end (or a masked row) read as zero.
__device__ __forceinline__ uint32_t ld_pair(const uint16_t* row, int i, int n,
                                            bool ok) {
  if (!ok || i >= n) return 0u;
  const uint16_t* p = row + i;
  if (i + 1 < n && (reinterpret_cast<uintptr_t>(p) & 3u) == 0)
    return *reinterpret_cast<const uint32_t*>(p);
  uint32_t lo = p[0];
  uint32_t hi = (i + 1 < n) ? p[1] : 0u;
  return lo | (hi << 16);
}

// The same pair of an int8 row, converted to two bf16. One 16-bit load when
// the pair is inside the row and 2-byte aligned, else two byte loads.
__device__ __forceinline__ uint32_t ld_pair8(const int8_t* row, int i, int n,
                                             bool ok) {
  if (!ok || i >= n) return 0u;
  const int8_t* p = row + i;
  int lo, hi;
  if (i + 1 < n && (reinterpret_cast<uintptr_t>(p) & 1u) == 0) {
    const uint16_t w = *reinterpret_cast<const uint16_t*>(p);
    lo = static_cast<int8_t>(w & 0xffu);
    hi = static_cast<int8_t>(w >> 8);
  } else {
    lo = p[0];
    hi = (i + 1 < n) ? p[1] : 0;
  }
  return i8_bf16(lo) | (i8_bf16(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Phase 1, one warp, one 16-wide step of the reduction starting at i0:
// acc[mt][nt] += x[rows of m-tile mt, i0:i0+16] . Rq[k of n-tile nt,
// i0:i0+16] in the mma.sync C layout (lane g = lane/4, t = lane%4 holds rows
// g, g+8 and columns 2t, 2t+1). bf16 x: tensor cores, Rq converted to bf16.
template <int MT>
__device__ __forceinline__ void step16(float (&acc)[MT][4][4],
                                       const uint16_t* __restrict__ x,
                                       const int8_t* __restrict__ r, int M,
                                       int I, int K, int m0, int kglob0,
                                       int kvalid, int i0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = m0 + mt * 16 + g, r1 = r0 + 8;
    const uint16_t* x0 = x + static_cast<size_t>(r0 < M ? r0 : 0) * I;
    const uint16_t* x1 = x + static_cast<size_t>(r1 < M ? r1 : 0) * I;
    a[mt][0] = ld_pair(x0, i0 + 2 * t, I, r0 < M);
    a[mt][1] = ld_pair(x1, i0 + 2 * t, I, r1 < M);
    a[mt][2] = ld_pair(x0, i0 + 8 + 2 * t, I, r0 < M);
    a[mt][3] = ld_pair(x1, i0 + 8 + 2 * t, I, r1 < M);
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int kl = nt * 8 + g;  // column of this lane's B operand in the chunk
    const bool ok = kl < kvalid && kglob0 + kl < K;
    const int8_t* rr = r + static_cast<size_t>(ok ? kglob0 + kl : 0) * I;
    const uint32_t b0 = ld_pair8(rr, i0 + 2 * t, I, ok);
    const uint32_t b1 = ld_pair8(rr, i0 + 8 + 2 * t, I, ok);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
  }
}

// The same step in plain f32 FMAs for f32 x, same output layout.
template <int MT>
__device__ __forceinline__ void step16(float (&acc)[MT][4][4],
                                       const float* __restrict__ x,
                                       const int8_t* __restrict__ r, int M,
                                       int I, int K, int m0, int kglob0,
                                       int kvalid, int i0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int n = (I - i0) < 16 ? (I - i0) : 16;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = m0 + mt * 16 + g, r1 = r0 + 8;
    const float* x0 = x + static_cast<size_t>(r0 < M ? r0 : 0) * I + i0;
    const float* x1 = x + static_cast<size_t>(r1 < M ? r1 : 0) * I + i0;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c0 = nt * 8 + 2 * t, c1 = c0 + 1;
      const bool ok0 = c0 < kvalid && kglob0 + c0 < K;
      const bool ok1 = c1 < kvalid && kglob0 + c1 < K;
      const int8_t* q0 =
          r + static_cast<size_t>(ok0 ? kglob0 + c0 : 0) * I + i0;
      const int8_t* q1 =
          r + static_cast<size_t>(ok1 ? kglob0 + c1 : 0) * I + i0;
      float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
      for (int j = 0; j < n; ++j) {
        const float xa = r0 < M ? x0[j] : 0.f;
        const float xb = r1 < M ? x1[j] : 0.f;
        const float ra = ok0 ? static_cast<float>(q0[j]) : 0.f;
        const float rb = ok1 ? static_cast<float>(q1[j]) : 0.f;
        s00 = fmaf(xa, ra, s00);
        s01 = fmaf(xa, rb, s01);
        s10 = fmaf(xb, ra, s10);
        s11 = fmaf(xb, rb, s11);
      }
      acc[mt][nt][0] += s00;
      acc[mt][nt][1] += s01;
      acc[mt][nt][2] += s10;
      acc[mt][nt][3] += s11;
    }
  }
}

// Two int8 of one 16-bit word -> two bf16 packed low/high.
__device__ __forceinline__ uint32_t cvt_pair8(uint16_t w) {
  return i8_bf16(static_cast<int8_t>(w & 0xffu)) |
         (i8_bf16(static_cast<int8_t>(w >> 8)) << 16);
}

// Phase 1 for bf16 x in the common case (I a multiple of 16, x 4-byte and
// Rq 2-byte aligned), branch-free as kernel #1's phase1_fast: rows past M
// or K are clamped to a valid row and zeroed by a select after the load, so
// every load is unconditional and U steps' loads are in flight at once (at
// decode this loop is bound by their latency). An Rq pair is one aligned
// 16-bit word.
template <int MT, int U>
__device__ __forceinline__ void phase1_fast(float (&acc)[MT][4][4],
                                            const uint16_t* __restrict__ x,
                                            const int8_t* __restrict__ r,
                                            int M, int I, int K, int m0,
                                            int kglob0, int kvalid, int warp,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* xrow[MT][2];
  bool xok[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + mt * 16 + g + 8 * h;
      xok[mt][h] = row < M;
      xrow[mt][h] = reinterpret_cast<const uint32_t*>(
                        x + static_cast<size_t>(min(row, M - 1)) * I) + t;
    }
  const uint16_t* rrow[4];
  bool rok[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int kl = nt * 8 + g;
    rok[nt] = kl < kvalid && kglob0 + kl < K;
    rrow[nt] = reinterpret_cast<const uint16_t*>(
                   r + static_cast<size_t>(min(kglob0 + kl, K - 1)) * I) + t;
  }
  const int nsteps = I >> 4;
  int s = warp;
  for (; s + (U - 1) * WARPS < nsteps; s += U * WARPS) {
    uint32_t a[U][MT][4];
    uint16_t b[U][4][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = (s + u * WARPS) * 8;  // word of element 16 * step
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[u][mt][0] = xrow[mt][0][w];
        a[u][mt][1] = xrow[mt][1][w];
        a[u][mt][2] = xrow[mt][0][w + 4];
        a[u][mt][3] = xrow[mt][1][w + 4];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        b[u][nt][0] = rrow[nt][w];
        b[u][nt][1] = rrow[nt][w + 4];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[u][mt][0] = xok[mt][0] ? a[u][mt][0] : 0u;
        a[u][mt][1] = xok[mt][1] ? a[u][mt][1] : 0u;
        a[u][mt][2] = xok[mt][0] ? a[u][mt][2] : 0u;
        a[u][mt][3] = xok[mt][1] ? a[u][mt][3] : 0u;
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint32_t b0 = rok[nt] ? cvt_pair8(b[u][nt][0]) : 0u;
        const uint32_t b1 = rok[nt] ? cvt_pair8(b[u][nt][1]) : 0u;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[u][mt], b0, b1);
      }
    }
  }
  for (; s < nsteps; s += WARPS) {
    const int w = s * 8;
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      a[mt][0] = xok[mt][0] ? xrow[mt][0][w] : 0u;
      a[mt][1] = xok[mt][1] ? xrow[mt][1][w] : 0u;
      a[mt][2] = xok[mt][0] ? xrow[mt][0][w + 4] : 0u;
      a[mt][3] = xok[mt][1] ? xrow[mt][1][w + 4] : 0u;
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const uint32_t b0 = rok[nt] ? cvt_pair8(rrow[nt][w]) : 0u;
      const uint32_t b1 = rok[nt] ? cvt_pair8(rrow[nt][w + 4]) : 0u;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
    }
  }
}

// Shared-memory layout (floats), the one of csrc/lowrank_fwd.cu, sized by
// lowrank_q8_smem_bytes():
//   region A: phase-1 warp partials [WARPS][BM][KC], then (after the
//             cluster barrier) the gathered h, k-major: [Kp2][BM + 4]
//   hs:       this CTA's k-slice of h (scaled by sR) [BM][KS]
//   ls:       phase-2 tile of Lq in f32, k-major: [TK][LS]
template <int BM>
__host__ __device__ inline int region_a_floats(int kp2) {
  const int part = WARPS * BM * KC;
  const int h = kp2 * (BM + 4);
  return part > h ? part : h;
}

template <typename T, int BM>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS)
    lowrank_q8_kernel(const T* __restrict__ x, const int8_t* __restrict__ r,
                      const float* __restrict__ rs,
                      const int8_t* __restrict__ l,
                      const float* __restrict__ lsc, T* __restrict__ y,
                      int M, int I, int K, int O, int KS, int OC) {
  constexpr int MT = BM / 16;  // 16-row mma tiles per CTA
  constexpr int RM = BM / 16;  // phase-2 rows per thread
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM;
  const int Kp = CL * KS;                          // padded rank
  const int Kp2 = (Kp + TK - 1) / TK * TK;          // phase-2 reduction span
  constexpr int HP = BM + 4;                        // k-major h row stride
  float* region = smem;
  float* hs = smem + region_a_floats<BM>(Kp2);
  float* ls = hs + BM * KS;

  // ---- phase 1: this CTA's k-slice of h, f32, over the whole I ----------
  const int kslice0 = rank * KS;
  const int nsteps = (I + 15) / 16;
  for (int kc = 0; kc < KS; kc += KC) {
    float acc[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    const int kvalid = KS - kc;
    bool fast = false;
    if constexpr (std::is_same<T, uint16_t>::value) {
      fast = I % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 3u) == 0 &&
             (reinterpret_cast<uintptr_t>(r) & 1u) == 0;
      if (fast)
        phase1_fast<MT, (MT == 1 ? 4 : 1)>(acc, x, r, M, I, K, m0,
                                           kslice0 + kc, kvalid, warp, lane);
    }
    if (!fast) {
#pragma unroll 2
      for (int s = warp; s < nsteps; s += WARPS)
        step16<MT>(acc, x, r, M, I, K, m0, kslice0 + kc, kvalid, s * 16,
                   lane);
    }
    // warp partials -> smem, then a fixed-order sum (deterministic)
    const int g = lane >> 2, t = lane & 3;
    float* part = region + warp * BM * KC;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int row = mt * 16 + g, col = nt * 8 + 2 * t;
        part[row * KC + col] = acc[mt][nt][0];
        part[row * KC + col + 1] = acc[mt][nt][1];
        part[(row + 8) * KC + col] = acc[mt][nt][2];
        part[(row + 8) * KC + col + 1] = acc[mt][nt][3];
      }
    __syncthreads();
    for (int e = tid; e < BM * KC; e += THREADS) {
      const int row = e / KC, col = e % KC;
      if (kc + col < KS) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) sum += region[w * BM * KC + e];
        // fold sR into h: a padded k (>= K) has scale 0 and adds nothing
        const int k = kslice0 + kc + col;
        hs[row * KS + kc + col] = k < K ? sum * rs[k] : 0.f;
      }
    }
    __syncthreads();
  }

  // ---- gather the full h (BM x Kp) from the cluster's shared memory ------
  cluster.sync();
  float* h = region;  // the partials are dead; reuse their space
  for (int e = tid; e < BM * Kp2; e += THREADS) {
    const int row = e / Kp2, c = e % Kp2;
    float v = 0.f;
    if (c < Kp) {
      const float* peer = cluster.map_shared_rank(hs, c / KS);
      v = peer[row * KS + c % KS];
    }
    h[c * HP + row] = v;
  }
  __syncthreads();

  // ---- phase 2: y[rows, this CTA's columns] = (h Lq^T) * sL in f32 ------
  const int o_begin = blockIdx.x * OC;
  const int o_end = min(O, o_begin + OC);
  const int ty = tid / 16, tx = tid % 16;
  for (int o0 = o_begin; o0 < o_end; o0 += TO) {
    float acc[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < Kp2; k0 += TK) {
      __syncthreads();
      for (int e = tid; e < TO * TK; e += THREADS) {
        const int oo = e / TK, kk = e % TK;
        const int o = o0 + oo, k = k0 + kk;
        ls[kk * LS + oo] =
            (o < o_end && k < K)
                ? static_cast<float>(l[static_cast<size_t>(o) * K + k])
                : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < TK; ++kk) {
        float hv[RM];
        const float* hk = h + (k0 + kk) * HP + ty * RM;
        if constexpr (RM == 4) {
          const float4 h4 = *reinterpret_cast<const float4*>(hk);
          hv[0] = h4.x;
          hv[1] = h4.y;
          hv[2] = h4.z;
          hv[3] = h4.w;
        } else {
#pragma unroll
          for (int i = 0; i < RM; ++i) hv[i] = hk[i];
        }
        const float4 l4 =
            *reinterpret_cast<const float4*>(ls + kk * LS + 4 * tx);
        const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(hv[i], lv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int m = m0 + ty * RM + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = o0 + 4 * tx + j;
        if (o < o_end)
          store(y + static_cast<size_t>(m) * O + o, acc[i][j] * lsc[o]);
      }
    }
  }
  // no CTA may leave while a peer can still read its hs slice
  cluster.sync();
}

template <typename T, int BM>
int launch(const void* x, const int8_t* r, const float* rs, const int8_t* l,
           const float* ls, void* y, int M, int I, int K, int O, int KS,
           int OC, int G, int smem, cudaStream_t stream) {
  auto kern = lowrank_q8_kernel<T, BM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(CL * G, (M + BM - 1) / BM);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(x), r, rs, l,
                                        ls, static_cast<T*>(y), M, I, K, O,
                                        KS, OC);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs (the layout, and so this
// count, is kernel #1's: repro_torch/kernels/lowrank.py::smem_bytes).
int lowrank_q8_smem_bytes(int bm, int ks) {
  const int kp = CL * ks;
  const int kp2 = (kp + TK - 1) / TK * TK;
  const int a = bm == 16 ? region_a_floats<16>(kp2)
                         : region_a_floats<64>(kp2);
  return static_cast<int>(sizeof(float)) * (a + bm * ks + TK * LS);
}

// x (M, I) in dtype (0 = float32, 1 = bfloat16); rq int8 (K, I), rs f32 (K);
// lq int8 (O, K), ls f32 (O); y (M, O) in x's dtype. bm: 16 or 64 rows per
// CTA. ks: width of each cluster rank's k-slice (a multiple of 8,
// CL * ks >= K). oc: output columns per CTA; g: clusters along O (grid.x =
// 8 * g, g * 8 * oc >= O). Returns the cudaError_t of the launch.
int lowrank_q8(const void* x, const int8_t* rq, const float* rs,
               const int8_t* lq, const float* ls, void* y, int M, int I, int K,
               int O, int dtype, int bm, int ks, int oc, int g, void* stream) {
  const int smem = lowrank_q8_smem_bytes(bm, ks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (bm == 16)
      return launch<uint16_t, 16>(x, rq, rs, lq, ls, y, M, I, K, O, ks, oc, g,
                                  smem, s);
    return launch<uint16_t, 64>(x, rq, rs, lq, ls, y, M, I, K, O, ks, oc, g,
                                smem, s);
  }
  if (bm == 16)
    return launch<float, 16>(x, rq, rs, lq, ls, y, M, I, K, O, ks, oc, g,
                             smem, s);
  return launch<float, 64>(x, rq, rs, lq, ls, y, M, I, K, O, ks, oc, g, smem,
                           s);
}

}  // extern "C"
