// Mamba-2 SSD chunked scan for Hopper (sm_90a), bf16 u, B and C on the
// tensor cores, chunk-parallel.
//
//   u (Bz, S, H, dh) bf16, dt (Bz, S, H) f32 > 0 (or 0: identity steps),
//   A (H,) f32 < 0, B and C (Bz, S, N) bf16; dh and N multiples of 16 up
//   to 64. Per chunk of Q steps, with cum = cumsum(dt A) inside the chunk
//   and L[i, j] = exp(cum_i - cum_j) for j <= i:
//     y = ((C B^T) * L)(dt u) + exp(cum) * (C S^T)
//     S <- exp(cum_Q) S + (dt u exp(cum_Q - cum))^T B
//   from S = 0. Writes y (Bz, S, H, dh) f32 without the D.u skip term and
//   the final S (Bz, H, dh, N) f32.
//
// Replaces repro/kernels/ssd_scan.py::_ssd_kernel (:27) for bf16 inputs;
// ssd_scan.cu's f32 kernel keeps f32 and the dims these tiles do not take
// (kernels/ssd_scan.py::ssd_route). Same function as the plain version
// repro_torch/kernels/ref.py::ssd_scan_ref. The TPU kernel's grid walks
// the chunks of one (batch, head) in order and carries the state in VMEM,
// and recomputes C B^T for every head.
//
// What bounds it on an H100. Per (batch, chunk) C B^T is 2 N flops a
// (query, key) pair on or below the diagonal, shared by every head; per
// head on top, 2 dh a pair (G u) and 4 Q N dh (the carried state's term
// and the state update): 3.8 GFLOP at zamba2-7b's prefill bucket (4 x
// 256 tokens, 112 heads, dh = N = 64), 0.056 ms on the f32 CUDA cores
// (67 TFLOP/s), and 5.7 GFLOP of piece products (below) on the bf16
// tensor cores (989 TFLOP/s), 0.006 ms. The bytes bound it: bf16 u, B
// and C and f32 dt in, f32 y and state out, ~52 MB, 0.016 ms at 3.35
// TB/s. Beside them every head reads C B^T from L2 (73 MB at the bucket)
// and each query tile re-reads the u tiles at or below it.
//
// The chunk-parallel SSD decomposition (Dao and Gu, "Transformers are
// SSMs", 2024, section 6), three launches from one host call, every
// product an mma.sync m16n8k16 (bf16 in, f32 accumulate) on ldmatrix
// fragments (gemm_bf16.cuh's helpers):
//   1. ssd_chunk, grid (pairs + H, chunks, Bz). The first `pairs` blocks
//      of each (batch, chunk) compute C B^T once, the lower-triangle 64 x
//      64 tiles only, into an f32 workspace (Bz, chunks, QP, QP) (QP = Q
//      rounded up to 64): every head reads it, none recomputes it. The
//      other H blocks scan dt A into cum (base 2) and store cum and dt in
//      a workspace, and compute each head's chunk-local state S_c = (u^T
//      diag(w)) B, w_j = dt_j exp(cum_Q - cum_j): each warp weights and
//      splits its own A fragments of u^T in registers, B stays bf16.
//   2. ssd_pass, only with more than one chunk: per (batch, head) and 4
//      state elements a thread, S_prev[0] = 0, S_prev[c + 1] =
//      exp(cum_Q[c]) S_prev[c] + S_c[c], sequential over the chunks but
//      elementwise; it stores each S_prev as bf16 pieces for launch 3 and
//      the last as the final state. With one chunk (every serve bucket up
//      to 256 tokens) launch 1 writes S_c as the final state and this
//      launch does not run.
//   3. ssd_out, grid (H, query tiles, Bz x chunks), heaviest query tile
//      first: per 64-row query tile, y = exp(cum_i) C S_prev^T (skipped
//      in chunk 0, where S_prev = 0) + sum over the key tiles at or below
//      the diagonal of G u, G = (C B^T) * L * dt. G is formed in f32 in
//      the mma accumulator layout, straight from the workspace's rows,
//      which is also the A fragment layout of G u; the decay is computed
//      only where j <= i (above the diagonal exp could overflow, and inf
//      * 0 is NaN), as exp2f with log2(e) folded into cum. A warp skips
//      the 16-key steps of the diagonal tile past its last row. u tiles
//      come through a 2-stage cp.async ring (the next key tile's copy
//      overlaps this one's products) and feed G u through ldmatrix.trans
//      from their stored (step, d) layout. 128 registers, 4 blocks an SM
//      (holding the next tile's C B^T values in registers took 158 and 3
//      blocks, and was slower on an H100).
// u, B and C are bf16, so their products are exact in f32. Each f32
// operand (G, w_j u_j, S_prev) goes in as P = 2 bf16 pieces (gemm_bf16.
// cuh's split rule), the mma for each piece into 8 independent
// accumulators in turn: the pieces sum to it within 2^-17 of its
// magnitude, far inside ssd_tol's 1e-4 (tests/test_torch_ssd_routes.py
// emulates the route: 1 piece misses the tolerance). No float atomics:
// two calls give the same bits.
//
// A ragged last chunk is masked with its real length (what zero-padding
// with dt = 0 computes); dt = 0 past a row's valid length needs nothing
// more. Every copy is 16 bytes: the wrapper checks that bases and the
// step, head and batch strides are 16-byte aligned (B and C may be row
// views of one (Bz, S, 2 N) tensor).

#include "gemm_bf16.cuh"

namespace {

using gemm16::bf16_value;
using gemm16::cp_async16;
using gemm16::cp_async_commit;
using gemm16::cp_async_wait;
using gemm16::ldmatrix_x4;
using gemm16::mma_bf16;

constexpr int T = 64;            // query and key tile rows; max dh and N
constexpr int ST = T + 8;        // padded bf16 row of a shared tile
constexpr int TILE = T * ST;     // bf16 elements of one tile
constexpr int THREADS = 128;     // 4 warps of 16 rows
constexpr int WARPS = THREADS / 32;
constexpr int P = 2;             // bf16 pieces of an f32 operand
constexpr float LOG2E = 1.4426950408889634f;
// cp.async ring of key tiles: deeper rings (3, 4) cost blocks an SM and
// were slower on an H100
constexpr int STAGES = 2;

struct Args {
  const uint16_t* u;
  const float* dt;         // (Bz, S, H) contiguous
  const float* A;
  const uint16_t* B;
  const uint16_t* C;
  float* y;                // (Bz, S, H, dh) contiguous
  float* state;            // (Bz, H, dh, N) contiguous
  float* cb;               // (Bz, nc, QP, QP): C B^T per chunk
  float* cw;               // (Bz, nc, H, 2, QP): cum (base 2) and dt
  float* sc;               // (Bz, nc, H, dh, N): S_c (nc > 1)
  uint16_t* sp;            // (Bz, nc, H, P, dh, N): S_prev pieces (nc > 1)
  long long usb, uss, ush; // u strides (batch, step, head); dh unit
  long long bsb, bss;      // B strides (batch, step); N unit
  long long csb, css;      // C strides
  int Bz, S, H, dh, N, Q, QP, nc, pairs;
};

// The first P bf16 pieces of the pair (lo, hi), each packed lo | hi << 16
// (gemm_bf16.cuh's split rule: piece q = bf16(v - pieces 0..q-1)).
__device__ __forceinline__ void split_pair(float lo, float hi,
                                           uint32_t (&out)[P]) {
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // one cvt
    out[q] = *reinterpret_cast<const uint32_t*>(&v);
    lo -= __low2float(v);
    hi -= __high2float(v);
  }
}

// Rows [r0, r0 + T) of a bf16 (rows, width) matrix, row stride rs, into a
// shared tile (zeros past `rows` and `width`): 16-byte cp.async.
__device__ __forceinline__ void load_rows(uint16_t* s, const uint16_t* p,
                                          long long rs, int r0, int rows,
                                          int width, int tid) {
  const int per = width / 8;
  for (int c = tid; c < T * per; c += THREADS) {
    const int r = c / per, k = (c % per) * 8;
    const bool in = r0 + r < rows;
    cp_async16(s + r * ST + k, in ? p + (r0 + r) * rs + k : p, in);
  }
}

// Inclusive prefix sum of dt * a2 over the chunk's len steps into cum[],
// dt into dts[]: a shuffle scan in each warp, the 4 warp totals added in
// order, a carry across rounds of THREADS steps.
__device__ void chunk_cumsum(const float* dtb, int H, int len, float a2,
                             float* cum, float* dts, float* wsum) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float carry = 0.f;
  for (int base = 0; base < len; base += THREADS) {
    const int t = base + tid;
    const float d = t < len ? dtb[static_cast<long long>(t) * H] : 0.f;
    float v = d * a2;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float nb = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += nb;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    float before = 0.f, total = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) before += wsum[w];
      total += wsum[w];
    }
    if (t < len) {
      cum[t] = (v + before) + carry;
      dts[t] = d;
    }
    carry += total;
    __syncthreads();
  }
}

// C B^T tile (qt, kt), kt <= qt, of one (batch, chunk) into the
// workspace. Shared memory: C and B tiles.
__device__ void cb_tile(const Args& a, uint16_t* smem, int pair, int c,
                        int b) {
  int qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= pair) ++qt;
  const int kt = pair - qt * (qt + 1) / 2;
  const int c0 = c * a.Q, ql = min(a.Q, a.S - c0);
  const int i0 = qt * T, j0 = kt * T;
  if (i0 >= ql) return;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  uint16_t* sc = smem;
  uint16_t* sb = smem + TILE;
  const long long cbase = b * a.csb + static_cast<long long>(c0) * a.css;
  const long long bbase = b * a.bsb + static_cast<long long>(c0) * a.bss;
  load_rows(sc, a.C + cbase, a.css, i0, ql, a.N, tid);
  load_rows(sb, a.B + bbase, a.bss, j0, ql, a.N, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < T / 16; ++kc) {
    if (kc * 16 >= a.N) break;
    uint32_t af[4];
    ldmatrix_x4<false>(af, sc + (16 * w + (lane & 15)) * ST + kc * 16 +
                               (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t bf[4];
      ldmatrix_x4<false>(bf, sb + (16 * j + (lane & 7) + (lane >> 4) * 8) *
                                      ST + kc * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * j], af, bf[0], bf[1]);
      mma_bf16(acc[2 * j + 1], af, bf[2], bf[3]);
    }
  }
  float* out = a.cb + (static_cast<long long>(b) * a.nc + c) * a.QP * a.QP;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float* row = out + static_cast<long long>(i0 + 16 * w + gq + 8 * hh) *
                           a.QP + j0;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n + 2 * tq) =
          make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
  }
}

// Head h's chunk-local state S_c (dh, N), and its cum and dt into the
// workspace (ssd_pass and ssd_out read them there). Shared memory: cum
// and the weights w_j (QP floats each), a 2-stage ring of (u, B) key
// tiles. The product is S_c = (u^T diag(w)) B: each warp weights and
// splits its own A fragments of u^T in registers, B stays one bf16 piece.
__device__ void chunk_state(const Args& a, uint16_t* smem, int h, int c,
                            int b) {
  __shared__ float wsum[WARPS];
  const int c0 = c * a.Q, ql = min(a.Q, a.S - c0);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  float* cum = reinterpret_cast<float*>(smem);
  float* wts = cum + a.QP;
  uint16_t* ring = reinterpret_cast<uint16_t*>(wts + a.QP);
  const uint16_t* ub = a.u + b * a.usb + static_cast<long long>(c0) * a.uss +
                       h * a.ush;
  const uint16_t* bb = a.B + b * a.bsb + static_cast<long long>(c0) * a.bss;
  const int nkt = (ql + T - 1) / T;

  // key tile kt into its ring stage; a group for every kt, empty past
  // the last tile, so the waits below count the same way throughout
  auto load = [&](int kt) {
    if (kt < nkt) {
      uint16_t* s = ring + (kt % STAGES) * 2 * TILE;
      load_rows(s, ub, a.uss, kt * T, ql, a.dh, tid);
      load_rows(s + TILE, bb, a.bss, kt * T, ql, a.N, tid);
    }
    cp_async_commit();
  };
  for (int kt = 0; kt < STAGES - 1; ++kt) load(kt);

  chunk_cumsum(a.dt + (static_cast<long long>(b) * a.S + c0) * a.H + h, a.H,
               ql, a.A[h] * LOG2E, cum, wts, wsum);
  const float last = cum[ql - 1];
  float* cwb = a.cw + ((static_cast<long long>(b) * a.nc + c) * a.H + h) *
                          2 * a.QP;
  for (int j = tid; j < a.QP; j += THREADS) {
    const bool in = j < ql;
    const float d = in ? wts[j] : 0.f;
    cwb[j] = in ? cum[j] : 0.f;
    cwb[a.QP + j] = d;
    wts[j] = in ? d * exp2f(last - cum[j]) : 0.f;
  }

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const bool active = 16 * w < a.dh;
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed (and the weights are written);
                      // every warp is done with the stage refilled next
    load(kt + STAGES - 1);
    if (!active) continue;
    const uint16_t* su = ring + (kt % STAGES) * 2 * TILE;
    const uint16_t* sb = su + TILE;
#pragma unroll
    for (int kc = 0; kc < T / 16; ++kc) {
      const int j = kt * T + kc * 16 + 2 * tq;
      if (j - 2 * tq >= ql) break;
      // A (d, j) = w_j u (j, d): rows d of this warp, 16 steps j
      uint32_t ur[4];
      ldmatrix_x4<true>(ur, su + (kc * 16 + (lane & 7) +
                                  ((lane >> 4) & 1) * 8) * ST +
                                16 * w + ((lane >> 3) & 1) * 8);
      const float2 w0 = *reinterpret_cast<const float2*>(wts + j);
      const float2 w8 = *reinterpret_cast<const float2*>(wts + j + 8);
      uint32_t pa[4][P];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 wr = r < 2 ? w0 : w8;
        split_pair(__uint_as_float(ur[r] << 16) * wr.x,
                   __uint_as_float(ur[r] & 0xffff0000u) * wr.y, pa[r]);
      }
      uint32_t af[P][4];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int r = 0; r < 4; ++r) af[p][r] = pa[r][p];
      uint32_t bf[4][4];  // B (j, n), n contiguous: ldmatrix.trans
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
        if (16 * jn < a.N)
          ldmatrix_x4<true>(bf[jn], sb + (kc * 16 + (lane & 7) +
                                          ((lane >> 3) & 1) * 8) * ST +
                                        16 * jn + (lane >> 4) * 8);
      // each piece into the 8 independent accumulators in turn
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
          if (16 * jn < a.N) {
            mma_bf16(acc[2 * jn], af[p], bf[jn][0], bf[jn][1]);
            mma_bf16(acc[2 * jn + 1], af[p], bf[jn][2], bf[jn][3]);
          }
    }
  }
  cp_async_wait<0>();
  if (!active) return;
  float* out = a.nc == 1
      ? a.state + (static_cast<long long>(b) * a.H + h) * a.dh * a.N
      : a.sc + ((static_cast<long long>(b) * a.nc + c) * a.H + h) * a.dh *
                   a.N;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float* row = out + static_cast<long long>(16 * w + gq + 8 * hh) * a.N;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (8 * n >= a.N) break;
      *reinterpret_cast<float2*>(row + 8 * n + 2 * tq) =
          make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
    }
  }
}

// Launch 1: grid (pairs + H, nc, Bz); C B^T tiles first (launch 3 waits on
// them), then the heads' chunk-local states.
__global__ void __launch_bounds__(THREADS) ssd_chunk(const Args a) {
  extern __shared__ __align__(16) uint16_t smem[];
  const int x = blockIdx.x;
  if (x < a.pairs)
    cb_tile(a, smem, x, blockIdx.y, blockIdx.z);
  else
    chunk_state(a, smem, x - a.pairs, blockIdx.y, blockIdx.z);
}

// Launch 2 (nc > 1): grid (ceil(dh N / (4 THREADS)), H, Bz).
__global__ void __launch_bounds__(THREADS) ssd_pass(const Args a) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int e0 = (blockIdx.x * THREADS + threadIdx.x) * 4;
  const int area = a.dh * a.N;
  if (e0 >= area) return;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < a.nc; ++c) {
    const long long bch = (static_cast<long long>(b) * a.nc + c) * a.H + h;
    if (c > 0) {
      uint32_t lo[P], hi[P];
      split_pair(s.x, s.y, lo);
      split_pair(s.z, s.w, hi);
#pragma unroll
      for (int p = 0; p < P; ++p)
        *reinterpret_cast<uint2*>(a.sp + (bch * P + p) * area + e0) =
            make_uint2(lo[p], hi[p]);
    }
    const int ql = min(a.Q, a.S - c * a.Q);
    const float t = exp2f(a.cw[bch * 2 * a.QP + ql - 1]);
    const float4 v = *reinterpret_cast<const float4*>(a.sc + bch * area + e0);
    s = make_float4(t * s.x + v.x, t * s.y + v.y, t * s.z + v.z,
                    t * s.w + v.w);
  }
  *reinterpret_cast<float4*>(
      a.state + (static_cast<long long>(b) * a.H + h) * area + e0) = s;
}

// Launch 3: grid (H, NT, Bz nc), query tile NT - 1 - blockIdx.y, at most
// 128 registers (4 blocks an SM). Shared memory: cum and dt of the
// chunk's steps up to the tile's last (QP floats each), a 2-stage ring of
// u key tiles, the query tile of C, P pieces of S_prev (dh rows of N).
__global__ void __launch_bounds__(THREADS, 4) ssd_out(const Args a) {
  extern __shared__ __align__(16) uint16_t smem[];
  const int h = blockIdx.x;
  const int qt = static_cast<int>(gridDim.y - 1 - blockIdx.y);
  const int b = blockIdx.z / a.nc, c = blockIdx.z % a.nc;
  const int c0 = c * a.Q, ql = min(a.Q, a.S - c0);
  const int i0 = qt * T;
  if (i0 >= ql) return;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  float* cum = reinterpret_cast<float*>(smem);
  float* dts = cum + a.QP;
  uint16_t* ring = reinterpret_cast<uint16_t*>(dts + a.QP);
  uint16_t* sc = ring + STAGES * TILE;
  uint16_t* sp = sc + TILE;
  const long long bch = (static_cast<long long>(b) * a.nc + c) * a.H + h;
  const uint16_t* ub = a.u + b * a.usb + static_cast<long long>(c0) * a.uss +
                       h * a.ush;

  // group: cum and dt (as ssd_chunk left them), C's query tile and
  // S_prev's pieces (chunks after the first)
  const int n4 = (min(ql, i0 + T) + 3) / 4;
  const float* cwb = a.cw + bch * 2 * a.QP;
  for (int e = tid; e < 2 * n4; e += THREADS) {
    const int off = (e / n4) * a.QP + (e % n4) * 4;
    cp_async16(cum + off, cwb + off, true);
  }
  if (c > 0) {
    load_rows(sc, a.C + b * a.csb + static_cast<long long>(c0) * a.css,
              a.css, i0, ql, a.N, tid);
    const int area = a.dh * a.N;
    for (int p = 0; p < P; ++p)
      load_rows(sp + p * TILE, a.sp + (bch * P + p) * area, a.N, 0, a.dh,
                a.N, tid);
  }
  cp_async_commit();
  // a group for each of the first STAGES - 1 u key tiles (empty past qt)
  for (int kt = 0; kt < STAGES - 1; ++kt) {
    if (kt <= qt)
      load_rows(ring + kt * TILE, ub, a.uss, kt * T, ql, a.dh, tid);
    cp_async_commit();
  }

  // this warp's rows ia, ib = ia + 8
  const int ia = i0 + 16 * w + gq, ib = ia + 8;
  const bool active = i0 + 16 * w < ql;
  const float* cbw = a.cb + (static_cast<long long>(b) * a.nc + c) * a.QP *
                                a.QP;
  const float* rowa = cbw + static_cast<long long>(ia) * a.QP;
  const float* rowb = cbw + static_cast<long long>(ib) * a.QP;
  // the C B^T values of this lane's G fragments of key tile kt: rows ia,
  // ib; keys j, j + 1 and j + 8, j + 9 of each 16-key step
  auto load_g = [&](float2 (&g)[T / 16][4], int kt) {
    const int nkc = kt == qt ? w + 1 : T / 16;
#pragma unroll
    for (int kc = 0; kc < T / 16; ++kc) {
      if (kc >= nkc) break;
      const int j = kt * T + kc * 16 + 2 * tq;
      g[kc][0] = __ldg(reinterpret_cast<const float2*>(rowa + j));
      g[kc][1] = __ldg(reinterpret_cast<const float2*>(rowb + j));
      g[kc][2] = __ldg(reinterpret_cast<const float2*>(rowa + j + 8));
      g[kc][3] = __ldg(reinterpret_cast<const float2*>(rowb + j + 8));
    }
  };

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  cp_async_wait<STAGES - 1>();
  __syncthreads();  // cum, dt, C and S_prev landed
  const float cia = ia < ql ? cum[ia] : 0.f;
  const float cib = ib < ql ? cum[ib] : 0.f;

  if (c > 0 && active) {
    // C S_prev^T: A = C (i, n), B (n, d) = S_prev (d, n), k = n
#pragma unroll
    for (int kc = 0; kc < T / 16; ++kc) {
      if (kc * 16 >= a.N) break;
      uint32_t af[4];
      ldmatrix_x4<false>(af, sc + (16 * w + (lane & 15)) * ST + kc * 16 +
                                 (lane >> 4) * 8);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        uint32_t bf[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (16 * j < a.dh)
            ldmatrix_x4<false>(bf[j], sp + p * TILE +
                                          (16 * j + (lane & 7) +
                                           (lane >> 4) * 8) * ST +
                                          kc * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (16 * j < a.dh) {
            mma_bf16(acc[2 * j], af, bf[j][0], bf[j][1]);
            mma_bf16(acc[2 * j + 1], af, bf[j][2], bf[j][3]);
          }
      }
    }
    const float ea = ia < ql ? exp2f(cia) : 0.f;
    const float eb = ib < ql ? exp2f(cib) : 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= ea;
      acc[n][1] *= ea;
      acc[n][2] *= eb;
      acc[n][3] *= eb;
    }
  }

  for (int kt = 0; kt <= qt; ++kt) {
    // this tile's C B^T values, in flight across the barrier
    float2 g[T / 16][4];
    if (active) load_g(g, kt);
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // u tile kt landed; every warp is done with kt - 1's
    if (kt + STAGES - 1 <= qt)
      load_rows(ring + ((kt + STAGES - 1) % STAGES) * TILE, ub, a.uss,
                (kt + STAGES - 1) * T, ql, a.dh, tid);
    cp_async_commit();
    if (!active) continue;
    // the next key tile's C B^T values, in flight during this tile's math
    const int nkc = kt == qt ? w + 1 : T / 16;  // keys up to this warp's rows
    const uint16_t* su = ring + (kt % STAGES) * TILE;
#pragma unroll
    for (int kc = 0; kc < T / 16; ++kc) {
      if (kc >= nkc) break;
      const int j = kt * T + kc * 16 + 2 * tq;
      // G = (C B^T) exp(cum_i - cum_j) dt_j for j <= i < ql, else 0
      const float2 cj0 = *reinterpret_cast<const float2*>(cum + j);
      const float2 cj8 = *reinterpret_cast<const float2*>(cum + j + 8);
      const float2 dj0 = *reinterpret_cast<const float2*>(dts + j);
      const float2 dj8 = *reinterpret_cast<const float2*>(dts + j + 8);
      auto gv = [&](float cbv, int i, float ci, int jj, float cj, float dj) {
        return jj <= i && i < ql ? cbv * exp2f(ci - cj) * dj : 0.f;
      };
      uint32_t pa[4][P];
      split_pair(gv(g[kc][0].x, ia, cia, j, cj0.x, dj0.x),
                 gv(g[kc][0].y, ia, cia, j + 1, cj0.y, dj0.y), pa[0]);
      split_pair(gv(g[kc][1].x, ib, cib, j, cj0.x, dj0.x),
                 gv(g[kc][1].y, ib, cib, j + 1, cj0.y, dj0.y), pa[1]);
      split_pair(gv(g[kc][2].x, ia, cia, j + 8, cj8.x, dj8.x),
                 gv(g[kc][2].y, ia, cia, j + 9, cj8.y, dj8.y), pa[2]);
      split_pair(gv(g[kc][3].x, ib, cib, j + 8, cj8.x, dj8.x),
                 gv(g[kc][3].y, ib, cib, j + 9, cj8.y, dj8.y), pa[3]);
      uint32_t af[P][4];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int r = 0; r < 4; ++r) af[p][r] = pa[r][p];
      // B (j, d) = u (j, d), d contiguous: ldmatrix.trans; each piece of
      // G into the 8 independent accumulators in turn
      uint32_t bf[4][4];
#pragma unroll
      for (int jd = 0; jd < 4; ++jd)
        if (16 * jd < a.dh)
          ldmatrix_x4<true>(bf[jd], su + (kc * 16 + (lane & 7) +
                                          ((lane >> 3) & 1) * 8) * ST +
                                        16 * jd + (lane >> 4) * 8);
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int jd = 0; jd < 4; ++jd)
          if (16 * jd < a.dh) {
            mma_bf16(acc[2 * jd], af[p], bf[jd][0], bf[jd][1]);
            mma_bf16(acc[2 * jd + 1], af[p], bf[jd][2], bf[jd][3]);
          }
    }
  }
  cp_async_wait<0>();
  if (!active) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = hh ? ib : ia;
    if (i >= ql) continue;
    float* row = a.y + ((static_cast<long long>(b) * a.S + c0 + i) * a.H +
                        h) * a.dh;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (8 * n >= a.dh) break;
      *reinterpret_cast<float2*>(row + 8 * n + 2 * tq) =
          make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
    }
  }
}

// Dynamic shared memory in bytes, for padded chunk length QP.
int chunk_smem(int qp) { return 2 * qp * 4 + 2 * STAGES * TILE * 2; }
int out_smem(int qp) { return 2 * qp * 4 + (STAGES + 1 + P) * TILE * 2; }

template <class K>
int prepare(K kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory: kernel 0 = ssd_chunk, 2 = ssd_out (1,
// ssd_pass, has none), for chunk length Q.
int ssd_scan_tc_smem_bytes(int kernel, int Q) {
  const int qp = (Q + T - 1) / T * T;
  if (kernel == 0) return chunk_smem(qp);
  if (kernel == 2) return out_smem(qp);
  return 0;
}

int ssd_scan_tc_pieces() { return P; }

// u, B, C bf16; dt, A f32; y, state f32 contiguous. Workspace (f32
// elements): cb Bz nc QP^2, cw Bz nc H 2 QP, and with nc > 1 sc Bz nc H
// dh N and sp (bf16) Bz nc H P dh N; the wrapper carves it. Returns the
// first nonzero cudaError_t of the launches (0 = launched).
int ssd_scan_tc(const void* u, const float* dt, const float* A,
                const void* B, const void* C, float* y, float* state,
                float* cb, float* cw, float* sc, void* sp, long long usb,
                long long uss, long long ush, long long bsb, long long bss,
                long long csb, long long css, int Bz, int S, int H, int dh,
                int N, int Q, void* stream) {
  const int qp = (Q + T - 1) / T * T, nt = qp / T;
  const int nc = (S + Q - 1) / Q;
  const Args a{static_cast<const uint16_t*>(u), dt, A,
               static_cast<const uint16_t*>(B),
               static_cast<const uint16_t*>(C), y, state, cb, cw, sc,
               static_cast<uint16_t*>(sp), usb, uss, ush, bsb, bss, csb, css,
               Bz, S, H, dh, N, Q, qp, nc, nt * (nt + 1) / 2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = prepare(ssd_chunk, chunk_smem(qp));
  if (err) return err;
  ssd_chunk<<<dim3(a.pairs + H, nc, Bz), THREADS, chunk_smem(qp), st>>>(a);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if (nc > 1) {
    const int per = 4 * THREADS;
    ssd_pass<<<dim3((dh * N + per - 1) / per, H, Bz), THREADS, 0, st>>>(a);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  if ((err = prepare(ssd_out, out_smem(qp)))) return err;
  ssd_out<<<dim3(H, nt, Bz * nc), THREADS, out_smem(qp), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
