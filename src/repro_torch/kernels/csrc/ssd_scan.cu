// Mamba-2 SSD chunked scan for Hopper (sm_90a), f32 on CUDA cores.
//
//   u (Bz, S, H, dh), dt (Bz, S, H) > 0, A (H,) < 0, B and C (Bz, S, N),
//   all f32 and contiguous; per chunk of Q steps, with cum = cumsum(dt A)
//   inside the chunk and L[i, j] = exp(cum_i - cum_j) for j <= i:
//     y = ((C B^T) * L)(dt u) + exp(cum) * (C S^T)
//     S <- exp(cum_Q) S + (dt u exp(cum_Q - cum))^T B
//   from S = 0. Writes y (Bz, S, H, dh) without the D.u skip term and the
//   final S (Bz, H, dh, N), both f32 and contiguous.
//
// Replaces repro/kernels/ssd_scan.py::_ssd_kernel. Same function as the
// plain version repro_torch/kernels/ref.py::ssd_scan_ref (the reference's
// repro/nn/mamba.py::_ssd_chunked without D.u). The TPU kernel's grid is
// (Bz, H, chunks) with the chunk axis innermost and sequential, carrying
// the (dh, N) state in VMEM scratch from one chunk to the next, and it
// writes no final state. A GPU grid runs in no order, so here ONE CTA owns
// one (batch, head) and loops over the chunks in order, the state S held
// in shared memory (64 x 64 f32, 16 KB) for the whole sequence; the grid
// is (H, Bz). The final state is written once at the end (prefill needs
// it).
//
// Inside a chunk the work is tiled in 64 x 64 blocks, so a chunk of any
// length fits (zamba2's Q = 256 would need 256 KB for the whole
// (C B^T) * L): for each 64-row query tile, y starts from the carried
// state's term exp(cum_i) (C S^T) and adds, for each 64-key tile at or
// below the diagonal, G (dt u) with G = (C B^T) * L * dt computed tile by
// tile; key tiles above the diagonal are skipped. exp(cum_i - cum_j) is
// evaluated only where j <= i (above the diagonal it could overflow to
// inf, and inf * 0 would give NaN); there cum_i - cum_j <= 0. Then the
// state update runs over the chunk's key tiles. cum is an inclusive
// prefix sum inside the CTA (warp shuffles, then across the 8 warps).
//
// A ragged last chunk (S not a multiple of Q) is processed with its real
// length only: that is what the reference's zero-padding with dt = 0
// computes (identity steps: decay exp(0) = 1, no input), so no padded
// copy is made. dt = 0 past a row's valid length (bucketed prefill) needs
// nothing more.
//
// What bounds it on an H100: operations. A chunk of Q steps costs about
// 2 Q^2 N + Q^2 dh (the lower triangle) + 4 Q N dh flops per (batch,
// head) against 8 Q dh bytes of u and y: ~Q/2 flops a byte at dh = N =
// 64, above the f32 CUDA-core ridge (20 flops a byte). The design does
// all of it in f32 FMAs (no TF32: the f32 parity tier), each of the 256
// threads owning a 4 x 4 block of every 64 x 64 product, operands read
// as float4 from shared memory. C B^T is recomputed per head (the TPU
// kernel does the same). This is the `fma` route of kernels/ssd_scan.py:
// f32 inputs and dims the tensor cores' tiles do not take; bf16 u, B and
// C take ssd_scan_tc.cu (chunk-parallel, C B^T once per (batch, chunk),
// products on the bf16 tensor cores).

#include <cuda_runtime.h>

namespace {

constexpr int T = 64;          // rows of a query or key tile; max dh and N
constexpr int TP = T + 4;      // padded row of a shared-memory tile
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int WARPS = THREADS / 32;

struct Args {
  const float* u;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  float* y;
  float* state;
  int Bz, S, H, dh, N, Q;
};

// Inclusive prefix sum of dt * A over the chunk's ql steps into cum[],
// dt into dts[]. 256 steps a round: a shuffle scan in each warp, the warp
// totals scanned by warp 0, a carry across rounds.
__device__ void chunk_cumsum(const Args& a, const float* dtb, int c0,
                             int ql, float A, float* cum, float* dts,
                             float* wsum) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float carry = 0.f;
  for (int base = 0; base < ql; base += THREADS) {
    const int t = base + tid;
    const float d = t < ql ? dtb[static_cast<long long>(c0 + t) * a.H] : 0.f;
    float v = d * A;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float nb = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += nb;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    if (warp == 0) {
      float w = lane < WARPS ? wsum[lane] : 0.f;
#pragma unroll
      for (int off = 1; off < WARPS; off <<= 1) {
        const float nb = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += nb;
      }
      if (lane < WARPS) wsum[lane] = w;
    }
    __syncthreads();
    if (warp > 0) v += wsum[warp - 1];
    if (t < ql) {
      cum[t] = v + carry;
      dts[t] = d;
    }
    carry += wsum[WARPS - 1];
    __syncthreads();
  }
}

// grid (H, Bz), THREADS threads. Dynamic shared memory (f32):
//   St [T (n)][T (d)]      the carried state, transposed (S^T)
//   Cs [T (n)][TP (i)]     the query tile of C, n-major
//   Bs [T (n)][TP (j)]     the key tile of B, n-major; in the state
//                          update [T (j)][TP (n)], j-major, weighted
//   Us [T (j)][TP (d)]     the key tile of u
//   Gs [T (j)][TP (i)]     (C B^T) * L * dt of a (query, key) tile pair
//   cum [Q], dts [Q]
__global__ void __launch_bounds__(THREADS) ssd_scan_f32(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* St = smem;
  float* Cs = St + T * T;
  float* Bs = Cs + T * TP;
  float* Us = Bs + T * TP;
  float* Gs = Us + T * TP;
  float* cum = Gs + T * TP;
  float* dts = cum + a.Q;
  __shared__ float wsum[WARPS];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float A = a.A[h];
  const long long us = static_cast<long long>(a.H) * a.dh;  // u, y row
  const float* ub = a.u + (static_cast<long long>(b) * a.S * a.H + h) * a.dh;
  float* yb = a.y + (static_cast<long long>(b) * a.S * a.H + h) * a.dh;
  const float* dtb = a.dt + static_cast<long long>(b) * a.S * a.H + h;
  const float* Bb = a.B + static_cast<long long>(b) * a.S * a.N;
  const float* Cb = a.C + static_cast<long long>(b) * a.S * a.N;

  for (int e = tid; e < T * T; e += THREADS) St[e] = 0.f;

  for (int c0 = 0; c0 < a.S; c0 += a.Q) {
    const int ql = min(a.Q, a.S - c0);
    chunk_cumsum(a, dtb, c0, ql, A, cum, dts, wsum);
    const float cum_q = cum[ql - 1];
    const int n_tiles = (ql + T - 1) / T;

    for (int qt = 0; qt < n_tiles; ++qt) {
      const int i0 = qt * T;
      // C rows i0 .. i0 + 63 of the chunk, n-major (zeros past ql and N)
      for (int e = tid; e < T * T; e += THREADS) {
        const int r = e / T, n = e % T;
        Cs[n * TP + r] = (i0 + r < ql && n < a.N)
            ? Cb[static_cast<long long>(c0 + i0 + r) * a.N + n] : 0.f;
      }
      __syncthreads();

      // y = exp(cum_i) (C S^T): the carried state's term
      float acc[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) acc[ii][dd] = 0.f;
      for (int n = 0; n < a.N; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(&Cs[n * TP + 4 * ty]);
        const float4 sv = *reinterpret_cast<const float4*>(&St[n * T + 4 * tx]);
        const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
        const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int dd = 0; dd < 4; ++dd) acc[ii][dd] += c4[ii] * s4[dd];
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = i0 + 4 * ty + ii;
        const float e = i < ql ? expf(cum[i]) : 0.f;
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) acc[ii][dd] *= e;
      }

      // + G (u) over the key tiles at or below the diagonal
      for (int kt = 0; kt <= qt; ++kt) {
        const int j0 = kt * T;
        for (int e = tid; e < T * T; e += THREADS) {
          const int r = e / T, c = e % T;
          const bool row = j0 + r < ql;
          Bs[c * TP + r] = (row && c < a.N)
              ? Bb[static_cast<long long>(c0 + j0 + r) * a.N + c] : 0.f;
          Us[r * TP + c] = (row && c < a.dh)
              ? ub[static_cast<long long>(c0 + j0 + r) * us + c] : 0.f;
        }
        __syncthreads();
        float g[4][4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) g[ii][jj] = 0.f;
        for (int n = 0; n < a.N; ++n) {
          const float4 cv =
              *reinterpret_cast<const float4*>(&Cs[n * TP + 4 * ty]);
          const float4 bv =
              *reinterpret_cast<const float4*>(&Bs[n * TP + 4 * tx]);
          const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
          const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) g[ii][jj] += c4[ii] * b4[jj];
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = j0 + 4 * tx + jj;
          float gcol[4];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const int i = i0 + 4 * ty + ii;
            // the decay only on and below the diagonal: cum_i - cum_j <= 0
            gcol[ii] = (j <= i && i < ql)
                ? g[ii][jj] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
          }
          *reinterpret_cast<float4*>(&Gs[(4 * tx + jj) * TP + 4 * ty]) =
              make_float4(gcol[0], gcol[1], gcol[2], gcol[3]);
        }
        __syncthreads();
        const int jn = min(T, ql - j0);
        for (int j = 0; j < jn; ++j) {
          const float4 gv = *reinterpret_cast<const float4*>(&Gs[j * TP + 4 * ty]);
          const float4 uv = *reinterpret_cast<const float4*>(&Us[j * TP + 4 * tx]);
          const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
          const float u4[4] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int dd = 0; dd < 4; ++dd) acc[ii][dd] += g4[ii] * u4[dd];
        }
        __syncthreads();
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = i0 + 4 * ty + ii;
        if (i >= ql) continue;
        float* row = yb + static_cast<long long>(c0 + i) * us;
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) {
          const int d = 4 * tx + dd;
          if (d < a.dh) row[d] = acc[ii][dd];
        }
      }
    }

    // S <- exp(cum_Q) S + sum_j (dt_j exp(cum_Q - cum_j) B_j) u_j^T;
    // thread (ty, tx) owns S^T[4 ty .. +4][4 tx .. +4]
    float sacc[4][4];
    const float decay = expf(cum_q);
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int dd = 0; dd < 4; ++dd)
        sacc[nn][dd] = decay * St[(4 * ty + nn) * T + 4 * tx + dd];
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int j0 = kt * T;
      for (int e = tid; e < T * T; e += THREADS) {
        const int r = e / T, c = e % T;
        const bool row = j0 + r < ql;
        const float w = row ? dts[j0 + r] * expf(cum_q - cum[j0 + r]) : 0.f;
        Bs[r * TP + c] = (row && c < a.N)
            ? w * Bb[static_cast<long long>(c0 + j0 + r) * a.N + c] : 0.f;
        Us[r * TP + c] = (row && c < a.dh)
            ? ub[static_cast<long long>(c0 + j0 + r) * us + c] : 0.f;
      }
      __syncthreads();
      const int jn = min(T, ql - j0);
      for (int j = 0; j < jn; ++j) {
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[j * TP + 4 * ty]);
        const float4 uv = *reinterpret_cast<const float4*>(&Us[j * TP + 4 * tx]);
        const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
        const float u4[4] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int dd = 0; dd < 4; ++dd) sacc[nn][dd] += b4[nn] * u4[dd];
      }
      __syncthreads();
    }
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int dd = 0; dd < 4; ++dd)
        St[(4 * ty + nn) * T + 4 * tx + dd] = sacc[nn][dd];
    __syncthreads();
  }

  // final state (Bz, H, dh, N): state[b, h, d, n] = S^T[n][d]
  float* sb = a.state + (static_cast<long long>(b) * a.H + h) * a.dh * a.N;
  for (int e = tid; e < a.dh * a.N; e += THREADS) {
    const int d = e / a.N, n = e % a.N;
    sb[e] = St[n * T + d];
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA for chunk length Q, in bytes.
int ssd_scan_smem_bytes(int Q) {
  return static_cast<int>(sizeof(float)) * (T * T + 4 * T * TP + 2 * Q);
}

// All tensors f32 and contiguous; the wrapper checks shapes (dh <= 64,
// N <= 64, 0 < Q, Q within the shared memory, S > 0). Returns the
// cudaError_t of the launch (0 = launched).
int ssd_scan(const float* u, const float* dt, const float* A, const float* B,
             const float* C, float* y, float* state, int Bz, int S, int H,
             int dh, int N, int Q, void* stream) {
  const Args a{u, dt, A, B, C, y, state, Bz, S, H, dh, N, Q};
  const int smem = ssd_scan_smem_bytes(Q);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(H, Bz);
  ssd_scan_f32<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
