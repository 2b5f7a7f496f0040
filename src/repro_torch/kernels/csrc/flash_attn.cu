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
// scratch. Here nothing is padded or copied: the kernel reads q, k and v
// through their (B, S, H) strides, maps query head h to KV head
// h / (H / KVH), and masks the ragged Sq and Sk itself. One CTA owns one
// (batch, head, 64-query tile) and loops over 64-key tiles staged in
// shared memory; the running max m, the normaliser l and the accumulator
// stay in registers. A key tile that lies wholly outside the causal or
// window range of every query of the CTA is skipped, as the TPU kernel
// skips it with pl.when.
//
// What bounds it on an H100: at the path's shapes (ViT 197 tokens, dh 64,
// f32; qwen2 512 tokens, dh 64, bf16) the operations, 4 B H Sq Sk_vis dh
// flops against 4 B S H dh bytes: ~S / 2 flops a byte, above the f32
// CUDA-core ridge (20 flops a byte) and near bf16's (295) only for long
// sequences.
//
// f32: CUDA-core FMAs (no TF32: the f32 parity tier), 256 threads; thread
// (ty, tx) owns rows 4 ty .. +4 and keys 4 tx .. +4 of the score tile and
// the same rows of the output in groups of 4 columns every 64. q and k are
// staged d-major (a float4 of 4 rows or 4 keys per read), p goes through
// shared memory to the p . v product.
// bf16: mma.sync m16n8k16 with f32 accumulators, 4 warps of 16 query rows
// (the FlashAttention-2 layout); the score accumulators are repacked as
// the A operand of p . v, p rounded to bf16 first, as the TPU kernel does
// (p.astype(v.dtype)); the normaliser sums p unrounded. v is staged
// transposed so both products read their B operand k-contiguous. dh is
// padded with zeros in shared memory to a power of two >= 16.
//
// Not yet done (later PRs): wgmma, TMA and a pipelined ring of K/V tiles,
// exp2 with a folded log2(e) scale.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;  // query rows a CTA
constexpr int BK = 64;  // keys a tile

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, H, KVH, dh;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal, window, vec;
  float scale;
};

// Is key tile [k0, k0 + BK) wholly outside the visible range of every
// query in [q0, q0 + BQ)? (flash_attention.py:40-49)
__device__ __forceinline__ bool skip_tile(const Args& a, int q0, int k0) {
  if (a.causal && k0 > q0 + BQ - 1) return true;
  if (a.window > 0 && k0 + BK - 1 <= q0 - a.window) return true;
  return false;
}

__device__ __forceinline__ bool visible(const Args& a, int qpos, int kpos) {
  bool ok = kpos < a.Sk;
  if (a.causal) ok = ok && kpos <= qpos;
  if (a.window > 0) ok = ok && kpos > qpos - a.window;
  return ok;
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int F_THREADS = 256;
constexpr int FP = BQ + 4;  // padded row of the d-major q and k tiles

// Load 4 consecutive d of row s of a (B, S, heads, dh) f32 tensor, zeros
// outside the rows.
__device__ __forceinline__ float4 load4(const float* p, long long off,
                                        bool in, int vec) {
  if (!in) return make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec) return *reinterpret_cast<const float4*>(p + off);
  return make_float4(p[off], p[off + 1], p[off + 2], p[off + 3]);
}

// grid (ceil(Sq / BQ), H, B). Shared memory: qs[dh][FP], ks[dh][FP] (d
// major), vs[BK][dh], ps[BK][FP] (key major), all f32.
template <int DG>
__global__ void __launch_bounds__(F_THREADS) flash_f32(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int dh = a.dh;
  float* qs = smem;
  float* ks = qs + dh * FP;
  float* vs = ks + dh * FP;
  float* ps = vs + BK * dh;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KVH);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const int d4 = dh / 4;

  for (int e = tid; e < BQ * d4; e += F_THREADS) {
    const int r = e / d4, d = (e % d4) * 4;
    const float4 t = load4(q, b * a.qsb + (q0 + r) * a.qss + h * a.qsh + d,
                           q0 + r < a.Sq, a.vec);
    qs[(d + 0) * FP + r] = t.x;
    qs[(d + 1) * FP + r] = t.y;
    qs[(d + 2) * FP + r] = t.z;
    qs[(d + 3) * FP + r] = t.w;
  }

  float m[4], l[4], acc[4][DG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < DG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.f;
  }

  const int n_tiles = (a.Sk + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    if (skip_tile(a, q0, k0)) continue;  // uniform over the CTA
    __syncthreads();  // the last tile's readers are done with ks, vs, ps
    for (int e = tid; e < BK * d4; e += F_THREADS) {
      const int j = e / d4, d = (e % d4) * 4;
      const bool in = k0 + j < a.Sk;
      const float4 tk = load4(k, b * a.ksb + (k0 + j) * a.kss + kvh * a.ksh + d,
                              in, a.vec);
      ks[(d + 0) * FP + j] = tk.x;
      ks[(d + 1) * FP + j] = tk.y;
      ks[(d + 2) * FP + j] = tk.z;
      ks[(d + 3) * FP + j] = tk.w;
      const float4 tv = load4(v, b * a.vsb + (k0 + j) * a.vss + kvh * a.vsh + d,
                              in, a.vec);
      *reinterpret_cast<float4*>(&vs[j * dh + d]) = tv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&qs[d * FP + ty * 4]);
      const float4 kb = *reinterpret_cast<const float4*>(&ks[d * FP + tx * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // scale, mask, online softmax; a row's 64 keys are spread over the 16
    // lanes tx of one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(a, qpos, k0 + tx * 4 + j) ? s[i][j] * a.scale
                                                     : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + sum;  // this thread's share; summed at the end
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < DG; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][g][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&ps[(tx * 4 + j) * FP + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(&ps[j * FP + ty * 4]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int g = 0; g < DG; ++g) {
        const int d = g * 64 + tx * 4;
        if (d < dh) {
          const float4 vb = *reinterpret_cast<const float4*>(&vs[j * dh + d]);
          const float vv[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[i][g][c] = fmaf(pv[i], vv[c], acc[i][g][c]);
        }
      }
    }
  }

  float* o = static_cast<float*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= a.Sq) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    float* row = o + ((static_cast<long long>(b) * a.Sq + qpos) * a.H + h) * dh;
#pragma unroll
    for (int g = 0; g < DG; ++g) {
      const int d = g * 64 + tx * 4;
      if (d < dh)
        *reinterpret_cast<float4*>(row + d) =
            make_float4(acc[i][g][0] * inv, acc[i][g][1] * inv,
                        acc[i][g][2] * inv, acc[i][g][3] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int B_THREADS = 128;  // 4 warps x 16 query rows
constexpr int VP = BK + 8;      // padded row of the transposed v tile

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t u = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (u << 16);
}

// 8 consecutive d (d % 8 == 0) of one row of a (B, S, heads, dh) bf16
// tensor; zeros outside the rows or past dh.
__device__ __forceinline__ uint4 load8(const uint16_t* p, long long off,
                                       bool in, int vec) {
  if (!in) return make_uint4(0u, 0u, 0u, 0u);
  if (vec) return *reinterpret_cast<const uint4*>(p + off);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = static_cast<uint32_t>(p[off + 2 * i]) |
           (static_cast<uint32_t>(p[off + 2 * i + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// grid (ceil(Sq / BQ), H, B). Shared memory: qs[BQ][DP + 8], ks[BK][DP + 8]
// (d contiguous), vt[DP][VP] (key contiguous), bf16 bits.
template <int DP>
__global__ void __launch_bounds__(B_THREADS) flash_bf16(Args a) {
  constexpr int QP = DP + 8;
  constexpr int NKC = DP / 16;  // k-steps of q . k^T
  constexpr int NDT = DP / 8;   // n-tiles of p . v
  extern __shared__ __align__(16) uint16_t sm16[];
  uint16_t* qs = sm16;
  uint16_t* ks = qs + BQ * QP;
  uint16_t* vt = ks + BK * QP;
  const int dh = a.dh;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KVH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const uint16_t* q = static_cast<const uint16_t*>(a.q);
  const uint16_t* k = static_cast<const uint16_t*>(a.k);
  const uint16_t* v = static_cast<const uint16_t*>(a.v);

  for (int e = tid; e < BQ * (DP / 8); e += B_THREADS) {
    const int r = e / (DP / 8), d = (e % (DP / 8)) * 8;
    *reinterpret_cast<uint4*>(&qs[r * QP + d]) =
        load8(q, b * a.qsb + (q0 + r) * a.qss + h * a.qsh + d,
              q0 + r < a.Sq && d < dh, a.vec);
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  const int n_tiles = (a.Sk + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    if (skip_tile(a, q0, k0)) continue;  // uniform over the CTA
    __syncthreads();  // the last tile's readers are done with ks, vt
    for (int e = tid; e < BK * (DP / 8); e += B_THREADS) {
      const int j = e / (DP / 8), d = (e % (DP / 8)) * 8;
      const bool in = k0 + j < a.Sk && d < dh;
      *reinterpret_cast<uint4*>(&ks[j * QP + d]) =
          load8(k, b * a.ksb + (k0 + j) * a.kss + kvh * a.ksh + d, in, a.vec);
      const uint4 w =
          load8(v, b * a.vsb + (k0 + j) * a.vss + kvh * a.vsh + d, in, a.vec);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        vt[(d + 2 * i) * VP + j] = static_cast<uint16_t>(ws[i]);
        vt[(d + 2 * i + 1) * VP + j] = static_cast<uint16_t>(ws[i] >> 16);
      }
    }
    __syncthreads();

    // s (16 x 64) of this warp's rows: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int kc = 0; kc < NKC; ++kc) {
      if (kc * 16 >= dh) break;  // zero padding past dh
      const uint16_t* qa = &qs[(warp * 16 + g) * QP + kc * 16 + 2 * t];
      const uint32_t a0 = ld_pair(qa), a1 = ld_pair(qa + 8 * QP);
      const uint32_t a2 = ld_pair(qa + 8), a3 = ld_pair(qa + 8 * QP + 8);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint16_t* kb = &ks[(n * 8 + g) * QP + kc * 16 + 2 * t];
        mma_bf16(s[n], a0, a1, a2, a3, ld_pair(kb), ld_pair(kb + 8));
      }
    }

    // scale, mask, online softmax: element c of n-tile n sits at row
    // r0 + 8 (c / 2), key k0 + 8 n + 2 t + c % 2; a row's keys are spread
    // over the 4 lanes t of a quad
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qpos = q0 + r0 + 8 * hh;
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[n][2 * hh + c];
          x = visible(a, qpos, k0 + 8 * n + 2 * t + c) ? x * a.scale : NEG_INF;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      const float alpha = expf(m[hh] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[n][2 * hh + c];
          x = expf(x - m_new);
          sum += x;
        }
      l[hh] = l[hh] * alpha + sum;  // this thread's share; summed at the end
      m[hh] = m_new;
#pragma unroll
      for (int n = 0; n < NDT; ++n) {
        o[n][2 * hh] *= alpha;
        o[n][2 * hh + 1] *= alpha;
      }
    }

    // o += p . v: the score accumulators of n-tiles 2c and 2c + 1 are the
    // A fragment of k-step c (keys 16 c .. +16), rounded to bf16
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t a0 = pack_bf16(s[2 * c][0], s[2 * c][1]);
      const uint32_t a1 = pack_bf16(s[2 * c][2], s[2 * c][3]);
      const uint32_t a2 = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
#pragma unroll
      for (int n = 0; n < NDT; ++n) {
        if (n * 8 >= dh) break;
        const uint16_t* vb = &vt[(n * 8 + g) * VP + c * 16 + 2 * t];
        mma_bf16(o[n], a0, a1, a2, a3, ld_pair(vb), ld_pair(vb + 8));
      }
    }
  }

  uint16_t* out = static_cast<uint16_t*>(a.o);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float li = l[hh];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int qpos = q0 + r0 + 8 * hh;
    if (qpos >= a.Sq) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    uint16_t* row =
        out + ((static_cast<long long>(b) * a.Sq + qpos) * a.H + h) * dh;
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      const int d = n * 8 + 2 * t;
      if (d < dh)
        *reinterpret_cast<uint32_t*>(row + d) =
            pack_bf16(o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, int threads, int smem, const Args& a,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const Args& a, cudaStream_t stream) {
  const int smem = (2 * a.dh * FP + BK * a.dh + BK * FP) * 4;
  if (a.dh <= 64) return launch(flash_f32<1>, F_THREADS, smem, a, stream);
  if (a.dh <= 128) return launch(flash_f32<2>, F_THREADS, smem, a, stream);
  return launch(flash_f32<4>, F_THREADS, smem, a, stream);
}

template <int DP>
int launch_bf16_dp(const Args& a, cudaStream_t stream) {
  const int smem = ((BQ + BK) * (DP + 8) + DP * VP) * 2;
  return launch(flash_bf16<DP>, B_THREADS, smem, a, stream);
}

int launch_bf16(const Args& a, cudaStream_t stream) {
  if (a.dh <= 16) return launch_bf16_dp<16>(a, stream);
  if (a.dh <= 32) return launch_bf16_dp<32>(a, stream);
  if (a.dh <= 64) return launch_bf16_dp<64>(a, stream);
  if (a.dh <= 128) return launch_bf16_dp<128>(a, stream);
  return launch_bf16_dp<256>(a, stream);
}

}  // namespace

extern "C" {

// dtype (q, k, v and o): 0 = float32, 1 = bfloat16. Strides in elements;
// each tensor's dh axis has unit stride and o is contiguous. ``vec`` says
// every row start is 16-byte aligned (pointers and strides), so rows load
// 16 bytes at a time. Returns the cudaError_t of the launch (0 =
// launched); the wrapper checks shapes (dh % 8 == 0, dh <= 256, H % KVH ==
// 0, Sq > 0, Sk > 0).
int flash_attn(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Sk, int H, int KVH, int dh, long long qsb,
               long long qss, long long qsh, long long ksb, long long kss,
               long long ksh, long long vsb, long long vss, long long vsh,
               int causal, int window, float scale, int vec, int dtype,
               void* stream) {
  const Args a{q, k, v, o, B, Sq, Sk, H, KVH, dh,
               qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
               causal, window, vec, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_bf16(a, st) : launch_f32(a, st);
}

}  // extern "C"
