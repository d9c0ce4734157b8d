// Chunked-prefill (flash) attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/chunked_prefill_attention.py :: chunked_prefill_attention
//   (kernel body `_kernel`; its padding wrapper is ops.chunked_prefill_attention_op).
//
// What it computes: a chunk of Tq queries at global positions offsets[b]+i
// attends, causally (kpos <= qpos), to (B,S,KV,hd) K/V that already holds
// the chunk's own K/V.  GQA reads kv_head = h / qpk with no replication.
// Online softmax (m, l, acc) in f32, masked scores -1e30, l floored at
// 1e-30; optional (B,S) per-token f32 dequant scales.  The output has q's
// dtype.
//
// What bounds it on an H100: operations at prefill sizes.  A chunk does
// 4*hd flops per (query, visible key, head) against 2*KV*hd*itemsize bytes
// per key, so a 512-token chunk sits well above the card's ~295 flop/byte
// ridge; the least time is its causal flops over the bf16 tensor-core peak.
//
// Design.  One CTA per (q-tile, head, b) loops over KV tiles only up to the
// causal frontier of its last valid row, so tiles wholly above the frontier
// are never read.  Ragged Tq and S edges are masked in the kernel (rows
// past Tq are never written, keys past S or past the frontier load as zero
// and score -1e30), so the wrapper pads nothing.  Two bodies:
//
// * bf16 queries (the serving path): tensor cores through mma.sync
//   m16n8k16 (bf16 in, f32 accumulate), flash-attention-2 style.  Four
//   warps each own 16 of the tile's 64 query rows and keep their Q
//   fragments, scores, online-softmax state and output accumulator in
//   registers; K and V tiles of 64 keys are staged in shared memory as
//   bf16.  fp8 and int8 codes convert to bf16 exactly, and their per-token
//   scales are applied to the f32 scores (K) and to the probabilities
//   before the P.V product (V), so no dequantized copy is rounded.  The
//   probabilities enter the P.V product rounded to bf16, as in
//   flash-attention-2.  No cp.async/TMA pipelining and no wgmma yet: those
//   are later work.
// * f32 queries: f32 FMAs on tiles staged in shared memory as f32 (each
//   thread owns a 4x4 block of the score tile and a 4 x hd/8 block of the
//   output), so f32 callers get f32 arithmetic throughout.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 32;        // keys per loop step
constexpr int THREADS = 128;  // 16 row groups x 8 column lanes
constexpr int MAX_K = 16;     // hd / 8, so hd <= 128
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

size_t smem_bytes(int hd) {
  const int ld = hd + 1;
  return sizeof(float) * (BQ * ld + BK * ld + BK * hd + BQ * (BK + 1));
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
chunked_prefill_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                       const TKV* __restrict__ v, const int* __restrict__ offsets,
                       const float* __restrict__ ks, const float* __restrict__ vs,
                       TQ* __restrict__ out, int Tq, int S, int H, int KV, int hd,
                       float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;           // padded row stride: conflict-free column reads
  float* q_s = smem;               // BQ x ld
  float* k_s = q_s + BQ * ld;      // BK x ld
  float* v_s = k_s + BK * ld;      // BK x hd
  float* p_s = v_s + BK * hd;      // BQ x (BK+1)

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int qpk = H / KV, kvh = h / qpk;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int nk = hd / 8;
  const int off = offsets[b];

  for (int e = tid; e < BQ * hd; e += THREADS) {
    const int r = e / hd, d = e - r * hd;
    const int t = q0 + r;
    q_s[r * ld + d] = t < Tq ? to_f(q[(((size_t)b * Tq + t) * H + h) * hd + d]) : 0.f;
  }

  float m[4], l[4], acc[4][MAX_K];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MAX_K; ++kk) acc[i][kk] = 0.f;
  }

  const int q_last = min(q0 + BQ, Tq) - 1;
  const int kv_end = min(S, off + q_last + 1);   // causal frontier of the tile

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();   // Q staged / previous step done with k_s, v_s, p_s
    for (int e = tid; e < BK * hd; e += THREADS) {
      const int c = e / hd, d = e - c * hd;
      const int s = k0 + c;
      float kf = 0.f, vf = 0.f;
      if (s < kv_end) {
        const size_t idx = (((size_t)b * S + s) * KV + kvh) * hd + d;
        kf = to_f(k[idx]);
        vf = to_f(v[idx]);
        if (ks) kf *= ks[(size_t)b * S + s];
        if (vs) vf *= vs[(size_t)b * S + s];
      }
      k_s[c * ld + d] = kf;
      v_s[c * hd + d] = vf;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = q_s[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = k_s[(tx + 8 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += qa[i] * kb[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qpos = off + q0 + r;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 8 * j;
        const float s = (kpos <= qpos && kpos < kv_end) ? sc[i][j] * scale : NEG_INF;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - mx);
        sum += p;
        p_s[r * (BK + 1) + tx + 8 * j] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const float alpha = expf(m[i] - mx);
      l[i] = l[i] * alpha + sum;
      m[i] = mx;
#pragma unroll
      for (int kk = 0; kk < MAX_K; ++kk) acc[i][kk] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = p_s[(ty * 4 + i) * (BK + 1) + c];
#pragma unroll
      for (int kk = 0; kk < MAX_K; ++kk) {
        if (kk < nk) {
          const float vv = v_s[c * hd + tx + 8 * kk];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][kk] += pa[i] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= Tq) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
    TQ* orow = out + (((size_t)b * Tq + t) * H + h) * hd;
#pragma unroll
    for (int kk = 0; kk < MAX_K; ++kk)
      if (kk < nk) orow[tx + 8 * kk] = from_f<TQ>(acc[i][kk] * inv_l);
  }
}

// ---------------------------------------------------------------------------
// bf16 queries: tensor cores
// ---------------------------------------------------------------------------
constexpr int MBQ = 64;       // query rows per CTA (16 per warp)
constexpr int MBK = 64;       // keys per loop step
constexpr int MTHREADS = 128;

__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_h(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 h;
  h.x = lo;
  h.y = hi;
  return *reinterpret_cast<uint32_t*>(&h);
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// eight consecutive elements as bf16 (exact for bf16, fp8-e4m3 and int8)
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
template <typename T>
__device__ __forceinline__ uint4 load8(const T* p) {
  uint4 r;
  uint32_t* w = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = pack_f(to_f(p[2 * i]), to_f(p[2 * i + 1]));
  return r;
}

template <int HD>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (MBQ + 2 * MBK) * (HD + 8) + sizeof(float) * 2 * MBK;
}

template <int HD, typename TKV>
__global__ void __launch_bounds__(MTHREADS)
chunked_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q, const TKV* __restrict__ k,
                           const TKV* __restrict__ v, const int* __restrict__ offsets,
                           const float* __restrict__ ks, const float* __restrict__ vs,
                           __nv_bfloat16* __restrict__ out, int Tq, int S, int H, int KV,
                           float scale) {
  constexpr int LD = HD + 8;     // smem row stride in bf16: conflict-free fragments
  constexpr int CH = HD / 8;     // 16-byte chunks per row
  constexpr int NKK = HD / 16;   // k-steps of Q.K^T over the head dim
  constexpr int NB = MBK / 8;    // score n-blocks per tile
  constexpr int NO = HD / 8;     // output n-blocks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // MBQ x LD
  __nv_bfloat16* k_s = q_s + MBQ * LD;                                // MBK x LD
  __nv_bfloat16* v_s = k_s + MBK * LD;                                // MBK x LD
  float* ksc_s = reinterpret_cast<float*>(v_s + MBK * LD);            // MBK
  float* vsc_s = ksc_s + MBK;                                         // MBK

  const int q0 = blockIdx.x * MBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int off = offsets[b];
  const int kv_end = min(S, off + min(q0 + MBQ, Tq));   // causal frontier of the tile

  for (int e = tid; e < MBQ * CH; e += MTHREADS) {
    const int r = e / CH, c = (e - r * CH) * 8;
    const int t = q0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < Tq) val = load8(q + (((size_t)b * Tq + t) * H + h) * HD + c);
    *reinterpret_cast<uint4*>(q_s + r * LD + c) = val;
  }
  __syncthreads();

  const int r0 = warp * 16;
  uint32_t qa[NKK][4];
#pragma unroll
  for (int kk = 0; kk < NKK; ++kk) {
    const __nv_bfloat16* base = q_s + (r0 + gid) * LD + kk * 16 + tig * 2;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LD);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LD + 8);
  }
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // rows gid, gid+8
  const int qpos0 = off + q0 + r0 + gid, qpos1 = qpos0 + 8;

  for (int k0 = 0; k0 < kv_end; k0 += MBK) {
    __syncthreads();   // the previous tile is consumed
    for (int e = tid; e < MBK * CH; e += MTHREADS) {
      const int r = e / CH, c = (e - r * CH) * 8;
      const int s = k0 + r;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (s < kv_end) {
        const size_t idx = (((size_t)b * S + s) * KV + kvh) * HD + c;
        kv4 = load8(k + idx);
        vv4 = load8(v + idx);
      }
      *reinterpret_cast<uint4*>(k_s + r * LD + c) = kv4;
      *reinterpret_cast<uint4*>(v_s + r * LD + c) = vv4;
    }
    for (int c = tid; c < MBK; c += MTHREADS) {
      const int s = k0 + c;
      const bool in = s < kv_end;
      ksc_s[c] = in ? (ks ? ks[(size_t)b * S + s] : 1.f) : 0.f;
      vsc_s[c] = in ? (vs ? vs[(size_t)b * S + s] : 1.f) : 0.f;
    }
    __syncthreads();

    // scores S = Q K^T for this warp's 16 rows x 64 keys
    float sc[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NKK; ++kk) {
        const __nv_bfloat16* kb = k_s + (j * 8 + gid) * LD + kk * 16 + tig * 2;
        mma_bf16(sc[j], qa[kk], *reinterpret_cast<const uint32_t*>(kb),
                 *reinterpret_cast<const uint32_t*>(kb + 8));
      }
    }
    // scale, dequantize K, mask; row max over the quad that shares a row
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + tig * 2 + e, key = k0 + c;
        const float f = scale * ksc_s[c];
        const bool live = key < kv_end;
        sc[j][e] = (live && key <= qpos0) ? sc[j][e] * f : NEG_INF;
        sc[j][2 + e] = (live && key <= qpos1) ? sc[j][2 + e] * f : NEG_INF;
        mx0 = fmaxf(mx0, sc[j][e]);
        mx1 = fmaxf(mx1, sc[j][2 + e]);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = expf(m0 - mx0), a1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }
    // probabilities; the V scale folds into them before the P.V product
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float vsc = vsc_s[j * 8 + tig * 2 + e];
        const float p0 = sc[j][e] <= 0.5f * NEG_INF ? 0.f : expf(sc[j][e] - mx0);
        const float p1 = sc[j][2 + e] <= 0.5f * NEG_INF ? 0.f : expf(sc[j][2 + e] - mx1);
        l0 += p0;
        l1 += p1;
        sc[j][e] = p0 * vsc;
        sc[j][2 + e] = p1 * vsc;
      }
    // O += P V: the score accumulators are the A fragments of P
#pragma unroll
    for (int kk = 0; kk < MBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_f(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_f(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_f(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_f(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* vb = v_s + (kk * 16 + tig * 2) * LD + n * 8 + gid;
        mma_bf16(o[n], pa, pack_h(vb[0], vb[LD]), pack_h(vb[8 * LD], vb[9 * LD]));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int t0 = q0 + r0 + gid, t1 = t0 + 8;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + tig * 2;
    if (t0 < Tq)
      *reinterpret_cast<uint32_t*>(out + (((size_t)b * Tq + t0) * H + h) * HD + c) =
          pack_f(o[n][0] * inv0, o[n][1] * inv0);
    if (t1 < Tq)
      *reinterpret_cast<uint32_t*>(out + (((size_t)b * Tq + t1) * H + h) * HD + c) =
          pack_f(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int HD, typename TKV>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* offsets,
                       const void* ks, const void* vs, void* out, int B, int Tq, int S,
                       int H, int KV, float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<HD>();
  auto kern = chunked_prefill_mma_kernel<HD, TKV>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((Tq + MBQ - 1) / MBQ, H, B);
  kern<<<grid, MTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(offsets),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<__nv_bfloat16*>(out), Tq, S, H, KV, scale);
  return cudaGetLastError();
}

template <typename TKV>
cudaError_t launch_mma_hd(int hd, const void* q, const void* k, const void* v,
                          const void* offsets, const void* ks, const void* vs, void* out,
                          int B, int Tq, int S, int H, int KV, float scale,
                          cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_mma<32, TKV>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, scale, stream);
    case 64: return launch_mma<64, TKV>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, scale, stream);
    default: return launch_mma<128, TKV>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, scale, stream);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* offsets,
                   const void* ks, const void* vs, void* out, int B, int Tq, int S,
                   int H, int KV, int hd, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  auto kern = chunked_prefill_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const int*>(offsets), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<TQ*>(out), Tq, S, H, KV, hd, scale);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_kv(int kv_dtype, const void* q, const void* k, const void* v,
                      const void* offsets, const void* ks, const void* vs, void* out,
                      int B, int Tq, int S, int H, int KV, int hd, float scale,
                      cudaStream_t stream) {
  if (sizeof(TQ) == 2 && (hd == 32 || hd == 64 || hd == 128)) {
    switch (kv_dtype) {
      case 0: return launch_mma_hd<float>(hd, q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, scale, stream);
      case 1: return launch_mma_hd<__nv_bfloat16>(hd, q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, scale, stream);
      case 2: return launch_mma_hd<__nv_fp8_e4m3>(hd, q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, scale, stream);
      case 3: return launch_mma_hd<int8_t>(hd, q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, scale, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (kv_dtype) {
    case 0: return launch<TQ, float>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, hd, scale, stream);
    case 1: return launch<TQ, __nv_bfloat16>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, hd, scale, stream);
    case 2: return launch<TQ, __nv_fp8_e4m3>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, hd, scale, stream);
    case 3: return launch<TQ, int8_t>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, hd, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float8_e4m3fn, 3 int8.
// q/out (B,Tq,H,hd); k/v (B,S,KV,hd); offsets (B,) int32;
// ks/vs (B,S) float32 or null.  bf16 queries with hd 32, 64 or 128 take
// the tensor-core body and need 16-byte aligned q, k, v and out.
extern "C" int chunked_prefill_attention(const void* q, const void* k, const void* v,
                                         const void* offsets, const void* ks,
                                         const void* vs, void* out, int B, int Tq,
                                         int S, int H, int KV, int hd, int q_dtype,
                                         int kv_dtype, float scale, void* stream) {
  if (KV <= 0 || H % KV != 0 || hd % 8 != 0 || hd > 8 * MAX_K || B <= 0 || Tq <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (q_dtype) {
    case 0: err = launch_kv<float>(kv_dtype, q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, hd, scale, s); break;
    case 1: err = launch_kv<__nv_bfloat16>(kv_dtype, q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, hd, scale, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
