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
// past Tq are never written, keys past S or past the frontier score
// -1e30), so the wrapper pads nothing.  q, k and v are read through their
// batch and row strides, so they may be row views of larger buffers.  The
// body is chosen by dtype and shape before launch:
//
// * bf16 queries at hd 128 on a bf16 pool (the serving path), or on an fp8
//   or int8 pool: TMA + wgmma, warp-specialised in the flash-attention-3
//   shape.  A CTA is three warpgroups.  The producer warpgroup gives up
//   registers (setmaxnreg 24) and one of its threads loads the 128-row Q
//   tile once, then K and V tiles of 128 keys into a 3-stage ring, each K
//   and each V stage guarded by its own full and empty mbarriers.  The
//   loads go through 4-D tensor maps (hd, heads, rows, B), so rows past Tq
//   or S read as zero instead of as the next batch row (masked scores give
//   P = 0, but 0 x NaN would still be NaN).  A 128-element row is two
//   64-element boxes with 128-byte swizzle.  The two consumer warpgroups
//   (setmaxnreg 240) own 64 query rows each.  S = Q.K^T is wgmma
//   m64n128k16 with both operands read from swizzled shared memory; the
//   online softmax runs on the f32 accumulators in registers (log2
//   domain); P goes, rounded to bf16, as register A-fragments into wgmma
//   for O += P.V, with V read transposed through its descriptor.  The grid
//   runs the q tiles with the most keys first.  Bound: operations (above),
//   but the body is held by its softmax, not its products: with the
//   softmax removed it runs in half the time.  So the softmax is lean: one
//   MUFU ex2 per probability, no select per masked score (masked scores
//   are -1e30 and a row's maximum is subtracted, or 0 while the row has no
//   live score, so their exp2 is 0), and the mask only on tiles that the
//   causal frontier or S cuts.  What is left between the kernel and its
//   bound: each warpgroup waits on its own products (its softmax overlaps
//   only the other warpgroup's products), and cut tiles are computed
//   whole.  Flash-attention-3's overlap inside a warpgroup (S of tile j+1
//   in flight during the softmax of tile j) needs S, P and O live at
//   once, which spills at the 168 registers ptxas allots a thread of a
//   384-thread CTA.
//   Quantized pools take the same pipeline with one more step: TMA loads
//   the K and V codes (one byte each, rows past S zero) into a staging
//   tile (the K/V ring has 2 stages here, for room), and warps 1-3 of the
//   producer warpgroup (setmaxnreg 56, the consumers 224) convert them
//   exactly to bf16 into the swizzled operand tile and copy the tile's
//   per-key scales beside it.  The K scale multiplies the f32 scores and
//   the V scale multiplies P before it is rounded to bf16, as in the
//   mma.sync body below, so no dequantized copy is rounded.
// * other bf16 queries (hd 32 and 64, f32 pools): tensor cores
//   through mma.sync m16n8k16 (bf16 in, f32 accumulate), flash-attention-2
//   style.  Four warps each own 16 of the tile's 64 query rows and keep
//   their Q fragments, scores, online-softmax state and output accumulator
//   in registers; K and V tiles of 64 keys are staged in shared memory as
//   bf16.  fp8 and int8 codes convert to bf16 exactly, and their per-token
//   scales are applied to the f32 scores (K) and to the probabilities
//   before the P.V product (V), so no dequantized copy is rounded.  The
//   probabilities enter the P.V product rounded to bf16, as in
//   flash-attention-2.  Loads are not pipelined.
// * f32 queries: f32 FMAs on tiles staged in shared memory as f32 (each
//   thread owns a 4x4 block of the score tile and a 4 x hd/8 block of the
//   output), so f32 callers get f32 arithmetic throughout.
#include <cuda.h>
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
                       long long sqb, long long sqt, long long skb, long long sks,
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
    q_s[r * ld + d] = t < Tq ? to_f(q[b * sqb + t * sqt + (size_t)h * hd + d]) : 0.f;
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
        const size_t idx = b * skb + s * sks + (size_t)kvh * hd + d;
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

// 2^x in one MUFU instruction (subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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
                           long long sqb, long long sqt, long long skb, long long sks,
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
    if (t < Tq) val = load8(q + b * sqb + t * sqt + (size_t)h * HD + c);
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
        const size_t idx = b * skb + s * sks + (size_t)kvh * HD + c;
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

// ---------------------------------------------------------------------------
// bf16 queries on a bf16 pool at hd 128: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------
namespace wg {

constexpr int BQ = 128;              // query rows per CTA, 64 per consumer warpgroup
constexpr int BK = 128;              // keys per K/V tile
constexpr int HD = 128;
constexpr int THREADS = 384;         // producer warpgroup + two consumer warpgroups
constexpr int BOX = 64;              // elements in one 128-byte swizzled box row
constexpr int Q_HALF = BQ * 128;     // bytes of one head-dim half of the Q tile
constexpr int KV_HALF = BK * 128;    // bytes of one head-dim half of a K or V tile
constexpr int Q_BYTES = 2 * Q_HALF;
constexpr int KV_BYTES = 2 * KV_HALF;
constexpr int CODE_BYTES = BK * HD;  // one staged K or V tile of 1-byte codes
// dynamic shared memory of a CTA with an nst-stage K/V ring (+1024: base
// alignment); quantized pools add the two staging tiles and the per-key
// scales
constexpr size_t smem_bytes(int nst, bool quant) {
  return Q_BYTES + 2 * nst * KV_BYTES + 1024 +
         (quant ? 2 * CODE_BYTES + 2 * nst * BK * sizeof(float) : 0);
}
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Returns once the phase of the given parity has completed.  A wait that
// outlasts ~2^35 cycles (tens of seconds) traps, so a broken pipeline
// fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  const long long start = clock64();
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (!done && clock64() - start > (1ll << 35)) asm volatile("trap;");
  } while (!done);
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
        "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (layout type 1)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma and its wait
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// keeps the registers of P, which a register-A wgmma reads while it runs,
// from being reused before its wait
__device__ __forceinline__ void pin(uint32_t (&a)[BK / 16][4]) {
#pragma unroll
  for (int i = 0; i < BK / 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d (+)= A (64x16, shared memory) * B (16x128, shared memory, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A (64x16, registers) * B (16x128, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// fp8 or int8 codes of one 16-code chunk as 16 bf16 values (exact), in two
// 16-byte halves
template <typename TKV>
__device__ __forceinline__ void codes_to_bf16(const uint4& raw, uint4& lo, uint4& hi) {
  const TKV* e = reinterpret_cast<const TKV*>(&raw);
  uint32_t* a = reinterpret_cast<uint32_t*>(&lo);
  uint32_t* c = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = pack_f(to_f(e[2 * i]), to_f(e[2 * i + 1]));
    c[i] = pack_f(to_f(e[8 + 2 * i]), to_f(e[9 + 2 * i]));
  }
}

// TKV is the pool's element type: bf16 tiles go by TMA straight into the
// swizzled operand tiles; fp8 or int8 codes go by TMA into a staging tile
// and warps 1-3 of the producer warpgroup convert them into the operand
// tile (and copy the tile's per-key scales beside it).
template <typename TKV, int NSTG>
__global__ void __launch_bounds__(THREADS, 1)
chunked_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const int* __restrict__ offsets, const float* __restrict__ ks,
                             const float* __restrict__ vs, __nv_bfloat16* __restrict__ out,
                             int Tq, int S, int H, int KV, float scale_log2) {
  constexpr bool QUANT = sizeof(TKV) == 1;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 4 * NSTG + 4];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = smem;                      // [2 halves][BQ rows][128 B]
  unsigned char* k_s = smem + Q_BYTES;            // [NSTG][2 halves][BK rows][128 B]
  unsigned char* v_s = k_s + NSTG * KV_BYTES;
  unsigned char* kc_s = v_s + NSTG * KV_BYTES;     // quantized: staged codes [BK][128]
  unsigned char* vc_s = kc_s + CODE_BYTES;
  float* ksc_s = reinterpret_cast<float*>(vc_s + CODE_BYTES);   // [NSTG][BK] scales
  float* vsc_s = ksc_s + NSTG * BK;
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + NSTG;
  uint64_t* k_empty = bars + 1 + 2 * NSTG;
  uint64_t* v_empty = bars + 1 + 3 * NSTG;
  uint64_t* kc_full = bars + 1 + 4 * NSTG;         // quantized: the staging tiles
  uint64_t* vc_full = kc_full + 1;
  uint64_t* kc_empty = kc_full + 2;
  uint64_t* vc_empty = kc_full + 3;

  // grid (H, B, q tiles), the last q tiles (the most keys) first, so the
  // tail of the grid is short; the heads of a KV group are neighbours, so
  // their K/V tiles come from L2
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ, h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int off = offsets[b];
  const int kv_end = min(S, off + min(q0 + BQ, Tq));   // causal frontier of the tile
  const int n_tiles = (kv_end + BK - 1) / BK;          // >= 1: S >= 1, Tq >= 1

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NSTG; ++s) {
      mbar_init(&k_full[s], QUANT ? 3 : 1);   // TMA, or lane 0 of each converter warp
      mbar_init(&v_full[s], QUANT ? 3 : 1);
      mbar_init(&k_empty[s], 8);              // lane 0 of each consumer warp
      mbar_init(&v_empty[s], 8);
    }
    mbar_init(kc_full, 1);
    mbar_init(vc_full, 1);
    mbar_init(kc_empty, 3);
    mbar_init(vc_empty, 3);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps TMA loads in flight ----
    if constexpr (QUANT)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, Q_BYTES);
      tma_load(q_s, &tq, q_full, 0, h, q0, b);
      tma_load(q_s + Q_HALF, &tq, q_full, BOX, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % NSTG, ph = (it / NSTG) & 1, k0 = it * BK;
        if constexpr (QUANT) {
          mbar_wait(kc_empty, (it & 1) ^ 1);
          mbar_expect_tx(kc_full, CODE_BYTES);
          tma_load(kc_s, &tk, kc_full, 0, kvh, k0, b);
          mbar_wait(vc_empty, (it & 1) ^ 1);
          mbar_expect_tx(vc_full, CODE_BYTES);
          tma_load(vc_s, &tv, vc_full, 0, kvh, k0, b);
        } else {
          unsigned char* kd = k_s + st * KV_BYTES;
          unsigned char* vd = v_s + st * KV_BYTES;
          mbar_wait(&k_empty[st], ph ^ 1);
          mbar_expect_tx(&k_full[st], KV_BYTES);
          tma_load(kd, &tk, &k_full[st], 0, kvh, k0, b);
          tma_load(kd + KV_HALF, &tk, &k_full[st], BOX, kvh, k0, b);
          mbar_wait(&v_empty[st], ph ^ 1);
          mbar_expect_tx(&v_full[st], KV_BYTES);
          tma_load(vd, &tv, &v_full[st], 0, kvh, k0, b);
          tma_load(vd + KV_HALF, &tv, &v_full[st], BOX, kvh, k0, b);
        }
      }
    } else if constexpr (QUANT) {
      // ---- converter warps: staged codes -> swizzled bf16 operand tile ----
      if (threadIdx.x < 32) return;
      const int ct = threadIdx.x - 32, lane = threadIdx.x & 31;
      auto convert = [&](int it, const unsigned char* codes, uint64_t* code_full,
                         uint64_t* code_empty, unsigned char* op, uint64_t* op_empty,
                         uint64_t* op_full, float* sc_out, const float* plane) {
        const int ph = (it / NSTG) & 1, k0 = it * BK;
        mbar_wait(code_full, it & 1);
        mbar_wait(op_empty, ph ^ 1);
        for (int u = ct; u < BK * 8; u += 96) {
          const int r = u >> 3, ch = u & 7;   // key row; 16-code chunk of the row
          uint4 lo, hi;
          codes_to_bf16<TKV>(*reinterpret_cast<const uint4*>(codes + r * 128 + ch * 16), lo, hi);
          // elements 16 ch .. 16 ch + 15: 16-byte chunks 2 (ch & 3) and
          // 2 (ch & 3) + 1 of head-dim half ch >> 2, 128-byte swizzled
          unsigned char* row = op + (ch >> 2) * KV_HALF + r * 128;
          const int c0 = (ch & 3) * 2;
          *reinterpret_cast<uint4*>(row + ((c0 ^ (r & 7)) << 4)) = lo;
          *reinterpret_cast<uint4*>(row + (((c0 + 1) ^ (r & 7)) << 4)) = hi;
        }
        for (int r = ct; r < BK; r += 96)
          sc_out[r] = k0 + r >= S ? 0.f : plane ? plane[(size_t)b * S + k0 + r] : 1.f;
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // for wgmma
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(code_empty);
          mbar_arrive(op_full);
        }
      };
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % NSTG;
        convert(it, kc_s, kc_full, kc_empty, k_s + st * KV_BYTES, &k_empty[st], &k_full[st],
                ksc_s + st * BK, ks);
        convert(it, vc_s, vc_full, vc_empty, v_s + st * KV_BYTES, &v_empty[st], &v_full[st],
                vsc_s + st * BK, vs);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    if constexpr (QUANT)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = threadIdx.x / 128 - 1;
    const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
    const int tig = lane & 3;
    const int r0 = c * 64 + warp * 16 + (lane >> 2);   // rows r0 and r0 + 8 of the tile
    const int qpos0 = off + q0 + r0, qpos1 = qpos0 + 8;
    const int qpos_min = off + q0 + c * 64;             // first row of this warpgroup

    float o[64], sc[64];
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
    const uint32_t qa = smem_u32(q_s) + c * 64 * 128;

    // S = Q K^T of tile `it` into sc: 8 k-steps of 16 over two swizzled halves
    auto issue_s = [&](int it) {
      const uint32_t ka = smem_u32(k_s + (it % NSTG) * KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(sc, desc_sw128(qa + (kk >> 2) * Q_HALF + (kk & 3) * 32, 16, 1024),
                 desc_sw128(ka + (kk >> 2) * KV_HALF + (kk & 3) * 32, 16, 1024), kk > 0);
      wg_commit();
    };
    // O += P V of tile `it`: P from registers, V transposed through the descriptor
    auto issue_pv = [&](int it) {
      const uint32_t va = smem_u32(v_s + (it % NSTG) * KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(o, pa[kk], desc_sw128(va + kk * 16 * 128, KV_HALF, 1024));
      wg_commit();
    };
    // online softmax of tile `it` in the log2 domain (masked scores -1e30;
    // quantized pools: K scale on the f32 scores): P stays in sc as f32, l
    // is updated, and the factor that rescales O from the old maximum to
    // the new one is returned per row
    auto softmax = [&](int it, float& a0, float& a1) {
      const int k0 = it * BK;
      const float* kss = ksc_s + (it % NSTG) * BK;
      const bool edge = k0 + BK - 1 > qpos_min || k0 + BK > kv_end;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j * 8 + tig * 2 + e, key = k0 + col;
          const float f = QUANT ? scale_log2 * kss[col] : scale_log2;
          float x0 = sc[j * 4 + e] * f, x1 = sc[j * 4 + 2 + e] * f;
          if (edge) {
            x0 = (key <= qpos0 && key < kv_end) ? x0 : NEG_INF;
            x1 = (key <= qpos1 && key < kv_end) ? x1 : NEG_INF;
          }
          sc[j * 4 + e] = x0;
          sc[j * 4 + 2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      a0 = ex2(m0 - mx0);
      a1 = ex2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      l0 *= a0;
      l1 *= a1;
      // a masked score minus a live row's maximum is about -1e30, whose
      // exp2 is 0; a row with no live score yet subtracts 0 instead
      const float s0 = mx0 <= 0.5f * NEG_INF ? 0.f : mx0;
      const float s1 = mx1 <= 0.5f * NEG_INF ? 0.f : mx1;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(sc[j * 4 + e] - (e < 2 ? s0 : s1));
          sc[j * 4 + e] = p;
          if (e < 2) l0 += p; else l1 += p;
        }
    };
    // P of tile `it` (quantized pools: times the V scale) as bf16 A fragments
    auto pack_p = [&](int it) {
      const float* vss = vsc_s + (it % NSTG) * BK;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float f0 = 1.f, f1 = 1.f;
        if constexpr (QUANT) {
          f0 = vss[j * 8 + tig * 2];
          f1 = vss[j * 8 + tig * 2 + 1];
        }
        pa[j >> 1][(j & 1) * 2] = pack_f(sc[j * 4] * f0, sc[j * 4 + 1] * f1);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_f(sc[j * 4 + 2] * f0, sc[j * 4 + 3] * f1);
      }
    };
    auto rescale_o = [&](float a0, float a1) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o[j * 4] *= a0;
        o[j * 4 + 1] *= a0;
        o[j * 4 + 2] *= a1;
        o[j * 4 + 3] *= a1;
      }
    };

    // Per tile: S = Q K^T, softmax, O += P V, each product waited for
    // before its registers are touched (S, P and O live at once would
    // not fit the 168 registers ptxas allots a thread of this CTA; the
    // two warpgroups interleave on their own).  P is packed once its V
    // tile has landed (quantized pools: its V scales arrive with it), and
    // a K stage is released only after the softmax has read its scales.
    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % NSTG, ph = (it / NSTG) & 1;
      float a0, a1;
      mbar_wait(&k_full[st], ph);
      pin(sc);
      wg_fence();
      issue_s(it);
      wg_wait<0>();
      pin(sc);
      softmax(it, a0, a1);
      if (lane == 0) mbar_arrive(&k_empty[st]);
      rescale_o(a0, a1);
      mbar_wait(&v_full[st], ph);
      pack_p(it);
      pin(o);
      wg_fence();
      issue_pv(it);
      wg_wait<0>();
      pin(o);
      pin(pa);
      if (lane == 0) mbar_arrive(&v_empty[st]);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    const int t0 = q0 + r0, t1 = t0 + 8;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = j * 8 + tig * 2;
      if (t0 < Tq)
        *reinterpret_cast<uint32_t*>(out + (((size_t)b * Tq + t0) * H + h) * HD + col) =
            pack_f(o[j * 4] * inv0, o[j * 4 + 1] * inv0);
      if (t1 < Tq)
        *reinterpret_cast<uint32_t*>(out + (((size_t)b * Tq + t1) * H + h) * HD + col) =
            pack_f(o[j * 4 + 2] * inv1, o[j * 4 + 3] * inv1);
    }
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
// The body each call took, reported back to the wrapper's counters.
enum Body { BODY_FMA = 0, BODY_MMA_SYNC = 1, BODY_WGMMA = 2 };

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so
// the library needs no -lcuda
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D map (hd, heads, rows, B) over a tensor of `esize`-byte elements
// whose box is one 128-byte row piece x 1 head x box_rows rows x 1 batch
// row: 64 bf16 elements with 128-byte swizzle, or 128 one-byte codes
// unswizzled.  Rows past `rows` read as zero, so a tile never sees the
// next batch row's data.
cudaError_t make_map(CUtensorMap* map, const void* base, int esize, int hd, int heads,
                     int rows, int B, long long s_row, long long s_b, int box_rows) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const bool codes = esize == 1;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * esize, (cuuint64_t)s_row * esize,
                                 (cuuint64_t)s_b * esize};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / esize), 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = enc(map, codes ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                   4, const_cast<void*>(base), dims, strides, box, estr,
                   CU_TENSOR_MAP_INTERLEAVE_NONE,
                   codes ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename TKV>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* offsets,
                         const void* ks, const void* vs, void* out, int B, int Tq, int S,
                         int H, int KV, long long sqb, long long sqt, long long skb,
                         long long sks, float scale, cudaStream_t stream) {
  constexpr int esize = (int)sizeof(TKV);
  constexpr int nst = esize == 1 ? 2 : 3;   // quantized: room for the staging tiles
  constexpr size_t smem = wg::smem_bytes(nst, esize == 1);
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, 2, wg::HD, H, Tq, B, sqt, sqb, wg::BQ);
  if (err == cudaSuccess) err = make_map(&tk, k, esize, wg::HD, KV, S, B, sks, skb, wg::BK);
  if (err == cudaSuccess) err = make_map(&tv, v, esize, wg::HD, KV, S, B, sks, skb, wg::BK);
  if (err != cudaSuccess) return err;
  auto kern = wg::chunked_prefill_wgmma_kernel<TKV, nst>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B, (Tq + wg::BQ - 1) / wg::BQ);
  kern<<<grid, wg::THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<const int*>(offsets), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<__nv_bfloat16*>(out), Tq, S, H, KV,
      scale * wg::LOG2E);
  return cudaGetLastError();
}

template <int HD, typename TKV>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* offsets,
                       const void* ks, const void* vs, void* out, int B, int Tq, int S,
                       int H, int KV, long long sqb, long long sqt, long long skb,
                       long long sks, float scale, cudaStream_t stream) {
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
      static_cast<__nv_bfloat16*>(out), Tq, S, H, KV, sqb, sqt, skb, sks, scale);
  return cudaGetLastError();
}

template <typename TKV>
cudaError_t launch_mma_hd(int hd, const void* q, const void* k, const void* v,
                          const void* offsets, const void* ks, const void* vs, void* out,
                          int B, int Tq, int S, int H, int KV, long long sqb, long long sqt,
                          long long skb, long long sks, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_mma<32, TKV>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, sqb, sqt, skb, sks, scale, stream);
    case 64: return launch_mma<64, TKV>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, sqb, sqt, skb, sks, scale, stream);
    default: return launch_mma<128, TKV>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, sqb, sqt, skb, sks, scale, stream);
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* offsets,
                   const void* ks, const void* vs, void* out, int B, int Tq, int S,
                   int H, int KV, int hd, long long sqb, long long sqt, long long skb,
                   long long sks, float scale, cudaStream_t stream) {
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
      static_cast<const float*>(vs), static_cast<TQ*>(out), Tq, S, H, KV, hd, sqb, sqt,
      skb, sks, scale);
  return cudaGetLastError();
}

// Which body a call takes is decided here, by dtype and shape, before any
// launch: bf16 queries at hd 128 on a bf16 pool (the serving path) or on
// an fp8 or int8 pool take TMA + wgmma; other bf16 queries (hd 32 and 64,
// f32 pools, bf16 pools that carry scales) take mma.sync; f32 queries
// keep f32 FMAs.
template <typename TQ>
cudaError_t launch_kv(int kv_dtype, const void* q, const void* k, const void* v,
                      const void* offsets, const void* ks, const void* vs, void* out,
                      int B, int Tq, int S, int H, int KV, int hd, long long sqb,
                      long long sqt, long long skb, long long sks, float scale,
                      cudaStream_t stream, int* body) {
  if (sizeof(TQ) == 2 && hd == wg::HD && (kv_dtype == 2 || kv_dtype == 3 ||
                                           (kv_dtype == 1 && ks == nullptr))) {
    *body = BODY_WGMMA;
    switch (kv_dtype) {
      case 1: return launch_wgmma<__nv_bfloat16>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, sqb, sqt, skb, sks, scale, stream);
      case 2: return launch_wgmma<__nv_fp8_e4m3>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, sqb, sqt, skb, sks, scale, stream);
      case 3: return launch_wgmma<int8_t>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, sqb, sqt, skb, sks, scale, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (sizeof(TQ) == 2 && (hd == 32 || hd == 64 || hd == 128)) {
    *body = BODY_MMA_SYNC;
    switch (kv_dtype) {
      case 0: return launch_mma_hd<float>(hd, q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, sqb, sqt, skb, sks, scale, stream);
      case 1: return launch_mma_hd<__nv_bfloat16>(hd, q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, sqb, sqt, skb, sks, scale, stream);
      case 2: return launch_mma_hd<__nv_fp8_e4m3>(hd, q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, sqb, sqt, skb, sks, scale, stream);
      case 3: return launch_mma_hd<int8_t>(hd, q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, sqb, sqt, skb, sks, scale, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  *body = BODY_FMA;
  switch (kv_dtype) {
    case 0: return launch<TQ, float>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, hd, sqb, sqt, skb, sks, scale, stream);
    case 1: return launch<TQ, __nv_bfloat16>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, hd, sqb, sqt, skb, sks, scale, stream);
    case 2: return launch<TQ, __nv_fp8_e4m3>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, hd, sqb, sqt, skb, sks, scale, stream);
    case 3: return launch<TQ, int8_t>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, hd, sqb, sqt, skb, sks, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float8_e4m3fn, 3 int8.
// q (B,Tq,H,hd) with strides (sqb, sqt, hd, 1); k/v (B,S,KV,hd) with
// strides (skb, sks, hd, 1), in elements, so q/k/v may be row views of
// larger buffers; offsets (B,) int32; ks/vs (B,S) float32 or null; out
// (B,Tq,H,hd) contiguous.  Tensor-core bodies need q, k, v and out 16-byte
// aligned and row strides that are multiples of 8 elements.  *body gets
// the body the call took (0 f32 FMA, 1 mma.sync, 2 TMA + wgmma).
extern "C" int chunked_prefill_attention(const void* q, const void* k, const void* v,
                                         const void* offsets, const void* ks,
                                         const void* vs, void* out, int B, int Tq,
                                         int S, int H, int KV, int hd, long long sqb,
                                         long long sqt, long long skb, long long sks,
                                         int q_dtype, int kv_dtype, float scale,
                                         int* body, void* stream) {
  if (KV <= 0 || H % KV != 0 || hd % 8 != 0 || hd > 8 * MAX_K || B <= 0 || Tq <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (q_dtype) {
    case 0: err = launch_kv<float>(kv_dtype, q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, hd, sqb, sqt, skb, sks, scale, s, body); break;
    case 1: err = launch_kv<__nv_bfloat16>(kv_dtype, q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, hd, sqb, sqt, skb, sks, scale, s, body); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
