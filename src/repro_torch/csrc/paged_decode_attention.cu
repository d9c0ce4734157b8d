// Paged GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_decode_attention.py :: paged_decode_attention
//   (kernel body `_kernel`).
//
// What it computes: one query token per sequence against the KV pages its
// block-table row names.  out[b, h] = softmax(q[b,h] . K[b,:len]^T / sqrt(hd))
// V[b,:len], with positions >= lengths[b] masked out, the online softmax
// state (m, l, acc) in f32, l floored at 1e-30 (a fully masked row gives 0),
// and optional per-token f32 dequant scales for fp8/int8 pages fetched
// through the same table and applied after the f32 cast.
//
// What bounds it on an H100: bytes.  Each query row does 4*hd flops per
// context token and reads 2*KV*hd*itemsize bytes per token for all its KV
// heads, far below the card's ~295 flop/byte ridge.  The least time is the
// live context's K/V bytes over 3.35 TB/s.
//
// Design.  One CTA per (kv_head, b) walks the whole sequence itself: the
// TPU's sequential page grid axis becomes a loop, since Hopper blocks run in
// no order.  (A third grid axis splits a KV group of more than GM query
// heads into several CTAs; qpk is 5 on Qwen2.5-14B, so one CTA there, and
// nothing assumes a power of two.)  Inside the CTA each warp owns every
// NW-th group of U consecutive tokens and keeps its own online-softmax state
// in registers, so the loop has no block-wide barrier: a lane holds hd/32
// consecutive elements of the K and V rows (one coalesced segment per row),
// the qpk dot products reduce with warp shuffles, and the next group's rows
// are loaded before the current group is consumed, to keep loads in flight.
// The warps' partial states merge once at the end through shared memory.
// Each CTA looks up its own table entries, one per token, so any page size
// works.  Tokens past the length are neither read nor weighted, so garbage
// in pages past the length cannot leak in.  Padded inactive slots (length
// 1, table entry 0) read one row of page 0.  Split-KV across CTAs
// (flash-decoding) for long contexts at small batch is later work, to be
// chosen from measured times.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;   // warps per CTA
constexpr int U = 4;               // tokens a warp takes per step
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

constexpr int RM = 4;              // head-dim elements a lane holds: hd <= 128
constexpr int GM = 8;              // query heads of one KV group a CTA takes

size_t smem_bytes(int hd) {
  return sizeof(float) * (2 * NW * GM + NW * GM * hd);
}

// Loads the K and V rows of tokens t0 .. t0+U-1 (those below `length`)
// into registers, dequantized; rows past the length load as zero.
template <typename TKV>
__device__ __forceinline__ void load_rows(
    int t0, int length, const int* __restrict__ tbl, int page,
    const TKV* __restrict__ kp, const TKV* __restrict__ vp,
    const float* __restrict__ ks, const float* __restrict__ vs,
    size_t row_stride, size_t head_off, int R,
    float (&kf)[U][RM], float (&vf)[U][RM]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + u;
    if (t < length) {
      const size_t row = (size_t)tbl[t / page] * page + t % page;
      const TKV* kr = kp + row * row_stride + head_off;
      const TKV* vr = vp + row * row_stride + head_off;
      const float ksc = ks ? ks[row] : 1.f;
      const float vsc = vs ? vs[row] : 1.f;
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        kf[u][r] = r < R ? to_f(kr[r]) * ksc : 0.f;
        vf[u][r] = r < R ? to_f(vr[r]) * vsc : 0.f;
      }
    } else {
#pragma unroll
      for (int r = 0; r < RM; ++r) kf[u][r] = vf[u][r] = 0.f;
    }
  }
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                    const TKV* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ lengths, const float* __restrict__ ks,
                    const float* __restrict__ vs, TQ* __restrict__ out,
                    int H, int KV, int hd, int page, int n_pp, float scale) {
  extern __shared__ float smem[];
  float* m_s = smem;                 // NW*GM   each warp's running max
  float* l_s = m_s + NW * GM;        // NW*GM   each warp's denominator
  float* a_s = l_s + NW * GM;        // NW*GM*hd each warp's numerator

  const int qpk = H / KV;
  const int kvh = blockIdx.x, b = blockIdx.y, g0 = blockIdx.z * GM;
  const int G = min(GM, qpk - g0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int R = hd / 32, d0 = lane * R;
  const int length = min(lengths[b], n_pp * page);
  const int* tbl = tables + (size_t)b * n_pp;
  const size_t row_stride = (size_t)KV * hd;
  const size_t head_off = (size_t)kvh * hd + d0;
  const TQ* qb = q + ((size_t)b * H + kvh * qpk + g0) * hd + d0;

  float qr[GM][RM], acc[GM][RM], m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      qr[g][r] = (g < G && r < R) ? to_f(qb[(size_t)g * hd + r]) : 0.f;
      acc[g][r] = 0.f;
    }
  }

  float kf[U][RM], vf[U][RM];
  int t0 = warp * U;
  load_rows<TKV>(t0, length, tbl, page, kp, vp, ks, vs, row_stride, head_off, R, kf, vf);
  while (t0 < length) {
    // next group's rows, in flight while this group is consumed
    float kn[U][RM], vn[U][RM];
    const int t1 = t0 + NW * U;
    load_rows<TKV>(t1, length, tbl, page, kp, vp, ks, vs, row_stride, head_off, R, kn, vn);

    float s[U][GM];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) continue;
        float part = 0.f;
#pragma unroll
        for (int r = 0; r < RM; ++r) part += qr[g][r] * kf[u][r];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        s[u][g] = (t0 + u < length) ? part * scale : NEG_INF;
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) continue;
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      const float alpha = expf(m[g] - mx);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u][g] = expf(s[u][g] - mx);
        psum += s[u][g];
      }
      l[g] = l[g] * alpha + psum;
      m[g] = mx;
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        float a = acc[g][r] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) a += s[u][g] * vf[u][r];
        acc[g][r] = a;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        kf[u][r] = kn[u][r];
        vf[u][r] = vn[u][r];
      }
    t0 = t1;
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) continue;
    if (lane == 0) {
      m_s[warp * GM + g] = m[g];
      l_s[warp * GM + g] = l[g];
    }
#pragma unroll
    for (int r = 0; r < RM; ++r)
      if (r < R) a_s[(warp * GM + g) * hd + d0 + r] = acc[g][r];
  }
  __syncthreads();
  TQ* ob = out + ((size_t)b * H + kvh * qpk + g0) * hd;
  for (int e = threadIdx.x; e < G * hd; e += THREADS) {
    const int g = e / hd, d = e - g * hd;
    float mx = NEG_INF;
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, m_s[w * GM + g]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float f = expf(m_s[w * GM + g] - mx);
      lsum += l_s[w * GM + g] * f;
      a += a_s[(w * GM + g) * hd + d] * f;
    }
    ob[(size_t)g * hd + d] = from_f<TQ>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* tables,
                   const void* lengths, const void* ks, const void* vs, void* out,
                   int B, int H, int KV, int hd, int page, int n_pp, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  auto kern = paged_decode_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int qpk = H / KV;
  dim3 grid(KV, B, (qpk + GM - 1) / GM);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp), static_cast<const TKV*>(vp),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<const float*>(ks), static_cast<const float*>(vs), static_cast<TQ*>(out),
      H, KV, hd, page, n_pp, scale);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_kv(int kv_dtype, const void* q, const void* kp, const void* vp,
                      const void* tables, const void* lengths, const void* ks,
                      const void* vs, void* out, int B, int H, int KV, int hd, int page,
                      int n_pp, float scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0: return launch<TQ, float>(q, kp, vp, tables, lengths, ks, vs, out, B, H, KV, hd, page, n_pp, scale, stream);
    case 1: return launch<TQ, __nv_bfloat16>(q, kp, vp, tables, lengths, ks, vs, out, B, H, KV, hd, page, n_pp, scale, stream);
    case 2: return launch<TQ, __nv_fp8_e4m3>(q, kp, vp, tables, lengths, ks, vs, out, B, H, KV, hd, page, n_pp, scale, stream);
    case 3: return launch<TQ, int8_t>(q, kp, vp, tables, lengths, ks, vs, out, B, H, KV, hd, page, n_pp, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float8_e4m3fn, 3 int8.
// q/out (B,H,hd); k/v pages (n_pages,page,KV,hd); tables (B,n_pp) int32;
// lengths (B,) int32; ks/vs (n_pages,page) float32 or null.
extern "C" int paged_decode_attention(const void* q, const void* kp, const void* vp,
                                      const void* tables, const void* lengths,
                                      const void* ks, const void* vs, void* out,
                                      int B, int H, int KV, int hd, int page, int n_pp,
                                      int q_dtype, int kv_dtype, float scale,
                                      void* stream) {
  if (KV <= 0 || H % KV != 0 || hd % 32 != 0 || hd > 32 * RM || B <= 0 || n_pp <= 0 || page <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (q_dtype) {
    case 0: err = launch_kv<float>(kv_dtype, q, kp, vp, tables, lengths, ks, vs, out, B, H, KV, hd, page, n_pp, scale, s); break;
    case 1: err = launch_kv<__nv_bfloat16>(kv_dtype, q, kp, vp, tables, lengths, ks, vs, out, B, H, KV, hd, page, n_pp, scale, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
