// Paged GQA decode attention for Hopper (sm_90a): split-KV ("flash-decoding").
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
// live context's K/V bytes over 3.35 TB/s, so the design is about keeping
// enough bytes in flight on every SM and spending few instructions per
// byte once they arrive.
//
// Design.  Two passes.
//
// * Split pass, grid (n_splits, KV, B * ceil(qpk / GM)).  Every sequence
//   is cut into spans of SPLIT tokens (a whole number of pages, 256 tokens
//   at page 8); n_splits comes from the table's width, never from the
//   lengths, so the host reads nothing back and the launch is the same for
//   every step of a bucket.  A CTA whose span starts at or past lengths[b]
//   writes the empty partial (m = -1e30, l = 0) and exits.  A live CTA
//   takes all query heads of one KV group (GM at most; qpk is 5 on
//   Qwen2.5-14B), so each K/V row is read once per group.  It loads its
//   span's block-table entries into shared memory once.  Each of its four
//   warps then streams its own sub-tiles of the span (warp w takes
//   sub-tiles w, w+4, ...) into its own ring of NSTAGE shared-memory
//   stages with cp.async, NSTAGE-1 sub-tiles ahead.  A token row is held
//   by LPT lanes, 8 elements each (one 16-byte chunk in bf16): hd/8
//   rounded up to a power of two, 4 to 32, so one warp holds a row of up
//   to 256 elements; lanes past hd (3 of 8 at hd 40, 8 of 32 at hd 192)
//   copy nothing and hold zeros.  Each lane group takes TPL tokens of a
//   sub-tile.  A lane copies its own chunks and reads back only those, so
//   the loop has no barrier at all.  With hd % 8 == 0 a lane's chunk
//   (32, 16 or 8 bytes for f32, bf16 or one-byte codes) starts at a
//   multiple of its own size within the row and within the pool, and
//   ends inside the row, so every head dim takes the same copies.
//   Scores and the online softmax run in f32 on CUDA cores (tensor cores
//   buy nothing at 4*hd flops per token and head), in the log2 domain: q
//   is pre-scaled by scale*log2(e), so each probability is one MUFU exp2.
//   The softmax rescales once per sub-tile of TPL tokens.  The loop has
//   no branch: slots of tokens past the length are zero-filled at issue,
//   and every shuffle level runs (levels past the lane group's width add
//   0), so the TPL x GM dot-product reductions of a sub-tile are
//   straight-line code whose shuffles the scheduler can overlap.  Lane groups and warps merge their
//   (m, l, acc) once at the end, through shuffles and shared memory.
//   Tokens past the length are neither loaded nor weighted, so garbage in
//   pages past the length cannot leak in.
// * Merge pass, grid (B*H): M = max m_i, out = sum 2^(m_i-M) acc_i /
//   max(sum 2^(m_i-M) l_i, 1e-30) over the splits that hold tokens, in q's
//   dtype.  With one split the split pass writes the output itself and
//   the merge is not launched.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int NW = THREADS / 32;   // warps per CTA
constexpr int NSTAGE = 3;          // sub-tiles each warp keeps in flight
constexpr int TPL = 4;             // tokens a lane group takes per sub-tile
constexpr int SPLIT_TOKENS = 256;  // target span; rounded to whole pages
constexpr int EPL = 8;             // head-dim elements a lane holds
constexpr int MAX_HD = 256;        // a whole warp of 8-element chunks
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 2^x in one MUFU instruction (subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// bytes of a lane's chunk of one row: EPL elements
template <typename T>
__host__ __device__ constexpr int chunk_bytes() { return EPL * (int)sizeof(T); }

// a lane's chunk (EPL elements of type T) from shared memory, as f32
template <typename T>
__device__ __forceinline__ void load_chunk(const unsigned char* p, float (&x)[EPL]) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else if constexpr (sizeof(T) == 2) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&a);
#pragma unroll
    for (int i = 0; i < EPL; ++i) x[i] = to_f(e[i]);
  } else {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&a);
#pragma unroll
    for (int i = 0; i < EPL; ++i) x[i] = to_f(e[i]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a lane's chunk of one K or V row into shared memory
template <typename T>
__device__ __forceinline__ void cp_chunk(unsigned char* dst, const unsigned char* src) {
  if constexpr (sizeof(T) == 4) {
    cp_async16(dst, src);
    cp_async16(dst + 16, src + 16);
  } else if constexpr (sizeof(T) == 2) {
    cp_async16(dst, src);
  } else {
    cp_async8(dst, src);
  }
}

// zeros in place of a lane's chunk
template <typename T>
__device__ __forceinline__ void zero_chunk(unsigned char* dst) {
  if constexpr (sizeof(T) == 4) {
    reinterpret_cast<uint4*>(dst)[0] = make_uint4(0u, 0u, 0u, 0u);
    reinterpret_cast<uint4*>(dst)[1] = make_uint4(0u, 0u, 0u, 0u);
  } else if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  } else {
    *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
  }
}

// Launch geometry shared by host and device.  WIDE (hd > 128): a row takes
// the whole warp; a narrower row takes 4, 8 or 16 lanes, a choice the
// compiler sees stop at 16.
struct Geom {
  int lpt;         // lanes per token row: hd/8 rounded up to a power of two, 4..32
  int tw;          // tokens of one warp sub-tile: (32 / lpt) lane groups x TPL
  int split;       // tokens per span, a whole number of pages
  int span_pages;  // pages per span
};

template <bool WIDE>
__host__ __device__ inline Geom geom(int hd, int page) {
  Geom g;
  const int chunks = hd / EPL;
  g.lpt = WIDE ? 32 : chunks <= 4 ? 4 : chunks <= 8 ? 8 : 16;
  g.tw = (32 / g.lpt) * TPL;
  g.span_pages = SPLIT_TOKENS >= page ? SPLIT_TOKENS / page : 1;
  g.split = g.span_pages * page;
  return g;
}

// One warp's ring stage: for each of a lane's TPL token slots, its K chunk
// and its V chunk ([slot][K|V][lane], so a warp's 16-byte reads are
// contiguous), then for quantized pools the slot's K and V scale per lane.
template <typename TKV>
__host__ __device__ inline int stage_bytes(bool quant) {
  return TPL * 2 * 32 * chunk_bytes<TKV>() + (quant ? TPL * 2 * 32 * 4 : 0);
}

template <typename TKV, int GM>
size_t smem_bytes(int hd, int page, bool quant) {
  const Geom g = geom<false>(hd, page);   // span_pages: the same at any width
  const size_t ring = (size_t)NW * NSTAGE * stage_bytes<TKV>(quant);
  const size_t merge = sizeof(float) * (2 * NW * GM + NW * GM * hd);
  return (ring > merge ? ring : merge) + sizeof(int) * g.span_pages;
}

// Split pass: one CTA per (span, kv head, b, group of up to GM query heads).
// Scores are kept in the log2 domain (q is pre-scaled by scale * log2 e),
// and so are the partial maxima m.  The launch bound holds a thread to 168
// registers, so three CTAs (12 warps) share an SM; left free, ptxas takes
// ~190 and only two fit.  Groups of 8 heads need ~245 and get two CTAs.
// WIDE: a row takes the whole warp (hd > 128), so a score sums over 32
// lanes, one shuffle level more than the narrower rows pay for, and a
// warp instruction serves one token where a narrower row serves two or
// more; such rows take groups of at most 4 heads, whose ~110 registers
// let four CTAs (16 warps) share an SM to hide the shuffles' latency.
template <typename TQ, typename TKV, int GM, bool WIDE>
__global__ void __launch_bounds__(THREADS, GM > 5 ? 2 : GM == 4 ? 4 : 3)
paged_decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                          const TKV* __restrict__ vp, const int* __restrict__ tables,
                          const int* __restrict__ lengths, const float* __restrict__ ks,
                          const float* __restrict__ vs, TQ* __restrict__ out,
                          float* __restrict__ part_m, float* __restrict__ part_l,
                          float* __restrict__ part_acc, int H, int KV, int hd, int page,
                          int page_shift, int n_pp, int n_splits, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geom gm = geom<WIDE>(hd, page);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, kvh = blockIdx.y;
  const int qpk = H / KV, ngz = (qpk + GM - 1) / GM;
  const int b = blockIdx.z / ngz, g0 = (blockIdx.z - b * ngz) * GM;
  const int G = min(GM, qpk - g0);
  const int length = min(max(lengths[b], 0), n_pp * page);
  const int t_begin = split * gm.split;
  const int t_end = min(length, t_begin + gm.split);
  const size_t hrow = (size_t)b * H + kvh * qpk + g0;   // first query head row

  if (t_begin >= length && n_splits > 1) {   // empty span: the empty partial
    if (tid < G) {
      part_m[(hrow + tid) * n_splits + split] = NEG_INF;
      part_l[(hrow + tid) * n_splits + split] = 0.f;
    }
    return;
  }

  const bool quant = ks != nullptr;
  const int stage = stage_bytes<TKV>(quant);
  const size_t ring = (size_t)NW * NSTAGE * stage;
  const size_t merge = sizeof(float) * (2 * NW * GM + NW * GM * hd);
  int* tbl_s = reinterpret_cast<int*>(smem + (ring > merge ? ring : merge));
  const int p0 = t_begin / page;
  const int np = min(gm.span_pages, n_pp - p0);
  for (int i = tid; i < np; i += THREADS) tbl_s[i] = tables[(size_t)b * n_pp + p0 + i];
  __syncthreads();

  // Lane group `sub` of a warp takes tokens sub, sub + nsub, ... of each of
  // the warp's sub-tiles; in its group the lane holds elements c8..c8+7.
  // Warp w takes sub-tiles w, w + NW, ... of the span.  A lane copies its
  // own chunks and reads back only those, so the loop needs no barrier.
  constexpr int CB = chunk_bytes<TKV>();
  const int lpt = gm.lpt, nsub = 32 / lpt, tw = gm.tw;
  const int sub = lane / lpt, c8 = (lane - sub * lpt) * EPL;
  const bool active = c8 < hd;
  const size_t row_bytes = (size_t)hd * sizeof(TKV);
  const size_t kv_stride = (size_t)KV * row_bytes;     // bytes per token row of the pool
  const unsigned char* kb =
      reinterpret_cast<const unsigned char*>(kp) + kvh * row_bytes + c8 * sizeof(TKV);
  const unsigned char* vb =
      reinterpret_cast<const unsigned char*>(vp) + kvh * row_bytes + c8 * sizeof(TKV);
  unsigned char* wring = smem + (size_t)warp * NSTAGE * stage;
  const int n_sub = (max(t_end - t_begin, 0) + tw - 1) / tw;
  const int n_mine = n_sub > warp ? (n_sub - warp + NW - 1) / NW : 0;

  auto issue = [&](int j) {
    unsigned char* st = wring + (j % NSTAGE) * stage;
    float* sc_st = reinterpret_cast<float*>(st + TPL * 2 * 32 * CB);
    const int t0 = t_begin + (warp + j * NW) * tw + sub;
#pragma unroll
    for (int i = 0; i < TPL; ++i) {
      const int t = t0 + i * nsub;
      unsigned char* k_dst = st + ((2 * i) * 32 + lane) * CB;
      unsigned char* v_dst = st + ((2 * i + 1) * 32 + lane) * CB;
      if (t < t_end) {
        const int rel = t - t_begin;
        const int pg = page_shift >= 0 ? rel >> page_shift : rel / page;
        const size_t row = (size_t)tbl_s[pg] * page + (rel - pg * page);
        if (active) {
          cp_chunk<TKV>(k_dst, kb + row * kv_stride);
          cp_chunk<TKV>(v_dst, vb + row * kv_stride);
        }
        if (quant) {
          cp_async4(sc_st + (2 * i) * 32 + lane, ks + row);
          cp_async4(sc_st + (2 * i + 1) * 32 + lane, vs + row);
        }
      }
      if (t >= t_end || !active) {   // zeros, so the compute loop needs no branch
        zero_chunk<TKV>(k_dst);
        zero_chunk<TKV>(v_dst);
      }
    }
  };

  float qr[GM][EPL], acc[GM][EPL], m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[g][e] = (g < G && active) ? to_f(q[(hrow + g) * hd + c8 + e]) * scale_log2 : 0.f;
      acc[g][e] = 0.f;
    }
  }

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n_mine) issue(s);
    cp_async_commit();
  }
  for (int j = 0; j < n_mine; ++j) {
    __syncwarp();   // this stage's reads of the last round are done
    if (j + NSTAGE - 1 < n_mine) issue(j + NSTAGE - 1);
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();

    const unsigned char* st = wring + (j % NSTAGE) * stage;
    const float* sc_st = reinterpret_cast<const float*>(st + TPL * 2 * 32 * CB);
    const int t0 = t_begin + (warp + j * NW) * tw + sub;
    float s[TPL][GM];
    bool live[TPL];
    // scores of this lane group's TPL tokens for every head of the group,
    // each summed over the group's lanes
#pragma unroll
    for (int i = 0; i < TPL; ++i) {
      live[i] = t0 + i * nsub < t_end;
      float kf[EPL];
      load_chunk<TKV>(st + ((2 * i) * 32 + lane) * CB, kf);
      const float ksc = (quant && live[i]) ? sc_st[(2 * i) * 32 + lane] : 1.f;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part = fmaf(qr[g][e], kf[e], part);
        // sum over the lane group: every level runs, levels at or past
        // the group's width add nothing, so the TPL x GM reductions are
        // straight-line code that the scheduler can interleave
#pragma unroll
        for (int o = WIDE ? 16 : 8; o > 0; o >>= 1) {
          const float x = __shfl_xor_sync(0xffffffffu, part, o);
          part += o < lpt ? x : 0.f;
        }
        s[i][g] = live[i] ? part * ksc : NEG_INF;
      }
    }
    // online softmax: one rescale per sub-tile
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int i = 1; i < TPL; ++i) mx = fmaxf(mx, s[i][g]);
      const float m_new = fmaxf(m[g], mx);
      const float alpha = ex2(m[g] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int i = 0; i < TPL; ++i) {
        s[i][g] = live[i] ? ex2(s[i][g] - m_new) : 0.f;
        ps += s[i][g];
      }
      l[g] = l[g] * alpha + ps;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
    }
    // acc += p * v, the V scale folded into p
#pragma unroll
    for (int i = 0; i < TPL; ++i) {
      float vf[EPL];
      load_chunk<TKV>(st + ((2 * i + 1) * 32 + lane) * CB, vf);
      const float vsc = (quant && live[i]) ? sc_st[(2 * i + 1) * 32 + lane] : 1.f;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float w = s[i][g] * vsc;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(w, vf[e], acc[g][e]);
      }
    }
  }
  cp_async_wait<0>();

  // merge the warp's lane groups (lanes lpt, 2 lpt, ... apart hold the same
  // elements), then the warps through shared memory (over the ring)
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      if (o < lpt) continue;
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mm = fmaxf(m[g], mo);
      const float f1 = exp2f(m[g] - mm), f2 = exp2f(mo - mm);
      l[g] = l[g] * f1 + lo * f2;
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[g][e] = acc[g][e] * f1 + __shfl_xor_sync(0xffffffffu, acc[g][e], o) * f2;
      m[g] = mm;
    }
  }
  __syncthreads();   // every warp is done with the ring
  float* m_s = reinterpret_cast<float*>(smem);
  float* l_s = m_s + NW * GM;
  float* a_s = l_s + NW * GM;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) continue;
    if (lane == 0) {
      m_s[warp * GM + g] = m[g];
      l_s[warp * GM + g] = l[g];
    }
    if (lane < lpt && active)
#pragma unroll
      for (int e = 0; e < EPL; ++e) a_s[(warp * GM + g) * hd + c8 + e] = acc[g][e];
  }
  __syncthreads();
  for (int e = tid; e < G * hd; e += THREADS) {
    const int g = e / hd, d = e - g * hd;
    float mx = NEG_INF;
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, m_s[w * GM + g]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float f = exp2f(m_s[w * GM + g] - mx);
      lsum += l_s[w * GM + g] * f;
      a += a_s[(w * GM + g) * hd + d] * f;
    }
    const size_t row = hrow + g;
    if (n_splits == 1) {
      out[row * hd + d] = from_f<TQ>(a / fmaxf(lsum, 1e-30f));
    } else {
      part_acc[(row * n_splits + split) * hd + d] = a;
      if (d == 0) {
        part_m[row * n_splits + split] = mx;
        part_l[row * n_splits + split] = lsum;
      }
    }
  }
}

// Merge pass: one CTA per (b, query head) over the splits that hold tokens
// (partial maxima in the log2 domain).
template <typename TQ>
__global__ void __launch_bounds__(THREADS)
paged_decode_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                          const float* __restrict__ part_acc, const int* __restrict__ lengths,
                          TQ* __restrict__ out, int H, int hd, int n_splits, int split,
                          int max_len) {
  const int bh = blockIdx.x, b = bh / H;
  const int length = min(max(lengths[b], 0), max_len);
  const int n_live = (length + split - 1) / split;
  const float* pm = part_m + (size_t)bh * n_splits;
  const float* pl = part_l + (size_t)bh * n_splits;
  const float* pa = part_acc + (size_t)bh * n_splits * hd;
  float mx = NEG_INF;
  for (int i = 0; i < n_live; ++i) mx = fmaxf(mx, pm[i]);
  float lsum = 0.f;
  for (int i = 0; i < n_live; ++i) lsum += pl[i] * exp2f(pm[i] - mx);
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
  for (int d = threadIdx.x; d < hd; d += THREADS) {
    float a = 0.f;
    for (int i = 0; i < n_live; ++i) a += pa[(size_t)i * hd + d] * exp2f(pm[i] - mx);
    out[(size_t)bh * hd + d] = from_f<TQ>(a * inv);
  }
}

template <typename TQ, typename TKV, int GM, bool WIDE>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* tables,
                   const void* lengths, const void* ks, const void* vs, void* out,
                   void* part_m, void* part_l, void* part_acc, int B, int H, int KV,
                   int hd, int page, int n_pp, float scale, cudaStream_t stream) {
  const Geom g = geom<WIDE>(hd, page);
  const int n_splits = (n_pp * page + g.split - 1) / g.split;
  const size_t smem = smem_bytes<TKV, GM>(hd, page, ks != nullptr);
  int page_shift = -1;   // log2(page) when page is a power of two
  for (int s = 0; s < 31; ++s)
    if ((1 << s) == page) page_shift = s;
  auto kern = paged_decode_split_kernel<TQ, TKV, GM, WIDE>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int qpk = H / KV;
  dim3 grid(n_splits, KV, B * ((qpk + GM - 1) / GM));
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp), static_cast<const TKV*>(vp),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<const float*>(ks), static_cast<const float*>(vs), static_cast<TQ*>(out),
      static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), H, KV, hd, page, page_shift, n_pp, n_splits,
      scale * LOG2E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  paged_decode_merge_kernel<TQ><<<B * H, THREADS, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<const int*>(lengths),
      static_cast<TQ*>(out), H, hd, n_splits, g.split, n_pp * page);
  return cudaGetLastError();
}

// qpk <= 2 -> 2 heads a CTA, <= 5 -> 5 (Qwen2.5-14B), else 8 (larger groups
// take a third grid axis), so register arrays fit the group; a WIDE row
// takes groups of 4 past 2 (Nemotron-4-340B's 12: three groups).
template <typename TQ, typename TKV, bool WIDE>
cudaError_t launch_gm(const void* q, const void* kp, const void* vp, const void* tables,
                      const void* lengths, const void* ks, const void* vs, void* out,
                      void* pm, void* pl, void* pa, int B, int H, int KV, int hd,
                      int page, int n_pp, float scale, cudaStream_t stream) {
  const int qpk = H / KV;
  if (qpk <= 2)
    return launch<TQ, TKV, 2, WIDE>(q, kp, vp, tables, lengths, ks, vs, out, pm, pl, pa, B, H, KV, hd, page, n_pp, scale, stream);
  if constexpr (WIDE) {
    return launch<TQ, TKV, 4, WIDE>(q, kp, vp, tables, lengths, ks, vs, out, pm, pl, pa, B, H, KV, hd, page, n_pp, scale, stream);
  } else {
    if (qpk <= 5)
      return launch<TQ, TKV, 5, WIDE>(q, kp, vp, tables, lengths, ks, vs, out, pm, pl, pa, B, H, KV, hd, page, n_pp, scale, stream);
    return launch<TQ, TKV, 8, WIDE>(q, kp, vp, tables, lengths, ks, vs, out, pm, pl, pa, B, H, KV, hd, page, n_pp, scale, stream);
  }
}

template <typename TQ, typename TKV>
cudaError_t launch_wide(const void* q, const void* kp, const void* vp, const void* tables,
                        const void* lengths, const void* ks, const void* vs, void* out,
                        void* pm, void* pl, void* pa, int B, int H, int KV, int hd,
                        int page, int n_pp, float scale, cudaStream_t stream) {
  if (hd > 16 * EPL)
    return launch_gm<TQ, TKV, true>(q, kp, vp, tables, lengths, ks, vs, out, pm, pl, pa, B, H, KV, hd, page, n_pp, scale, stream);
  return launch_gm<TQ, TKV, false>(q, kp, vp, tables, lengths, ks, vs, out, pm, pl, pa, B, H, KV, hd, page, n_pp, scale, stream);
}

template <typename TQ>
cudaError_t launch_kv(int kv_dtype, const void* q, const void* kp, const void* vp,
                      const void* tables, const void* lengths, const void* ks,
                      const void* vs, void* out, void* pm, void* pl, void* pa, int B,
                      int H, int KV, int hd, int page, int n_pp, float scale,
                      cudaStream_t stream) {
  switch (kv_dtype) {
    case 0: return launch_wide<TQ, float>(q, kp, vp, tables, lengths, ks, vs, out, pm, pl, pa, B, H, KV, hd, page, n_pp, scale, stream);
    case 1: return launch_wide<TQ, __nv_bfloat16>(q, kp, vp, tables, lengths, ks, vs, out, pm, pl, pa, B, H, KV, hd, page, n_pp, scale, stream);
    case 2: return launch_wide<TQ, __nv_fp8_e4m3>(q, kp, vp, tables, lengths, ks, vs, out, pm, pl, pa, B, H, KV, hd, page, n_pp, scale, stream);
    case 3: return launch_wide<TQ, int8_t>(q, kp, vp, tables, lengths, ks, vs, out, pm, pl, pa, B, H, KV, hd, page, n_pp, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The head layouts this kernel takes (repro_torch/kernels/shapes.py holds
// the same rule): hd a multiple of 8 up to a warp of 8-element chunks, and
// a whole number of query heads for each KV head.
static bool supported(int hd, int H, int KV) {
  return hd % 8 == 0 && hd >= 8 && hd <= MAX_HD && KV > 0 && H > 0 && H % KV == 0;
}

// The number of spans a sequence of n_pp pages is cut into: the partials'
// middle dimension, which the caller allocates.
extern "C" int paged_decode_attention_splits(int hd, int page, int n_pp) {
  const Geom g = geom<false>(hd, page);   // spans: the same at any width
  return (n_pp * page + g.split - 1) / g.split;
}

// dtype codes: 0 float32, 1 bfloat16, 2 float8_e4m3fn, 3 int8.
// q/out (B,H,hd); k/v pages (n_pages,page,KV,hd), 16-byte aligned;
// tables (B,n_pp) int32; lengths (B,) int32; ks/vs (n_pages,page) float32
// or null; part_m/part_l (B,H,n_splits) and part_acc (B,H,n_splits,hd)
// float32 scratch, n_splits from paged_decode_attention_splits.  Two
// kernel launches when n_splits > 1 (split, merge), one otherwise.
extern "C" int paged_decode_attention(const void* q, const void* kp, const void* vp,
                                      const void* tables, const void* lengths,
                                      const void* ks, const void* vs, void* out,
                                      void* part_m, void* part_l, void* part_acc,
                                      int B, int H, int KV, int hd, int page, int n_pp,
                                      int q_dtype, int kv_dtype, float scale,
                                      void* stream) {
  if (!supported(hd, H, KV) || B <= 0 || n_pp <= 0 || page <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (q_dtype) {
    case 0: err = launch_kv<float>(kv_dtype, q, kp, vp, tables, lengths, ks, vs, out, part_m, part_l, part_acc, B, H, KV, hd, page, n_pp, scale, s); break;
    case 1: err = launch_kv<__nv_bfloat16>(kv_dtype, q, kp, vp, tables, lengths, ks, vs, out, part_m, part_l, part_acc, B, H, KV, hd, page, n_pp, scale, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
