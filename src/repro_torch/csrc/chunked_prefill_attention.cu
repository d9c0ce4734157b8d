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
// wrapper names the body by dtype and shape (shapes.prefill_body), and
// the entry point launches it or, where it has no instance for the call,
// returns cudaErrorInvalidValue:
//
// * bf16 queries on a bf16 pool that carries no scales (the serving
//   path), or on an fp8 or int8 pool whose head dim is a multiple of 16:
//   TMA + wgmma, warp-specialised in the flash-attention-3 shape, at every
//   head dim.  A row of hd elements is read as the next instance width
//   in {64, 128, 192, 256}: the tensor maps carry the true hd as the row's
//   extent and head stride, so the columns between hd and the instance
//   width read as zeros (they add nothing to Q.K^T, and give O columns
//   that are never written), and the epilogue writes hd columns.  A CTA
//   is three warpgroups at widths 64 to 192.  The producer
//   warpgroup gives up registers (setmaxnreg 24) and one of its threads
//   loads the 128-row Q tile once, then K and V tiles of BK keys into a
//   ring of 3 stages (2 at width 256), each K and each V stage guarded by
//   its own full and empty mbarriers.  ptxas allots a thread of a
//   384-thread CTA 168 registers (setmaxnreg moves registers at run time,
//   not in its allocation), and a consumer at width 256 holds 128 f32 of
//   O, 32 of S and 16 registers of P: there the CTA is the two consumer
//   warpgroups alone (255 registers a thread), and consumer thread 0
//   issues the loads, each tile NSTG - 1 ahead into the stage both
//   warpgroups have released.  The loads go through 4-D tensor
//   maps (hd, heads, rows, B), so rows past Tq or S read as zero instead
//   of as the next batch row (masked scores give P = 0, but 0 x NaN would
//   still be NaN).  A row is width/64 boxes of 64 elements with 128-byte
//   swizzle.  BK is 128 at widths 64 and 128; at 192 and 256 the Q tile
//   alone is 48 or 64 KB and a 128-key K or V tile as much again, so they
//   take 64-key tiles: 197,632 B with 3 stages at 192 and with 2 at 256.
//   The two consumer warpgroups
//   (setmaxnreg 240) own 64 query rows each.  S = Q.K^T is wgmma
//   m64nBKk16 with both operands read from swizzled shared memory; the
//   online softmax runs on the f32 accumulators in registers (log2
//   domain); P goes, rounded to bf16, as register A-fragments into wgmma
//   m64n(width)k16 for O += P.V, with V read transposed through its
//   descriptor (the 64-column pieces of a row one leading-byte offset
//   apart).  The grid
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
//   the K and V codes (one byte each, a whole row of the instance width a
//   box, rows past S and columns past hd zero) into a staging tile (the
//   K/V ring has 2 stages here, for room), and warps 1-3 of the
//   producer warpgroup (setmaxnreg 56, the consumers 224) convert them
//   exactly to bf16 into the swizzled operand tile and copy the tile's
//   per-key scales beside it.  The K scale multiplies the f32 scores and
//   the V scale multiplies P before it is rounded to bf16, as in the
//   mma.sync body below, so no dequantized copy is rounded.  At widths 64
//   and 256, where 168 registers spill, the CTA is the producer
//   warpgroup and one consumer warpgroup (64 query rows, 255 registers a
//   thread).  A tensor map
//   needs 16-byte head strides, so one-byte codes take this body only at
//   hd % 16 == 0; codes at other head dims take the 3xTF32 body (no
//   mma.sync instance has such a width).
// * bf16 queries on an f32 pool or a bf16 pool that carries scales, at hd
//   32, 64 and 128: tensor cores
//   through mma.sync m16n8k16 (bf16 in, f32 accumulate), flash-attention-2
//   style.  Four warps each own 16 of the tile's 64 query rows and keep
//   their Q fragments, scores, online-softmax state and output accumulator
//   in registers; K and V tiles of 64 keys are staged in shared memory as
//   bf16.  The per-token scales are applied to the f32 scores (K) and to
//   the probabilities before the P.V product (V), so no dequantized copy
//   is rounded.  The
//   probabilities enter the P.V product rounded to bf16, as in
//   flash-attention-2.  Loads are not pipelined.
// * f32 queries on every pool, and every other call (bf16 queries on an
//   f32 pool or a scaled bf16 pool at a head dim other than 32, 64 and
//   128; on fp8 or int8 codes at hd % 16 != 0): 3xTF32 on the tensor
//   cores, mma.sync m16n8k8 with tf32 operands and f32 accumulation.
//   Every f32 operand x is split as hi = cvt.rna.tf32(x) and lo =
//   cvt.rna.tf32(x - hi) (the rounding is written as two integer
//   operations on the bits: add half a tf32 ulp, clear the low 13 bits;
//   the same value for every finite x), and each product is hi.hi + hi.lo
//   + lo.hi, for S = Q.K^T and again for P.V.  The lo.lo term left out
//   and lo's own rounding are each below 2^-22 of the product, so a
//   product keeps about 21 bits, against 24 in f32 and 11 in one TF32
//   pass.  On unit-scale inputs the output is within 2e-6 to 1e-5 of the
//   plain f32 version at hd 8 to 256 on an H100, where a one-pass build
//   errs by 5e-4 to 1e-3 (chip_smoke.py --phases tf32_one_pass): f32
//   callers still get f32 arithmetic in substance, held to 3e-5 by the
//   card checks.  Four warps each own 16 of the CTA's 64
//   query rows.  hd % 8 == 0 is exactly the tf32 k-step, and P.V's n-step
//   is 8, so every head dim runs unpadded.  Q is staged once in shared
//   memory as f32 and its fragments are read and split per tile; O and
//   the scores stay in registers.  K and V tiles of 64 keys, as f32 with
//   a row pitch of hd + 4 (conflict-free fragment reads both for K's rows
//   and for V's columns), take turns in two slots: each tile is in flight
//   while the one before it is used (a third slot would leave room for
//   one CTA an SM at hd 128, not two).  f32
//   pools arrive by cp.async (rows past the frontier zero-filled), other
//   pools are converted exactly to f32 as they are stored.  The score accumulators become the
//   A fragments of P without a shuffle: P.V's key order is permuted (key
//   2t of an 8-key step is its k-index t, key 2t + 1 its k-index t + 4),
//   and V's fragments are read in the same order.  Scales, masking (-1e30,
//   l floored at 1e-30) and the causal frontier of each q tile are those of
//   the other bodies.
//
// The packed-row body (packed_chunked_prefill_attention) replaces no TPU
// kernel: the JAX engine scatters a mixed step's chunks into (B, T) and
// gathers the pages, as this port did before it.  It serves a paged
// engine's packed step (bf16 queries on an unscaled bf16 pool, hd <= 192):
// the step's N query rows, slot after slot, each attending causally to
// its own slot's keys, read a page at a time through the block table, so
// no dense copy of the pages and no (slots x chunk) query buffer is made.
// What bounds it: a mixed step is a 512-token chunk (operations) beside
// decode rows at long contexts (bytes of their K/V).  Design (see
// wg::packed_chunked_prefill_wgmma_kernel): the wgmma body's pipeline and
// softmax; a CTA takes one KV head and up to 128 / qpk rows of one slot
// with all their query heads as its 128 MMA rows, so a row reads its K/V
// once for the group; a slot of one tile or less (a decode row) splits
// its keys into up to 8 spans merged by a second kernel, which also
// writes the rows of no slot as zeros.  The grid depends only on N, B
// and the span count, as a CUDA graph needs; CTAs past the step's work
// exit at once.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// f32 queries, and every call without a bf16 instance: 3xTF32
// ---------------------------------------------------------------------------
namespace tf {

constexpr int BQ = 64;          // query rows per CTA, 16 per warp
constexpr int BK = 64;          // keys per K or V tile
constexpr int THREADS = 128;
constexpr int NB = BK / 8;      // 8-key steps of a tile

// x rounded to the nearest tf32, ties away from zero (cvt.rna.tf32.f32)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each a tf32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a (16x8, row) * b (8x8, col); tf32 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b as three TF32 products: the cross terms, then hi.hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// eight consecutive elements as f32 (exact for every pool type)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = to_f(e[i]);
}
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&f)[8]) {   // one-byte codes
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = to_f(e[i]);
}

// four consecutive query elements as f32
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
  return make_float4(to_f(e[0]), to_f(e[1]), to_f(e[2]), to_f(e[3]));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_f(a, b);
}

// Shared memory of a CTA: the Q tile, two K/V tiles and their per-key scales.
inline size_t smem_bytes(int hd) {
  const size_t ld = hd + 4;
  return sizeof(float) * (BQ * ld + 2 * BK * (ld + 1));
}

// NO: O's 8-column blocks a warp holds, hd / 8 at most
template <typename TQ, typename TKV, int NO>
__global__ void __launch_bounds__(THREADS)
chunked_prefill_tf32_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                            const TKV* __restrict__ v, const int* __restrict__ offsets,
                            const float* __restrict__ ks, const float* __restrict__ vs,
                            TQ* __restrict__ out, int Tq, int S, int H, int KV, int hd,
                            long long sqb, long long sqt, long long skb, long long sks,
                            float scale_log2) {
  extern __shared__ __align__(16) float smem[];
  const int ld = hd + 4;
  float* q_s = smem;                        // BQ x ld
  float* ring = q_s + BQ * ld;              // 2 x BK x ld: K and V tiles in turn
  float* sc_s = ring + 2 * BK * ld;         // 2 x BK: each tile's per-key scales

  // grid (H, B, q tiles), the q tiles with the most keys first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ, h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int off = offsets[b];
  const int kv_end = min(S, off + min(q0 + BQ, Tq));   // causal frontier of the tile
  const int n_loads = 2 * ((kv_end + BK - 1) / BK);    // K and V of every tile
  const int nk = hd / 8;

  for (int e = tid; e < BQ * (hd / 4); e += THREADS) {
    const int r = e / (hd / 4), c = (e - r * (hd / 4)) * 4;
    const int t = q0 + r;
    const float4 val = t < Tq ? load4(q + b * sqb + t * sqt + (size_t)h * hd + c)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(q_s + r * ld + c) = val;
  }

  // load j: the K (j even) or V (j odd) tile j / 2 into slot j % 2; keys
  // past the frontier read as zero.
  auto load = [&](int j) {
    if (j < n_loads) {
      const int k0 = (j >> 1) * BK;
      const TKV* src = (j & 1) ? v : k;
      const float* plane = (j & 1) ? vs : ks;
      float* dst = ring + (j & 1) * BK * ld;
      if constexpr (sizeof(TKV) == 4) {
        const int cpr = hd / 4;   // 16-byte chunks of a row
        for (int e = tid; e < BK * cpr; e += THREADS) {
          const int r = e / cpr, c = (e - r * cpr) * 4, s = k0 + r;
          const bool in = s < kv_end;
          cp_async16(dst + r * ld + c, in ? src + b * skb + s * sks + (size_t)kvh * hd + c : src,
                     in);
        }
      } else {
        const int cpr = hd / 8;   // 8-element chunks of a row
        for (int e = tid; e < BK * cpr; e += THREADS) {
          const int r = e / cpr, c = (e - r * cpr) * 8, s = k0 + r;
          float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          if (s < kv_end) load8(src + b * skb + s * sks + (size_t)kvh * hd + c, f);
          *reinterpret_cast<float4*>(dst + r * ld + c) = make_float4(f[0], f[1], f[2], f[3]);
          *reinterpret_cast<float4*>(dst + r * ld + c + 4) = make_float4(f[4], f[5], f[6], f[7]);
        }
      }
      if (plane != nullptr) {
        float* sdst = sc_s + (j & 1) * BK;
        for (int r = tid; r < BK; r += THREADS) {
          const int s = k0 + r;
          cp_async4(sdst + r, s < kv_end ? plane + (size_t)b * S + s : plane, s < kv_end);
        }
      }
    }
    cp_commit();
  };

  const int r0 = warp * 16;                            // this warp's rows r0 .. r0 + 15
  const int qpos0 = off + q0 + r0 + gid, qpos1 = qpos0 + 8;
  const int qpos_min = off + q0 + r0;
  float o[NO][4], sc[NB][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // rows gid, gid + 8

  load(0);
  for (int j = 0; j < n_loads; ++j) {
    cp_wait_all();
    __syncthreads();              // load j landed; every warp is done with the other slot
    load(j + 1);                  // into the other slot
    const float* tile = ring + (j & 1) * BK * ld;
    const float* tsc = sc_s + (j & 1) * BK;
    const int k0 = (j >> 1) * BK;
    if ((j & 1) == 0) {
      // S = Q K^T for this warp's 16 rows x BK keys
#pragma unroll
      for (int jj = 0; jj < NB; ++jj) sc[jj][0] = sc[jj][1] = sc[jj][2] = sc[jj][3] = 0.f;
      for (int kk = 0; kk < nk; ++kk) {
        const float* qa = q_s + (r0 + gid) * ld + kk * 8 + tig;
        uint32_t ah[4], al[4];
        split(qa[0], ah[0], al[0]);
        split(qa[8 * ld], ah[1], al[1]);
        split(qa[4], ah[2], al[2]);
        split(qa[8 * ld + 4], ah[3], al[3]);
#pragma unroll
        for (int jj = 0; jj < NB; ++jj) {
          const float* kb = tile + (jj * 8 + gid) * ld + kk * 8 + tig;
          mma3(sc[jj], ah, al, kb[0], kb[4]);
        }
      }
      // scale (K's per-key scale on the f32 scores), mask, online softmax
      // in the log2 domain; P stays in sc
      const bool edge = k0 + BK - 1 > qpos_min || k0 + BK > kv_end;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int jj = 0; jj < NB; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = jj * 8 + tig * 2 + e, key = k0 + col;
          const float f = ks != nullptr ? scale_log2 * tsc[col] : scale_log2;
          float x0 = sc[jj][e] * f, x1 = sc[jj][2 + e] * f;
          if (edge) {
            x0 = (key <= qpos0 && key < kv_end) ? x0 : NEG_INF;
            x1 = (key <= qpos1 && key < kv_end) ? x1 : NEG_INF;
          }
          sc[jj][e] = x0;
          sc[jj][2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float a0 = ex2(m0 - mx0), a1 = ex2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      l0 *= a0;
      l1 *= a1;
      // a masked score minus a live row's maximum is about -1e30, whose
      // exp2 is 0; a row with no live score yet subtracts 0 instead
      const float s0 = mx0 <= 0.5f * NEG_INF ? 0.f : mx0;
      const float s1 = mx1 <= 0.5f * NEG_INF ? 0.f : mx1;
#pragma unroll
      for (int jj = 0; jj < NB; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(sc[jj][e] - (e < 2 ? s0 : s1));
          sc[jj][e] = p;
          if (e < 2) l0 += p; else l1 += p;
        }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= a0;
        o[n][1] *= a0;
        o[n][2] *= a1;
        o[n][3] *= a1;
      }
    } else {
      // O += P V.  The keys of an 8-key step are taken in the order of the
      // score accumulators: key 2 tig is k-index tig, key 2 tig + 1 is
      // k-index tig + 4, so sc[jj] is P's A fragment as it stands (V's
      // scale folded in before the split) and V's fragment is read in
      // the same order.
#pragma unroll
      for (int jj = 0; jj < NB; ++jj) {
        float f0 = 1.f, f1 = 1.f;
        if (vs != nullptr) {
          f0 = tsc[jj * 8 + tig * 2];
          f1 = tsc[jj * 8 + tig * 2 + 1];
        }
        uint32_t ah[4], al[4];
        split(sc[jj][0] * f0, ah[0], al[0]);
        split(sc[jj][2] * f0, ah[1], al[1]);
        split(sc[jj][1] * f1, ah[2], al[2]);
        split(sc[jj][3] * f1, ah[3], al[3]);
        const float* vb = tile + (jj * 8 + tig * 2) * ld + gid;
#pragma unroll
        for (int n = 0; n < NO; ++n)
          if (n < nk) mma3(o[n], ah, al, vb[n * 8], vb[ld + n * 8]);
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
    if (n >= nk) continue;
    const int col = n * 8 + tig * 2;
    if (t0 < Tq)
      store2(out + (((size_t)b * Tq + t0) * H + h) * hd + col, o[n][0] * inv0, o[n][1] * inv0);
    if (t1 < Tq)
      store2(out + (((size_t)b * Tq + t1) * H + h) * hd + col, o[n][2] * inv1, o[n][3] * inv1);
  }
}

}  // namespace tf

// ---------------------------------------------------------------------------
// bf16 queries on f32 pools or scaled bf16 pools: mma.sync
// ---------------------------------------------------------------------------
constexpr int MBQ = 64;       // query rows per CTA (16 per warp)
constexpr int MBK = 64;       // keys per loop step
constexpr int MTHREADS = 128;

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// eight consecutive elements as bf16 (f32 rounded to nearest)
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
// bf16 queries on an unscaled bf16 pool, or on fp8 or int8 codes at
// hd % 16 == 0: TMA + wgmma, warp-specialised, at instance widths 64, 128,
// 192 and 256
// ---------------------------------------------------------------------------
namespace wg {

constexpr int BOX = 64;              // elements in one 128-byte swizzled box row
constexpr size_t SMEM_MAX = 232448;  // the shared memory a CTA may hold

// The tiles of one instance: a row of HD elements (the head dim rounded
// up to HD) is NP pieces of 64 (128 bytes, swizzled), K/V tiles hold BK
// keys, and NC consumer warpgroups own 64 query rows each.  Widths 64
// and 128 take 128-key tiles; 192 and 256 take 64-key tiles, so that the
// Q tile (48 or 64 KB) and the K/V ring (24 or 32 KB a tile) fit the 227
// KB a CTA may hold.  A producer warpgroup (one TMA thread and, for
// one-byte codes, three converter warps) comes first, unless SELF: then
// a consumer thread issues the loads.  ptxas allots a thread of a
// 384-thread CTA 168 registers whatever setmaxnreg later moves, and a
// consumer at width 256 needs about 200 (128 f32 of O alone), so width
// 256 runs 256-thread CTAs (255 registers a thread): two consumer
// warpgroups that load for themselves (bf16), or the producer warpgroup
// and one consumer warpgroup (codes, which need the converters; also at
// width 64, where 168 registers spill).
template <int HD_, int BK_, int NC_ = 2, bool SELF_ = false>
struct Tile {
  static constexpr int HD = HD_;
  static constexpr int BK = BK_;
  static constexpr int NC = NC_;
  static constexpr bool SELF = SELF_;
  static constexpr int BQ = 64 * NC;                       // query rows per CTA
  static constexpr int THREADS = 128 * (NC + (SELF ? 0 : 1));
  static constexpr int NP = HD / BOX;          // 128-byte pieces of a row
  static constexpr int Q_PIECE = BQ * 128;     // bytes of one piece of the Q tile
  static constexpr int KV_PIECE = BK * 128;    // bytes of one piece of a K or V tile
  static constexpr int Q_BYTES = NP * Q_PIECE;
  static constexpr int KV_BYTES = NP * KV_PIECE;
  static constexpr int CODE_BYTES = BK * HD;   // one staged K or V tile of 1-byte codes
  // dynamic shared memory of a CTA with an nst-stage K/V ring (+1024:
  // base alignment); quantized pools add the two staging tiles and the
  // per-key scales
  static constexpr size_t smem_bytes(int nst, bool quant) {
    return Q_BYTES + 2 * nst * KV_BYTES + 1024 +
           (quant ? 2 * CODE_BYTES + 2 * nst * BK * sizeof(float) : 0);
  }
  // stages of the K/V ring: 3 where they fit; quantized pools keep 2 for
  // the staging tiles, and at width 256 three bf16 stages (256 KB with Q)
  // do not fit
  static constexpr int stages(bool quant) {
    return !quant && smem_bytes(3, false) <= SMEM_MAX ? 3 : 2;
  }
};

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
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// keeps the registers of P, which a register-A wgmma reads while it runs,
// from being reused before its wait
template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d (+)= A (64x16, shared memory) * B (16xN, shared memory, K-major); N is
// the K/V tile's keys (64 or 128)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d);
// d += A (64x16, registers) * B (16xN, shared memory, MN-major); N is the
// instance width (64, 128, 192 or 256)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
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

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
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

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %101, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
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

// The consumer warpgroup's loop over its K/V tiles, shared by
// chunked_prefill_wgmma_kernel and packed_chunked_prefill_wgmma_kernel:
// per tile `it` (keys k_lo + it * BK on), S = Q K^T, the online softmax,
// O += P V, each product waited for before its registers are touched (S,
// P and O live at once would not fit the 168 registers ptxas allots a
// thread of a 384-thread CTA; the two warpgroups interleave on their
// own).  P is packed once its V tile has landed (quantized pools: its V
// scales arrive with it), and a K stage is released only after the
// softmax has read its scales.  qa is this warpgroup's 64 rows of the
// swizzled Q tile; qpos0 and qpos1 the positions of this thread's two
// rows, qpos_min that of the warpgroup's first row; keys past a row's
// position or at kv_end and beyond are masked.  ahead(it) runs at the top
// of each step (the SELF body's loads).  On return o holds the rows'
// unnormalised outputs, m their maxima (log2 domain) and l their sums,
// reduced over the four threads of a row.
template <typename T, int NSTG, bool QUANT, typename Ahead>
__device__ __forceinline__ void consume_tiles(
    float (&o)[T::HD / 2], float& m0, float& m1, float& l0, float& l1, uint32_t qa,
    unsigned char* k_s, unsigned char* v_s, const float* ksc_s, const float* vsc_s,
    uint64_t* k_full, uint64_t* v_full, uint64_t* k_empty, uint64_t* v_empty, int n_tiles,
    int k_lo, int kv_end, int qpos0, int qpos1, int qpos_min, float scale_log2, Ahead ahead) {
  constexpr int HD = T::HD, BK = T::BK;
  constexpr int Q_PIECE = T::Q_PIECE, KV_PIECE = T::KV_PIECE, KV_BYTES = T::KV_BYTES;
  const int lane = threadIdx.x & 31, tig = lane & 3;
  float sc[BK / 2];
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  m0 = NEG_INF;
  m1 = NEG_INF;
  l0 = 0.f;
  l1 = 0.f;

  // S = Q K^T of tile `it` into sc: HD/16 k-steps of 16 over NP swizzled pieces
  auto issue_s = [&](int it) {
    const uint32_t ka = smem_u32(k_s + (it % NSTG) * KV_BYTES);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<BK>(sc, desc_sw128(qa + (kk >> 2) * Q_PIECE + (kk & 3) * 32, 16, 1024),
                   desc_sw128(ka + (kk >> 2) * KV_PIECE + (kk & 3) * 32, 16, 1024), kk > 0);
    wg_commit();
  };
  // O += P V of tile `it`: P from registers, V transposed through the descriptor
  auto issue_pv = [&](int it) {
    const uint32_t va = smem_u32(v_s + (it % NSTG) * KV_BYTES);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<HD>(o, pa[kk], desc_sw128(va + kk * 16 * 128, KV_PIECE, 1024));
    wg_commit();
  };
  // online softmax of tile `it` in the log2 domain (masked scores -1e30;
  // quantized pools: K scale on the f32 scores): P stays in sc as f32, l
  // is updated, and the factor that rescales O from the old maximum to
  // the new one is returned per row
  auto softmax = [&](int it, float& a0, float& a1) {
    const int k0 = k_lo + it * BK;
    const bool edge = k0 + BK - 1 > qpos_min || k0 + BK > kv_end;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + tig * 2 + e, key = k0 + col;
        float f = scale_log2;
        if constexpr (QUANT) f *= ksc_s[(it % NSTG) * BK + col];
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
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(sc[j * 4 + e] - (e < 2 ? s0 : s1));
        sc[j * 4 + e] = p;
        if (e < 2) l0 += p; else l1 += p;
      }
  };
  // P of tile `it` (quantized pools: times the V scale) as bf16 A fragments
  auto pack_p = [&](int it) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      float f0 = 1.f, f1 = 1.f;
      if constexpr (QUANT) {
        const float* vss = vsc_s + (it % NSTG) * BK;
        f0 = vss[j * 8 + tig * 2];
        f1 = vss[j * 8 + tig * 2 + 1];
      }
      pa[j >> 1][(j & 1) * 2] = pack_f(sc[j * 4] * f0, sc[j * 4 + 1] * f1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_f(sc[j * 4 + 2] * f0, sc[j * 4 + 3] * f1);
    }
  };
  auto rescale_o = [&](float a0, float a1) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[j * 4] *= a0;
      o[j * 4 + 1] *= a0;
      o[j * 4 + 2] *= a1;
      o[j * 4 + 3] *= a1;
    }
  };

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % NSTG, ph = (it / NSTG) & 1;
    float a0, a1;
    ahead(it);
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
}

// TKV is the pool's element type: bf16 tiles go by TMA straight into the
// swizzled operand tiles; fp8 or int8 codes go by TMA into a staging tile
// and warps 1-3 of the producer warpgroup convert them into the operand
// tile (and copy the tile's per-key scales beside it).  T is the Tile of
// the instance width; hd, the true head dim, is the row the epilogue
// writes.
template <typename TKV, int NSTG, typename T>
__global__ void __launch_bounds__(T::THREADS, 1)
chunked_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const int* __restrict__ offsets, const float* __restrict__ ks,
                             const float* __restrict__ vs, __nv_bfloat16* __restrict__ out,
                             int Tq, int S, int H, int KV, int hd, float scale_log2) {
  constexpr bool QUANT = sizeof(TKV) == 1;
  constexpr int HD = T::HD, BK = T::BK, NP = T::NP, BQ = T::BQ, NC = T::NC;
  static_assert(!(QUANT && T::SELF), "codes need the producer warpgroup's converters");
  constexpr int Q_PIECE = T::Q_PIECE, KV_PIECE = T::KV_PIECE;
  constexpr int Q_BYTES = T::Q_BYTES, KV_BYTES = T::KV_BYTES, CODE_BYTES = T::CODE_BYTES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 4 * NSTG + 4];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = smem;                      // [NP pieces][BQ rows][128 B]
  unsigned char* k_s = smem + Q_BYTES;            // [NSTG][NP pieces][BK rows][128 B]
  unsigned char* v_s = k_s + NSTG * KV_BYTES;
  unsigned char* kc_s = v_s + NSTG * KV_BYTES;     // quantized: staged codes [BK][HD]
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
      mbar_init(&k_empty[s], 4 * NC);         // lane 0 of each consumer warp
      mbar_init(&v_empty[s], 4 * NC);
    }
    mbar_init(kc_full, 1);
    mbar_init(vc_full, 1);
    mbar_init(kc_empty, 3);
    mbar_init(vc_empty, 3);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // one thread issues every TMA load: the Q tile, then the K and V
  // tiles (bf16: into the ring; codes: into the staging tiles)
  auto load_q = [&]() {
    mbar_expect_tx(q_full, Q_BYTES);
#pragma unroll
    for (int pc = 0; pc < NP; ++pc) tma_load(q_s + pc * Q_PIECE, &tq, q_full, pc * BOX, h, q0, b);
  };
  auto load_tile = [&](int it) {
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
#pragma unroll
      for (int pc = 0; pc < NP; ++pc)
        tma_load(kd + pc * KV_PIECE, &tk, &k_full[st], pc * BOX, kvh, k0, b);
      mbar_wait(&v_empty[st], ph ^ 1);
      mbar_expect_tx(&v_full[st], KV_BYTES);
#pragma unroll
      for (int pc = 0; pc < NP; ++pc)
        tma_load(vd + pc * KV_PIECE, &tv, &v_full[st], pc * BOX, kvh, k0, b);
    }
  };

  if (!T::SELF && threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps TMA loads in flight ----
    if constexpr (T::THREADS == 384) {
      if constexpr (QUANT)
        asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
      else
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    }
    if (threadIdx.x == 0) {
      load_q();
      for (int it = 0; it < n_tiles; ++it) load_tile(it);
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
        constexpr int CPR = HD / 16;   // 16-code chunks of a row
        for (int u = ct; u < BK * CPR; u += 96) {
          const int r = u / CPR, ch = u - r * CPR;   // key row; 16-code chunk of the row
          uint4 lo, hi;
          codes_to_bf16<TKV>(*reinterpret_cast<const uint4*>(codes + r * HD + ch * 16), lo, hi);
          // elements 16 ch .. 16 ch + 15: 16-byte chunks 2 (ch & 3) and
          // 2 (ch & 3) + 1 of head-dim piece ch >> 2, 128-byte swizzled
          unsigned char* row = op + (ch >> 2) * KV_PIECE + r * 128;
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
    if constexpr (T::THREADS == 384) {
      if constexpr (QUANT)
        asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
      else
        asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    }
    const int c = T::SELF ? threadIdx.x / 128 : threadIdx.x / 128 - 1;
    const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
    const int tig = lane & 3;
    const int r0 = c * 64 + warp * 16 + (lane >> 2);   // rows r0 and r0 + 8 of the tile
    const int qpos0 = off + q0 + r0, qpos1 = qpos0 + 8;
    const int qpos_min = off + q0 + c * 64;             // first row of this warpgroup

    float o[HD / 2], m0, m1, l0, l1;
    // SELF: thread 0 loads Q and the first NSTG tiles, then, at the top of
    // each step, the tile NSTG - 1 ahead into the stage both warpgroups
    // have just released
    if constexpr (T::SELF) {
      if (threadIdx.x == 0) {
        load_q();
        for (int it = 0; it < min(NSTG, n_tiles); ++it) load_tile(it);
      }
    }
    mbar_wait(q_full, 0);
    consume_tiles<T, NSTG, QUANT>(
        o, m0, m1, l0, l1, smem_u32(q_s) + c * 64 * 128, k_s, v_s, ksc_s, vsc_s, k_full,
        v_full, k_empty, v_empty, n_tiles, 0, kv_end, qpos0, qpos1, qpos_min, scale_log2,
        [&](int it) {
          if constexpr (T::SELF) {
            if (threadIdx.x == 0 && it > 0 && it + NSTG - 1 < n_tiles) load_tile(it + NSTG - 1);
          }
        });
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    const int t0 = q0 + r0, t1 = t0 + 8;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = j * 8 + tig * 2;
      if (col >= hd) break;   // the padded columns of the instance width
      if (t0 < Tq)
        *reinterpret_cast<uint32_t*>(out + (((size_t)b * Tq + t0) * H + h) * hd + col) =
            pack_f(o[j * 4] * inv0, o[j * 4 + 1] * inv0);
      if (t1 < Tq)
        *reinterpret_cast<uint32_t*>(out + (((size_t)b * Tq + t1) * H + h) * hd + col) =
            pack_f(o[j * 4 + 2] * inv1, o[j * 4 + 3] * inv1);
    }
  }
}

// ---------------------------------------------------------------------------
// A packed step's query rows over the page pool (packed_chunked_prefill_*)
// ---------------------------------------------------------------------------
// A paged engine's mixed step packs its tokens into N rows, slot by slot:
// slot b holds n_b = active[b] ? n_valid[b] : 0 consecutive rows ending at
// row last[b], at positions pos_offset[b] .. pos_offset[b] + n_b - 1.
// slots is the (4, B) int32 array of those rows.  A work tile is up to R
// consecutive rows of one slot, all qpk query heads of one KV head: MMA
// row i * qpk + g is the tile's row i at query head kvh * qpk + g (the
// layout a 3-D TMA box of (64 columns, qpk heads, R rows) writes), so R =
// 128 / qpk rows fill the CTA's 128 MMA rows and K/V is read once for the
// whole group.  A slot of more than R rows runs one work item a tile, its
// last tile (the most keys) first.  A slot of at most R rows (a decode
// row, a tail chunk) splits its keys into up to NSPLIT spans of whole
// key tiles, each a work item that writes its unnormalised (O, m, l) to
// scratch, and the merge pass weighs the spans together, so a long
// context is read by NSPLIT CTAs at once instead of one; a warpgroup
// whose MMA rows hold no query (the second, for a slot of 64 or fewer)
// skips its products.  Work items are enumerated on the device from the
// per-slot arrays, so the grid depends only on N, B and NSPLIT (a CUDA
// graph's key), and CTAs past the step's items exit at once.
constexpr int PACKED_ROWS = 128;   // MMA rows of a CTA: two consumer warpgroups

struct Work {
  int b, row0, nrows, pos0, k_lo, k_hi, split, nsplit;
};

__device__ __forceinline__ int slot_rows(const int* slots, int B, int b) {
  return slots[2 * B + b] ? slots[B + b] : 0;
}

// the key tiles a span of a split slot takes, and the number of spans, for
// `frontier` keys
__device__ __forceinline__ void split_keys(int frontier, int bk, int nsplit, int& tps,
                                           int& ns) {
  const int nk = (frontier + bk - 1) / bk;
  const int want = min(nsplit, nk);
  tps = (nk + want - 1) / want;
  ns = (nk + tps - 1) / tps;
}

// work item `idx` of the step: the tiles of slots of more than R rows,
// then the spans of the others; false past the last item
__device__ bool find_work(int idx, const int* slots, int B, int R, int bk, int nsplit,
                          Work& w) {
  for (int b = 0; b < B; ++b) {
    const int n = slot_rows(slots, B, b);
    if (n <= R) continue;
    const int nt = (n + R - 1) / R;
    if (idx < nt) {
      const int j = nt - 1 - idx;
      w.b = b;
      w.row0 = slots[3 * B + b] - n + 1 + j * R;
      w.nrows = min(R, n - j * R);
      w.pos0 = slots[b] + j * R;
      w.k_lo = 0;
      w.k_hi = w.pos0 + w.nrows;
      w.split = 0;
      w.nsplit = 1;
      return true;
    }
    idx -= nt;
  }
  for (int b = 0; b < B; ++b) {
    const int n = slot_rows(slots, B, b);
    if (n == 0 || n > R) continue;
    const int frontier = slots[b] + n;
    int tps, ns;
    split_keys(frontier, bk, nsplit, tps, ns);
    if (idx < ns) {
      w.b = b;
      w.row0 = slots[3 * B + b] - n + 1;
      w.nrows = n;
      w.pos0 = slots[b];
      w.k_lo = idx * tps * bk;
      w.k_hi = min(frontier, w.k_lo + tps * bk);
      w.split = idx;
      w.nsplit = ns;
      return true;
    }
    idx -= ns;
  }
  return false;
}

// The pipeline is that of chunked_prefill_wgmma_kernel (bf16 pools, three
// warpgroups), and the consumers run the same loop (consume_tiles).  What
// differs: the Q tile is one box a 64-column piece (qpk heads x R rows
// of the packed q); the K and V tiles come a page at a time, one
// 4-D box (64 columns, 1 head, page rows, 1 page) a page and piece,
// through the slot's block-table row, issued by the 32 lanes of the
// producer warp (one box a lane: BK / page pages x NP pieces <= 32); and
// each MMA row carries its own position.
template <int NSTG, typename T>
__global__ void __launch_bounds__(T::THREADS, 1)
packed_chunked_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                    const __grid_constant__ CUtensorMap tk,
                                    const __grid_constant__ CUtensorMap tv,
                                    const int* __restrict__ slots,
                                    const int* __restrict__ tables,
                                    __nv_bfloat16* __restrict__ out,
                                    float* __restrict__ part_o, float* __restrict__ part_ml,
                                    int H, int KV, int hd, int B, int n_pp, int n_pages,
                                    int page, int R, int nsplit, float scale_log2) {
  constexpr int HD = T::HD, BK = T::BK, NP = T::NP;
  static_assert(T::BQ == PACKED_ROWS && !T::SELF, "two consumer warpgroups and a producer");
  constexpr int Q_PIECE = T::Q_PIECE, KV_PIECE = T::KV_PIECE;
  constexpr int Q_BYTES = T::Q_BYTES, KV_BYTES = T::KV_BYTES;
  const int kvh = blockIdx.x, qpk = H / KV;
  Work w;
  if (!find_work(blockIdx.y, slots, B, R, BK, nsplit, w)) return;

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 4 * NSTG];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = smem;                      // [NP pieces][128 rows][128 B]
  unsigned char* k_s = smem + Q_BYTES;            // [NSTG][NP pieces][BK rows][128 B]
  unsigned char* v_s = k_s + NSTG * KV_BYTES;
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + NSTG;
  uint64_t* k_empty = bars + 1 + 2 * NSTG;
  uint64_t* v_empty = bars + 1 + 3 * NSTG;
  const int used = w.nrows * qpk;                          // MMA rows that hold a query
  const int n_tiles = (w.k_hi - w.k_lo + BK - 1) / BK;     // >= 1

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NSTG; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 4 * T::NC);      // lane 0 of each consumer warp
      mbar_init(&v_empty[s], 4 * T::NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // MMA rows past the box (128 - qpk * R of them) are never loaded: zero
  // them once, so every product reads finite values
  for (int e = threadIdx.x; e < NP * (PACKED_ROWS - qpk * R) * 8; e += T::THREADS) {
    const int pc = e / ((PACKED_ROWS - qpk * R) * 8), rest = e - pc * (PACKED_ROWS - qpk * R) * 8;
    *reinterpret_cast<uint4*>(q_s + pc * Q_PIECE + (qpk * R) * 128 + rest * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: warp 0's lanes issue the TMA loads ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) mbar_expect_tx(q_full, NP * qpk * R * 128);
    __syncwarp();
    if (lane < NP) tma_load(q_s + lane * Q_PIECE, &tq, q_full, lane * BOX, kvh * qpk, w.row0, 0);
    // lane u loads page u / NP of a tile, piece u % NP; a page past the
    // table is out of the map's bounds and reads as zeros
    const int nbox = BK / page * NP, j = lane / NP, pc = lane - j * NP;
    const int* tbl = tables + (size_t)w.b * n_pp;
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % NSTG, ph = (it / NSTG) & 1;
      const int lp = (w.k_lo + it * BK) / page + j;
      const int phys = lane < nbox && lp < n_pp ? tbl[lp] : n_pages;
      const int at = pc * KV_PIECE + j * page * 128;
      if (lane == 0) {
        mbar_wait(&k_empty[st], ph ^ 1);
        mbar_expect_tx(&k_full[st], KV_BYTES);
      }
      __syncwarp();
      if (lane < nbox) tma_load(k_s + st * KV_BYTES + at, &tk, &k_full[st], pc * BOX, kvh, 0, phys);
      if (lane == 0) {
        mbar_wait(&v_empty[st], ph ^ 1);
        mbar_expect_tx(&v_full[st], KV_BYTES);
      }
      __syncwarp();
      if (lane < nbox) tma_load(v_s + st * KV_BYTES + at, &tv, &v_full[st], pc * BOX, kvh, 0, phys);
    }
    return;
  }

  // ---- consumer warpgroups: 64 MMA rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = threadIdx.x / 128 - 1;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int tig = lane & 3;
  if (c * 64 >= used) {
    // no query in this warpgroup's rows: release each stage as it lands
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % NSTG, ph = (it / NSTG) & 1;
      mbar_wait(&k_full[st], ph);
      if (lane == 0) mbar_arrive(&k_empty[st]);
      mbar_wait(&v_full[st], ph);
      if (lane == 0) mbar_arrive(&v_empty[st]);
    }
    return;
  }
  const int mr0 = c * 64 + warp * 16 + (lane >> 2), mr1 = mr0 + 8;   // this thread's MMA rows
  // a row past the tile's queries takes its last query's position
  const int qpos0 = w.pos0 + min(mr0 / qpk, w.nrows - 1);
  const int qpos1 = w.pos0 + min(mr1 / qpk, w.nrows - 1);
  const int qpos_min = w.pos0 + (c * 64) / qpk;   // first query row of this warpgroup

  float o[HD / 2], m0, m1, l0, l1;
  mbar_wait(q_full, 0);
  consume_tiles<T, NSTG, false>(o, m0, m1, l0, l1, smem_u32(q_s) + c * 64 * 128, k_s, v_s,
                                nullptr, nullptr, k_full, v_full, k_empty, v_empty, n_tiles,
                                w.k_lo, w.k_hi, qpos0, qpos1, qpos_min, scale_log2,
                                [](int) {});
  if (w.nsplit == 1) {
    // the rows' outputs: MMA row m is query row m / qpk at head kvh * qpk + m % qpk
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    const int i0 = mr0 / qpk, i1 = mr1 / qpk;
    __nv_bfloat16* out0 = out + ((size_t)(w.row0 + i0) * H + kvh * qpk + mr0 - i0 * qpk) * hd;
    __nv_bfloat16* out1 = out + ((size_t)(w.row0 + i1) * H + kvh * qpk + mr1 - i1 * qpk) * hd;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = j * 8 + tig * 2;
      if (col >= hd) break;   // the padded columns of the instance width
      if (mr0 < used)
        *reinterpret_cast<uint32_t*>(out0 + col) = pack_f(o[j * 4] * inv0, o[j * 4 + 1] * inv0);
      if (mr1 < used)
        *reinterpret_cast<uint32_t*>(out1 + col) = pack_f(o[j * 4 + 2] * inv1, o[j * 4 + 3] * inv1);
    }
  } else {
    // a span's unnormalised output and (m, l) a row, for the merge pass
    const size_t base = ((size_t)(w.b * nsplit + w.split) * KV + kvh) * PACKED_ROWS;
    float* po0 = part_o + (base + mr0) * hd;
    float* po1 = part_o + (base + mr1) * hd;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = j * 8 + tig * 2;
      if (col >= hd) break;
      if (mr0 < used) *reinterpret_cast<float2*>(po0 + col) = make_float2(o[j * 4], o[j * 4 + 1]);
      if (mr1 < used) *reinterpret_cast<float2*>(po1 + col) = make_float2(o[j * 4 + 2], o[j * 4 + 3]);
    }
    if (tig == 0) {
      if (mr0 < used) *reinterpret_cast<float2*>(part_ml + (base + mr0) * 2) = make_float2(m0, l0);
      if (mr1 < used) *reinterpret_cast<float2*>(part_ml + (base + mr1) * 2) = make_float2(m1, l1);
    }
  }
}

// The merge pass, one CTA a packed row: a row of no slot (a pad) is
// written as zeros; a row of a slot whose keys were split into two or more
// spans is the spans' outputs weighed by 2^(m_s - M) over the same sum of
// their l, in q's dtype; every other row was written by the main pass.  A
// thread takes 8 columns of one head at a time and issues the loads of
// every span at once, so a row costs about one round trip to L2.
constexpr int MAX_SPLIT = 8;
constexpr int MERGE_THREADS = 256;

__global__ void __launch_bounds__(MERGE_THREADS)
packed_chunked_prefill_merge_kernel(const int* __restrict__ slots,
                                    const float* __restrict__ part_o,
                                    const float* __restrict__ part_ml,
                                    __nv_bfloat16* __restrict__ out, int H, int KV, int hd,
                                    int B, int R, int bk, int nsplit) {
  const int r = blockIdx.x, width = H * hd;
  int b = -1, n = 0;
  for (int s = 0; s < B; ++s) {
    const int ns = slot_rows(slots, B, s), last = slots[3 * B + s];
    if (ns > 0 && r > last - ns && r <= last) {
      b = s;
      n = ns;
    }
  }
  __nv_bfloat16* row = out + (size_t)r * width;
  if (b < 0) {
    for (int e = threadIdx.x * 8; e < width; e += MERGE_THREADS * 8)
      *reinterpret_cast<uint4*>(row + e) = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  if (n > R) return;
  int tps, ns;
  split_keys(slots[b] + n, bk, nsplit, tps, ns);
  if (ns == 1) return;
  const int i = r - (slots[3 * B + b] - n + 1), qpk = H / KV, per_head = hd / 8;
  const size_t stride = (size_t)KV * PACKED_ROWS;   // from one span to the next
  for (int u = threadIdx.x; u < H * per_head; u += MERGE_THREADS) {
    const int h = u / per_head, col = (u - h * per_head) * 8, kvh = h / qpk;
    const size_t base = ((size_t)b * nsplit * KV + kvh) * PACKED_ROWS + i * qpk + h - kvh * qpk;
    float2 ml[MAX_SPLIT];
    float4 lo[MAX_SPLIT], hi[MAX_SPLIT];
#pragma unroll
    for (int s = 0; s < MAX_SPLIT; ++s) {
      if (s < ns) {
        const size_t at = base + s * stride;
        ml[s] = *reinterpret_cast<const float2*>(part_ml + at * 2);
        lo[s] = *reinterpret_cast<const float4*>(part_o + at * hd + col);
        hi[s] = *reinterpret_cast<const float4*>(part_o + at * hd + col + 4);
      }
    }
    float mx = NEG_INF;
#pragma unroll
    for (int s = 0; s < MAX_SPLIT; ++s)
      if (s < ns) mx = fmaxf(mx, ml[s].x);
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, l = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLIT; ++s) {
      if (s < ns) {
        const float f = ex2(ml[s].x - mx);
        l += f * ml[s].y;
        acc[0] += f * lo[s].x;
        acc[1] += f * lo[s].y;
        acc[2] += f * lo[s].z;
        acc[3] += f * lo[s].w;
        acc[4] += f * hi[s].x;
        acc[5] += f * hi[s].y;
        acc[6] += f * hi[s].z;
        acc[7] += f * hi[s].w;
      }
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    uint4 v;
    v.x = pack_f(acc[0] * inv, acc[1] * inv);
    v.y = pack_f(acc[2] * inv, acc[3] * inv);
    v.z = pack_f(acc[4] * inv, acc[5] * inv);
    v.w = pack_f(acc[6] * inv, acc[7] * inv);
    *reinterpret_cast<uint4*>(row + h * hd + col) = v;
  }
}
}  // namespace wg

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
// The bodies, by the code the wrapper passes (shapes.PREFILL_BODIES).
enum Body { BODY_TF32 = 0, BODY_MMA_SYNC = 1, BODY_WGMMA = 2 };

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
// whose box is box_cols elements x box_heads heads x box_rows rows x 1
// batch row:
// 64 bf16 elements (128 bytes) with 128-byte swizzle, or a whole row of
// the instance width in one-byte codes unswizzled.  hd is the true head
// dim: the row's extent and the head stride.  Columns past hd and rows
// past `rows` read as zero, so a tile never sees the next head's or the
// next batch row's data.
cudaError_t make_map(CUtensorMap* map, const void* base, int esize, int hd, int box_cols,
                     int heads, int rows, int B, long long s_row, long long s_b,
                     int box_rows, int box_heads = 1) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const bool codes = esize == 1;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * esize, (cuuint64_t)s_row * esize,
                                 (cuuint64_t)s_b * esize};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)box_heads, (cuuint32_t)box_rows,
                             1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = enc(map, codes ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                   4, const_cast<void*>(base), dims, strides, box, estr,
                   CU_TENSOR_MAP_INTERLEAVE_NONE,
                   codes ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename TKV, typename T>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* offsets,
                         const void* ks, const void* vs, void* out, int B, int Tq, int S,
                         int H, int KV, int hd, long long sqb, long long sqt, long long skb,
                         long long sks, float scale, cudaStream_t stream) {
  constexpr int esize = (int)sizeof(TKV);
  constexpr int nst = T::stages(esize == 1);
  constexpr size_t smem = T::smem_bytes(nst, esize == 1);
  static_assert(smem <= wg::SMEM_MAX, "a CTA holds at most 227 KB of shared memory");
  // the true hd for the rows' extent and stride; the instance width for
  // the code boxes
  const int kv_box = esize == 1 ? T::HD : wg::BOX;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, 2, hd, wg::BOX, H, Tq, B, sqt, sqb, T::BQ);
  if (err == cudaSuccess) err = make_map(&tk, k, esize, hd, kv_box, KV, S, B, sks, skb, T::BK);
  if (err == cudaSuccess) err = make_map(&tv, v, esize, hd, kv_box, KV, S, B, sks, skb, T::BK);
  if (err != cudaSuccess) return err;
  auto kern = wg::chunked_prefill_wgmma_kernel<TKV, nst, T>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B, (Tq + T::BQ - 1) / T::BQ);
  kern<<<grid, T::THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<const int*>(offsets), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<__nv_bfloat16*>(out), Tq, S, H, KV, hd,
      scale * LOG2E);
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

// The wgmma instance of each head dim: hd rounded up to the next width in
// {64, 128, 192, 256}, in CTAs of 256 threads where 384 would spill (see
// wg::Tile).
template <typename TKV>
cudaError_t launch_wgmma_hd(int hd, const void* q, const void* k, const void* v,
                            const void* offsets, const void* ks, const void* vs, void* out,
                            int B, int Tq, int S, int H, int KV, long long sqb, long long sqt,
                            long long skb, long long sks, float scale, cudaStream_t stream) {
  constexpr bool quant = sizeof(TKV) == 1;
  using T64 = wg::Tile<64, 128, quant ? 1 : 2>;
  using T256 = std::conditional_t<quant, wg::Tile<256, 64, 1>, wg::Tile<256, 64, 2, true>>;
  if (hd <= 64) return launch_wgmma<TKV, T64>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, hd, sqb, sqt, skb, sks, scale, stream);
  if (hd <= 128) return launch_wgmma<TKV, wg::Tile<128, 128>>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, hd, sqb, sqt, skb, sks, scale, stream);
  if (hd <= 192) return launch_wgmma<TKV, wg::Tile<192, 64>>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, hd, sqb, sqt, skb, sks, scale, stream);
  return launch_wgmma<TKV, T256>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, hd, sqb, sqt, skb, sks, scale, stream);
}

// The packed-row body at instance width T::HD, then the merge pass.  q
// (N, H, hd) with row stride sq (elements) and heads contiguous; pools
// (n_pages, page, KV, hd) contiguous.  Takes pages of a multiple of 8
// tokens (a box then starts on a 1024-byte swizzle period) that divide
// the key tile, and at most 128 query heads a KV head.
template <typename T>
cudaError_t launch_packed(const void* q, const void* kp, const void* vp, const void* slots,
                          const void* tables, void* out, void* part_o, void* part_ml, int N,
                          int H, int KV, int hd, long long sq, int B, int n_pp, int n_pages,
                          int page, int nsplit, float scale, cudaStream_t stream) {
  constexpr int nst = T::stages(false);
  constexpr size_t smem = T::smem_bytes(nst, false);
  static_assert(smem <= wg::SMEM_MAX, "a CTA holds at most 227 KB of shared memory");
  const int qpk = H / KV, R = wg::PACKED_ROWS / qpk;
  if (R < 1 || page % 8 != 0 || T::BK % page != 0 || nsplit < 1 || nsplit > wg::MAX_SPLIT)
    return cudaErrorInvalidValue;
  // q as (hd, H, N, 1), a box of qpk heads x R rows; the pools as (hd,
  // KV, page, n_pages), a box of one head's page
  CUtensorMap tq, tk, tv;
  const long long s_page = (long long)page * KV * hd;
  cudaError_t err = make_map(&tq, q, 2, hd, wg::BOX, H, N, 1, sq, N * sq, R, qpk);
  if (err == cudaSuccess)
    err = make_map(&tk, kp, 2, hd, wg::BOX, KV, page, n_pages, KV * hd, s_page, page);
  if (err == cudaSuccess)
    err = make_map(&tv, vp, 2, hd, wg::BOX, KV, page, n_pages, KV * hd, s_page, page);
  if (err != cudaSuccess) return err;
  auto kern = wg::packed_chunked_prefill_wgmma_kernel<nst, T>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // work items: at most ceil(N / R) + B tiles of slots longer than R rows
  // and nsplit spans of each other slot
  dim3 grid(KV, (N + R - 1) / R + B + B * nsplit);
  kern<<<grid, T::THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<const int*>(slots), static_cast<const int*>(tables),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part_o),
      static_cast<float*>(part_ml), H, KV, hd, B, n_pp, n_pages, page, R, nsplit,
      scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wg::packed_chunked_prefill_merge_kernel<<<N, wg::MERGE_THREADS, 0, stream>>>(
      static_cast<const int*>(slots), static_cast<const float*>(part_o),
      static_cast<const float*>(part_ml), static_cast<__nv_bfloat16*>(out), H, KV, hd, B, R,
      T::BK, nsplit);
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
    case 128: return launch_mma<128, TKV>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, sqb, sqt, skb, sks, scale, stream);
    default: return cudaErrorInvalidValue;   // no instance: never read a row as another width
  }
}

// The 3xTF32 body: O's column blocks sized for hd up to 64, 128 or 256.
template <typename TQ, typename TKV>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, const void* offsets,
                        const void* ks, const void* vs, void* out, int B, int Tq, int S,
                        int H, int KV, int hd, long long sqb, long long sqt, long long skb,
                        long long sks, float scale, cudaStream_t stream) {
  const size_t smem = tf::smem_bytes(hd);
  auto kern = hd <= 64 ? tf::chunked_prefill_tf32_kernel<TQ, TKV, 8>
              : hd <= 128 ? tf::chunked_prefill_tf32_kernel<TQ, TKV, 16>
                          : tf::chunked_prefill_tf32_kernel<TQ, TKV, 32>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(H, B, (Tq + tf::BQ - 1) / tf::BQ);
  kern<<<grid, tf::THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const int*>(offsets), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<TQ*>(out), Tq, S, H, KV, hd, sqb, sqt,
      skb, sks, scale * LOG2E);
  return cudaGetLastError();
}

// Launch the body the wrapper names (repro_torch/kernels/shapes.py ::
// prefill_body decides it).  A body without an instance for the call
// returns cudaErrorInvalidValue: TMA + wgmma takes bf16 queries on an
// unscaled bf16 pool, or on fp8 or int8 codes at hd % 16 == 0 (a tensor
// map's 16-byte head stride); mma.sync takes bf16 queries on an f32 or a
// bf16 pool at hd 32, 64 and 128; 3xTF32 takes every call.
template <typename TQ>
cudaError_t launch_kv(int body, int kv_dtype, const void* q, const void* k, const void* v,
                      const void* offsets, const void* ks, const void* vs, void* out,
                      int B, int Tq, int S, int H, int KV, int hd, long long sqb,
                      long long sqt, long long skb, long long sks, float scale,
                      cudaStream_t stream) {
  const bool bf16q = sizeof(TQ) == 2, codes = kv_dtype == 2 || kv_dtype == 3;
  switch (body) {
    case BODY_WGMMA:
      if (!bf16q || !((kv_dtype == 1 && ks == nullptr) || (codes && hd % 16 == 0)))
        return cudaErrorInvalidValue;
      switch (kv_dtype) {
        case 1: return launch_wgmma_hd<__nv_bfloat16>(hd, q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, sqb, sqt, skb, sks, scale, stream);
        case 2: return launch_wgmma_hd<__nv_fp8_e4m3>(hd, q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, sqb, sqt, skb, sks, scale, stream);
        default: return launch_wgmma_hd<int8_t>(hd, q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, sqb, sqt, skb, sks, scale, stream);
      }
    case BODY_MMA_SYNC:
      if (!bf16q) return cudaErrorInvalidValue;
      switch (kv_dtype) {
        case 0: return launch_mma_hd<float>(hd, q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, sqb, sqt, skb, sks, scale, stream);
        case 1: return launch_mma_hd<__nv_bfloat16>(hd, q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, sqb, sqt, skb, sks, scale, stream);
        default: return cudaErrorInvalidValue;
      }
    case BODY_TF32:
      switch (kv_dtype) {
        case 0: return launch_tf32<TQ, float>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, hd, sqb, sqt, skb, sks, scale, stream);
        case 1: return launch_tf32<TQ, __nv_bfloat16>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, hd, sqb, sqt, skb, sks, scale, stream);
        case 2: return launch_tf32<TQ, __nv_fp8_e4m3>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, hd, sqb, sqt, skb, sks, scale, stream);
        case 3: return launch_tf32<TQ, int8_t>(q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, hd, sqb, sqt, skb, sks, scale, stream);
        default: return cudaErrorInvalidValue;
      }
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The head layouts this kernel takes (repro_torch/kernels/shapes.py holds
// the same rule): hd a multiple of 8 up to 256, and a whole number of
// query heads for each KV head.
static bool supported(int hd, int H, int KV) {
  return hd % 8 == 0 && hd >= 8 && hd <= 256 && KV > 0 && H > 0 && H % KV == 0;
}

// dtype codes: 0 float32, 1 bfloat16, 2 float8_e4m3fn, 3 int8.
// q (B,Tq,H,hd) with strides (sqb, sqt, hd, 1); k/v (B,S,KV,hd) with
// strides (skb, sks, hd, 1), in elements, so q/k/v may be row views of
// larger buffers; offsets (B,) int32; ks/vs (B,S) float32 or null; out
// (B,Tq,H,hd) contiguous.  Every body needs q, k, v and out 16-byte
// aligned and row strides that are multiples of 16 bytes.  body: 0
// 3xTF32, 1 mma.sync, 2 TMA + wgmma.
extern "C" int chunked_prefill_attention(const void* q, const void* k, const void* v,
                                         const void* offsets, const void* ks,
                                         const void* vs, void* out, int B, int Tq,
                                         int S, int H, int KV, int hd, long long sqb,
                                         long long sqt, long long skb, long long sks,
                                         int q_dtype, int kv_dtype, float scale,
                                         int body, void* stream) {
  if (!supported(hd, H, KV) || B <= 0 || Tq <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (q_dtype) {
    case 0: err = launch_kv<float>(body, kv_dtype, q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, hd, sqb, sqt, skb, sks, scale, s); break;
    case 1: err = launch_kv<__nv_bfloat16>(body, kv_dtype, q, k, v, offsets, ks, vs, out, B, Tq, S, H, KV, hd, sqb, sqt, skb, sks, scale, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// The packed-row body: a paged engine's packed step's query rows q (N,
// H, hd) bf16, row stride sq elements, over unscaled bf16 pools (n_pages,
// page, KV, hd) through the block tables (B, n_pp) int32; slots (4, B)
// int32: each slot's pos_offset, n_valid, active and last row.  out (N,
// H, hd) bf16 contiguous, every row written (a row of no slot as zeros);
// part_o (B * nsplit * KV * 128 * hd) and part_ml (B * nsplit * KV * 128
// * 2) f32 scratch.  Instances at widths 64, 128 and 192 (hd <= 192);
// wider rows are refused with cudaErrorInvalidValue, as are pages that
// are no multiple of 8 or do not divide the key tile (128 keys, 64 at
// width 192) and more than 128 query heads a KV head.
extern "C" int packed_chunked_prefill_attention(const void* q, const void* k_pages,
                                                const void* v_pages, const void* slots,
                                                const void* tables, void* out, void* part_o,
                                                void* part_ml, int N, int H, int KV, int hd,
                                                long long sq, int B, int n_pp, int n_pages,
                                                int page, int nsplit, float scale,
                                                void* stream) {
  if (!supported(hd, H, KV) || hd > 192 || N <= 0 || B <= 0 || n_pp <= 0 || n_pages <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (hd <= 64)
    err = launch_packed<wg::Tile<64, 128, 2>>(q, k_pages, v_pages, slots, tables, out, part_o, part_ml, N, H, KV, hd, sq, B, n_pp, n_pages, page, nsplit, scale, s);
  else if (hd <= 128)
    err = launch_packed<wg::Tile<128, 128>>(q, k_pages, v_pages, slots, tables, out, part_o, part_ml, N, H, KV, hd, sq, B, n_pp, n_pages, page, nsplit, scale, s);
  else
    err = launch_packed<wg::Tile<192, 64>>(q, k_pages, v_pages, slots, tables, out, part_o, part_ml, N, H, KV, hd, sq, B, n_pp, n_pages, page, nsplit, scale, s);
  return (int)err;
}
