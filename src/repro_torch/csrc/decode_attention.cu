// Dense-slab flash-decode for Hopper (sm_90a): the R-Part attention of one
// decode step over a per-row KV slab, with bf16/fp32 or int8 storage, and
// the same int8 kernel reading a block-table page pool in place.  One
// template, three C entry points:
//
// * repro_decode_attention (kernel 2) replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention.py:39 (_kernel, wrapped by
//   decode_attention): K/V in the query's dtype.
// * repro_decode_attention_int8 (kernel 3) replaces
//   src/repro/kernels/quant_kv.py:44 (_kernel, wrapped by
//   decode_attention_int8): int8 K/V with one fp32 scale per (token,
//   kv-head), dequantized exactly (never rounded below the products'
//   precision).  It alone also takes Dh 256 (recurrentgemma's windowed
//   MQA layers, G 10, in ring order); every other entry takes Dh 64 and
//   128.
// * repro_paged_decode_attention_int8 computes the function of
//   src/repro/kernels/ops.py:78 (paged_decode_attention_int8: gather the
//   int8 pages into a slab, then kernel 3) without the gather: kernel 3's
//   template reads int8 pools pk_q/pv_q [P,page,Hkv,Dh] and fp32 scales
//   pk_s/pv_s [P,page,Hkv] through tables [B,MP] (int32, -1 unmapped), slot
//   j of table entry i being position i*page+j, as
//   csrc/paged_attention.cu does.
// * repro_paged_verify_attention_int8 is the multi-token instance of that
//   paged entry: it computes src/repro/kernels/ops.py:152
//   (paged_verify_attention_int8: gather the int8 pages into a slab, then
//   the multi-token int8 reference) for T candidate tokens per row, q
//   [B,T,Hq,Dh], query t of row b at position lengths[b] + t, as kernel 4
//   (csrc/paged_attention.cu) is the multi-token instance of kernel 1.
//
// One query token per row, q [B,Hq,Dh] grouped into [B,Hkv,G,Dh].  The slab
// k/v [B,S,Hkv,Dh] holds absolute positions in pos [B,S] (-1 = empty;
// windowed caches are stored in ring order, so validity comes from pos and
// never from the slot index).  A slot is valid when pos >= 0, pos <=
// lengths[b] and, with window > 0, inside the window or the sink.  Scale
// 1/sqrt(Dh), the optional tanh softcap, fp32 online softmax from -1e30; a
// row with no valid slot writes exactly 0; the output has q's dtype.  The
// int8 scales fold into the products: s = k_s * (q . k_q) and acc += (p *
// v_s) * v_q, equal to dequantizing first up to fp32 rounding.
//
// What bounds it: HBM bytes.  Each valid K/V row is read once per (row,
// kv-head): 2*Hkv*Dh*elt bytes per token (bf16 512 B per kv-head pair at Dh
// 128; int8 264 B with its scales), against 4*Hq*Dh flops per token, far
// below the card's flop/byte balance.  The first version (one CTA per (row,
// kv-head, <= 8 or 4 query heads), no split, plain loads) was bound by
// latency at the serve's shape (2 rows x 8 kv-heads = 16 CTAs on 132 SMs)
// and by issue at 64 x 4096 (kernel 2 1.8 TB/s; kernel 3 0.8 TB/s: fp32
// FMAs on dequantized values, 228 registers, 2 CTAs per SM).
//
// Design (second version; the split, ring and merge follow
// csrc/paged_attention.cu):
// * Split-K over the slots (flash-decoding).  The grid is (splits, Hkv, B x
//   head groups); a CTA owns slots [split*sps, (split+1)*sps) of one row and
//   kv-head for up to 8 query heads (16 on the 16-row engine).  The plan
//   comes from the wrapper
//   (kernels/decode_attention.py::slab_plan: paged_attention.split_plan
//   with slots counted as pages of one; shapes only, no host sync): one
//   split when the grid fills the SMs, else splits of >= 64 slots for about
//   2 CTAs per SM (the dense-int8 serve's per-worker call, 2 rows x 8
//   kv-heads over 1024 slots: 16 splits of 64).  The paged entry takes
//   kernel 1's plan over the table.  With one split the CTA writes the
//   output; else fp32 (m, l, acc[Dh]) partials go to the wrapper's scratch
//   and dense_merge (launched by the same C call as a programmatic
//   dependent launch) combines them in split order: no atomics, bitwise
//   reproducible; an empty partial (m = -1e30, l = 0) weighs 0.
// * Validity before any K/V byte moves.  A slab CTA reads its split's pos
//   entries once (plain 4-byte loads: a worker's row slice of pos is not
//   16-byte aligned) and stages one validity bit per slot in shared memory
//   (a warp ballot per 32 slots: 512 B for 4096 slots, where the ints
//   would take 16 KB and cost a CTA per SM); a CTA with no valid slot
//   writes an empty partial and exits (the unused tail of a slab, the gap
//   between sink and window of a ring).  A paged CTA stages its split's table
//   entries and walks only the sink part and the window part of its split
//   up to lengths[b]; unmapped (-1) and out-of-pool entries are never read.
// * A cp.async ring of K/V tiles in shared memory (tc_decode.cuh's Ring:
//   3 stages of 32 rows on the CUDA cores, 2 in fp32; 3 stages of 64 rows
//   on kernel 3's 8-row tensor-core path, 4 CTAs per SM; 2 stages on the
//   16-row one at Dh 256; kernel 2 with a bf16 q 64 rows, 2 stages at Dh
//   128 and 3 at Dh 64): 16-byte copies of the valid rows only, zero-fill
//   (src-size 0) for the others, rows padded by 16 B (or, on the
//   tensor-core paths at Dh 128 and 256 and kernel 2's, chunks
//   XOR-swizzled by row) so the 8 rows a quarter warp reads fall on
//   distinct banks; the int8 scales come with their tile as 4-byte copies
//   (they are not 16-byte aligned), and each row's validity flag is
//   written beside them.
// * Scores per tile, each warp owning its token rows with its own online
//   softmax, the 4 warps merged through shared memory at the end.
//   - Kernel 2 with a bf16 q at G 2 and up: tensor cores (tc_decode.cuh's
//     Bf16MmaEngine, shared with kernel 1): 64-row tiles, 16 rows per
//     warp, the token rows as the M of mma.sync.m16n8k16 and the query
//     heads as its N, K by ldmatrix and V by ldmatrix.trans, P^T as bf16
//     hi + lo (that header has the layout).
//   - Kernel 2 at G 1 and every fp32-q instantiation: CUDA cores
//     (FmaEngine, as kernel 1's in fp32): 32-row tiles, 8 rows per warp,
//     4 lanes per row.
//   - Kernel 3 with bf16 q: tensor cores (MmaEngine), 64-row tiles, 16 rows
//     per warp.  int8 values convert exactly to bf16 (|x| <= 127), so QK^T
//     on mma.sync m16n8k16 (bf16 in, fp32 accumulate) with k_s applied in
//     fp32 after the product equals fp32 dequantization up to summation
//     order.  The token rows are the M of the product and the query heads
//     its N: the serve's G = 4 heads fill half an n8 tile, where as M they
//     would fill a quarter of m16.  Fragments are loaded by hand from the
//     int8 tiles (ldmatrix moves 16-bit elements only), with the head
//     dimension permuted so each lane reads 16-byte pieces (a dot product
//     sums in any order), and converted with the 2^23 float trick (prmt +
//     fsub, no I2F).  The score fragment (tokens x heads) is transposed to
//     the B operand of PV with movmatrix; p * v_s (fp32) is split into bf16
//     hi + lo, and O^T = V^T P^T runs as two m16n8k16 products per 16
//     dimensions, so PV keeps about 16 bits of p.
// * The multi-token entry (MULTI) folds the T queries of a row into the
//   query rows of a kv-head: row r = t*G + head, T*G rows per (row,
//   kv-head), cut into CTAs of up to 16 rows (bf16 q, Mma16Engine: the N
//   of the tensor-core products is two n8 tiles, so Qwen3-8B's verify at
//   k = 3, T*G = 16, reads each page once per kv-head; 8 rows or fewer on
//   MmaEngine) or 8 (fp32 q, CUDA cores).
//   Each tile row carries its position in place of its validity flag, and
//   query row r sees it when it is mapped, <= lengths[b] + r/G and inside
//   the window or the sink; the split walks positions up to lengths[b] +
//   T - 1, the window anchored at lengths[b] (the first query's).  The
//   split plan (shapes only) and the merge kernel are the decode entry's,
//   over B*T*Hq output rows.  T = 1 launches the decode instantiation with
//   the decode plan, so it is bitwise the decode entry.
//
// * Dh 256 (the slab int8 entry only) is the same template at DH = 256.
//
// Third version of kernel 3's 16-row instances (Mma16Engine): the slab
// entry at Dh 256 with a bf16 q (src/repro/kernels/quant_kv.py:44 at
// recurrentgemma-2b's windowed MQA heads, G 10) and the multi-token entry
// at T*G > 8 (src/repro/kernels/ops.py:152, Qwen3-8B's verify: T 4, G 4).
// What bounds them: HBM bytes, as above (Dh 256: 520 B per token with its
// scales).  What held them back: G 10 ran as two CTAs of 8 and 2 rows, each
// streaming and converting the whole slab (twice the bytes); the Dh 256
// rows were padded, not swizzled; and the 8- and 16-row engine kept q's
// fragments and the whole O^T accumulator in every warp (KS x NT x 2 +
// Dh/16 x NT x 4 registers: 249 at Dh 256), so with a 106 KB ring 2 CTAs
// fitted an SM.  Measured on an H100 once that was cured, the engine was
// bound by its own instructions and latency more than by the bytes
// (tools/k3_variants.py on an H100: at 64 x 2048 its tile loop without its
// K/V copies keeps 85% of its time).  The design:
// * One CTA for up to 16 query rows at any Dh: G 10 reads and converts
//   each K/V byte and scale once (grid.z = B, quant_kv.slab_row_groups;
//   its plan keeps Dh 256 to one wave of 2 CTAs per SM).
// * Per-thread state that does not grow with Dh x rows: q in shared memory
//   (ldmatrix at each k-step), one running max per query row shared by the
//   4 warps (the tile's max through shared memory), P' through shared
//   memory, and PV cut by output dims, so a warp holds Dh/64 x 2 x 4
//   accumulators (32 at Dh 256) and no warp merge remains.
// * fp16 products: int8 -> fp16 is exact in 5 instructions per 4 values
//   (int8 -> bf16 took 11), with powers of two keeping q and P' in fp16's
//   range (below); q is staged by read-only loads issued all at once.
// * The swizzle spans 16-chunk rows (chunk c of row r at (c & 8) | ((c ^ r)
//   & 7)), so Dh 256 drops the padding; 2 stages of 64 rows at Dh 256 (66
//   KB of ring + 9 KB of q and maxima: 3 CTAs per SM), 3 at Dh 128 (4 per
//   SM); the loader copies whole 64- or 128-byte pieces of rows per warp
//   instruction.  P' reuses the K half of the tile's stage.
//
// Fourth version (kernel 2 with a bf16 q, on the tensor cores): on the
// CUDA cores its instructions per byte grew with G, so it was bound by
// issue, not bytes: 0.343 ms at vision's cross shape (G 8, 64 rows x 1600
// slots) against a bytes bound of 0.126 and SDPA's 0.139, 0.435 at the
// serve's G 4 and 64 x 4096 against 0.321.  It now runs kernel 1's
// tensor-core engine (tc_decode.cuh) from G 2 up; at G 1 (whisper's
// cross-attention, MHA) FmaEngine stays: there the engine took 4.5-6.5%
// longer at 1 and 2 rows, though 14% less at 64 rows (tools/
// k12_variants.py on an H100, PERF.md section 6).
//
// Left for later: TMA bulk copies with mbarriers in place of cp.async,
// persistent CTAs walking several (row, kv-head, split) items, a
// single-launch merge, wgmma (m64n8k16 would fit kernel 2's 64-row tile
// by G <= 8 heads; untried), a ring depth chosen per launch for kernel 2
// (3 stages at Dh 128 took 4-6% off 64-row grids and cost split grids a
// second wave), the fp16 conversions
// for the 8-row decode instances at Dh 64 / 128 (they stay on MmaEngine:
// on the 16-row engine the paged decode at 64 x 4096 took 7.7% longer,
// tools/k3_variants.py on an H100), fewer barriers per tile in the 16-row
// engine (3: the tile's max, P', the ring), and a 256-byte L2 prefetch
// hint on the K/V copies (measured there: 10-11% off the 8-row decodes at
// 64 x 4096, outputs bitwise the same, the 16-row instances unmoved).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "tc_decode.cuh"

namespace {

using namespace tcd;

constexpr int kMaxSplitIdx = 8192;      // pos / table entries a CTA stages

struct Params {
  const void* q;
  const void* k;            // slab [B,S,Hkv,Dh] or pool [P,page,Hkv,Dh]
  const void* v;
  const float* k_s;         // int8: [B,S,Hkv] or [P,page,Hkv]; else null
  const float* v_s;
  const int* pos;           // slab only
  const int* tables;        // paged only
  const int* lengths;
  void* out;
  float* part;              // [S][rows] m, [S][rows] l, [S][rows][Dh] acc
  int s_len;                // slab slots S
  int t_count;              // query tokens per row (> 1: multi-token entry)
  int hq, hkv, g;
  int page, page_shift, mp, num_pages;   // paged only
  int window, sink;
  int per_split;            // slots (slab) or table pages (paged) per split
  int num_splits, rows_total;
  float softcap, scale;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// byte i of w (an int8) as an exact float: 2^23 + (x + 128) - (2^23 + 128)
__device__ __forceinline__ float i8_at(uint32_t biased, int sel) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, sel))
         - 8388736.f;
}
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* o) {
  const uint32_t u = w ^ 0x80808080u;
  o[0] = i8_at(u, 0x7650);
  o[1] = i8_at(u, 0x7651);
  o[2] = i8_at(u, 0x7652);
  o[3] = i8_at(u, 0x7653);
}

// N consecutive elements of T in shared memory as floats
template <typename T, int N> struct Vec;
template <> struct Vec<__nv_bfloat16, 8> {
  __device__ static void load(const __nv_bfloat16* p, float* o) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};
template <> struct Vec<__nv_bfloat16, 4> {
  __device__ static void load(const __nv_bfloat16* p, float* o) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 c = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    o[0] = a.x; o[1] = a.y; o[2] = c.x; o[3] = c.y;
  }
};
template <> struct Vec<__nv_bfloat16, 2> {
  __device__ static void load(const __nv_bfloat16* p, float* o) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = a.x; o[1] = a.y;
  }
};
template <> struct Vec<float, 4> {
  __device__ static void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <> struct Vec<float, 2> {
  __device__ static void load(const float* p, float* o) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x; o[1] = v.y;
  }
};
template <> struct Vec<int8_t, 16> {
  __device__ static void load(const int8_t* p, float* o) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    i8x4_to_f32(v.x, o);
    i8x4_to_f32(v.y, o + 4);
    i8x4_to_f32(v.z, o + 8);
    i8x4_to_f32(v.w, o + 12);
  }
};
template <> struct Vec<int8_t, 8> {
  __device__ static void load(const int8_t* p, float* o) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    i8x4_to_f32(v.x, o);
    i8x4_to_f32(v.y, o + 4);
  }
};
template <> struct Vec<int8_t, 4> {
  __device__ static void load(const int8_t* p, float* o) {
    i8x4_to_f32(*reinterpret_cast<const uint32_t*>(p), o);
  }
};
template <> struct Vec<int8_t, 2> {
  __device__ static void load(const int8_t* p, float* o) {
    float f[4];
    i8x4_to_f32(*reinterpret_cast<const uint16_t*>(p), f);
    o[0] = f[0]; o[1] = f[1];
  }
};

// whether a query at qpos sees the key at pos (-1: empty or unmapped)
__device__ __forceinline__ bool sees(const Params& p, int pos, int qpos) {
  return pos >= 0 && pos <= qpos
      && (p.window <= 0 || pos > qpos - p.window || pos < p.sink);
}

// ---------------------------------------------------------------------------
// CUDA-core engine: every fp32-q instantiation (kernel 1's
// FmaEngine on a validity flag per row and, for int8, the tile's scales).
// Warp w owns token rows 8w..8w+7 of every 32-row tile; lane 8c + t scores
// row t against the 16-byte chunks c, c+4, ... for every query row (q
// pre-scaled in fp32 in shared memory); max and sum over the warp's 8 rows
// take 3 + 3 shuffles per query row and tile.  p (times v_s for int8) goes
// to the warp's shared buffer; in PV lane i owns Dh columns [i*DH/32,
// (i+1)*DH/32) of every query row.  With MULTI each tile row's flag is its
// position and each query row masks it at its own position (``qp``).
// ---------------------------------------------------------------------------
template <typename TQ, typename TKV, int DH, int GT, bool MULTI>
struct FmaEngine {
  using R = Ring<TKV, DH, 32, sizeof(TKV) == 4 ? 2 : 3>;
  static constexpr int EPC = 16 / (int)sizeof(TKV);  // elements per chunk
  static constexpr int CPQ = R::kChunks / 4;         // chunks per lane
  static constexpr int CPL = DH / 32;                // PV columns per lane
  static constexpr int kMinBlocks = sizeof(TKV) == 4 || DH > 128 ? 2 : 3;
  static constexpr int kLoadTPR = kThreads / 32;   // a pass: the tile
  static constexpr bool kMaxShared = false;
  struct Shared {
    float q[GT][DH];              // pre-scaled q rows
    float pw[kWarps][8][GT];      // each warp's p (x v_s) of this tile
    float m[kWarps][GT], l[kWarps][GT];
  };

  Shared& sh;
  const int warp, lane, c, t;
  float m[GT], l[GT];
  int qp[GT];               // MULTI: each query row's position (-1: dead)
  float acc[GT][CPL];

  __device__ FmaEngine(Shared& s, const Params& p, int b, int h, int r0,
                       int nr)
      : sh(s), warp(threadIdx.x / 32), lane(threadIdx.x % 32),
        c(lane / 8), t(lane % 8) {
    const TQ* q = static_cast<const TQ*>(p.q);
    for (int idx = threadIdx.x; idx < GT * DH; idx += kThreads) {
      const int j = idx / DH, d = idx % DH;
      sh.q[j][d] = j < nr
          ? to_float(q[(size_t)out_row(p, b, h, r0 + j) * DH + d]) * p.scale
          : 0.f;
    }
#pragma unroll
    for (int j = 0; j < GT; ++j) {
      m[j] = kNegInf;
      l[j] = 0.f;
#pragma unroll
      for (int e = 0; e < CPL; ++e) acc[j][e] = 0.f;
    }
  }

  // each query row's position, once the row's length is known
  __device__ void set_base(const Params& p, int base, int r0, int nr) {
#pragma unroll
    for (int j = 0; j < GT; ++j) qp[j] = j < nr ? base + (r0 + j) / p.g : -1;
  }

  __device__ void tile(const Params& p, unsigned char* ring, int stage) {
    const int tok = 8 * warp + t;
    const int flag = R::ok(ring, stage)[tok];
    const bool ok = MULTI ? flag >= 0 : flag != 0;
    float ks = 1.f, vs = 1.f;
    if constexpr (R::kInt8) {
      ks = R::scales(ring, stage, 0)[tok];
      vs = R::scales(ring, stage, 1)[tok];
    }
    const unsigned char* krow = R::row(ring, stage, 0, tok);
    float s[GT];
#pragma unroll
    for (int j = 0; j < GT; ++j) s[j] = 0.f;
#pragma unroll
    for (int i = 0; i < CPQ; ++i) {
      const int ch = c + 4 * i;
      float kf[EPC];
      Vec<TKV, EPC>::load(reinterpret_cast<const TKV*>(krow + ch * 16), kf);
#pragma unroll
      for (int j = 0; j < GT; ++j) {
        const float4* qv = reinterpret_cast<const float4*>(&sh.q[j][ch * EPC]);
#pragma unroll
        for (int e = 0; e < EPC / 4; ++e) {
          const float4 qq = qv[e];
          s[j] += qq.x * kf[4 * e] + qq.y * kf[4 * e + 1]
                + qq.z * kf[4 * e + 2] + qq.w * kf[4 * e + 3];
        }
      }
    }
    bool moved = false;
#pragma unroll
    for (int j = 0; j < GT; ++j) {
      // lanes t, t+8, t+16, t+24 hold the 4 parts of token t's score
      float sc = s[j] + __shfl_xor_sync(0xffffffffu, s[j], 8);
      sc += __shfl_xor_sync(0xffffffffu, sc, 16);
      sc *= ks;
      if (p.softcap > 0.f) sc = p.softcap * tanhf(sc / p.softcap);
      // a decode query's limit and window are the span's own
      const bool ok_j = MULTI ? ok && sees(p, flag, qp[j]) : ok;
      sc = ok_j ? sc : kNegInf;
      float mt = fmaxf(sc, __shfl_xor_sync(0xffffffffu, sc, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
      const float m_new = fmaxf(m[j], mt);
      const float pr = ok_j ? expf(sc - m_new) : 0.f;
      float lt = pr + __shfl_xor_sync(0xffffffffu, pr, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      lt += __shfl_xor_sync(0xffffffffu, lt, 4);
      s[j] = expf(m[j] - m_new);          // now the row's correction
      moved |= s[j] != 1.f;
      l[j] = l[j] * s[j] + lt;
      m[j] = m_new;
      if (c == 0) sh.pw[warp][t][j] = pr * vs;
    }
    __syncwarp();
    // m, l and so the corrections are the same in every lane: the branch
    // is warp-uniform (x 1.0 is exact, so skipping it changes no bit)
    if (moved) {
#pragma unroll
      for (int j = 0; j < GT; ++j)
#pragma unroll
        for (int e = 0; e < CPL; ++e) acc[j][e] *= s[j];
    }
    const unsigned char* vrow = R::row(ring, stage, 1, 8 * warp);
#pragma unroll
    for (int tk = 0; tk < 8; ++tk) {
      float v[CPL];
      Vec<TKV, CPL>::load(reinterpret_cast<const TKV*>(vrow + tk * R::kStride)
                              + CPL * lane, v);
      float pj[GT];
      if constexpr (GT % 4 == 0) {
#pragma unroll
        for (int j = 0; j < GT; j += 4) {
          const float4 pp = *reinterpret_cast<const float4*>(
              &sh.pw[warp][tk][j]);
          pj[j] = pp.x; pj[j + 1] = pp.y; pj[j + 2] = pp.z; pj[j + 3] = pp.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < GT; ++j) pj[j] = sh.pw[warp][tk][j];
      }
#pragma unroll
      for (int j = 0; j < GT; ++j)
#pragma unroll
        for (int e = 0; e < CPL; ++e) acc[j][e] += pj[j] * v[e];
    }
  }

  // merge the 4 warps' states (the ring is free: it holds their acc now)
  __device__ void finish(const Params& p, unsigned char* ring, int split,
                         int b, int h, int r0, int nr) {
    float* s_acc = reinterpret_cast<float*>(ring);    // [warp][row][DH]
    static_assert(kWarps * GT * DH * 4 <= R::kRowsBytes, "s_acc in the ring");
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < GT; ++j) {
        sh.m[warp][j] = m[j];
        sh.l[warp][j] = l[j];
      }
    }
#pragma unroll
    for (int j = 0; j < GT; ++j)
#pragma unroll
      for (int e = 0; e < CPL; ++e)
        s_acc[(warp * GT + j) * DH + CPL * lane + e] = acc[j][e];
    __syncthreads();
    merge_warps<TQ, DH, GT>(p, sh.m, sh.l, s_acc, split, b, h, r0, nr);
  }
};

// ---------------------------------------------------------------------------
// tensor-core engine: int8 K/V with bf16 q (kernel 3 on the serve path).
// Warp w owns token rows 16w..16w+15 of every 64-row tile; lane = 4*gi + ti.
//   QK^T: S^T[tok][head] = K[tok][:] . q[head][:], mma m16n8k16 with the
//   16 token rows as M, the 8 query heads as N and Dh in KS = Dh/16 steps.
//   Logical k 2ti+{0,1} (A regs 0,1) and 2ti+8+{0,1} (regs 2,3) of step kk
//   are physical dims ti*Dh/4 + 4kk + {0,1,2,3}: a lane reads Dh/4
//   contiguous bytes of rows gi and gi+8 (one or two 16-byte loads).
//   C: c[e] = (tok gi, head 2ti+e), c[2+e] = (tok gi+8, head 2ti+e).
//   PV: O^T[dim][head] = V^T P^T, M = 16 dims, K = the 16 tokens, N = heads.
//   The M row gi of dim tile mt is physical dim gi*Dh/8 + 2mt, row gi+8 the
//   next one, so a lane reads Dh/8 contiguous bytes of tokens 2ti, 2ti+1,
//   2ti+8, 2ti+9.  B = P'^T comes from the score fragment by movmatrix.trans
//   of its two 8x8 halves (tokens 0-7 and 8-15), in bf16 hi and lo terms.
// ---------------------------------------------------------------------------
template <int DH, bool MULTI>
struct MmaEngine {
  using R = Ring<int8_t, DH, 64, 3, DH == 128>;
  static constexpr int NT = 1;            // one n8 tile (16 rows: Mma16Engine)
  static constexpr int GT = 8 * NT;       // query rows
  static constexpr int KS = DH / 16;      // k-steps of QK^T
  static constexpr int MT = DH / 16;      // dim tiles of PV
  static constexpr int KB = DH / 4;       // K bytes per lane and row
  static constexpr int VB = DH / 8;       // V bytes per lane and token
  static constexpr int kMinBlocks = 4;
  static constexpr int kLoadTPR = kThreads / 64;   // a pass: the tile
  static constexpr bool kMaxShared = false;
  struct Shared {
    float m[kWarps][GT], l[kWarps][GT];
  };

  Shared& sh;
  const int warp, lane, gi, ti;
  uint32_t qb[KS][NT][2];  // B fragments of the query rows (unscaled)
  float acc[MT][NT][4];    // O^T: dims (gi, gi+8 of tile mt) x rows 8nt+2ti+e
  float m[NT][2], l[NT][2];    // rows 8nt + 2ti + e
  int qp[NT][2];           // MULTI: those rows' positions (-1: dead row)

  __device__ MmaEngine(Shared& s, const Params& p, int b, int h, int r0,
                       int nr)
      : sh(s), warp(threadIdx.x / 32), lane(threadIdx.x % 32),
        gi(lane / 4), ti(lane % 4) {
    // q rows need no alignment beyond their element (a worker's slice)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int j = 8 * nt + gi;
      const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q)
          + (size_t)out_row(p, b, h, r0 + min(j, nr - 1)) * DH + ti * KB;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t w[2] = {0u, 0u};
        if (j < nr) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            __nv_bfloat162 v;
            v.x = q[4 * kk + 2 * i];
            v.y = q[4 * kk + 2 * i + 1];
            w[i] = *reinterpret_cast<const uint32_t*>(&v);
          }
        }
        qb[kk][nt][0] = w[0];
        qb[kk][nt][1] = w[1];
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        m[nt][e] = kNegInf;
        l[nt][e] = 0.f;
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3]
            = 0.f;
    }
  }

  // each query row's position, once the row's length is known
  __device__ void set_base(const Params& p, int base, int r0, int nr) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 8 * nt + 2 * ti + e;
        qp[nt][e] = j < nr ? base + (r0 + j) / p.g : -1;
      }
  }

  // N bytes of row r from byte byte0 (N/16 chunks, or 8 bytes) as words
  template <int N>
  __device__ static void words(unsigned char* ring, int stage, int kv, int r,
                               int byte0, uint32_t* w) {
    if constexpr (N >= 16) {
#pragma unroll
      for (int j = 0; j < N / 16; ++j) {
        const uint4 a = *reinterpret_cast<const uint4*>(
            R::at(ring, stage, kv, r, byte0 + 16 * j));
        w[4 * j] = a.x; w[4 * j + 1] = a.y;
        w[4 * j + 2] = a.z; w[4 * j + 3] = a.w;
      }
    } else {
      static_assert(N == 8, "8 bytes or whole chunks");
      const uint2 a = *reinterpret_cast<const uint2*>(
          R::at(ring, stage, kv, r, byte0));
      w[0] = a.x; w[1] = a.y;
    }
  }

  __device__ void tile(const Params& p, unsigned char* ring, int stage) {
    const int tok0 = 16 * warp;
    // ---- S^T = K q^T on the tensor cores (one A fragment, NT products)
    float c[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3]
        = 0.f;
    {
      uint32_t w0[KS], w8[KS];
      words<KB>(ring, stage, 0, tok0 + gi, ti * KB, w0);
      words<KB>(ring, stage, 0, tok0 + gi + 8, ti * KB, w8);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        float f0[4], f8[4];
        i8x4_to_f32(w0[kk], f0);
        i8x4_to_f32(w8[kk], f8);
        const uint32_t a[4] = {pack_bf16(f0[0], f0[1]),
                               pack_bf16(f8[0], f8[1]),
                               pack_bf16(f0[2], f0[3]),
                               pack_bf16(f8[2], f8[3])};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_16816(c[nt], a, qb[kk][nt][0], qb[kk][nt][1]);
      }
    }
    // ---- online softmax per query-row column over the warp's 16 rows
    const int* okf = R::ok(ring, stage);
    const float* ksc = R::scales(ring, stage, 0);
    const float* vsc = R::scales(ring, stage, 1);
    const int flag[2] = {okf[tok0 + gi], okf[tok0 + gi + 8]};
    const bool ok[2] = {MULTI ? flag[0] >= 0 : flag[0] != 0,
                        MULTI ? flag[1] >= 0 : flag[1] != 0};
    const float kscale[2] = {ksc[tok0 + gi] * p.scale,
                             ksc[tok0 + gi + 8] * p.scale};
    float pr[NT][4], corr[NT][2];
    bool moved = false;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s[2];
        bool v[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          // a decode query's limit and window are the span's own
          v[hh] = MULTI ? ok[hh] && sees(p, flag[hh], qp[nt][e]) : ok[hh];
          float sc = c[nt][2 * hh + e] * kscale[hh];
          if (p.softcap > 0.f) sc = p.softcap * tanhf(sc / p.softcap);
          s[hh] = v[hh] ? sc : kNegInf;
        }
        float mt = fmaxf(s[0], s[1]);
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 8));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 16));
        const float m_new = fmaxf(m[nt][e], mt);
        pr[nt][e] = v[0] ? expf(s[0] - m_new) : 0.f;
        pr[nt][2 + e] = v[1] ? expf(s[1] - m_new) : 0.f;
        float lt = pr[nt][e] + pr[nt][2 + e];
        lt += __shfl_xor_sync(0xffffffffu, lt, 4);
        lt += __shfl_xor_sync(0xffffffffu, lt, 8);
        lt += __shfl_xor_sync(0xffffffffu, lt, 16);
        corr[nt][e] = expf(m[nt][e] - m_new);
        moved |= corr[nt][e] != 1.f;
        l[nt][e] = l[nt][e] * corr[nt][e] + lt;
        m[nt][e] = m_new;
      }
    }
    // rescale only when some row's max moved (x 1.0 is exact)
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] *= corr[nt][e % 2];
        }
      }
    }
    // ---- P' = p * v_s as B of PV: bf16 hi + lo, transposed by movmatrix
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float vs = vsc[tok0 + gi + 8 * hh];
        const float x0 = pr[nt][2 * hh] * vs, x1 = pr[nt][2 * hh + 1] * vs;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(hi);
        bh[nt][hh] =
            movmatrix_trans(*reinterpret_cast<const uint32_t*>(&hi));
        bl[nt][hh] = movmatrix_trans(pack_bf16(x0 - hf.x, x1 - hf.y));
      }
    }
    // ---- O^T += V^T P'^T: tokens 2ti, 2ti+1, 2ti+8, 2ti+9 of the warp
    uint32_t vw[4][VB / 4];
    const int vt[4] = {2 * ti, 2 * ti + 1, 2 * ti + 8, 2 * ti + 9};
#pragma unroll
    for (int r = 0; r < 4; ++r)
      words<VB>(ring, stage, 1, tok0 + vt[r], gi * VB, vw[r]);
#pragma unroll
    for (int wi = 0; wi < VB / 4; ++wi) {
      float f[4][4];            // [token][byte]: dims 4wi .. 4wi+3
#pragma unroll
      for (int r = 0; r < 4; ++r) i8x4_to_f32(vw[r][wi], f[r]);
#pragma unroll
      for (int u = 0; u < 2; ++u) {          // dim tile mt = 2wi + u
        const uint32_t a[4] = {pack_bf16(f[0][2 * u], f[1][2 * u]),
                               pack_bf16(f[0][2 * u + 1], f[1][2 * u + 1]),
                               pack_bf16(f[2][2 * u], f[3][2 * u]),
                               pack_bf16(f[2][2 * u + 1], f[3][2 * u + 1])};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_16816(acc[2 * wi + u][nt], a, bh[nt][0], bh[nt][1]);
          mma_16816(acc[2 * wi + u][nt], a, bl[nt][0], bl[nt][1]);
        }
      }
    }
  }

  // merge the 4 warps' states (the ring is free: it holds their acc now)
  __device__ void finish(const Params& p, unsigned char* ring, int split,
                         int b, int h, int r0, int nr) {
    float* s_acc = reinterpret_cast<float*>(ring);    // [warp][row][DH]
    static_assert(kWarps * GT * DH * 4 <= R::kRowsBytes, "s_acc in the ring");
    if (gi == 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sh.m[warp][8 * nt + 2 * ti + e] = m[nt][e];
          sh.l[warp][8 * nt + 2 * ti + e] = l[nt][e];
        }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 8 * nt + 2 * ti + e % 2;
          const int dim = gi * VB + 2 * mt + e / 2;
          s_acc[(warp * GT + row) * DH + dim] = acc[mt][nt][e];
        }
      }
    }
    __syncthreads();
    merge_warps<__nv_bfloat16, DH, GT>(p, sh.m, sh.l, s_acc, split, b, h,
                                       r0, nr);
  }
};

// ---------------------------------------------------------------------------
// 16-row tensor-core engine: int8 K/V with bf16 q, 16 query rows per CTA
// (kernel 3's slab entry at Dh 256, G 10 in one CTA; its multi-token entry
// at T*G > 8).  Its registers do not grow with Dh x rows:
//   * q lives in shared memory, its head dimension stored in QK^T's
//     permuted order (MmaEngine's: logical k 2ti+{0,1} and 2ti+8+{0,1} of
//     step kk are physical dims ti*Dh/4 + 4kk + {0..3}) and its 16-byte
//     chunks swizzled by row, so one ldmatrix.x4 gives both n8 tiles' B
//     fragments of a k-step;
//   * QK^T as MmaEngine's: warp w scores tokens 16w..16w+15 of the 64-row
//     tile (M) against the 16 query rows (two n8 tiles), in two chains of
//     k-steps summed at the end;
//   * the tile's max per query row is taken over the 4 warps through
//     shared memory, so every warp keeps the same running m (and its own
//     share of l, summed over the warps at the end);
//   * P' = p * v_s goes to shared memory (as B of PV, [hi/lo][row][token],
//     chunks swizzled by row) in the K half of the tile's stage, which
//     QK^T no longer reads; after a barrier warp w computes O^T for the
//     output dims [w*Dh/4, (w+1)*Dh/4) over all 64 tokens: M = 16 dims (row
//     gi of dim tile mt is local dim gi*Dh/32 + 2mt, row gi+8 the next), K =
//     16 tokens (4 steps), N = the query rows.  A warp's accumulator is
//     Dh/64 x 2 x 4 floats, and no merge of the warps' accumulators remains.
// The products run in fp16 (fp32 accumulate): int8 converts to fp16 exactly
// in 2 PRMT + 2 HSUB2 per 4 values (0x6400 | (x + 128) is the half 1152 +
// x), where bf16 took 4 PRMT + 4 FADD + 2 F2F (the conversions were most
// of the engine's instructions).  fp16's range is
// kept with powers of two, which round nothing: each q row is scaled so its
// largest |q| lies in [2^14, 2^15) (exact: bf16's 8 significant bits fit
// fp16's 11 down to 2^-31 of that largest value; the score is scaled back
// in fp32), and P' by a running 2^T shared by the CTA, lowered (with acc)
// whenever a tile's largest v_s would take P' past 2^15 (P' <= v_s, as p <=
// 1); P' = hi + lo in fp16 keeps 22 bits of it, and acc / 2^T is the
// output's numerator.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_16816_f16(float* c, const uint32_t* a,
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// the two bytes of u that sel picks (each x + 128 of an int8 x) as the
// f16x2 {x0, x1}
__device__ __forceinline__ uint32_t u8x2_to_f16x2(uint32_t u, int sel) {
  const uint32_t h = __byte_perm(u, 0x64646464u, sel);   // 1152 + x
  uint32_t r;
  asm("sub.f16x2 %0, %1, %2;\n" : "=r"(r) : "r"(h), "r"(0x64806480u));
  return r;
}
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int DH, bool MULTI>
struct Mma16Engine {
  // 2 stages at Dh 256 (64 KB of K/V), 3 below: ring, q and the staged
  // index fit 3 CTAs per SM at Dh 256 and 4 at Dh 128
  using R = Ring<int8_t, DH, 64, (DH == 256 ? 2 : 3), (DH >= 128)>;
  static constexpr int GT = 16;          // query rows: two n8 tiles
  static constexpr int NT = 2;
  static constexpr int KB = DH / 4;      // K bytes per lane and row
  static constexpr int DW = DH / 4;      // output dims per warp
  static constexpr int MTW = DW / 16;    // its dim tiles
  static constexpr int VBW = DW / 8;     // V bytes per lane and token
  static constexpr int VW = VBW >= 4 ? VBW / 4 : 1;    // as words
  static constexpr int QROW = DH * 2;    // bytes of a q row
  static constexpr int PHALF = GT * 64 * 2;   // bytes of P' hi (or lo)
  static constexpr int kMinBlocks = DH == 256 ? 3 : 4;
  // threads per tile row in the loader: 8 at Dh 256 (a copy instruction
  // of a warp reads a 128-byte line of each of 4 rows), 4 below (64 bytes
  // of each of 8 rows); the fastest of 2, 4, 8 and 16 on an H100
  static constexpr int kLoadTPR = DH == 256 ? 8 : 4;
  // its 3 or 4 CTAs per SM need the largest shared-memory carveout
  static constexpr bool kMaxShared = true;
  static_assert(KB % 16 == 0 && 2 * PHALF <= 64 * R::kStride, "layout");
  struct Shared {
    __align__(16) unsigned char q[GT * QROW];   // fp16, scaled per row
    float mx[kWarps][GT];        // each warp's max of the tile per row
    float l[kWarps][GT];         // each warp's l, at the end
    float vmx[kWarps];           // each warp's largest v_s of the tile
    float rq[GT];                // 1 / each q row's scale (a power of 2)
  };

  Shared& sh;
  const int warp, lane, gi, ti;
  float acc[MTW][NT][4];   // O^T: dims (gi, gi+8 of tile mt) x rows 8nt+2ti+e
  float m[NT][2], l[NT][2];    // rows 8nt + 2ti + e (l: this warp's tokens)
  float ps;                // P''s running scale 2^T
  int qp[NT][2];           // MULTI: those rows' positions (-1: dead row)

  __device__ Mma16Engine(Shared& s, const Params& p, int b, int h, int r0,
                         int nr)
      : sh(s), warp(threadIdx.x / 32), lane(threadIdx.x % 32),
        gi(lane / 4), ti(lane % 4), ps(0x1p126f) {
    // warp w stages q rows w, w+4, ...: each lane loads its Dh/32 elements
    // of every such row at once (read-only loads: none waits on a shared
    // store), scales the row by a power of two from the warp's max |q| and
    // stores it as fp16.  q rows need no alignment beyond their element (a
    // worker's slice).
    const unsigned short* q = static_cast<const unsigned short*>(p.q);
    constexpr int RW = GT / kWarps, EL = DH / 32;
    float x[RW][EL];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int n = warp + kWarps * i;
      const unsigned short* qr =
          q + (size_t)out_row(p, b, h, r0 + min(n, nr - 1)) * DH + lane;
#pragma unroll
      for (int j = 0; j < EL; ++j)
        x[i][j] = n < nr ? __bfloat162float(
                               __ushort_as_bfloat16(__ldg(qr + 32 * j)))
                         : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int n = warp + kWarps * i;
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < EL; ++j) a = fmaxf(a, fabsf(x[i][j]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
      const float sc = a > 0.f && isfinite(a)
                           ? ldexpf(1.f, min(14 - ilogbf(a), 126)) : 1.f;
      if (lane == 0) sh.rq[n] = 1.f / sc;
#pragma unroll
      for (int j = 0; j < EL; ++j) {
        const int d = lane + 32 * j;
        const int t = d / KB, kk = (d % KB) / 4, f = d % 4;
        const int col = 16 * kk + (f < 2 ? 2 * t + f : 8 + 2 * t + f - 2);
        *reinterpret_cast<__half*>(
            sh.q + n * QROW + (swz(col >> 3, n) << 4) + (col & 7) * 2) =
            __float2half_rn(x[i][j] * sc);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        m[nt][e] = kNegInf;
        l[nt][e] = 0.f;
      }
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt)
        acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3]
            = 0.f;
    }
  }

  // each query row's position, once the row's length is known
  __device__ void set_base(const Params& p, int base, int r0, int nr) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 8 * nt + 2 * ti + e;
        qp[nt][e] = j < nr ? base + (r0 + j) / p.g : -1;
      }
  }

  // this lane's ldmatrix.x4 row of a [16 rows][chunks] 16-bit operand:
  // rows (lane/16)*8 + lane%8, chunk 2*step + (lane/8)%2 (B of n8 tiles 0
  // and 1, k 0-7 and 8-15); byte offset for rows of ``row_bytes``
  __device__ int frag_off(int step, int row_bytes) const {
    const int n = (lane >> 4) * 8 + (lane & 7);
    return n * row_bytes + (swz(2 * step + ((lane >> 3) & 1), n) << 4);
  }

  __device__ void tile(const Params& p, unsigned char* ring, int stage) {
    const int tok0 = 16 * warp;
    // ---- S^T = K q^T on the tensor cores, q's fragments from shared; two
    // chains of k-steps (even, odd) for the tensor pipe's latency
    float c[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        c[i][nt][0] = c[i][nt][1] = c[i][nt][2] = c[i][nt][3] = 0.f;
#pragma unroll
    for (int ch = 0; ch < KB / 16; ++ch) {
      const uint4 r0 = *reinterpret_cast<const uint4*>(
          R::at(ring, stage, 0, tok0 + gi, ti * KB + 16 * ch));
      const uint4 r8 = *reinterpret_cast<const uint4*>(
          R::at(ring, stage, 0, tok0 + gi + 8, ti * KB + 16 * ch));
      const uint32_t w0[4] = {r0.x, r0.y, r0.z, r0.w};
      const uint32_t w8[4] = {r8.x, r8.y, r8.z, r8.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t u0 = w0[u] ^ 0x80808080u, u8 = w8[u] ^ 0x80808080u;
        const uint32_t a[4] = {u8x2_to_f16x2(u0, 0x4140),
                               u8x2_to_f16x2(u8, 0x4140),
                               u8x2_to_f16x2(u0, 0x4342),
                               u8x2_to_f16x2(u8, 0x4342)};
        uint32_t qb[4];
        ldmatrix_x4(qb, sh.q + frag_off(4 * ch + u, QROW));
        mma_16816_f16(c[u & 1][0], a, qb[0], qb[1]);
        mma_16816_f16(c[u & 1][1], a, qb[2], qb[3]);
      }
    }
    // ---- the tile's max per query row and largest v_s, over the 4 warps
    const int* okf = R::ok(ring, stage);
    const float* ksc = R::scales(ring, stage, 0);
    const float* vsc = R::scales(ring, stage, 1);
    const int flag[2] = {okf[tok0 + gi], okf[tok0 + gi + 8]};
    const bool ok[2] = {MULTI ? flag[0] >= 0 : flag[0] != 0,
                        MULTI ? flag[1] >= 0 : flag[1] != 0};
    const float kscale[2] = {ksc[tok0 + gi] * p.scale,
                             ksc[tok0 + gi + 8] * p.scale};
    const float vs[2] = {vsc[tok0 + gi], vsc[tok0 + gi + 8]};
    float s[NT][4];
    bool v[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          // a decode query's limit and window are the span's own
          const int i = 2 * hh + e;
          v[nt][i] = MULTI ? ok[hh] && sees(p, flag[hh], qp[nt][e]) : ok[hh];
          float sc = (c[0][nt][i] + c[1][nt][i])
                     * sh.rq[8 * nt + 2 * ti + e] * kscale[hh];
          if (p.softcap > 0.f) sc = p.softcap * tanhf(sc / p.softcap);
          s[nt][i] = v[nt][i] ? sc : kNegInf;
        }
        float mt = fmaxf(s[nt][e], s[nt][2 + e]);
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 8));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 16));
        if (gi == 0) sh.mx[warp][8 * nt + 2 * ti + e] = mt;
      }
    }
    {
      float vm = fmaxf(vs[0], vs[1]);
      vm = fmaxf(vm, __shfl_xor_sync(0xffffffffu, vm, 4));
      vm = fmaxf(vm, __shfl_xor_sync(0xffffffffu, vm, 8));
      vm = fmaxf(vm, __shfl_xor_sync(0xffffffffu, vm, 16));
      if (lane == 0) sh.vmx[warp] = vm;
    }
    __syncthreads();       // every warp's maxima; every warp done with K
    // ---- P''s scale: lowered when the tile's v_s would pass 2^15
    float vmax = sh.vmx[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) vmax = fmaxf(vmax, sh.vmx[w]);
    const float ps_new =
        vmax > 0.f && isfinite(vmax)
            ? fminf(ps, ldexpf(1.f, min(14 - ilogbf(vmax), 126))) : ps;
    const float pratio = ps_new / ps;          // a power of two, <= 1
    ps = ps_new;
    // ---- online softmax with the shared max; P' into the K half
    unsigned char* pb = R::row(ring, stage, 0, 0);
    float corr[NT][2];
    bool moved = false;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float pr[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = 8 * nt + 2 * ti + e;
        float tm = sh.mx[0][row];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) tm = fmaxf(tm, sh.mx[w][row]);
        const float m_new = fmaxf(m[nt][e], tm);
        pr[e] = v[nt][e] ? expf(s[nt][e] - m_new) : 0.f;
        pr[2 + e] = v[nt][2 + e] ? expf(s[nt][2 + e] - m_new) : 0.f;
        float lt = pr[e] + pr[2 + e];
        lt += __shfl_xor_sync(0xffffffffu, lt, 4);
        lt += __shfl_xor_sync(0xffffffffu, lt, 8);
        lt += __shfl_xor_sync(0xffffffffu, lt, 16);
        const float cm = expf(m[nt][e] - m_new);
        l[nt][e] = l[nt][e] * cm + lt;
        m[nt][e] = m_new;
        corr[nt][e] = cm * pratio;
        moved |= corr[nt][e] != 1.f;
      }
      // P' of tokens gi, gi+8 x rows 2ti+e, transposed by movmatrix to
      // rows gi x tokens 8hh+2ti+{0,1}: one 4-byte store of hi and of lo
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float sv = vs[hh] * ps;
        const float x0 = pr[2 * hh] * sv, x1 = pr[2 * hh + 1] * sv;
        const __half2 hi = __floats2half2_rn(x0, x1);
        const float2 hf = __half22float2(hi);
        const uint32_t th =
            movmatrix_trans(*reinterpret_cast<const uint32_t*>(&hi));
        const uint32_t tl = movmatrix_trans(pack_f16(x0 - hf.x, x1 - hf.y));
        const int n = 8 * nt + gi, tok = tok0 + 8 * hh + 2 * ti;
        const int off = n * 128 + (swz(tok >> 3, n) << 4) + (tok & 7) * 2;
        *reinterpret_cast<uint32_t*>(pb + off) = th;
        *reinterpret_cast<uint32_t*>(pb + PHALF + off) = tl;
      }
    }
    // rescale only when some row's max or P''s scale moved (x 1.0 is exact)
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] *= corr[nt][e % 2];
    }
    __syncthreads();       // P' of all 64 tokens
    // ---- O^T += V^T P'^T for this warp's dims, 16 tokens a step
    const int byte0 = warp * DW + gi * VBW;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t bh[4], bl[4];
      ldmatrix_x4(bh, pb + frag_off(ks, 128));
      ldmatrix_x4(bl, pb + PHALF + frag_off(ks, 128));
      uint32_t vw[4][VW];
      const int vt[4] = {16 * ks + 2 * ti, 16 * ks + 2 * ti + 1,
                         16 * ks + 2 * ti + 8, 16 * ks + 2 * ti + 9};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const unsigned char* a = R::at(ring, stage, 1, vt[r], byte0);
        if constexpr (VBW == 8) {
          const uint2 x = *reinterpret_cast<const uint2*>(a);
          vw[r][0] = x.x;
          vw[r][1] = x.y;
        } else if constexpr (VBW == 4) {
          vw[r][0] = *reinterpret_cast<const uint32_t*>(a);
        } else {
          vw[r][0] = *reinterpret_cast<const uint16_t*>(a);
        }
      }
#pragma unroll
      for (int wi = 0; wi < VW; ++wi) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {        // dim tile mt = 2wi + u
          const int mt = 2 * wi + u;
          if (mt >= MTW) break;
          // bytes 2u, 2u+1 (local dims 4wi+2u, +1) of tokens (0, 1) and
          // (2, 3), interleaved: x0 y0 x1 y1
          const int sel = u ? 0x7362 : 0x5140;
          const uint32_t z01 =
              __byte_perm(vw[0][wi], vw[1][wi], sel) ^ 0x80808080u;
          const uint32_t z23 =
              __byte_perm(vw[2][wi], vw[3][wi], sel) ^ 0x80808080u;
          const uint32_t a[4] = {u8x2_to_f16x2(z01, 0x4140),
                                 u8x2_to_f16x2(z01, 0x4342),
                                 u8x2_to_f16x2(z23, 0x4140),
                                 u8x2_to_f16x2(z23, 0x4342)};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma_16816_f16(acc[mt][nt], a, bh[2 * nt], bh[2 * nt + 1]);
            mma_16816_f16(acc[mt][nt], a, bl[2 * nt], bl[2 * nt + 1]);
          }
        }
      }
    }
  }

  // every warp writes its own dims; only l is summed over the warps
  __device__ void finish(const Params& p, unsigned char* ring, int split,
                         int b, int h, int r0, int nr) {
    if (gi == 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) sh.l[warp][8 * nt + 2 * ti + e] = l[nt][e];
    }
    __syncthreads();
    const float rps = 1.f / ps;          // acc / 2^T: a power of two
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = 8 * nt + 2 * ti + e;
        if (row >= nr) continue;
        float ls = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) ls += sh.l[w][row];
        const int orow = out_row(p, b, h, r0 + row);
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            emit<__nv_bfloat16>(p, split, orow,
                                warp * DW + gi * VBW + 2 * mt + hh, DH,
                                m[nt][e], ls, acc[mt][nt][2 * hh + e] * rps);
      }
    }
  }
};

// the engine of an instantiation: tensor cores for a bf16 q with bf16 K/V
// (kernel 2: tc_decode.cuh's Bf16MmaEngine, 8 query rows per CTA) or int8
// K/V (8 query rows per CTA on MmaEngine; 16 on Mma16Engine: the
// multi-token entry at T*G > 8, the slab entry at Dh 256), CUDA cores for
// an fp32 q
template <typename TQ, typename TKV, int DH, int GT, bool MULTI>
struct EngineOf {
  using type = FmaEngine<TQ, TKV, DH, GT, MULTI>;
};
template <int DH>
struct EngineOf<__nv_bfloat16, __nv_bfloat16, DH, 8, false> {
  using type = Bf16MmaEngine<DH>;
};
template <int DH, bool MULTI>
struct EngineOf<__nv_bfloat16, int8_t, DH, 8, MULTI> {
  using type = MmaEngine<DH, MULTI>;
};
template <int DH, bool MULTI>
struct EngineOf<__nv_bfloat16, int8_t, DH, 16, MULTI> {
  using type = Mma16Engine<DH, MULTI>;
};

// ---------------------------------------------------------------------------
// addressing: which slot (slab) or position (paged) each tile row holds
// ---------------------------------------------------------------------------
// Slab: the split's slots [lo, hi), cut into tiles from lo; s_idx holds
// their validity, one bit per slot.
struct SlabSpan {
  int lo, hi, n;
  __device__ bool row(const Params& p, const int* s_idx, int b, int h,
                      int qpos, int tile_rows, int k, int r,
                      size_t& off, int& at) const {
    const int slot = lo + k * tile_rows + r, i = slot - lo;
    if (slot >= hi || !((static_cast<unsigned>(s_idx[i >> 5]) >> (i & 31))
                        & 1u))
      return false;
    off = ((size_t)b * p.s_len + slot) * p.hkv + h;
    at = slot;
    return true;
  }
};

// Paged: the positions a CTA reads, [a1, e1) (the part of its split inside
// the sink) then [a2, e2) (inside the window, up to the last query's
// position), each cut into tiles from its start; s_idx holds the split's
// table entries.
struct PagedSpan {
  int a1, e1, a2, e2, n1, n, first;
  __device__ bool row(const Params& p, const int* s_idx, int b, int h,
                      int qpos, int tile_rows, int k, int r,
                      size_t& off, int& at) const {
    const int pos = k < n1 ? a1 + k * tile_rows + r
                           : a2 + (k - n1) * tile_rows + r;
    if (pos >= (k < n1 ? e1 : e2)) return false;
    const int pg = p.page_shift >= 0 ? pos >> p.page_shift : pos / p.page;
    const int sl = p.page_shift >= 0 ? pos & (p.page - 1) : pos % p.page;
    const int pid = s_idx[pg - first];
    // unmapped (-1) entries are never loaded; an id outside the pool would
    // be a caller bug and is masked too, not read
    if (pid < 0 || pid >= p.num_pages) return false;
    off = ((size_t)pid * p.page + sl) * p.hkv + h;
    at = pos;
    return true;
  }
};

// the window is anchored at ``base`` (the first query), the split cut at
// ``last`` (the last query's position)
__device__ __forceinline__ PagedSpan paged_span(const Params& p, int split,
                                                int base, int last,
                                                int tile_rows) {
  last = min(last, p.mp * p.page - 1);
  const int lo = split * p.per_split * p.page;
  const int hi = min(min((split + 1) * p.per_split, p.mp) * p.page,
                     last + 1);
  PagedSpan s;
  s.first = split * p.per_split;
  s.a1 = lo;
  if (p.window <= 0) {
    s.e1 = max(hi, lo);
    s.a2 = s.e2 = 0;
  } else {
    s.e1 = max(lo, min(hi, p.sink));
    s.a2 = max(max(lo, base - p.window + 1), s.e1);
    s.e2 = max(hi, s.a2);
  }
  s.n1 = (s.e1 - s.a1 + tile_rows - 1) / tile_rows;
  s.n = s.n1 + (s.e2 - s.a2 + tile_rows - 1) / tile_rows;
  return s;
}

// ---------------------------------------------------------------------------
// the kernel: split range, pos or table staging, the ring, an engine
// ---------------------------------------------------------------------------
template <typename TQ, typename TKV, int DH, int GT, bool PAGED, bool MULTI>
__global__ void __launch_bounds__(
    kThreads, EngineOf<TQ, TKV, DH, GT, MULTI>::type::kMinBlocks)
dense_attn_kernel(const Params p) {
  static_assert(PAGED || !MULTI, "the multi-token entry is paged");
  using E = typename EngineOf<TQ, TKV, DH, GT, MULTI>::type;
  using R = typename E::R;
  constexpr int TILE = R::kTile;
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ __align__(16) typename E::Shared sh;
  int* s_idx = reinterpret_cast<int*>(ring + R::kBytes);

  const int split = blockIdx.x, h = blockIdx.y;
  const int rows = p.t_count * p.g;               // query rows per kv-head
  const int groups = (rows + GT - 1) / GT;
  const int b = blockIdx.z / groups;
  const int r0 = (blockIdx.z % groups) * GT;
  const int nr = min(GT, rows - r0);              // live query rows
  // the merge kernel (if any) may launch now and wait for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // q and the split's pos or table entries do not depend on lengths:
  // their loads go out with the lengths load, not after it
  E eng(sh, p, b, h, r0, nr);
  using Span = typename std::conditional<PAGED, PagedSpan, SlabSpan>::type;
  Span span;
  bool any;
  int qpos;
  if constexpr (PAGED) {
    const int first = split * p.per_split;
    const int* tbl = p.tables + (size_t)b * p.mp + first;
    for (int i = threadIdx.x; i < min(p.per_split, p.mp - first);
         i += kThreads)
      s_idx[i] = tbl[i];
    qpos = p.lengths[b];
    span = paged_span(p, split, qpos, qpos + p.t_count - 1, TILE);
    any = span.n > 0;
    if constexpr (MULTI) eng.set_base(p, qpos, r0, nr);
    __syncthreads();
  } else {
    span.lo = split * p.per_split;
    span.hi = min(span.lo + p.per_split, p.s_len);
    span.n = (span.hi - span.lo + TILE - 1) / TILE;
    const int* prow = p.pos + (size_t)b * p.s_len + span.lo;
    qpos = p.lengths[b];
    // one validity bit per slot (a ballot per warp and 32 slots), so a
    // split of 4096 slots stages 512 B and leaves room for 4 CTAs per SM
    bool mine = false;
    const int n_slots = span.hi - span.lo;
    for (int base = 0; base < n_slots; base += kThreads) {
      const int i = base + threadIdx.x;
      const bool ok = i < n_slots && sees(p, prow[i], qpos);
      const unsigned bits = __ballot_sync(0xffffffffu, ok);
      if (threadIdx.x % 32 == 0)
        s_idx[base / 32 + threadIdx.x / 32] = static_cast<int>(bits);
      mine |= ok;
    }
    any = __syncthreads_or(mine) != 0;
  }
  if (!any) {          // nothing of this split is visible
    for (int idx = threadIdx.x; idx < nr * DH; idx += kThreads)
      emit<TQ>(p, split, out_row(p, b, h, r0 + idx / DH), idx % DH, DH,
               kNegInf, 0.f, 0.f);
    return;
  }

  const unsigned char* gk = static_cast<const unsigned char*>(p.k);
  const unsigned char* gv = static_cast<const unsigned char*>(p.v);
  constexpr int TPR = E::kLoadTPR;            // threads per tile row
  constexpr int RPP = kThreads / TPR;         // rows a pass covers
  static_assert(TILE % RPP == 0 && R::kChunks % TPR == 0, "loader");
  auto load_tile = [&](int k) {
    const int stage = k % R::kStages;
    const int part = threadIdx.x % TPR;
#pragma unroll
    for (int r = threadIdx.x / TPR; r < TILE; r += RPP) {
      size_t off = 0;
      int at = -1;
      const bool ok = span.row(p, s_idx, b, h, qpos, TILE, k, r, off, at);
      const size_t byte0 = off * R::kRowBytes;
      const unsigned char* ksrc = ok ? gk + byte0 : gk;
      const unsigned char* vsrc = ok ? gv + byte0 : gv;

      // each copy instruction of a warp reads TPR*16 contiguous bytes of
      // 32/TPR rows
#pragma unroll
      for (int j = 0; j < R::kChunks / TPR; ++j) {
        const int byte = (part + TPR * j) * 16;
        cp_async16(R::at(ring, stage, 0, r, byte), ksrc + (ok ? byte : 0),
                   ok);
        cp_async16(R::at(ring, stage, 1, r, byte), vsrc + (ok ? byte : 0),
                   ok);
      }
      if (part == 0) {
        if constexpr (R::kInt8) {
          cp_async4(R::scales(ring, stage, 0) + r,
                    ok ? p.k_s + off : p.k_s, ok);
          cp_async4(R::scales(ring, stage, 1) + r,
                    ok ? p.v_s + off : p.v_s, ok);
        }
        // MULTI: the row's position, which each query row masks itself
        R::ok(ring, stage)[r] = MULTI ? (ok ? at : -1) : ok;
      }
    }
  };

#pragma unroll
  for (int k = 0; k < R::kStages - 1; ++k) {
    if (k < span.n) load_tile(k);
    cp_async_commit();
  }
  for (int k = 0; k < span.n; ++k) {
    cp_async_wait<R::kStages - 2>();
    __syncthreads();          // tile k landed; tile k-1's stage is free
    if (k + R::kStages - 1 < span.n) load_tile(k + R::kStages - 1);
    cp_async_commit();
    eng.tile(p, ring, k % R::kStages);
  }
  cp_async_wait<0>();
  __syncthreads();
  eng.finish(p, ring, split, b, h, r0, nr);
}

// combine the splits' partials of one output row, in split order
template <typename TQ, int DH>
__global__ void __launch_bounds__(DH)
dense_merge(const float* __restrict__ part, TQ* __restrict__ out,
            int rows_total, int num_splits) {
  // launched early (programmatic dependent launch): wait until the
  // attention grid has finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int row = blockIdx.x, d = threadIdx.x;
  const size_t s_rows = (size_t)num_splits * rows_total;
  const float* pm = part;
  const float* pl = part + s_rows;
  const float* pa = part + 2 * s_rows;
  float mx = kNegInf;
  for (int s = 0; s < num_splits; ++s)
    mx = fmaxf(mx, pm[(size_t)s * rows_total + row]);
  float ls = 0.f, o = 0.f;
  for (int s = 0; s < num_splits; ++s) {
    const size_t i = (size_t)s * rows_total + row;
    const float ms = pm[i];
    if (ms > kEmpty) {        // an empty partial weighs 0, acc unread
      const float w = expf(ms - mx);
      ls += pl[i] * w;
      o += pa[i * DH + d] * w;
    }
  }
  store1(out + (size_t)row * DH + d,
         mx > kEmpty ? o / fmaxf(ls, 1e-30f) : 0.f);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
using KernelFn = void (*)(Params);

// an instantiation, its query rows per CTA, its ring (dynamic shared
// memory before the staged index) and whether it wants the largest
// shared-memory carveout
struct Choice {
  KernelFn fn;
  int gt;
  int ring_bytes;
  bool max_shared;
};

template <typename TQ, typename TKV, int DH, int GT, bool PAGED, bool MULTI>
Choice pick() {
  using E = typename EngineOf<TQ, TKV, DH, GT, MULTI>::type;
  return {&dense_attn_kernel<TQ, TKV, DH, GT, PAGED, MULTI>, GT,
          E::R::kBytes, E::kMaxShared};
}

// the instantiation for t_count query tokens and g query heads per
// kv-head.  A decode (t_count = 1): 8 (Bf16MmaEngine for kernel 2 with a
// bf16 q at G 2 and up; MmaEngine for kernel 3 with a bf16 q) or, at Dh
// 256 (the slab entry), 16 (Mma16Engine); kernel 2 at G 1 and every fp32
// q the smallest width in {1,2,4,8} that holds the g heads (FmaEngine: at
// G 1 whisper's cross-attention call, 2 rows, took 5.5% less than on the
// tensor cores, PERF.md section 6); grid.z covers the rest in groups of
// that width, as the wrappers' row_groups(1, g) and, for kernel 3's slab
// entry, quant_kv.slab_row_groups.  The multi-token entry (paged only): the
// t_count*g rows in CTAs of 8 (MmaEngine) or 16 (Mma16Engine), or of 2, 4
// or 8 (FmaEngine), as the wrapper's verify_row_groups.
template <typename TQ, typename TKV, int DH, bool PAGED>
Choice choose(int t_count, int g) {
  constexpr bool kBf16Q = std::is_same<TQ, __nv_bfloat16>::value;
  constexpr bool kMma = kBf16Q && std::is_same<TKV, int8_t>::value;
  constexpr bool kBf16 = kBf16Q && std::is_same<TKV, __nv_bfloat16>::value;
  if constexpr (PAGED) {
    if (t_count > 1) {
      const int rows = t_count * g;
      if constexpr (kMma) {
        if (rows > 8) return pick<TQ, TKV, DH, 16, true, true>();
        return pick<TQ, TKV, DH, 8, true, true>();
      } else {
        if (rows > 4) return pick<TQ, TKV, DH, 8, true, true>();
        if (rows > 2) return pick<TQ, TKV, DH, 4, true, true>();
        return pick<TQ, TKV, DH, 2, true, true>();
      }
    }
  }
  if constexpr (kMma) {
    if constexpr (DH == 256) return pick<TQ, TKV, DH, 16, PAGED, false>();
    else return pick<TQ, TKV, DH, 8, PAGED, false>();
  } else if constexpr (kBf16) {
    if (g == 1) return pick<TQ, TKV, DH, 1, PAGED, false>();
    return pick<TQ, TKV, DH, 8, PAGED, false>();
  } else {
    if (g > 4) return pick<TQ, TKV, DH, 8, PAGED, false>();
    if (g > 2) return pick<TQ, TKV, DH, 4, PAGED, false>();
    if (g > 1) return pick<TQ, TKV, DH, 2, PAGED, false>();
    return pick<TQ, TKV, DH, 1, PAGED, false>();
  }
}

// every instantiation may take its ring + the largest staged index as
// dynamic shared memory (above the default 48 KB), once per device; the
// 16-row engine's and Bf16MmaEngine's also ask for the largest
// shared-memory carveout (their 3 or 4 CTAs per SM need it)
template <typename TQ, typename TKV, int DH, bool PAGED>
cudaError_t allow_smem_one() {
  // t_count 2 reaches every multi-token instantiation: rows 2, 4, 8, 16
  for (int t_count : {1, 2}) {
    if (!PAGED && t_count > 1) continue;
    for (int g : {1, 2, 4, 8}) {
      const Choice c = choose<TQ, TKV, DH, PAGED>(t_count, g);
      const void* fn = reinterpret_cast<const void*>(c.fn);
      cudaError_t e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
          c.ring_bytes + kMaxSplitIdx * 4);
      if (e == cudaSuccess && c.max_shared)
        e = cudaFuncSetAttribute(
            fn, cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
      if (e != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}

template <typename TQ, typename TKV>
cudaError_t allow_smem_kv() {
  cudaError_t r = allow_smem_one<TQ, TKV, 64, false>();
  if (r == cudaSuccess) r = allow_smem_one<TQ, TKV, 128, false>();
  if constexpr (std::is_same<TKV, int8_t>::value) {
    if (r == cudaSuccess) r = allow_smem_one<TQ, TKV, 256, false>();
    if (r == cudaSuccess) r = allow_smem_one<TQ, TKV, 64, true>();
    if (r == cudaSuccess) r = allow_smem_one<TQ, TKV, 128, true>();
  }
  return r;
}

cudaError_t allow_smem() {
  static std::once_flag once[64];
  static cudaError_t err[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    cudaError_t r = allow_smem_kv<float, float>();
    if (r == cudaSuccess) r = allow_smem_kv<__nv_bfloat16, __nv_bfloat16>();
    if (r == cudaSuccess) r = allow_smem_kv<float, int8_t>();
    if (r == cudaSuccess) r = allow_smem_kv<__nv_bfloat16, int8_t>();
    err[dev] = r;
  });
  return err[dev];
}

// staged: the split's table entries (paged) or a validity bit per slot,
// in words of 128 slots (slab)
template <bool PAGED>
int staged_bytes(int per_split) {
  return PAGED ? per_split * 4
               : (per_split + kThreads - 1) / kThreads * kThreads / 8;
}

template <typename TQ, typename TKV, int DH, bool PAGED>
cudaError_t launch_dh(Params p, int b, cudaStream_t stream) {
  const Choice c = choose<TQ, TKV, DH, PAGED>(p.t_count, p.g);
  const dim3 grid(p.num_splits, p.hkv,
                  b * ((p.t_count * p.g + c.gt - 1) / c.gt));
  c.fn<<<grid, kThreads, c.ring_bytes + staged_bytes<PAGED>(p.per_split),
         stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.num_splits == 1) return e;
  // programmatic dependent launch: the merge's launch overlaps the
  // attention grid, and griddepcontrol.wait orders its reads
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.rows_total);
  cfg.blockDim = dim3(DH);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dense_merge<TQ, DH>, (const float*)p.part,
                            static_cast<TQ*>(p.out), p.rows_total,
                            p.num_splits);
}

// the query rows per CTA of the instantiation a call launches and the
// CTAs of it that fit on one SM (the occupancy calculator)
template <typename TQ, typename TKV, int DH, bool PAGED>
cudaError_t occupancy_dh(int t_count, int g, int per_split, int* rows,
                         int* ctas) {
  const Choice c = choose<TQ, TKV, DH, PAGED>(t_count, g);
  *rows = c.gt;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, reinterpret_cast<const void*>(c.fn), kThreads,
      c.ring_bytes + staged_bytes<PAGED>(per_split));
}

template <typename TQ, typename TKV, bool PAGED>
cudaError_t occupancy_kv(int t_count, int g, int dh, int per_split,
                         int* rows, int* ctas) {
  if (dh == 128)
    return occupancy_dh<TQ, TKV, 128, PAGED>(t_count, g, per_split, rows,
                                             ctas);
  if (dh == 64)
    return occupancy_dh<TQ, TKV, 64, PAGED>(t_count, g, per_split, rows,
                                            ctas);
  if constexpr (std::is_same<TKV, int8_t>::value && !PAGED) {
    if (dh == 256)
      return occupancy_dh<TQ, TKV, 256, PAGED>(t_count, g, per_split, rows,
                                               ctas);
  }
  return cudaErrorInvalidValue;
}

template <typename TQ, typename TKV, bool PAGED>
int launch_kv(const Params& p, int b, int dh, cudaStream_t s) {
  if (dh == 128) return (int)launch_dh<TQ, TKV, 128, PAGED>(p, b, s);
  if (dh == 64) return (int)launch_dh<TQ, TKV, 64, PAGED>(p, b, s);
  // Dh 256: kernel 3's slab entry only
  if constexpr (std::is_same<TKV, int8_t>::value && !PAGED) {
    if (dh == 256) return (int)launch_dh<TQ, TKV, 256, PAGED>(p, b, s);
  }
  return (int)cudaErrorInvalidValue;
}

// shapes and the split plan: per_split entries per split over n_idx slots
// (slab) or table pages (paged), every split non-empty
bool bad_plan(int b, int hq, int hkv, int n_idx, int per_split,
              int num_splits, const void* scratch) {
  return b <= 0 || hkv <= 0 || hq <= 0 || hq % hkv != 0 || n_idx <= 0
      || per_split <= 0 || per_split > kMaxSplitIdx || num_splits <= 0
      || (long long)num_splits * per_split < n_idx
      || (long long)(num_splits - 1) * per_split >= n_idx
      || (num_splits > 1 && scratch == nullptr);
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* k_s, const void* v_s, const void* lengths,
                   void* out, int b, int hq, int hkv, int window, int sink,
                   float softcap, float scale, int per_split,
                   int num_splits, void* scratch) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_s = static_cast<const float*>(k_s);
  p.v_s = static_cast<const float*>(v_s);
  p.lengths = static_cast<const int*>(lengths);
  p.out = out;
  p.part = static_cast<float*>(scratch);
  p.hq = hq;
  p.hkv = hkv;
  p.g = hq / hkv;
  p.window = window;
  p.sink = sink;
  p.per_split = per_split;
  p.num_splits = num_splits;
  p.t_count = 1;
  p.rows_total = b * hq;
  p.softcap = softcap;
  p.scale = scale;
  p.page_shift = -1;
  return p;
}

}  // namespace

// Every entry: slots_per_split / pages_per_split and num_splits are the
// wrapper's split plan (num_splits * per_split >= S or MP, every split
// non-empty, per_split <= 8192); scratch holds num_splits * B*T*Hq * (Dh +
// 2) floats (T = 1 but in the multi-token entry) and may be null with one
// split.  Each returns a cudaError_t (0 =
// success); anything the kernel does not take returns
// cudaErrorInvalidValue, though the Python wrappers check it all first.

// Kernel 2.  dtype (of q, k, v and the output): 0 = float32, 1 = bfloat16.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* pos,
    const void* lengths, void* out, int b, int s_len, int hq, int hkv,
    int dh, int window, int sink, float softcap, float scale, int dtype,
    int slots_per_split, int num_splits, void* scratch, void* stream) {
  if (bad_plan(b, hq, hkv, s_len, slots_per_split, num_splits, scratch))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  Params p = make_params(q, k, v, nullptr, nullptr, lengths, out, b, hq,
                         hkv, window, sink, softcap, scale, slots_per_split,
                         num_splits, scratch);
  p.pos = static_cast<const int*>(pos);
  p.s_len = s_len;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_kv<float, float, false>(p, b, dh, s);
  if (dtype == 1)
    return launch_kv<__nv_bfloat16, __nv_bfloat16, false>(p, b, dh, s);
  return (int)cudaErrorInvalidValue;
}

// Kernel 3.  k_q/v_q int8 [B,S,Hkv,Dh] (Dh 64, 128 or 256), k_s/v_s
// float32 [B,S,Hkv]; q_dtype (of q and the output): 0 = float32, 1 =
// bfloat16.
extern "C" int repro_decode_attention_int8(
    const void* q, const void* k_q, const void* k_s, const void* v_q,
    const void* v_s, const void* pos, const void* lengths, void* out,
    int b, int s_len, int hq, int hkv, int dh, int window, int sink,
    float softcap, float scale, int q_dtype, int slots_per_split,
    int num_splits, void* scratch, void* stream) {
  if (bad_plan(b, hq, hkv, s_len, slots_per_split, num_splits, scratch))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  Params p = make_params(q, k_q, v_q, k_s, v_s, lengths, out, b, hq, hkv,
                         window, sink, softcap, scale, slots_per_split,
                         num_splits, scratch);
  p.pos = static_cast<const int*>(pos);
  p.s_len = s_len;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) return launch_kv<float, int8_t, false>(p, b, dh, s);
  if (q_dtype == 1)
    return launch_kv<__nv_bfloat16, int8_t, false>(p, b, dh, s);
  return (int)cudaErrorInvalidValue;
}

namespace {

// kernel 3's paged addressing for t_count query tokens per row
int paged_int8(const void* q, const void* pk_q, const void* pk_s,
               const void* pv_q, const void* pv_s, const void* tables,
               const void* lengths, void* out, int b, int t_count, int hq,
               int hkv, int dh, int page, int mp, int num_pages, int window,
               int sink, float softcap, float scale, int q_dtype,
               int pages_per_split, int num_splits, void* scratch,
               void* stream) {
  if (page <= 0 || t_count <= 0
      || bad_plan(b, hq, hkv, mp, pages_per_split, num_splits, scratch))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  Params p = make_params(q, pk_q, pv_q, pk_s, pv_s, lengths, out, b, hq,
                         hkv, window, sink, softcap, scale, pages_per_split,
                         num_splits, scratch);
  p.t_count = t_count;
  p.rows_total = b * t_count * hq;
  p.tables = static_cast<const int*>(tables);
  p.page = page;
  for (int sh = 0; sh < 31; ++sh)
    if ((1 << sh) == page) p.page_shift = sh;
  p.mp = mp;
  p.num_pages = num_pages;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) return launch_kv<float, int8_t, true>(p, b, dh, s);
  if (q_dtype == 1) return launch_kv<__nv_bfloat16, int8_t, true>(p, b, dh, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Kernel 3, paged addressing.  pk_q/pv_q int8 [P,page,Hkv,Dh], pk_s/pv_s
// float32 [P,page,Hkv], tables [B,MP] int32 (-1 = unmapped).
extern "C" int repro_paged_decode_attention_int8(
    const void* q, const void* pk_q, const void* pk_s, const void* pv_q,
    const void* pv_s, const void* tables, const void* lengths, void* out,
    int b, int hq, int hkv, int dh, int page, int mp, int num_pages,
    int window, int sink, float softcap, float scale, int q_dtype,
    int pages_per_split, int num_splits, void* scratch, void* stream) {
  return paged_int8(q, pk_q, pk_s, pv_q, pv_s, tables, lengths, out, b, 1,
                    hq, hkv, dh, page, mp, num_pages, window, sink, softcap,
                    scale, q_dtype, pages_per_split, num_splits, scratch,
                    stream);
}

// Kernel 3's multi-token paged entry (the int8 verify): q and out
// [B,T,Hq,Dh], lengths [B] = tokens before the verify step (query t sees
// positions <= lengths[b] + t).  T = 1 is the decode entry above.
extern "C" int repro_paged_verify_attention_int8(
    const void* q, const void* pk_q, const void* pk_s, const void* pv_q,
    const void* pv_s, const void* tables, const void* lengths, void* out,
    int b, int t_count, int hq, int hkv, int dh, int page, int mp,
    int num_pages, int window, int sink, float softcap, float scale,
    int q_dtype, int pages_per_split, int num_splits, void* scratch,
    void* stream) {
  return paged_int8(q, pk_q, pk_s, pv_q, pv_s, tables, lengths, out, b,
                    t_count, hq, hkv, dh, page, mp, num_pages, window, sink,
                    softcap, scale, q_dtype, pages_per_split, num_splits,
                    scratch, stream);
}

// The instantiation a call of these entries would launch: kv_int8 0 =
// kernel 2 (K/V in q's dtype), 1 = kernel 3; paged 1 = kernel 3's paged
// entries (t_count > 1: the multi-token one); q_dtype as above; per_split
// the plan's slots or pages per split.  Writes its query rows per CTA and
// the CTAs of it that fit on one SM at that staged index.
extern "C" int repro_decode_attention_occupancy(
    int kv_int8, int paged, int t_count, int hq, int hkv, int dh,
    int q_dtype, int per_split, int* rows_per_cta, int* ctas_per_sm) {
  if (t_count <= 0 || hkv <= 0 || hq <= 0 || hq % hkv != 0
      || per_split <= 0 || per_split > kMaxSplitIdx
      || (t_count > 1 && !paged) || (paged && !kv_int8))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  const int g = hq / hkv;
  int* r = rows_per_cta;
  int* c = ctas_per_sm;
  if (!kv_int8 && q_dtype == 0)
    return (int)occupancy_kv<float, float, false>(1, g, dh, per_split, r, c);
  if (!kv_int8 && q_dtype == 1)
    return (int)occupancy_kv<__nv_bfloat16, __nv_bfloat16, false>(
        1, g, dh, per_split, r, c);
  if (q_dtype == 0)
    return (int)(paged ? occupancy_kv<float, int8_t, true>(
                             t_count, g, dh, per_split, r, c)
                       : occupancy_kv<float, int8_t, false>(
                             1, g, dh, per_split, r, c));
  if (q_dtype == 1)
    return (int)(paged ? occupancy_kv<__nv_bfloat16, int8_t, true>(
                             t_count, g, dh, per_split, r, c)
                       : occupancy_kv<__nv_bfloat16, int8_t, false>(
                             1, g, dh, per_split, r, c));
  return (int)cudaErrorInvalidValue;
}
