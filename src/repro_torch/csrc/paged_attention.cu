// Paged flash-decode for Hopper (sm_90a): the R-Part attention of one
// decode step, or of one speculative-decode verify step, over a
// block-table KV page pool.  One template, two C entry points:
//
// * repro_paged_decode_attention replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py (_kernel, wrapped by
//   paged_decode_attention): one query token per row, q [B,Hq,Dh].
// * repro_paged_verify_attention replaces _verify_kernel (wrapped by
//   paged_verify_attention) of the same file: T candidate tokens per row,
//   q [B,T,Hq,Dh], query t of row b at absolute position lengths[b] + t.
//
// Same function otherwise: the pool pages_k/v [P,page,Hkv,Dh] is read
// through tables [B,MP] (int32, -1 = unmapped); slot j of table entry i is
// absolute position i*page+j; a position is valid for query t when it is
// mapped, <= lengths[b] + t and (window > 0) inside the window or the
// sink.  Optional tanh softcap, scale 1/sqrt(Dh), fp32 online softmax; a
// query with no valid key writes zeros.  The pool is read-only here (the
// verify op writes the candidates' K/V before it attends), so two rows may
// share a page.
//
// What bounds it: HBM bytes.  Each valid K/V row is read once per (row,
// kv-head), 2*Hkv*Dh*elt bytes per token, against 4*T*Hq*Dh flops per
// token, far below the card's flop/byte balance.  The first version (one
// CTA per (row, kv-head), each warp walking positions one at a time through
// a table -> page -> 8-byte-load chain) was bound by load latency instead:
// 16 CTAs with ~512 B in flight per warp at the serve's shape, and 0.3-1
// TB/s at 64 x 4096 tokens, where the verify kernel was also issue-bound
// (5 shuffles and 2 exponentials per position, warp and query row).
//
// Design (second version):
// * Split-K over the page list (flash-decoding).  The grid is (splits,
//   Hkv, B x row groups); a CTA owns pages [split*pps, (split+1)*pps) of
//   one row and kv-head for up to 8 (decode) or 16 (verify) query rows, so
//   each page is still read once per (row, kv-head).  The split plan comes
//   from the wrapper (kernels/paged_attention.py::split_plan, shapes only,
//   no lengths, so no host sync): one split when B*Hkv*groups CTAs fill
//   the SMs, else enough splits of >= 64 positions to put about 2 CTAs on
//   every SM (the serve's 2 rows x 8 kv-heads over 64 table pages: 16
//   splits of 4 pages).  A CTA whose positions all lie past the last
//   query, or between the sink and the window, writes an empty partial
//   (m = -1e30, l = 0) and exits; a CTA walks only the sink part and the
//   window part of its split.  With one split the CTA writes the output;
//   otherwise it writes fp32 (m, l, acc[Dh]) partials to the wrapper's
//   scratch, and merge_splits (launched by the same C entry, on the same
//   stream) combines them in split order: no atomics, bitwise
//   reproducible; a partial with m <= -5e29 weighs 0 and its acc is not
//   read, and a query whose every partial is empty writes 0.
// * An asynchronous page ring.  The CTA stages its split's table entries
//   in shared memory once, then walks its positions in tiles: cp.async
//   (16 B per thread) copies the tile's K and V rows of its kv-head
//   (Dh*elt bytes each, at a stride of Hkv*Dh*elt in the pool) into a ring
//   in shared memory while earlier tiles are computed.  The fp32 and
//   kernel 4 engines take tiles of 32 rows, padded by 16 B, in 3 (bf16) or
//   2 (fp32) stages, 4 loader threads per row; kernel 1 in bf16 takes
//   tc_decode.cuh's ring: 64-row tiles with XOR-swizzled 16-byte chunks, 2
//   stages at Dh 128 (64 KB, 3 CTAs per SM) and 3 at Dh 64 (48 KB, 4), 8
//   loader threads per row (each copy instruction of a warp reads a
//   128-byte piece of 4 rows).  Either way the loader writes each row's
//   flag beside the ring (whether it loaded it; for a verify its position,
//   or -1), and the engines read nothing else of the addressing; the 8
//   rows a quarter warp (or an ldmatrix phase) reads fall on distinct
//   banks.  An unmapped (-1) or out-of-pool table
//   entry, a position past the split or past the last query, is never
//   loaded: the copy zero-fills the row (src-size 0) and the score is
//   masked.
// * Scores per tile, not per position.  Each warp owns its token rows of
//   a tile and keeps its own online softmax over them, so a tile needs no
//   block barrier beyond the ring's; each row's max and sum are reduced
//   once per tile; the 4 warps' states merge through shared memory at the
//   end.  Three engines:
//   - kernel 1 in bf16: tc_decode.cuh's Bf16MmaEngine (shared with kernel
//     2), the token rows as the M of mma.sync.m16n8k16 and the G <= 8
//     query heads as its N, q unscaled in registers, K by ldmatrix and V
//     by ldmatrix.trans from the ring, the scale, the softcap and the mask
//     in fp32 on the score fragment, P^T by movmatrix as bf16 hi + lo, two
//     products per 16 output dims (that header has the layout);
//   - every fp32 instantiation: CUDA cores (FmaEngine): the 4 lanes of a
//     token row score a quarter of Dh each against every query row (q
//     pre-scaled in fp32 in shared memory) and sum with 2 shuffles; max
//     and sum over the warp's 8 rows take 3 + 3 shuffles per query row and
//     tile; in the PV product each lane owns Dh/32 columns of every query
//     row;
//   - the bf16 verify (kernel 4): tensor cores (MmaEngine): the T*G <= 16
//     query rows are the M of mma.sync.m16n8k16; each warp computes its 16
//     x 8 scores from unscaled bf16 q (A fragments in registers) and K
//     (ldmatrix), scales them in fp32, masks each query row's causal limit
//     as a select on the accumulator fragment; P (fp32) is split into bf16
//     hi + lo and multiplied with V (ldmatrix.trans) by two m16n8k8
//     products, so PV keeps ~16 bits of p.
//   fp32 pools never go through TF32.  Every engine skips the accumulator
//   rescale of a tile where no row's max moved.
// * Kernel 4 at T = 1 launches exactly kernel 1's instantiation with the
//   same plan, so it is bitwise kernel 1.
//
// Third version (kernel 1 in bf16, on the tensor cores): the CUDA-core
// engine cost 2 shuffles per score, 3 + 3 per query row and tile and Dh/32
// FMAs per query row and token in PV, so its instructions per byte grew
// with G and it was bound by issue, not bytes: at Qwen3-8B's G 4 it took
// 0.436 ms at 64 x 4096 against a bytes bound of 0.321, and lost to SDPA
// by 1.56x at the serve's call and 1.89x at llama4-scout's G 5.  On the
// tensor cores the instructions per token no longer grow with G.  Measured
// on an H100 (tools/k12_variants.py, PERF.md section 6), and left: one
// more ring stage at Dh 128 (3, 2 CTAs per SM) took 7% off 64 x 4096 but
// cost kernel 2's split grids a second wave (26% at vision's cross call);
// an L2::256B prefetch hint on the copies gained 2-4% with 4 loader
// threads per row and nothing on top of 8; G 1 (llama-13b, opt-175b)
// stays on the tensor cores, 4-16% faster than FmaEngine there.
//
// Left for later: TMA bulk copies with mbarriers in place of cp.async,
// wgmma (m64n8k16 would fit a 64-row tile by G <= 8 heads; untried),
// a ring depth chosen per launch (3 stages where the grid has one split),
// persistent CTAs that walk several (row, kv-head, split) items, and a
// single-launch merge.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

#include "tc_decode.cuh"

namespace {

using namespace tcd;

constexpr int kMaxSplitPages = 2048; // table entries a CTA stages

struct Params {
  const void* q;
  const void* pages_k;
  const void* pages_v;
  const int* tables;
  const int* lengths;
  void* out;
  float* part;        // [S][rows] m, [S][rows] l, [S][rows][Dh] acc
  int t_count, hq, hkv, g, page, mp, num_pages, window, sink;
  int page_shift;     // log2(page) for a power-of-two page, else -1
  int pps, num_splits, groups, rows_total;
  float softcap, scale;
};

// the CUDA-core engine's and kernel 4's ring: 32-row K/V tiles (rows
// padded by 16 B), 3 stages in bf16 and 2 in fp32, each row's flag beside
// them; the split's table follows the ring in dynamic shared memory
template <typename T, int DH>
using PadRing = Ring<T, DH, 32, sizeof(T) == 2 ? 3 : 2>;

__device__ __forceinline__ float to_float(float v) { return v; }
// The positions a CTA reads: [a1, e1) (the part of its split inside the
// sink) then [a2, e2) (the part inside the loosest query's window, up to
// the last query), each cut into tiles of ``rows`` from its start.
struct Span {
  int a1, e1, a2, e2, n1, n, rows;
  __device__ void tile(int k, int& start, int& end) const {
    if (k < n1) {
      start = a1 + k * rows;
      end = e1;
    } else {
      start = a2 + (k - n1) * rows;
      end = e2;
    }
  }
};

__device__ __forceinline__ Span make_span(const Params& p, int split,
                                          int base, int last, int rows) {
  const int lo = split * p.pps * p.page;
  const int hi = min(min((split + 1) * p.pps, p.mp) * p.page, last + 1);
  Span s;
  s.a1 = lo;
  if (p.window <= 0) {
    s.e1 = max(hi, lo);
    s.a2 = s.e2 = 0;
  } else {
    s.e1 = max(lo, min(hi, p.sink));
    s.a2 = max(max(lo, base - p.window + 1), s.e1);
    s.e2 = max(hi, s.a2);
  }
  s.rows = rows;
  s.n1 = (s.e1 - s.a1 + rows - 1) / rows;
  s.n = s.n1 + (s.e2 - s.a2 + rows - 1) / rows;
  return s;
}

// query rows j of this CTA whose position limit is qp: may they see pos?
__device__ __forceinline__ bool row_sees(const Params& p, int pos, int qp) {
  return pos <= qp
      && (p.window <= 0 || pos > qp - p.window || pos < p.sink);
}

// table entry and slot of a position (a shift for a power-of-two page)
__device__ __forceinline__ int page_of(const Params& p, int pos) {
  return p.page_shift >= 0 ? pos >> p.page_shift : pos / p.page;
}
__device__ __forceinline__ int slot_of(const Params& p, int pos) {
  return p.page_shift >= 0 ? pos & (p.page - 1) : pos % p.page;
}

// N consecutive fp32 elements (FmaEngine runs the fp32 pools only)
template <typename T, int N> struct Vec;
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

// ---------------------------------------------------------------------------
// CUDA-core engine: every fp32 instantiation (kernels 1 and 4).  Warp w
// owns token rows 8w..8w+7 of every tile.  Lane 8c + t scores token row t
// against the 16-byte Dh chunks c, c+4, c+8, ... for every query row (q
// pre-scaled in fp32 in shared memory; each quarter warp reads one q
// address and 8 K rows on distinct banks); the 4 lanes of a token sum
// their parts (2 shuffles per row), and each row's max and sum over the
// warp's 8 rows take 3 + 3 shuffles per tile, with no block barrier.
// p goes to the warp's own shared buffer; in the PV product lane i owns
// Dh columns [i*DH/32, (i+1)*DH/32) of every query row.
// ---------------------------------------------------------------------------
template <typename T, int DH, int GT, bool MULTI>
struct FmaEngine {
  using R = PadRing<T, DH>;
  static constexpr int kMinBlocks = sizeof(T) == 2 ? 3 : 2;
  static constexpr int kLoadTPR = 4;
  static constexpr bool kMaxShared = false;
  static constexpr int EPC = 16 / (int)sizeof(T);   // elements per chunk
  static constexpr int CPQ = R::kChunks / 4;    // chunks per lane
  static constexpr int CPL = DH / 32;           // PV columns per lane
  struct Shared {
    float q[GT][DH];              // pre-scaled q rows
    float pw[kWarps][8][GT];      // each warp's p of this tile
    float m[kWarps][GT], l[kWarps][GT];
  };

  Shared& sh;
  const int warp, lane, c, t;
  float m[GT], l[GT];
  int qp[GT];               // each query row's position (-1: dead row)
  float acc[GT][CPL];

  __device__ FmaEngine(Shared& s, const Params& p, int b, int h, int r0,
                       int nr)
      : sh(s), warp(threadIdx.x / 32), lane(threadIdx.x % 32),
        c(lane / 8), t(lane % 8) {
    const T* q = static_cast<const T*>(p.q);
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
    // the loader's flag: the row's position (-1: not loaded) for a verify,
    // else whether it was loaded
    const int pos = R::ok(ring, stage)[tok];
    const bool ok = MULTI ? pos >= 0 : pos != 0;
    const unsigned char* krow = R::row(ring, stage, 0, tok);
    float s[GT];
#pragma unroll
    for (int j = 0; j < GT; ++j) s[j] = 0.f;
#pragma unroll
    for (int i = 0; i < CPQ; ++i) {
      const int ch = c + 4 * i;
      float kf[EPC];
      Vec<T, EPC>::load(reinterpret_cast<const T*>(krow + ch * 16), kf);
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
      if (p.softcap > 0.f) sc = p.softcap * tanhf(sc / p.softcap);
      // the decode query's limit and window are the span's own
      const bool ok_j = MULTI ? ok && row_sees(p, pos, qp[j]) : ok;
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
      if (c == 0) sh.pw[warp][t][j] = pr;
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
      Vec<T, CPL>::load(reinterpret_cast<const T*>(vrow + tk * R::kStride)
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
    merge_warps<T, DH, GT>(p, sh.m, sh.l, s_acc, split, b, h, r0, nr);
  }
};

// ---------------------------------------------------------------------------
// tensor-core engine: the bf16 verify (kernel 4), 16 query rows
// ---------------------------------------------------------------------------
// c += a (16x8, row) * b (8x8, col)
__device__ __forceinline__ void mma_1688(float* c, const uint32_t* a,
                                         uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}
__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DH>
struct MmaEngine {
  using T = __nv_bfloat16;
  using R = PadRing<T, DH>;
  static constexpr int kMinBlocks = 3;
  static constexpr int kLoadTPR = 4;
  static constexpr bool kMaxShared = false;
  static constexpr int KS = DH / 16;     // k-steps of Q K^T
  static constexpr int NB = DH / 8;      // n-blocks of P V
  static constexpr int GT = 16;
  struct Shared {
    float m[kWarps][GT], l[kWarps][GT];
  };

  Shared& sh;
  const int warp, lane;
  uint32_t qa[KS][4];      // A fragments of the 16 query rows
  float acc[NB][4];        // rows lane/4 and lane/4 + 8
  float m[2], l[2];
  int qp[2];

  __device__ MmaEngine(Shared& s, const Params& p, int b, int h, int r0,
                       int nr)
      : sh(s), warp(threadIdx.x / 32), lane(threadIdx.x % 32) {
    const T* q = static_cast<const T*>(p.q);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = lane / 4 + 8 * hh;
      m[hh] = kNegInf;
      l[hh] = 0.f;
      const T* row = q + (size_t)out_row(p, b, h, r0 + min(j, nr - 1)) * DH;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int col = kk * 16 + 2 * (lane % 4);
        qa[kk][hh] = j < nr
            ? *reinterpret_cast<const uint32_t*>(row + col) : 0u;
        qa[kk][2 + hh] = j < nr
            ? *reinterpret_cast<const uint32_t*>(row + col + 8) : 0u;
      }
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  }

  __device__ void set_base(const Params& p, int base, int r0, int nr) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = lane / 4 + 8 * hh;
      qp[hh] = j < nr ? base + (r0 + j) / p.g : -1;
    }
  }

  __device__ void tile(const Params& p, unsigned char* ring, int stage) {
    const int tok0 = warp * 8;             // this warp's 8 token rows
    const unsigned char* kst = R::row(ring, stage, 0, tok0 + lane % 8);
    const unsigned char* vst = R::row(ring, stage, 1, tok0 + lane % 8);
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KS; kk += 2) {
      uint32_t bk[4];
      ldmatrix_x4(bk, kst + (kk * 16 + (lane / 8) * 8) * 2);
      mma_16816(c, qa[kk], bk[0], bk[1]);
      mma_16816(c, qa[kk + 1], bk[2], bk[3]);
    }
    // c[2hh + e]: query row lane/4 + 8hh, token row tok0 + 2(lane%4) + e,
    // whose position the loader flagged (-1: not loaded)
    const int* flag = R::ok(ring, stage) + tok0 + 2 * (lane % 4);
    const int pos[2] = {flag[0], flag[1]};
    float pr[4], corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float s[2];
      bool v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float sc = c[2 * hh + e] * p.scale;
        if (p.softcap > 0.f) sc = p.softcap * tanhf(sc / p.softcap);
        v[e] = pos[e] >= 0 && row_sees(p, pos[e], qp[hh]);
        s[e] = v[e] ? sc : kNegInf;
      }
      float mt = fmaxf(s[0], s[1]);
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[hh], mt);
      pr[2 * hh] = v[0] ? expf(s[0] - m_new) : 0.f;
      pr[2 * hh + 1] = v[1] ? expf(s[1] - m_new) : 0.f;
      float lt = pr[2 * hh] + pr[2 * hh + 1];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      corr[hh] = expf(m[hh] - m_new);
      l[hh] = l[hh] * corr[hh] + lt;
      m[hh] = m_new;
    }
    // rescale only when some row's max moved (x 1.0 is exact, so skipping
    // it changes no bit)
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][e] *= corr[e / 2];
      }
    }
    // P as the A fragment of m16n8k8, in two bf16 terms: hi + lo
    uint32_t ah[2], al[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const __nv_bfloat162 hi =
          __floats2bfloat162_rn(pr[2 * hh], pr[2 * hh + 1]);
      const float2 hf = __bfloat1622float2(hi);
      ah[hh] = pack(hi);
      al[hh] = pack(__floats2bfloat162_rn(pr[2 * hh] - hf.x,
                                          pr[2 * hh + 1] - hf.y));
    }
#pragma unroll
    for (int n4 = 0; n4 < DH / 32; ++n4) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, vst + (n4 * 32 + (lane / 8) * 8) * 2);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        mma_1688(acc[n4 * 4 + u], ah, bv[u]);
        mma_1688(acc[n4 * 4 + u], al, bv[u]);
      }
    }
  }

  // merge the 4 warps' states (the ring is free: it holds their acc now)
  __device__ void finish(const Params& p, unsigned char* ring, int split,
                         int b, int h, int r0, int nr) {
    float* s_acc = reinterpret_cast<float*>(ring);    // [warp][row][DH]
    if (lane % 4 == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        sh.m[warp][lane / 4 + 8 * hh] = m[hh];
        sh.l[warp][lane / 4 + 8 * hh] = l[hh];
      }
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(
            &s_acc[(warp * GT + lane / 4 + 8 * hh) * DH + nb * 8
                   + 2 * (lane % 4)]) =
            make_float2(acc[nb][2 * hh], acc[nb][2 * hh + 1]);
    __syncthreads();
    merge_warps<T, DH, GT>(p, sh.m, sh.l, s_acc, split, b, h, r0, nr);
  }
};

// ---------------------------------------------------------------------------
// the kernel: split range, table staging, the ring, an engine
// ---------------------------------------------------------------------------
// kernel 1 with bf16: tc_decode.cuh's Bf16MmaEngine (8 query rows, 64-row
// tiles); kernel 4 with bf16: MmaEngine (16 query rows); fp32: FmaEngine
template <typename T, int DH, int GT, bool MULTI, bool MMA>
struct EngineOf {
  using type = FmaEngine<T, DH, GT, MULTI>;
};
template <int DH>
struct EngineOf<__nv_bfloat16, DH, 8, false, true> {
  using type = Bf16MmaEngine<DH>;
};
template <int DH>
struct EngineOf<__nv_bfloat16, DH, 16, true, true> {
  using type = MmaEngine<DH>;
};

template <typename T, int DH, int GT, bool MULTI, bool MMA>
__global__ void __launch_bounds__(
    kThreads, EngineOf<T, DH, GT, MULTI, MMA>::type::kMinBlocks)
paged_attn_kernel(const Params p) {
  using E = typename EngineOf<T, DH, GT, MULTI, MMA>::type;
  using R = typename E::R;
  constexpr int TILE = R::kTile;
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ __align__(16) typename E::Shared sh;
  int* s_tbl = reinterpret_cast<int*>(ring + R::kBytes);

  const int split = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / p.groups;
  const int r0 = (blockIdx.z % p.groups) * GT;
  const int nr = min(GT, p.t_count * p.g - r0);     // live query rows
  // the merge kernel (if any) may launch now and wait for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // q and the split's table entries do not depend on lengths: their
  // loads go out with the lengths load, not after it
  E eng(sh, p, b, h, r0, nr);
  const int first = split * p.pps;
  const int* tbl = p.tables + (size_t)b * p.mp + first;
  for (int i = threadIdx.x; i < min(p.pps, p.mp - first); i += kThreads)
    s_tbl[i] = tbl[i];
  const int base = p.lengths[b];
  // positions past the last query or past the table are never valid
  const int last = min(MULTI ? base + p.t_count - 1 : base,
                       p.mp * p.page - 1);
  const Span span = make_span(p, split, base, last, TILE);
  if (span.n == 0) {          // nothing of this split is visible
    for (int idx = threadIdx.x; idx < nr * DH; idx += kThreads)
      emit<T>(p, split, out_row(p, b, h, r0 + idx / DH), idx % DH, DH,
              kNegInf, 0.f, 0.f);
    return;
  }
  eng.set_base(p, base, r0, nr);
  __syncthreads();

  const T* pk = static_cast<const T*>(p.pages_k);
  const T* pv = static_cast<const T*>(p.pages_v);
  const size_t tok_stride = (size_t)p.hkv * DH;    // elements
  // TPR threads per token row: one table lookup each, then 16-byte copies
  // of chunks part, part + TPR, ... (each copy instruction of a warp reads
  // TPR*16 contiguous bytes of 32/TPR rows); a pass covers RPP rows
  constexpr int TPR = E::kLoadTPR, RPP = kThreads / TPR;
  static_assert(TILE % RPP == 0 && R::kChunks % TPR == 0, "loader");
  auto load_tile = [&](int k) {
    int start, end;
    span.tile(k, start, end);
    const int stage = k % R::kStages;
    const int part = threadIdx.x % TPR;
#pragma unroll
    for (int r = threadIdx.x / TPR; r < TILE; r += RPP) {
      const int pos = start + r;
      size_t off = 0;
      bool ok = pos < end;
      if (ok) {
        const int pid = s_tbl[page_of(p, pos) - first];
        // unmapped (-1) entries are never loaded; an id outside the pool
        // would be a caller bug and is masked too, not read
        ok = pid >= 0 && pid < p.num_pages;
        off = ((size_t)pid * p.page + slot_of(p, pos)) * tok_stride
              + (size_t)h * DH;
      }
      const unsigned char* ksrc =
          reinterpret_cast<const unsigned char*>(ok ? pk + off : pk);
      const unsigned char* vsrc =
          reinterpret_cast<const unsigned char*>(ok ? pv + off : pv);
#pragma unroll
      for (int j = 0; j < R::kChunks / TPR; ++j) {
        const int byte = (part + TPR * j) * 16;
        cp_async16(R::at(ring, stage, 0, r, byte), ksrc + (ok ? byte : 0),
                   ok);
        cp_async16(R::at(ring, stage, 1, r, byte), vsrc + (ok ? byte : 0),
                   ok);
      }
      // every engine reads the row's flag beside it: its position (-1: not
      // loaded) for a verify's per-query limits, else whether it loaded
      if (part == 0) R::ok(ring, stage)[r] = MULTI ? (ok ? pos : -1) : ok;
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
template <typename T, int DH>
__global__ void __launch_bounds__(DH)
merge_splits(const float* __restrict__ part, T* __restrict__ out,
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
// memory before the table) and whether it wants the largest carveout
struct Choice {
  KernelFn fn;
  int gt;
  int ring_bytes;
  bool max_shared;
};

template <typename T, int DH, int GT, bool MULTI, bool MMA>
Choice pick() {
  using E = typename EngineOf<T, DH, GT, MULTI, MMA>::type;
  return {&paged_attn_kernel<T, DH, GT, MULTI, MMA>, GT, E::R::kBytes,
          E::kMaxShared};
}

// rows = T*G query rows per (row, kv-head).  A decode (t_count = 1): 8
// (bf16, Bf16MmaEngine, at every G, G 1 included, PERF.md section 6) or
// the smallest width in {1,2,4,8} that holds them (fp32); a verify
// {2,4,8,16} (fp32) or 16 (bf16, the tensor-core M); grid.z covers the
// rest, at most 8 (decode) or 16 (verify) rows per CTA, as the wrapper's
// row_groups.
template <typename T, int DH>
Choice choose(int t_count, int rows) {
  constexpr bool kBf16 = sizeof(T) == 2;
  if (t_count == 1) {
    if constexpr (kBf16) {
      return pick<T, DH, 8, false, true>();
    } else {
      if (rows <= 1) return pick<T, DH, 1, false, false>();
      if (rows <= 2) return pick<T, DH, 2, false, false>();
      if (rows <= 4) return pick<T, DH, 4, false, false>();
      return pick<T, DH, 8, false, false>();
    }
  }
  if constexpr (kBf16) {
    return pick<T, DH, 16, true, true>();
  } else {
    if (rows <= 2) return pick<T, DH, 2, true, false>();
    if (rows <= 4) return pick<T, DH, 4, true, false>();
    if (rows <= 8) return pick<T, DH, 8, true, false>();
    return pick<T, DH, 16, true, false>();
  }
}

// every instantiation may take its ring + the largest table as dynamic
// shared memory (above the default 48 KB), once per device; Bf16MmaEngine's
// also asks for the largest shared-memory carveout (its 3 or 4 CTAs per SM
// need it)
template <typename T, int DH>
cudaError_t allow_smem_one() {
  for (int t : {1, 2}) {
    for (int rows : {1, 2, 4, 8, 16}) {
      const Choice c = choose<T, DH>(t, rows);
      const void* fn = reinterpret_cast<const void*>(c.fn);
      cudaError_t e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
          c.ring_bytes + kMaxSplitPages * 4);
      if (e == cudaSuccess && c.max_shared)
        e = cudaFuncSetAttribute(
            fn, cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
      if (e != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}

cudaError_t allow_smem() {
  static std::once_flag once[64];
  static cudaError_t err[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    cudaError_t r = allow_smem_one<float, 64>();
    if (r == cudaSuccess) r = allow_smem_one<float, 128>();
    if (r == cudaSuccess) r = allow_smem_one<__nv_bfloat16, 64>();
    if (r == cudaSuccess) r = allow_smem_one<__nv_bfloat16, 128>();
    err[dev] = r;
  });
  return err[dev];
}

template <typename T, int DH>
cudaError_t launch_dh(Params p, int b, cudaStream_t stream) {
  const Choice c = choose<T, DH>(p.t_count, p.t_count * p.g);
  p.groups = (p.t_count * p.g + c.gt - 1) / c.gt;
  const dim3 grid(p.num_splits, p.hkv, b * p.groups);
  const int smem = c.ring_bytes + p.pps * 4;
  c.fn<<<grid, kThreads, smem, stream>>>(p);
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
  return cudaLaunchKernelEx(&cfg, merge_splits<T, DH>, (const float*)p.part,
                            static_cast<T*>(p.out), p.rows_total,
                            p.num_splits);
}

int launch(const void* q, const void* pages_k, const void* pages_v,
           const void* tables, const void* lengths, void* out, int b,
           int t_count, int hq, int hkv, int dh, int page, int mp,
           int num_pages, int window, int sink, float softcap, float scale,
           int dtype, int pages_per_split, int num_splits, void* scratch,
           void* stream) {
  if (b <= 0 || t_count <= 0 || hkv <= 0 || hq % hkv != 0 || page <= 0
      || mp <= 0 || pages_per_split <= 0
      || pages_per_split > kMaxSplitPages || num_splits <= 0
      || (long long)num_splits * pages_per_split < mp
      || (long long)(num_splits - 1) * pages_per_split >= mp
      || (num_splits > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  Params p;
  p.q = q;
  p.pages_k = pages_k;
  p.pages_v = pages_v;
  p.tables = static_cast<const int*>(tables);
  p.lengths = static_cast<const int*>(lengths);
  p.out = out;
  p.part = static_cast<float*>(scratch);
  p.t_count = t_count;
  p.hq = hq;
  p.hkv = hkv;
  p.g = hq / hkv;
  p.page = page;
  p.page_shift = -1;
  for (int sh = 0; sh < 31; ++sh)
    if ((1 << sh) == page) p.page_shift = sh;
  p.mp = mp;
  p.num_pages = num_pages;
  p.window = window;
  p.sink = sink;
  p.pps = pages_per_split;
  p.num_splits = num_splits;
  p.groups = 1;
  p.rows_total = b * t_count * hq;
  p.softcap = softcap;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dh == 128) return (int)launch_dh<float, 128>(p, b, s);
  if (dtype == 0 && dh == 64) return (int)launch_dh<float, 64>(p, b, s);
  if (dtype == 1 && dh == 128)
    return (int)launch_dh<__nv_bfloat16, 128>(p, b, s);
  if (dtype == 1 && dh == 64)
    return (int)launch_dh<__nv_bfloat16, 64>(p, b, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int DH>
cudaError_t occupancy_dh(int t_count, int rows, int pps, int* ctas) {
  const Choice c = choose<T, DH>(t_count, rows);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, reinterpret_cast<const void*>(c.fn), kThreads,
      c.ring_bytes + pps * 4);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  pages_per_split and num_splits are
// the wrapper's split plan (num_splits * pages_per_split >= mp, every
// split non-empty); scratch holds num_splits * B*T*Hq * (Dh + 2) floats
// and may be null with one split.  Each returns a cudaError_t (0 =
// success); anything the kernel does not take returns
// cudaErrorInvalidValue, though the Python wrappers check it all first.
extern "C" int repro_paged_decode_attention(
    const void* q, const void* pages_k, const void* pages_v,
    const void* tables, const void* lengths, void* out,
    int b, int hq, int hkv, int dh, int page, int mp, int num_pages,
    int window, int sink, float softcap, float scale, int dtype,
    int pages_per_split, int num_splits, void* scratch, void* stream) {
  return launch(q, pages_k, pages_v, tables, lengths, out, b, 1, hq, hkv, dh,
                page, mp, num_pages, window, sink, softcap, scale, dtype,
                pages_per_split, num_splits, scratch, stream);
}

// q and out [B,T,Hq,Dh]; lengths [B] = tokens before the verify step.
extern "C" int repro_paged_verify_attention(
    const void* q, const void* pages_k, const void* pages_v,
    const void* tables, const void* lengths, void* out,
    int b, int t_count, int hq, int hkv, int dh, int page, int mp,
    int num_pages, int window, int sink, float softcap, float scale,
    int dtype, int pages_per_split, int num_splits, void* scratch,
    void* stream) {
  return launch(q, pages_k, pages_v, tables, lengths, out, b, t_count, hq,
                hkv, dh, page, mp, num_pages, window, sink, softcap, scale,
                dtype, pages_per_split, num_splits, scratch, stream);
}

// CTAs of the instantiation a call with these shapes launches that fit on
// one SM at once (registers, shared memory), into *ctas.
extern "C" int repro_paged_attention_ctas_per_sm(
    int t_count, int hq, int hkv, int dh, int dtype, int pages_per_split,
    int* ctas) {
  if (t_count <= 0 || hkv <= 0 || hq % hkv != 0 || pages_per_split <= 0
      || pages_per_split > kMaxSplitPages)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  const int rows = t_count * (hq / hkv);
  if (dtype == 0 && dh == 128)
    e = occupancy_dh<float, 128>(t_count, rows, pages_per_split, ctas);
  else if (dtype == 0 && dh == 64)
    e = occupancy_dh<float, 64>(t_count, rows, pages_per_split, ctas);
  else if (dtype == 1 && dh == 128)
    e = occupancy_dh<__nv_bfloat16, 128>(t_count, rows, pages_per_split,
                                         ctas);
  else if (dtype == 1 && dh == 64)
    e = occupancy_dh<__nv_bfloat16, 64>(t_count, rows, pages_per_split,
                                        ctas);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
