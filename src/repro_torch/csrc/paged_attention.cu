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
//   in shared memory once, then walks its positions in tiles of 32 token
//   rows: cp.async (16 B per thread) copies the tile's K and V rows of its
//   kv-head (Dh*elt bytes each, at a stride of Hkv*Dh*elt in the pool) into
//   a ring of 3 (bf16) or 2 (fp32) stages, so two tiles (16 KB in bf16 at
//   Dh 128) are in flight while one is computed.  Rows are padded by 16 B
//   so the 8 rows a quarter warp (or an ldmatrix phase) reads fall on
//   distinct banks.  An unmapped (-1) or out-of-pool table entry, a
//   position past the split or past the last query, is never loaded: the
//   copy zero-fills the row (src-size 0) and the score is masked.
// * Scores per tile, not per position.  Each warp owns 8 of the tile's
//   token rows and keeps its own online softmax over them, so a tile needs
//   no block barrier beyond the ring's; each row's max and sum are reduced
//   once per tile; the 4 warps' states merge through shared memory at the
//   end.  Decode (kernel 1), and every fp32 instantiation, run on the CUDA
//   cores (FmaEngine): the 4 lanes of a token row score a quarter of Dh
//   each against every query row (q pre-scaled in fp32 in shared memory)
//   and sum with 2 shuffles; max and sum over the warp's 8 rows take 3 + 3
//   shuffles per query row and tile; in the PV product each lane owns
//   Dh/32 columns of every query row.  The bf16 verify (kernel 4) runs on
//   the tensor cores (MmaEngine): the T*G <= 16 query rows are the M of
//   mma.sync.m16n8k16; each warp computes its 16 x 8 scores from unscaled
//   bf16 q (A fragments in registers) and K (ldmatrix), scales them in
//   fp32, masks each query row's causal limit as a select on the
//   accumulator fragment; P (fp32) is split into bf16 hi + lo and
//   multiplied with V (ldmatrix.trans) by two m16n8k8 products, so PV
//   keeps ~16 bits of p.  fp32 pools never go through TF32.  Both skip
//   the accumulator rescale of a tile where no row's max moved.
// * Kernel 4 at T = 1 launches exactly kernel 1's instantiation with the
//   same plan, so it is bitwise kernel 1.
//
// Left for later: TMA bulk copies with mbarriers in place of cp.async,
// wgmma (needs 64 query rows; a verify has 16), persistent CTAs that walk
// several (row, kv-head, split) items, and a single-launch merge.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;            // token rows per ring stage
constexpr int kMaxSplitPages = 2048; // table entries a CTA stages
constexpr float kNegInf = -1e30f;    // NEG_INF of the reference
constexpr float kEmpty = kNegInf * 0.5f;   // m at or below: no valid key

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

// the ring of K/V tiles in dynamic shared memory, then the split's table
template <typename T, int DH>
struct Ring {
  static constexpr int kRowBytes = DH * (int)sizeof(T);
  static constexpr int kStride = kRowBytes + 16;
  static constexpr int kChunks = kRowBytes / 16;
  static constexpr int kStages = sizeof(T) == 2 ? 3 : 2;
  static constexpr int kBytes = kStages * 2 * kTile * kStride;
  static constexpr int kMinBlocks = sizeof(T) == 2 ? 3 : 2;
  __device__ static unsigned char* row(unsigned char* base, int stage,
                                       int kv, int r) {
    return base + ((stage * 2 + kv) * kTile + r) * kStride;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(pred ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// output row of CTA row j: token (r0 + j) / g of head h*g + (r0 + j) % g
__device__ __forceinline__ int out_row(const Params& p, int b, int h,
                                       int r) {
  return (b * p.t_count + r / p.g) * p.hq + h * p.g + r % p.g;
}

// one query row's result: the output (one split) or the split's partial
template <typename T>
__device__ __forceinline__ void emit(const Params& p, int split, int orow,
                                     int d, int dh, float m, float l,
                                     float acc) {
  if (p.num_splits == 1) {
    store1(static_cast<T*>(p.out) + (size_t)orow * dh + d,
           m > kEmpty ? acc / fmaxf(l, 1e-30f) : 0.f);
    return;
  }
  const size_t s_rows = (size_t)p.num_splits * p.rows_total;
  const size_t i = (size_t)split * p.rows_total + orow;
  if (m > kEmpty) p.part[2 * s_rows + i * dh + d] = acc;   // else unread
  if (d == 0) {
    p.part[i] = m;
    p.part[s_rows + i] = l;
  }
}

// The positions a CTA reads: [a1, e1) (the part of its split inside the
// sink) then [a2, e2) (the part inside the loosest query's window, up to
// the last query), each cut into kTile-row tiles from its start.
struct Span {
  int a1, e1, a2, e2, n1, n;
  __device__ void tile(int k, int& start, int& end) const {
    if (k < n1) {
      start = a1 + k * kTile;
      end = e1;
    } else {
      start = a2 + (k - n1) * kTile;
      end = e2;
    }
  }
};

__device__ __forceinline__ Span make_span(const Params& p, int split,
                                          int base, int last) {
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
  s.n1 = (s.e1 - s.a1 + kTile - 1) / kTile;
  s.n = s.n1 + (s.e2 - s.a2 + kTile - 1) / kTile;
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

// table entry of pos is mapped to a page of the pool
__device__ __forceinline__ bool mapped(const Params& p, const int* s_tbl,
                                       int first, int pos) {
  const int pid = s_tbl[page_of(p, pos) - first];
  return pid >= 0 && pid < p.num_pages;
}

// ---------------------------------------------------------------------------
// both engines: each warp keeps its own online softmax over 8 token rows of
// every tile; at the end the 4 warps' states (m, l [kWarps][GT] and acc
// [kWarps][GT][DH] in shared memory) merge into one query row's result
// ---------------------------------------------------------------------------
template <typename T, int DH, int GT>
__device__ void merge_warps(const Params& p, const float (*sm)[GT],
                            const float (*sl)[GT], const float* s_acc,
                            int split, int b, int h, int r0, int nr) {
  for (int idx = threadIdx.x; idx < nr * DH; idx += kThreads) {
    const int j = idx / DH, d = idx % DH;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm[w][j]);
    float ls = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (sm[w][j] > kEmpty) {
        const float cw = expf(sm[w][j] - mx);
        ls += sl[w][j] * cw;
        o += s_acc[(w * GT + j) * DH + d] * cw;
      }
    }
    emit<T>(p, split, out_row(p, b, h, r0 + j), d, DH, mx, ls, o);
  }
}

// N consecutive elements of T as floats (4, 8 or 16 bytes)
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

// ---------------------------------------------------------------------------
// CUDA-core engine: kernel 1 and every fp32 instantiation.  Warp w owns
// token rows 8w..8w+7 of every tile.  Lane 8c + t scores token row t
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
  using R = Ring<T, DH>;
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

  __device__ void tile(const Params& p, unsigned char* ring, int stage,
                       const int* s_tbl, int first, int start, int end) {
    const int tok = 8 * warp + t;
    const int pos = start + tok;
    const bool ok = pos < end && mapped(p, s_tbl, first, pos);
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
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
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
  using R = Ring<T, DH>;
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

  __device__ void tile(const Params& p, unsigned char* ring, int stage,
                       const int* s_tbl, int first, int start, int end) {
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
    // c[2hh + e]: query row lane/4 + 8hh, token row tok0 + 2(lane%4) + e
    const int pos0 = start + tok0 + 2 * (lane % 4);
    bool ok[2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      ok[e] = pos0 + e < end && mapped(p, s_tbl, first, pos0 + e);
    float pr[4], corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float s[2];
      bool v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float sc = c[2 * hh + e] * p.scale;
        if (p.softcap > 0.f) sc = p.softcap * tanhf(sc / p.softcap);
        v[e] = ok[e] && row_sees(p, pos0 + e, qp[hh]);
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
template <typename T, int DH, int GT, bool MULTI, bool MMA>
struct EngineOf {
  using type = FmaEngine<T, DH, GT, MULTI>;
};
template <int DH>
struct EngineOf<__nv_bfloat16, DH, 16, true, true> {
  using type = MmaEngine<DH>;
};

template <typename T, int DH, int GT, bool MULTI, bool MMA>
__global__ void __launch_bounds__(kThreads, Ring<T, DH>::kMinBlocks)
paged_attn_kernel(const Params p) {
  using R = Ring<T, DH>;
  using E = typename EngineOf<T, DH, GT, MULTI, MMA>::type;
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
  const Span span = make_span(p, split, base, last);
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
  // 4 threads per token row: one table lookup each, then 16-byte copies
  // of chunks lane%4, lane%4 + 4, ... (each copy instruction of a warp
  // reads 64 contiguous bytes of 8 rows)
  static_assert(kThreads == 4 * kTile && R::kChunks % 4 == 0, "loader");
  auto load_tile = [&](int k) {
    int start, end;
    span.tile(k, start, end);
    const int stage = k % R::kStages;
    const int r = threadIdx.x / 4, pos = start + r;
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
    unsigned char* kdst = R::row(ring, stage, 0, r);
    unsigned char* vdst = R::row(ring, stage, 1, r);
#pragma unroll
    for (int j = 0; j < R::kChunks / 4; ++j) {
      const int byte = (threadIdx.x % 4 + 4 * j) * 16;
      cp_async16(kdst + byte, ksrc + (ok ? byte : 0), ok);
      cp_async16(vdst + byte, vsrc + (ok ? byte : 0), ok);
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
    int start, end;
    span.tile(k, start, end);
    eng.tile(p, ring, k % R::kStages, s_tbl, first, start, end);
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

struct Choice {
  KernelFn fn;
  int gt;
  int ring_bytes;
};

// rows = T*G query rows per (row, kv-head); a decode (t_count = 1) takes
// the smallest width in {1,2,4,8} that holds them, a verify {2,4,8,16}
// (fp32) or 16 (bf16, the tensor-core M); grid.z covers the rest, at most
// 8 (decode) or 16 (verify) rows per CTA, as the wrapper's row_groups.
template <typename T, int DH>
Choice choose(int t_count, int rows) {
  const int ring = Ring<T, DH>::kBytes;
  if (t_count == 1) {
    if (rows <= 1) return {&paged_attn_kernel<T, DH, 1, false, false>, 1, ring};
    if (rows <= 2) return {&paged_attn_kernel<T, DH, 2, false, false>, 2, ring};
    if (rows <= 4) return {&paged_attn_kernel<T, DH, 4, false, false>, 4, ring};
    return {&paged_attn_kernel<T, DH, 8, false, false>, 8, ring};
  }
  if constexpr (sizeof(T) == 2) {
    return {&paged_attn_kernel<T, DH, 16, true, true>, 16, ring};
  } else {
    if (rows <= 2) return {&paged_attn_kernel<T, DH, 2, true, false>, 2, ring};
    if (rows <= 4) return {&paged_attn_kernel<T, DH, 4, true, false>, 4, ring};
    if (rows <= 8) return {&paged_attn_kernel<T, DH, 8, true, false>, 8, ring};
    return {&paged_attn_kernel<T, DH, 16, true, false>, 16, ring};
  }
}

// every instantiation may take ring + the largest table as dynamic shared
// memory (above the default 48 KB), once per device
template <typename T, int DH>
cudaError_t allow_smem_one() {
  const int bytes = Ring<T, DH>::kBytes + kMaxSplitPages * 4;
  for (int t : {1, 2}) {
    for (int rows : {1, 2, 4, 8, 16}) {
      const cudaError_t e = cudaFuncSetAttribute(
          reinterpret_cast<const void*>(choose<T, DH>(t, rows).fn),
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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
