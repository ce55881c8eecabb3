// What csrc/paged_attention.cu (kernels 1 and 4) and
// csrc/decode_attention.cu (kernels 2 and 3) share: the block shape, the
// swizzled K/V ring, the cp.async / ldmatrix / mma.sync wrappers, the
// split partials' layout, and the tokens-as-M tensor-core decode engine for
// bf16 K/V (Bf16MmaEngine) that kernel 1's decode over a page pool and
// kernel 2 over a dense slab both run.  Each source includes it once; the
// kernels around the engine (the split, the page walk or the slab's
// validity bits, the loader) stay in their own source.
//
// Bf16MmaEngine: one decode query token per row, up to 8 query heads of a
// kv-head (G <= 8; grid.z covers more in groups of 8).  What bounds it:
// HBM bytes, 2*Dh*2 bytes per token and kv-head against 4*G*Dh flops.  The
// CUDA-core engine it replaces (FmaEngine: 4 lanes per token row, 2
// shuffles per score, 3 + 3 per query row and tile, Dh/32 columns of every
// query row per lane in PV) did work per byte that grows with G, and was
// bound by issue at G 4 (1.36x its bytes bound at 64 x 4096) and G 8
// (2.7x).  Here the tensor cores take the products, so the instructions
// per token no longer grow with G:
//   * 64-row tiles, warp w owns token rows 16w..16w+15 and keeps its own
//     online softmax over them (no block barrier beyond the ring's); the
//     4 warps' states merge through shared memory at the end;
//   * QK^T: S^T[tok][head] = K[tok][:] . q[head][:] on mma.sync m16n8k16
//     (bf16 in, fp32 accumulate), the 16 token rows the M, the query heads
//     the N (one n8 tile), Dh in Dh/16 k-steps in two chains; the A
//     fragment comes straight from the swizzled ring by ldmatrix.x4, the B
//     fragments are the unscaled bf16 q, in registers for the whole CTA;
//   * the scale, the softcap and the mask are applied in fp32 on the score
//     fragment (c[e]: token gi, head 2ti+e; c[2+e]: token gi+8);
//   * PV: O^T[dim][head] = V^T P^T, M = 16 dims, K = the warp's 16 tokens,
//     N = the heads; A = V^T by ldmatrix.x4.trans from the same ring, B =
//     P^T from the score fragment by movmatrix.trans of its two 8x8 halves;
//     p is split into bf16 hi + lo and each 16 output dims take two
//     products, so PV keeps about 16 bits of p.
// The ring's 16-byte chunks are XOR-swizzled by row (swz), so the 8 rows
// of every ldmatrix phase fall on distinct banks without padding.  The
// kernel's loader writes each tile row's validity beside the ring (R::ok);
// the engine reads nothing else of the addressing.  Its order of
// operations is modelled in plain torch by kernels/ref.py's
// bf16_mma_slab_ref and bf16_mma_paged_ref.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace tcd {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;       // NEG_INF of the reference
constexpr float kEmpty = kNegInf * 0.5f;   // m at or below: no valid key

// chunk c of a row r of 16-byte chunks, XOR-swizzled within each group of
// 8 chunks: 8 rows read at one chunk index fall on distinct banks
__host__ __device__ constexpr int swz(int c, int r) {
  return (c & ~7) | ((c ^ r) & 7);
}

// ---------------------------------------------------------------------------
// the ring: [stage][K,V][TILE rows][Dh*elt + 16 B], then (int8) the tiles'
// scales [stage][K,V][TILE] and every tile row's validity [stage][TILE].
// SWZ (rows of 8 or 16 16-byte chunks) drops the 16-byte padding and
// stores chunk c of row r at chunk swz(c, r) instead: the same distinct
// banks for the tensor-core engines' reads, in less shared memory.
// ---------------------------------------------------------------------------
template <typename TKV, int DH, int TILE, int STAGES, bool SWZ = false>
struct Ring {
  static constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  static constexpr int kRowBytes = DH * (int)sizeof(TKV);
  static constexpr int kStride = SWZ ? kRowBytes : kRowBytes + 16;
  static constexpr int kChunks = kRowBytes / 16;
  static_assert(!SWZ || kChunks % 8 == 0, "the swizzle spans 8 chunks");
  static constexpr int kStages = STAGES;
  static constexpr int kTile = TILE;
  static constexpr int kRowsBytes = kStages * 2 * TILE * kStride;
  static constexpr int kScaleBytes = kInt8 ? kStages * 2 * TILE * 4 : 0;
  static constexpr int kBytes = kRowsBytes + kScaleBytes + kStages * TILE * 4;
  __device__ static unsigned char* row(unsigned char* base, int stage,
                                       int kv, int r) {
    return base + ((stage * 2 + kv) * TILE + r) * kStride;
  }
  // byte ``byte`` of row r (contiguous within each 16-byte chunk)
  __device__ static unsigned char* at(unsigned char* base, int stage, int kv,
                                      int r, int byte) {
    const int off = SWZ ? ((swz(byte >> 4, r) << 4) | (byte & 15)) : byte;
    return row(base, stage, kv, r) + off;
  }
  __device__ static float* scales(unsigned char* base, int stage, int kv) {
    return reinterpret_cast<float*>(base + kRowsBytes)
        + (stage * 2 + kv) * TILE;
  }
  __device__ static int* ok(unsigned char* base, int stage) {
    return reinterpret_cast<int*>(base + kRowsBytes + kScaleBytes)
        + stage * TILE;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(pred ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(pred ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
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
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// ---------------------------------------------------------------------------
// query rows and results: every Params has q, out, part, t_count, hq, g,
// num_splits and rows_total
// ---------------------------------------------------------------------------
// output row of query row r of kv-head h: token r / g, head h*g + r % g of
// row b (a decode has r < g)
template <class P>
__device__ __forceinline__ int out_row(const P& p, int b, int h, int r) {
  return (b * p.t_count + r / p.g) * p.hq + h * p.g + r % p.g;
}

// one query row's result: the output (one split) or the split's partial,
// part = [S][rows] m, [S][rows] l, [S][rows][Dh] acc
template <typename TQ, class P>
__device__ __forceinline__ void emit(const P& p, int split, int orow, int d,
                                     int dh, float m, float l, float acc) {
  if (p.num_splits == 1) {
    store1(static_cast<TQ*>(p.out) + (size_t)orow * dh + d,
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

// the 4 warps' states (m, l [kWarps][GT], acc [kWarps][GT][DH] in shared
// memory) merged into one query row's result
template <typename TQ, int DH, int GT, class P>
__device__ void merge_warps(const P& p, const float (*sm)[GT],
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
    emit<TQ>(p, split, out_row(p, b, h, r0 + j), d, DH, mx, ls, o);
  }
}

// ---------------------------------------------------------------------------
// the tokens-as-M engine for bf16 K/V (see the head of this file).  Lane =
// 4*gi + ti.  STAGES tiles of 64 rows in the ring: 3 at Dh 64 (48 KB, 4
// CTAs per SM), 2 at Dh 128 (64 KB, 3 per SM).
// ---------------------------------------------------------------------------
template <int DH, int STAGES = (DH == 128 ? 2 : 3)>
struct Bf16MmaEngine {
  using R = Ring<__nv_bfloat16, DH, 64, STAGES, true>;
  static constexpr int GT = 8;            // query rows: one n8 tile
  static constexpr int KS = DH / 16;      // k-steps of QK^T, dim tiles of PV
  // CTAs per SM the ring leaves room for (228 KB an SM, 1 KB reserved a
  // CTA, and the staged index): the launch bound's register cap
  static constexpr int kMinBlocks =
      R::kBytes <= 52 * 1024 ? 4 : R::kBytes <= 70 * 1024 ? 3 : 2;
  // loader threads per tile row: each copy instruction of a warp reads a
  // 128-byte piece of 4 rows (with 4 threads, 64-byte pieces of 8 rows,
  // kernel 1 took up to 3% longer at 64 x 4096 on an H100; with 8 an L2
  // prefetch hint on the copies gained nothing more, tools/k12_variants.py)
  static constexpr int kLoadTPR = 8;
  static constexpr bool kMaxShared = true;   // wants the largest carveout
  struct Shared {
    float m[kWarps][GT], l[kWarps][GT];
  };

  Shared& sh;
  const int warp, lane, gi, ti;
  uint32_t qb[KS][2];      // B fragments of the query rows (unscaled bf16)
  float acc[KS][4];        // O^T: dims 16mt + gi (+8) x rows 2ti + {0,1}
  float m[2], l[2];        // rows 2ti + e

  template <class P>
  __device__ Bf16MmaEngine(Shared& s, const P& p, int b, int h, int r0,
                           int nr)
      : sh(s), warp(threadIdx.x / 32), lane(threadIdx.x % 32),
        gi(lane / 4), ti(lane % 4) {
    // lane (gi, ti) holds q[gi][16kk + 2ti, +1] and q[gi][16kk + 8 + 2ti,
    // +1]; element loads, as q rows need no alignment beyond their element
    const unsigned short* q = static_cast<const unsigned short*>(p.q)
        + (size_t)out_row(p, b, h, r0 + min(gi, nr - 1)) * DH + 2 * ti;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const unsigned short* x = q + 16 * kk + 8 * i;
        qb[kk][i] = gi < nr ? (uint32_t)__ldg(x)
                                  | ((uint32_t)__ldg(x + 1) << 16)
                            : 0u;
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      m[e] = kNegInf;
      l[e] = 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < KS; ++mt)
      acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
  }

  // a decode query's limit and window are its span's: nothing per row
  template <class P>
  __device__ void set_base(const P&, int, int, int) {}

  template <class P>
  __device__ void tile(const P& p, unsigned char* ring, int stage) {
    const int tok0 = 16 * warp;
    // ---- S^T = K q^T: A by ldmatrix.x4 (lane l addresses row l % 16 of
    // the warp's 16, chunk 2kk + l / 16), two chains of k-steps
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const int krow = tok0 + (lane & 15), kchunk = lane >> 4;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, R::at(ring, stage, 0, krow, (2 * kk + kchunk) * 16));
      mma_16816(c[kk & 1], a, qb[kk][0], qb[kk][1]);
    }
    // ---- online softmax per query-row column over the warp's 16 rows
    const int* okf = R::ok(ring, stage);
    const bool ok[2] = {okf[tok0 + gi] != 0, okf[tok0 + gi + 8] != 0};
    float pr[4], corr[2];
    bool moved = false;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float sc = (c[0][2 * hh + e] + c[1][2 * hh + e]) * p.scale;
        if (p.softcap > 0.f) sc = p.softcap * tanhf(sc / p.softcap);
        s[hh] = ok[hh] ? sc : kNegInf;
      }
      float mt = fmaxf(s[0], s[1]);
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 8));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 16));
      const float m_new = fmaxf(m[e], mt);
      pr[e] = ok[0] ? expf(s[0] - m_new) : 0.f;
      pr[2 + e] = ok[1] ? expf(s[1] - m_new) : 0.f;
      float lt = pr[e] + pr[2 + e];
      lt += __shfl_xor_sync(0xffffffffu, lt, 4);
      lt += __shfl_xor_sync(0xffffffffu, lt, 8);
      lt += __shfl_xor_sync(0xffffffffu, lt, 16);
      corr[e] = expf(m[e] - m_new);
      moved |= corr[e] != 1.f;
      l[e] = l[e] * corr[e] + lt;
      m[e] = m_new;
    }
    // rescale only when some row's max moved (x 1.0 is exact)
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int mt = 0; mt < KS; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][i] *= corr[i & 1];
    }
    // ---- P^T as B of PV: bf16 hi + lo, transposed by movmatrix
    uint32_t bh[2], bl[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float x0 = pr[2 * hh], x1 = pr[2 * hh + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(hi);
      bh[hh] = movmatrix_trans(*reinterpret_cast<const uint32_t*>(&hi));
      bl[hh] = movmatrix_trans(pack_bf16(x0 - hf.x, x1 - hf.y));
    }
    // ---- O^T += V^T P^T: A by ldmatrix.x4.trans (lane l addresses token
    // l % 8 + 8 (l / 16), chunk 2mt + (l / 8) % 2)
    const int vrow = tok0 + (lane & 7) + ((lane >> 4) << 3);
    const int vchunk = (lane >> 3) & 1;
#pragma unroll
    for (int mt = 0; mt < KS; ++mt) {
      uint32_t a[4];
      ldmatrix_x4_trans(a,
                        R::at(ring, stage, 1, vrow, (2 * mt + vchunk) * 16));
      mma_16816(acc[mt], a, bh[0], bh[1]);
      mma_16816(acc[mt], a, bl[0], bl[1]);
    }
  }

  // merge the 4 warps' states (the ring is free: it holds their acc now)
  template <class P>
  __device__ void finish(const P& p, unsigned char* ring, int split, int b,
                         int h, int r0, int nr) {
    float* s_acc = reinterpret_cast<float*>(ring);    // [warp][row][DH]
    static_assert(kWarps * GT * DH * 4 <= R::kRowsBytes, "s_acc in the ring");
    if (gi == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sh.m[warp][2 * ti + e] = m[e];
        sh.l[warp][2 * ti + e] = l[e];
      }
    }
#pragma unroll
    for (int mt = 0; mt < KS; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s_acc[(warp * GT + 2 * ti + (i & 1)) * DH + 16 * mt + gi
              + 8 * (i >> 1)] = acc[mt][i];
    __syncthreads();
    merge_warps<__nv_bfloat16, DH, GT>(p, sh.m, sh.l, s_acc, split, b, h, r0,
                                       nr);
  }
};

}  // namespace tcd
