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
// Bound: HBM bytes.  Each valid K/V row is read once per (row, kv-head)
// (2*Hkv*Dh*elt bytes per token) against 4*T*Hq*Dh flops per token, far
// below the card's flop/byte balance in bf16.  This version of the verify
// kernel is issue-bound, not byte-bound: per position every warp reduces
// each of its T*G rows' scores with 5 shuffles and 2 exponentials.
//
// Design (simple first version): the TPU walks the page list as the
// sequential innermost grid axis and carries (m, l, acc) in VMEM scratch;
// Hopper blocks run in no order, so one CTA owns one (row, kv-head, group
// of up to GT query rows) and loops over the row's positions itself.  The
// verify kernel folds its T tokens into the head-group axis, as the TPU
// kernel does: the CTA's query rows are the T*G (token, head) pairs of one
// kv-head, so each K/V page is read once per (row, kv-head) for all T
// tokens (GT = 16 covers T*G = 16, the k = 3 verify of a G = 4 model, in
// one CTA).  Each of the CTA's kWarps warps takes every kWarps-th
// position, a lane holds Dh/32 contiguous elements of the K/V row (one 8-
// or 16-byte load), the dot products are reduced with warp shuffles, and
// every warp keeps its own online-softmax state per query row in
// registers.  The loop runs to the last position of the CTA's last token,
// so its bound is warp-uniform; a position past a query's own causal
// limit (or outside its window) scores kNegInf for that query, so masked
// queries add nothing.  The warps' states are merged through shared
// memory at the end.  The per-query mask is compiled into the verify
// instantiations only, so the decode kernel's inner loop is untouched;
// with T = 1 the verify entry launches exactly the decode kernel.  Left for a later PR: split-K across CTAs (B*Hkv CTAs
// seldom fill 132 SMs at decode batch sizes), cp.async/TMA page
// pipelining, several pages per tile, and tensor-core products over the
// T*G query rows.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxRowsDecode = 8;  // query rows per CTA (grid.z covers
constexpr int kMaxRowsVerify = 16; // the rest): decode, verify
constexpr float kNegInf = -1e30f;  // NEG_INF of the reference

template <typename T, int N>
struct Vec;

template <>
struct Vec<float, 4> {
  __device__ static void load(const float* p, float* out) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <>
struct Vec<float, 2> {
  __device__ static void load(const float* p, float* out) {
    float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  }
};
template <>
struct Vec<__nv_bfloat16, 4> {
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&raw.x);
    __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&raw.y);
    float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
    out[0] = fa.x; out[1] = fa.y; out[2] = fb.x; out[3] = fb.y;
  }
};
template <>
struct Vec<__nv_bfloat16, 2> {
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(p);
    float2 fa = __bfloat1622float2(a);
    out[0] = fa.x; out[1] = fa.y;
  }
};

__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// MULTI = false is the decode kernel (one token per row, no per-query
// mask); MULTI = true adds the per-query causal limit of the verify step.
template <typename T, int DH, int GT, bool MULTI>
__global__ void __launch_bounds__(kWarps * 32)
paged_attn_kernel(const T* __restrict__ q,
                  const T* __restrict__ pages_k,
                  const T* __restrict__ pages_v,
                  const int* __restrict__ tables,
                  const int* __restrict__ lengths,
                  T* __restrict__ out,
                  int t_count, int hq, int hkv, int page, int mp,
                  int num_pages, int window, int sink, float softcap,
                  float scale) {
  constexpr int N = DH / 32;              // elements per lane
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int g = hq / hkv;
  const int r0 = blockIdx.z * GT;         // first (token, head) row
  const int nr = min(GT, t_count * g - r0);   // live rows of this CTA
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int base = lengths[b];

  // q slice of every live row, pre-scaled, in registers; row j is token
  // (r0 + j) / g of head h*g + (r0 + j) % g, at position base + token
  float qr[GT][N];
  int qp[GT];
#pragma unroll
  for (int j = 0; j < GT; ++j) {
    if (j < nr) {
      const int t = (r0 + j) / g, gi = (r0 + j) % g;
      const T* qptr = q + (((size_t)b * t_count + t) * hq
                           + (size_t)h * g + gi) * DH + lane * N;
      Vec<T, N>::load(qptr, qr[j]);
#pragma unroll
      for (int e = 0; e < N; ++e) qr[j][e] *= scale;
      qp[j] = base + t;
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) qr[j][e] = 0.f;
      qp[j] = -1;                         // dead row: never updated
    }
  }

  float m[GT], l[GT], acc[GT][N];
#pragma unroll
  for (int j = 0; j < GT; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < N; ++e) acc[j][e] = 0.f;
  }

  // positions past the last token's position or past the table are never
  // valid; the window is loosest for the first token
  const int last = min(MULTI ? base + t_count - 1 : base, mp * page - 1);
  const int* tbl = tables + (size_t)b * mp;
  const size_t row_stride = (size_t)hkv * DH;   // one token of one page

  for (int pos = warp; pos <= last; pos += kWarps) {
    if (window > 0 && !(pos > base - window || pos < sink)) continue;
    const int pid = __ldg(tbl + pos / page);
    // unmapped (-1) entries are masked; an id outside the pool would be a
    // caller bug and is masked too rather than read out of bounds
    if (pid < 0 || pid >= num_pages) continue;
    const size_t off = ((size_t)pid * page + pos % page) * row_stride
                       + (size_t)h * DH + lane * N;
    float kr[N], vr[N];
    Vec<T, N>::load(pages_k + off, kr);
    Vec<T, N>::load(pages_v + off, vr);
#pragma unroll
    for (int j = 0; j < GT; ++j) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < N; ++e) s += qr[j][e] * kr[e];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      if constexpr (MULTI) {
        // per-query causal limit and window, as a select and not a
        // branch, so the compiler can interleave the rows' shuffle
        // chains: a masked score is kNegInf, which adds nothing once the
        // row has seen a valid key (p underflows to 0), and whatever it
        // adds before that is wiped by corr = 0 at the first valid key,
        // or dropped as a no-valid-key row at the end
        const bool ok = pos <= qp[j]
            && (window <= 0 || pos > qp[j] - window || pos < sink);
        s = ok ? s : kNegInf;
      }
      const float m_new = fmaxf(m[j], s);
      const float corr = expf(m[j] - m_new);
      const float p = expf(s - m_new);
      l[j] = l[j] * corr + p;
#pragma unroll
      for (int e = 0; e < N; ++e) acc[j][e] = acc[j][e] * corr + p * vr[e];
      m[j] = m_new;
    }
  }

  // merge the warps' partial softmax states
  __shared__ float s_m[kWarps][GT];
  __shared__ float s_l[kWarps][GT];
  __shared__ float s_acc[kWarps][GT][DH];
#pragma unroll
  for (int j = 0; j < GT; ++j) {
    if (lane == 0) {
      s_m[warp][j] = m[j];
      s_l[warp][j] = l[j];
    }
#pragma unroll
    for (int e = 0; e < N; ++e) s_acc[warp][j][lane * N + e] = acc[j][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nr * DH; idx += kWarps * 32) {
    const int j = idx / DH, d = idx % DH;
    const int t = (r0 + j) / g, gi = (r0 + j) % g;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][j]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(s_m[w][j] - mx);
      lsum += s_l[w][j] * c;
      o += s_acc[w][j][d] * c;
    }
    // no valid key at all -> zeros, never NaN
    const float res = mx > kNegInf * 0.5f ? o / fmaxf(lsum, 1e-30f) : 0.f;
    store(out + (((size_t)b * t_count + t) * hq + (size_t)h * g + gi) * DH
              + d, res);
  }
}

// rows = t_count * G query rows per (row, kv-head), at most max_rows per
// CTA; GT is the smallest instantiated width that holds min(rows,
// max_rows).  A verify of one token (t_count = 1) launches the decode
// instantiation with the decode cap: exactly the decode kernel.
template <typename T, int DH, bool MULTI>
cudaError_t launch_dh(const void* q, const void* pk, const void* pv,
                      const int* tables, const int* lengths, void* out,
                      int b, int t_count, int hq, int hkv, int page, int mp,
                      int num_pages, int window, int sink, float softcap,
                      float scale, int max_rows, cudaStream_t stream) {
  const int rows = t_count * (hq / hkv);
  const int gt = rows <= 1 ? 1 : rows <= 2 ? 2 : rows <= 4 ? 4
                 : rows <= 8 || max_rows <= 8 ? 8 : 16;
  dim3 grid(b, hkv, (rows + gt - 1) / gt);
  dim3 block(kWarps * 32);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(pk);
  const T* vt = static_cast<const T*>(pv);
  T* ot = static_cast<T*>(out);
#define REPRO_LAUNCH(GT)                                                    \
  paged_attn_kernel<T, DH, GT, MULTI><<<grid, block, 0, stream>>>(          \
      qt, kt, vt, tables, lengths, ot, t_count, hq, hkv, page, mp,          \
      num_pages, window, sink, softcap, scale)
  if constexpr (MULTI) {          // t_count >= 2, so rows >= 2
    if (gt <= 2) REPRO_LAUNCH(2);
    else if (gt == 4) REPRO_LAUNCH(4);
    else if (gt == 8) REPRO_LAUNCH(8);
    else REPRO_LAUNCH(16);
  } else {                        // rows per CTA <= kMaxRowsDecode
    if (gt == 1) REPRO_LAUNCH(1);
    else if (gt == 2) REPRO_LAUNCH(2);
    else if (gt == 4) REPRO_LAUNCH(4);
    else REPRO_LAUNCH(8);
  }
#undef REPRO_LAUNCH
  return cudaGetLastError();
}

int launch(const void* q, const void* pages_k, const void* pages_v,
           const void* tables, const void* lengths, void* out, int b,
           int t_count, int hq, int hkv, int dh, int page, int mp,
           int num_pages, int window, int sink, float softcap, float scale,
           int dtype, int max_rows, void* stream) {
  if (b <= 0 || t_count <= 0 || hkv <= 0 || hq % hkv != 0 || page <= 0
      || mp <= 0)
    return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tables);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DISPATCH(TYPE, DH)                                            \
  return (int)(t_count == 1                                                 \
      ? launch_dh<TYPE, DH, false>(q, pages_k, pages_v, t, len, out, b, 1,  \
                                   hq, hkv, page, mp, num_pages, window,    \
                                   sink, softcap, scale, kMaxRowsDecode, s) \
      : launch_dh<TYPE, DH, true>(q, pages_k, pages_v, t, len, out, b,      \
                                  t_count, hq, hkv, page, mp, num_pages,    \
                                  window, sink, softcap, scale, max_rows, s))
  if (dtype == 0 && dh == 128) REPRO_DISPATCH(float, 128);
  if (dtype == 0 && dh == 64) REPRO_DISPATCH(float, 64);
  if (dtype == 1 && dh == 128) REPRO_DISPATCH(__nv_bfloat16, 128);
  if (dtype == 1 && dh == 64) REPRO_DISPATCH(__nv_bfloat16, 64);
#undef REPRO_DISPATCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns a cudaError_t (0 =
// success); anything the kernel does not take returns
// cudaErrorInvalidValue, though the Python wrappers check it all first.
extern "C" int repro_paged_decode_attention(
    const void* q, const void* pages_k, const void* pages_v,
    const void* tables, const void* lengths, void* out,
    int b, int hq, int hkv, int dh, int page, int mp, int num_pages,
    int window, int sink, float softcap, float scale, int dtype,
    void* stream) {
  return launch(q, pages_k, pages_v, tables, lengths, out, b, 1, hq, hkv, dh,
                page, mp, num_pages, window, sink, softcap, scale, dtype,
                kMaxRowsDecode, stream);
}

// q and out [B,T,Hq,Dh]; lengths [B] = tokens before the verify step.
extern "C" int repro_paged_verify_attention(
    const void* q, const void* pages_k, const void* pages_v,
    const void* tables, const void* lengths, void* out,
    int b, int t_count, int hq, int hkv, int dh, int page, int mp,
    int num_pages, int window, int sink, float softcap, float scale,
    int dtype, void* stream) {
  return launch(q, pages_k, pages_v, tables, lengths, out, b, t_count, hq,
                hkv, dh, page, mp, num_pages, window, sink, softcap, scale,
                dtype, kMaxRowsVerify, stream);
}
