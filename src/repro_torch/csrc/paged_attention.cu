// Paged flash-decode for Hopper (sm_90a): the R-Part attention of one
// decode step over a block-table KV page pool.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (_kernel, wrapped by paged_decode_attention).  Same function: one query
// token per row, q [B,Hq,Dh] grouped into [B,Hkv,G,Dh]; the pool
// pages_k/v [P,page,Hkv,Dh] is read through tables [B,MP] (int32, -1 =
// unmapped); slot j of table entry i is absolute position i*page+j; a
// position is valid when it is mapped, <= lengths[b] and (window > 0)
// inside the window or the sink.  Optional tanh softcap, scale 1/sqrt(Dh),
// fp32 online softmax; a row with no valid key writes zeros.  The pool is
// read-only here, so two rows may share a page.
//
// Bound: HBM bytes.  Each valid K/V row is read once (2*Hkv*Dh*elt bytes
// per token) against 4*Hq*Dh flops per token, far below the card's
// flop/byte balance.
//
// Design (simple first version): the TPU walks the page list as the
// sequential innermost grid axis and carries (m, l, acc) in VMEM scratch;
// Hopper blocks run in no order, so one CTA owns one (row, kv-head, group
// of up to 8 query heads) and loops over the row's positions itself.  Each
// of the CTA's kWarps warps takes every kWarps-th position, a lane holds Dh/32
// contiguous elements of the K/V row (one 8- or 16-byte load), the G dot
// products are reduced with warp shuffles, and every warp keeps its own
// online-softmax state in registers.  The warps' states are merged through
// shared memory at the end.  Left for a later PR: split-K across CTAs
// (B*Hkv CTAs seldom fill 132 SMs at decode batch sizes), cp.async/TMA
// page pipelining, and several pages per tile.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxGroup = 8;       // query heads per CTA (grid.z covers G)
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

template <typename T, int DH, int GT>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q,
                    const T* __restrict__ pages_k,
                    const T* __restrict__ pages_v,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths,
                    T* __restrict__ out,
                    int hq, int hkv, int page, int mp, int num_pages,
                    int window, int sink, float softcap, float scale) {
  constexpr int N = DH / 32;              // elements per lane
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int g = hq / hkv;
  const int g0 = blockIdx.z * kMaxGroup;
  const int ng = min(GT, g - g0);         // live heads of this CTA
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // q slice of every live head, pre-scaled, in registers
  float qr[GT][N];
#pragma unroll
  for (int j = 0; j < GT; ++j) {
    if (j < ng) {
      const T* qp = q + ((size_t)b * hq + (size_t)h * g + g0 + j) * DH
                    + lane * N;
      Vec<T, N>::load(qp, qr[j]);
#pragma unroll
      for (int e = 0; e < N; ++e) qr[j][e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) qr[j][e] = 0.f;
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

  const int qpos = lengths[b];
  // positions past qpos or past the table are never valid
  const int last = min(qpos, mp * page - 1);
  const int* tbl = tables + (size_t)b * mp;
  const size_t row_stride = (size_t)hkv * DH;   // one token of one page

  for (int pos = warp; pos <= last; pos += kWarps) {
    if (window > 0 && !(pos > qpos - window || pos < sink)) continue;
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
  for (int idx = threadIdx.x; idx < ng * DH; idx += kWarps * 32) {
    const int j = idx / DH, d = idx % DH;
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
    store(out + ((size_t)b * hq + (size_t)h * g + g0 + j) * DH + d, res);
  }
}

template <typename T, int DH>
cudaError_t launch_dh(const void* q, const void* pk, const void* pv,
                      const int* tables, const int* lengths, void* out,
                      int b, int hq, int hkv, int page, int mp,
                      int num_pages, int window, int sink, float softcap,
                      float scale, cudaStream_t stream) {
  const int g = hq / hkv;
  dim3 grid(b, hkv, (g + kMaxGroup - 1) / kMaxGroup);
  dim3 block(kWarps * 32);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(pk);
  const T* vt = static_cast<const T*>(pv);
  T* ot = static_cast<T*>(out);
#define REPRO_LAUNCH(GT)                                                    \
  paged_decode_kernel<T, DH, GT><<<grid, block, 0, stream>>>(               \
      qt, kt, vt, tables, lengths, ot, hq, hkv, page, mp, num_pages,        \
      window, sink, softcap, scale)
  if (g == 1) REPRO_LAUNCH(1);
  else if (g == 2) REPRO_LAUNCH(2);
  else if (g <= 4) REPRO_LAUNCH(4);
  else REPRO_LAUNCH(8);
#undef REPRO_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success);
// anything the kernel does not take returns cudaErrorInvalidValue, though
// the Python wrapper checks it all before calling.
extern "C" int repro_paged_decode_attention(
    const void* q, const void* pages_k, const void* pages_v,
    const void* tables, const void* lengths, void* out,
    int b, int hq, int hkv, int dh, int page, int mp, int num_pages,
    int window, int sink, float softcap, float scale, int dtype,
    void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || page <= 0 || mp <= 0)
    return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tables);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dh == 128)
    return (int)launch_dh<float, 128>(q, pages_k, pages_v, t, len, out, b, hq,
                                      hkv, page, mp, num_pages, window, sink,
                                      softcap, scale, s);
  if (dtype == 0 && dh == 64)
    return (int)launch_dh<float, 64>(q, pages_k, pages_v, t, len, out, b, hq,
                                     hkv, page, mp, num_pages, window, sink,
                                     softcap, scale, s);
  if (dtype == 1 && dh == 128)
    return (int)launch_dh<__nv_bfloat16, 128>(q, pages_k, pages_v, t, len,
                                              out, b, hq, hkv, page, mp,
                                              num_pages, window, sink,
                                              softcap, scale, s);
  if (dtype == 1 && dh == 64)
    return (int)launch_dh<__nv_bfloat16, 64>(q, pages_k, pages_v, t, len,
                                             out, b, hq, hkv, page, mp,
                                             num_pages, window, sink,
                                             softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}
