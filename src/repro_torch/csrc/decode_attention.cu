// Dense-slab flash-decode for Hopper (sm_90a): the R-Part attention of one
// decode step over a per-row KV slab, with bf16/fp32 or int8 storage.
//
// Replaces two Pallas TPU kernels that compute the same function:
//   * src/repro/kernels/decode_attention.py (_kernel, wrapped by
//     decode_attention): K/V in the query's dtype;
//   * src/repro/kernels/quant_kv.py (_kernel, wrapped by
//     decode_attention_int8): int8 K/V with one fp32 scale per
//     (token, kv-head), dequantized in fp32 (never rounded to bf16 first).
// One query token per row, q [B,Hq,Dh] grouped into [B,Hkv,G,Dh]; the slab
// k/v [B,S,Hkv,Dh] holds absolute positions in pos [B,S] (-1 = empty slot;
// windowed caches are stored in ring order, so validity comes from pos and
// never from the slot index).  A slot is valid when pos >= 0, pos <=
// lengths[b] and, with window > 0, inside the window or the sink.  Scale
// 1/sqrt(Dh), then the optional tanh softcap, fp32 online softmax from
// -1e30; a row with no valid slot writes exactly 0.  The output has q's
// dtype.  No padding of S is needed: the loop runs to S with a bounds
// check where the TPU pads with pos = -1.
//
// Bound: HBM bytes.  Each valid K/V row is read once (2*Hkv*Dh*elt bytes
// per token, plus 2*Hkv*4 bytes of scales for int8) against 4*Hq*Dh flops
// per token, far below the card's flop/byte balance.  int8 storage reads
// ~3.9x fewer bytes than bf16 at Dh 128.
//
// Design (simple first version, as csrc/paged_attention.cu): one CTA per
// (row, kv-head, group of up to kMaxGroup query heads) loops over the row's
// slots itself, since Hopper blocks run in no order and cannot carry the
// softmax state across a sequential grid axis as the TPU does.  Every lane
// makes one 16-byte load per K/V row: a token's row is covered by
// L = Dh*elt/16 lanes (8 lanes for an int8 row of Dh 128, 16 for bf16, 32
// for fp32), so a warp covers 32/L tokens per iteration (4 for int8 Dh 128)
// instead of giving each lane a 4-byte piece of a single token.  Each group
// of L lanes keeps its own online-softmax state in registers; the groups of
// a warp merge with shuffles and the warps through shared memory at the
// end.  Invalid slots are not loaded.  The int8 scales are folded into the
// products: s = k_s * (q . k_q) and acc += (p * v_s) * v_q, which equals
// dequantizing first up to fp32 rounding.  Left for a later PR: split-K
// across CTAs, cp.async/TMA pipelining, and a paged-int8 kernel that reads
// the pages in place instead of the gathered slab.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr float kNegInf = -1e30f;  // NEG_INF of the reference

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// one 16-byte load of a K/V row -> kN floats
template <typename T>
struct Load16;

template <>
struct Load16<float> {
  static constexpr int kN = 4;
  __device__ static void run(const float* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

template <>
struct Load16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void run(const __nv_bfloat16* p, float* out) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Load16<int8_t> {
  static constexpr int kN = 16;
  __device__ static void run(const int8_t* p, float* out) {
    const int4 raw = __ldg(reinterpret_cast<const int4*>(p));
    const char4* c = reinterpret_cast<const char4*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[4 * i] = static_cast<float>(c[i].x);
      out[4 * i + 1] = static_cast<float>(c[i].y);
      out[4 * i + 2] = static_cast<float>(c[i].z);
      out[4 * i + 3] = static_cast<float>(c[i].w);
    }
  }
};

// query heads per CTA: int8 lanes hold 16 K/V elements, so 4 heads keep q
// and the accumulators (2*4*16 floats) in registers without spilling
template <typename TKV>
constexpr int max_group() {
  return std::is_same<TKV, int8_t>::value ? 4 : 8;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_s;   // int8 only, else nullptr
  const float* v_s;
  const int* pos;
  const int* lengths;
  void* out;
  int b, s_len, hq, hkv, window, sink;
  float softcap, scale;
};

template <typename TQ, typename TKV, int DH, int GT>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const float* __restrict__ k_s,
              const float* __restrict__ v_s, const int* __restrict__ pos,
              const int* __restrict__ lengths, TQ* __restrict__ out,
              int s_len, int hq, int hkv, int window, int sink,
              float softcap, float scale) {
  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  constexpr int E = Load16<TKV>::kN;      // elements per lane
  constexpr int L = DH / E;               // lanes per token
  constexpr int TPW = 32 / L;             // tokens per warp iteration
  static_assert(L >= 1 && L <= 32 && 32 % L == 0, "unsupported head_dim");
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int g = hq / hkv;
  const int g0 = blockIdx.z * GT;
  const int ng = min(GT, g - g0);         // live heads of this CTA
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / L;               // this lane's token in the warp
  const int d0 = (lane % L) * E;          // this lane's first head dim

  // q slice of every live head, pre-scaled, in registers
  float qr[GT][E];
#pragma unroll
  for (int j = 0; j < GT; ++j) {
    if (j < ng) {
      const TQ* qp = q + ((size_t)b * hq + (size_t)h * g + g0 + j) * DH
                     + d0;
#pragma unroll
      for (int e = 0; e < E; ++e) qr[j][e] = to_float(qp[e]) * scale;
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qr[j][e] = 0.f;
    }
  }

  float m[GT], l[GT], acc[GT][E];
#pragma unroll
  for (int j = 0; j < GT; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[j][e] = 0.f;
  }

  const int qpos = lengths[b];
  const int* prow = pos + (size_t)b * s_len;
  const size_t tok_stride = (size_t)hkv * DH;
  const size_t row0 = (size_t)b * s_len;
  const TKV* kb = k + row0 * tok_stride + (size_t)h * DH + d0;
  const TKV* vb = v + row0 * tok_stride + (size_t)h * DH + d0;

  // the loop bound is warp-uniform, so every lane reaches the shuffles
  for (int base = warp * TPW; base < s_len; base += kWarps * TPW) {
    const int t = base + sub;
    bool valid = false;
    if (t < s_len) {
      const int p = __ldg(prow + t);
      valid = p >= 0 && p <= qpos;
      if (window > 0) valid = valid && (p > qpos - window || p < sink);
    }
    float kr[E], vr[E];
    float ks = 1.f, vs = 1.f;
    if (valid) {
      Load16<TKV>::run(kb + (size_t)t * tok_stride, kr);
      Load16<TKV>::run(vb + (size_t)t * tok_stride, vr);
      if constexpr (kInt8) {
        ks = __ldg(k_s + (row0 + t) * hkv + h);
        vs = __ldg(v_s + (row0 + t) * hkv + h);
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) kr[e] = vr[e] = 0.f;
    }
    float sc[GT];
#pragma unroll
    for (int j = 0; j < GT; ++j) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) s += qr[j][e] * kr[e];
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      sc[j] = s * ks;
    }
    if (valid) {
#pragma unroll
      for (int j = 0; j < GT; ++j) {
        float s = sc[j];
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        const float m_new = fmaxf(m[j], s);
        const float corr = expf(m[j] - m_new);
        const float p = expf(s - m_new);
        const float pv = p * vs;
        l[j] = l[j] * corr + p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[j][e] = acc[j][e] * corr + pv * vr[e];
        m[j] = m_new;
      }
    }
  }

  // merge the token groups of each warp (lanes holding the same dims)
#pragma unroll
  for (int o = L; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < GT; ++j) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[j], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[j], o);
      const float mx = fmaxf(m[j], m2);
      const float c1 = expf(m[j] - mx), c2 = expf(m2 - mx);
      l[j] = l[j] * c1 + l2 * c2;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float a2 = __shfl_xor_sync(0xffffffffu, acc[j][e], o);
        acc[j][e] = acc[j][e] * c1 + a2 * c2;
      }
      m[j] = mx;
    }
  }

  // merge the warps' states through shared memory
  __shared__ float s_m[kWarps][GT];
  __shared__ float s_l[kWarps][GT];
  __shared__ float s_acc[kWarps][GT][DH];
  if (lane < L) {
#pragma unroll
    for (int j = 0; j < GT; ++j) {
      if (lane == 0) {
        s_m[warp][j] = m[j];
        s_l[warp][j] = l[j];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) s_acc[warp][j][d0 + e] = acc[j][e];
    }
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
    // no valid slot at all -> zeros, never NaN
    const float res = mx > kNegInf * 0.5f ? o / fmaxf(lsum, 1e-30f) : 0.f;
    store(out + ((size_t)b * hq + (size_t)h * g + g0 + j) * DH + d, res);
  }
}

template <typename TQ, typename TKV, int DH, int GT>
void launch_gt(const Args& a, dim3 grid, cudaStream_t stream) {
  decode_kernel<TQ, TKV, DH, GT><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.k_s, a.v_s, a.pos, a.lengths,
      static_cast<TQ*>(a.out), a.s_len, a.hq, a.hkv, a.window, a.sink,
      a.softcap, a.scale);
}

template <typename TQ, typename TKV, int DH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int kMaxG = max_group<TKV>();
  const int g = a.hq / a.hkv;
  dim3 grid(a.b, a.hkv, (g + kMaxG - 1) / kMaxG);
  if (g == 1) {
    launch_gt<TQ, TKV, DH, 1>(a, grid, stream);
  } else if (g == 2) {
    launch_gt<TQ, TKV, DH, 2>(a, grid, stream);
  } else if (g <= 4 || kMaxG == 4) {
    launch_gt<TQ, TKV, DH, 4>(a, grid, stream);
  } else {
    if constexpr (kMaxG >= 8) launch_gt<TQ, TKV, DH, 8>(a, grid, stream);
  }
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_dh(const Args& a, int dh, cudaStream_t stream) {
  if (dh == 128) return launch<TQ, TKV, 128>(a, stream);
  if (dh == 64) return launch<TQ, TKV, 64>(a, stream);
  return cudaErrorInvalidValue;
}

bool bad_shape(int b, int s_len, int hq, int hkv) {
  return b <= 0 || s_len < 0 || hkv <= 0 || hq <= 0 || hq % hkv != 0;
}

}  // namespace

// Kernel 2.  dtype (of q, k, v and the output): 0 = float32, 1 = bfloat16.
// Returns a cudaError_t (0 = success); anything the kernel does not take
// returns cudaErrorInvalidValue, though the Python wrapper checks it all
// before calling.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* pos,
    const void* lengths, void* out, int b, int s_len, int hq, int hkv,
    int dh, int window, int sink, float softcap, float scale, int dtype,
    void* stream) {
  if (bad_shape(b, s_len, hq, hkv)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, nullptr, nullptr, static_cast<const int*>(pos),
               static_cast<const int*>(lengths), out, b, s_len, hq, hkv,
               window, sink, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_dh<float, float>(a, dh, s);
  if (dtype == 1)
    return (int)launch_dh<__nv_bfloat16, __nv_bfloat16>(a, dh, s);
  return (int)cudaErrorInvalidValue;
}

// Kernel 3.  k_q/v_q int8 [B,S,Hkv,Dh], k_s/v_s float32 [B,S,Hkv];
// q_dtype (of q and the output): 0 = float32, 1 = bfloat16.
extern "C" int repro_decode_attention_int8(
    const void* q, const void* k_q, const void* k_s, const void* v_q,
    const void* v_s, const void* pos, const void* lengths, void* out,
    int b, int s_len, int hq, int hkv, int dh, int window, int sink,
    float softcap, float scale, int q_dtype, void* stream) {
  if (bad_shape(b, s_len, hq, hkv)) return (int)cudaErrorInvalidValue;
  const Args a{q, k_q, v_q, static_cast<const float*>(k_s),
               static_cast<const float*>(v_s), static_cast<const int*>(pos),
               static_cast<const int*>(lengths), out, b, s_len, hq, hkv,
               window, sink, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) return (int)launch_dh<float, int8_t>(a, dh, s);
  if (q_dtype == 1) return (int)launch_dh<__nv_bfloat16, int8_t>(a, dh, s);
  return (int)cudaErrorInvalidValue;
}
