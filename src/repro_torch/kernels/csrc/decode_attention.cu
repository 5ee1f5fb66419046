// Single-token decode attention for Hopper (sm_90a), split over the keys.
//
// Replaces the Pallas TPU kernel decode_attention_grouped in
// src/repro/kernels/decode_attention/kernel.py (wrapper decode_attention in
// ops.py): one query token per sequence attends its gathered K/V; the
// G = H/KH query heads of a KV group share one KV head; the softmax is an
// fp32 online softmax; masked logits are -2^30 (finite, so a fully masked
// row averages V as the oracle does); the output is in q's type.
//
// Bound: bytes.  The work is 4*G*D operations for each key of a group
// against 2*D*sizeof(kv) bytes of K and V, a handful of operations per
// byte, so the card can at best stream K/V once at its memory rate.  What
// the design does about it:
//   * K/V are read once, in their (B, S, KH, D) strides, with no transposed
//     copy.  A warp takes one key row at a time, its 32 lanes splitting D
//     (EPL = D/32 consecutive elements each), so a row is one coalesced
//     vector access.  A warp issues the loads of KB keys before it uses
//     any, to keep enough bytes in flight.
//   * The key loop has a CTA-uniform trip count and no lane- or
//     warp-dependent branch, so the compiler can prove each warp converged
//     at its shuffles and emits no warp-sync sequence around them.
//   * The G query rows of a group stay in registers for the whole stream,
//     so each K/V byte is read once for all G heads.
//   * The keys are cut into splits so that the grid fills the SMs: at
//     B = 8, KH = 2 one CTA per group would leave 116 of 132 SMs idle.
//     Each CTA writes fp32 (max, sum, accumulator) partials for its split;
//     a second small kernel combines them.  With one split the first
//     kernel writes the output itself.
// Query rows: G rows go in chunks of GT <= 8 per CTA (GT a power of two),
// so any G works; D may be anything up to 256 (16, 120, 128, ...).  The
// caller chooses GT and the splits (ops.split_plan); the entry point checks
// them against the kernel's constants.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, as the TPU kernel
constexpr int kWarps = 4;                   // warps per CTA
constexpr int kKB = 4;                      // keys a warp loads at once

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// Load EPL consecutive elements at p into f: vector accesses when `vec`
// (the caller has checked alignment and D % EPL == 0), else one element at
// a time up to `n` valid elements.
template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* __restrict__ p, bool vec,
                                         int n, float (&f)[EPL]) {
  constexpr int kBytes = EPL * static_cast<int>(sizeof(T));
  if (vec) {
    if constexpr (kBytes >= 16) {
      constexpr int kPer = 16 / sizeof(T);
#pragma unroll
      for (int c = 0; c < kBytes / 16; ++c) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + c);
        const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int e = 0; e < kPer; ++e) f[c * kPer + e] = to_f(t[e]);
      }
    } else if constexpr (kBytes == 8) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int e = 0; e < EPL; ++e) f[e] = to_f(t[e]);
    } else if constexpr (kBytes == 4) {
      const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(p));
      const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int e = 0; e < EPL; ++e) f[e] = to_f(t[e]);
    } else {
      f[0] = to_f(p[0]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const float x = to_f(p[e < n ? e : 0]);  // p[0] is always readable
      f[e] = e < n ? x : 0.f;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid.x: key split; grid.y: (b * KH + kh) * n_gchunks + gchunk.
// q: (B, H, D) contiguous; k, v: strides (k_sb, k_ss, k_sh, 1) in elements;
// mask: uint8 rows of S with row stride m_sb (0 = one row shared by all b);
// out: (B, H, D) contiguous; ws_acc: (B*H, n_splits, D) fp32;
// ws_ml: (B*H, n_splits, 2) fp32.
template <typename T, int GT, int EPL>
__global__ void __launch_bounds__(kWarps * 32)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const uint8_t* __restrict__ mask, T* __restrict__ out,
                      float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                      int S, int KH, int G, int D, long long k_sb,
                      long long k_ss, long long k_sh, long long m_sb,
                      int n_splits, int split_len, float scale, bool vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_gchunks = (G + GT - 1) / GT;
  const int gc = blockIdx.y % n_gchunks;
  const int bk = blockIdx.y / n_gchunks;
  const int kh = bk % KH, b = bk / KH;
  const int g0 = gc * GT;
  const int gn = min(GT, G - g0);
  const int H = KH * G;
  const int d0 = lane * EPL;
  const int dn = min(EPL, D - d0);  // valid elements of this lane (<= 0: none)
  // Lanes past D read column 0 (always valid) and hold zero q, so they add
  // nothing to the dot products; their accumulators are never written out.
  const int dc = dn > 0 ? d0 : 0;
  const int dl = dn > 0 ? dn : 1;

  float qf[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    load_row<T, EPL>(q + ((size_t)b * H + kh * G + g0 + min(g, gn - 1)) * D +
                         dc, vec, dl, qf[g]);
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qf[g][e] = (g < gn && dn > 0) ? qf[g][e] : 0.f;
  }

  float m[GT], l[GT], acc[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const int split = blockIdx.x;
  const int s_begin = split * split_len;
  const int s_end = min(S, s_begin + split_len);
  const T* kbase = k + (size_t)b * k_sb + (size_t)kh * k_sh + dc;
  const T* vbase = v + (size_t)b * k_sb + (size_t)kh * k_sh + dc;
  const uint8_t* mrow = mask + (size_t)b * m_sb;

  // Every warp runs the same, CTA-uniform number of iterations and takes
  // no lane- or warp-dependent branch, so the warp shuffles below need no
  // reconvergence handling.  Keys past the split's end are read at its
  // last row and dropped by selects.
  const int per_it = kWarps * kKB;
  const int n_it = (s_end - s_begin + per_it - 1) / per_it;
  for (int it = 0; it < n_it; ++it) {
    const int s0 = s_begin + (it * kWarps + warp) * kKB;
    float kf[kKB][EPL], vf[kKB][EPL];
    bool in[kKB], live[kKB];
#pragma unroll
    for (int j = 0; j < kKB; ++j) {
      in[j] = s0 + j < s_end;
      const int s = in[j] ? s0 + j : s_end - 1;
      load_row<T, EPL>(kbase + (size_t)s * k_ss, vec, dl, kf[j]);
      load_row<T, EPL>(vbase + (size_t)s * k_ss, vec, dl, vf[j]);
      const bool valid = mrow[s] != 0;
      live[j] = in[j] && valid;
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g >= gn) break;
      float sc[kKB];
      float mx = m[g];
#pragma unroll
      for (int j = 0; j < kKB; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot += qf[g][e] * kf[j][e];
        dot = warp_sum(dot);
        sc[j] = live[j] ? dot * scale : kNegInf;
        mx = in[j] ? fmaxf(mx, sc[j]) : mx;
      }
      const float corr = expf(m[g] - mx);
      float lsum = l[g] * corr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int j = 0; j < kKB; ++j) {
        const float p = in[j] ? expf(sc[j] - mx) : 0.f;
        lsum += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] += p * vf[j][e];
      }
      l[g] = lsum;
      m[g] = mx;
    }
  }

  // Combine the warps of this CTA.
  __shared__ float sm_ml[kWarps][GT][2];
  __shared__ float sm_acc[kWarps][GT][32 * EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (lane == 0) {
      sm_ml[warp][g][0] = m[g];
      sm_ml[warp][g][1] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][g][d0 + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < gn * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_ml[w][g][0]);
    float ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_ml[w][g][0] - mx);
      ls += sm_ml[w][g][1] * c;
      a += sm_acc[w][g][d] * c;
    }
    const size_t row = (size_t)b * H + kh * G + g0 + g;
    if (n_splits == 1) {
      out[row * D + d] = from_f<T>(a / fmaxf(ls, 1e-30f));
    } else {
      ws_acc[(row * n_splits + split) * D + d] = a;
      if (d == 0) {
        ws_ml[(row * n_splits + split) * 2] = mx;
        ws_ml[(row * n_splits + split) * 2 + 1] = ls;
      }
    }
  }
}

// grid.x: B*H rows; each thread one or more of the D outputs.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ ws_acc,
                                      const float* __restrict__ ws_ml,
                                      T* __restrict__ out, int D,
                                      int n_splits) {
  const size_t row = blockIdx.x;
  const float* ml = ws_ml + row * n_splits * 2;
  float mx = kNegInf;
  for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, ml[2 * s]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float ls = 0.f, a = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float c = expf(ml[2 * s] - mx);
      ls += ml[2 * s + 1] * c;
      a += ws_acc[(row * n_splits + s) * D + d] * c;
    }
    out[row * D + d] = from_f<T>(a / fmaxf(ls, 1e-30f));
  }
}

struct Args {
  const void *q, *k, *v, *mask;
  void *out, *ws_acc, *ws_ml;
  int B, S, KH, G, D;
  long long k_sb, k_ss, k_sh, m_sb;
  int n_splits, split_len;
  float scale;
  bool vec;
  cudaStream_t stream;
};

template <typename T, int GT, int EPL>
void launch_partial(const Args& a) {
  const int n_gchunks = (a.G + GT - 1) / GT;
  dim3 grid(a.n_splits, a.B * a.KH * n_gchunks);
  decode_partial_kernel<T, GT, EPL><<<grid, kWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const uint8_t*>(a.mask),
      static_cast<T*>(a.out), static_cast<float*>(a.ws_acc),
      static_cast<float*>(a.ws_ml), a.S, a.KH, a.G, a.D, a.k_sb, a.k_ss,
      a.k_sh, a.m_sb, a.n_splits, a.split_len, a.scale, a.vec);
}

template <typename T, int GT>
void dispatch_epl(const Args& a, int epl) {
  switch (epl) {
    case 1: launch_partial<T, GT, 1>(a); break;
    case 2: launch_partial<T, GT, 2>(a); break;
    case 4: launch_partial<T, GT, 4>(a); break;
    default: launch_partial<T, GT, 8>(a); break;
  }
}

template <typename T>
void run(const Args& a, int gt, int epl) {
  switch (gt) {
    case 1: dispatch_epl<T, 1>(a, epl); break;
    case 2: dispatch_epl<T, 2>(a, epl); break;
    case 4: dispatch_epl<T, 4>(a, epl); break;
    default: dispatch_epl<T, 8>(a, epl); break;
  }
  if (a.n_splits > 1) {
    const int threads = a.D < 128 ? 32 * ((a.D + 31) / 32) : 128;
    decode_combine_kernel<T><<<a.B * a.KH * a.G, threads, 0, a.stream>>>(
        static_cast<const float*>(a.ws_acc),
        static_cast<const float*>(a.ws_ml), static_cast<T*>(a.out), a.D,
        a.n_splits);
  }
}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace

// q: (B, H, D) contiguous; k, v: (B, S, KH, D) with strides
// (k_sb, k_ss, k_sh, 1) in elements, the same for both; mask: uint8 with
// row stride m_sb (0 when one (S,) row is shared); out: (B, H, D); ws_acc
// and ws_ml: fp32 workspaces of B*H*n_splits*D and B*H*n_splits*2 floats
// (unused when n_splits == 1).  dtype 0 = float32, 1 = bfloat16.
// gt: query rows per CTA, 1, 2, 4 or 8.  Keys [i*split_len,
// (i+1)*split_len) form split i; split_len is a multiple of kWarps*kKB.  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* out,
    void* ws_acc, void* ws_ml, int B, int S, int KH, int G, int D,
    long long k_sb, long long k_ss, long long k_sh, long long m_sb, int gt,
    int n_splits, int split_len, float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || G <= 0 || D <= 0 || D > 256 ||
      (gt != 1 && gt != 2 && gt != 4 && gt != 8) || n_splits <= 0 ||
      split_len <= 0 || split_len % (kWarps * kKB) != 0 ||
      (long long)n_splits * split_len < S || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int epl = pow2_at_least((D + 31) / 32);
  const int elem = dtype == 0 ? 4 : 2;
  const int vbytes = epl * elem;
  const int abytes = vbytes < 16 ? vbytes : 16;
  const bool vec = D % epl == 0 && k_sb % epl == 0 && k_ss % epl == 0 &&
                   k_sh % epl == 0 && aligned(q, abytes) &&
                   aligned(k, abytes) && aligned(v, abytes);
  Args a{q, k, v, mask, out, ws_acc, ws_ml, B, S, KH, G, D,
         k_sb, k_ss, k_sh, m_sb, n_splits, split_len, scale, vec,
         static_cast<cudaStream_t>(stream)};
  if (dtype == 0) run<float>(a, gt, epl);
  else run<__nv_bfloat16>(a, gt, epl);
  return static_cast<int>(cudaGetLastError());
}
