// Causal GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_bhsd in
// src/repro/kernels/flash_attention/kernel.py (wrapper flash_attention in
// ops.py) and keeps its contract, not its blocking: query head h reads KV
// head h / G; query row i sits at position qpos = (T - S) + i and attends
// keys with kpos <= qpos, kpos < T and, where a window is given,
// qpos - kpos < window; scores, the online softmax and the accumulator are
// fp32 whatever the input type (bf16 or fp32); masked logits are -2^30;
// the finished row is divided by max(l, 1e-30); KV tiles that lie wholly
// outside causal ∩ window are never visited.  Tails of S and T are masked
// here: nothing is padded in memory.
//
// Layout: q, k and v are read through their strides in the model layout,
// q (B, S, H, D) and k/v (B, T, KH, D), so the caller makes no transposed
// copy; out is (B, S, H, D) contiguous.
//
// Bound: operations.  Each (query, key) pair costs 4*D operations against
// a few bytes of q, k, v and out per row, so at prefill lengths the work
// is far above the card's bytes-to-operations balance.  What the design
// does about it:
//   * One CTA per (batch, KV head, query tile).  Its 64 rows are
//     (position, head) pairs of the G query heads that share the KV head,
//     BQ = 64 / G positions each, so every K/V tile is brought into shared
//     memory once for all G heads.
//   * bf16 runs on the tensor cores (mma.sync m16n8k16, fp32 accumulate):
//     four warps of 16 rows, 64-key tiles; the scores stay in registers,
//     where the online softmax runs on them, and P goes to the P·V product
//     as bf16 (its row sums l are taken in fp32 before that rounding).
//   * fp32 runs on the CUDA cores (fp32 FMAs from shared memory, eight
//     warps of 8 rows, 32-key tiles, a lane per key for the scores and
//     DP/32 output columns per lane), since the tensor cores would round
//     the inputs.
//   * D is zero-filled to DP (32, 64 or 128) in shared memory, so D = 120
//     and D = 16 need nothing on the host.
//   * The heaviest causal query tiles (the last ones) launch first.
// Shared memory above 48 KB goes through the dynamic shared memory opt-in:
// bf16 52,224 bytes, fp32 74,240 bytes at DP = 128.  wgmma, TMA and warp
// specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, as the TPU kernel
constexpr int kRows = 64;                  // (position, head) rows per CTA

struct Args {
  const void *q, *k, *v;
  void* out;
  int B, S, T, KH, G, D;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh;  // k and v share strides
  int window;                                    // <= 0: none
  float scale;
  bool vec;  // 16-byte loads: D and every stride a multiple of 16 bytes
  cudaStream_t stream;
};

// The CTA's query tile: grid.x is the tile, heaviest (last) first;
// grid.y is b * KH + kh.  Row r is (position q0 + r / G, head kh*G + r % G).
struct Tile {
  int b, kh, q0, nrows, q_lo, kt_lo, kt_hi;

  __device__ __forceinline__ Tile(const Args& a, int bk) {
    const int bq = kRows / a.G;
    kh = blockIdx.y % a.KH;
    b = blockIdx.y / a.KH;
    q0 = (gridDim.x - 1 - blockIdx.x) * bq;
    const int qn = min(bq, a.S - q0);
    nrows = qn * a.G;
    // KV tiles of causal ∩ window: the last holds key q_hi; the first holds
    // key q_lo - window + 1 (the oldest key the first row may see).
    q_lo = a.T - a.S + q0;
    const int q_hi = q_lo + qn - 1;
    kt_hi = min((a.T - 1) / bk, q_hi / bk);
    kt_lo = a.window > 0 ? max(0, q_lo - a.window + 1) / bk : 0;
  }
  // Position of row r (rows past the tile repeat the last one).
  __device__ __forceinline__ int qpos(int r, int G) const {
    return q_lo + min(r, nrows - 1) / G;
  }
  __device__ __forceinline__ long long q_off(const Args& a, int r) const {
    return b * a.q_sb + (long long)(q0 + r / a.G) * a.q_ss +
           (long long)(kh * a.G + r % a.G) * a.q_sh;
  }
  __device__ __forceinline__ long long out_row(const Args& a, int r) const {
    return ((long long)b * a.S + q0 + r / a.G) * (a.KH * a.G) +
           (long long)kh * a.G + r % a.G;
  }
  __device__ __forceinline__ long long kv_off(const Args& a, int key) const {
    return b * a.k_sb + (long long)key * a.k_ss + kh * a.k_sh;
  }
};

__device__ __forceinline__ bool visible(int key, int qpos, const Args& a) {
  return key < a.T && key <= qpos && (a.window <= 0 || qpos - key < a.window);
}

// 16 bytes of a row from element d on, zero past D: one load when `vec`,
// else element by element.
template <typename T>
__device__ __forceinline__ uint4 load16(const T* __restrict__ row, int d,
                                        int D, bool vec) {
  constexpr int kN = 16 / sizeof(T);
  if (d >= D) return make_uint4(0u, 0u, 0u, 0u);
  if (vec) return __ldg(reinterpret_cast<const uint4*>(row + d));
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  T* t = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int e = 0; e < kN; ++e)
    if (d + e < D) t[e] = row[d + e];
  return u;
}

// ------------------------------------------------------------------ //
// bf16: tensor cores (mma.sync.m16n8k16, fp32 accumulate)
// ------------------------------------------------------------------ //

constexpr int kMWarps = kRows / 16;
constexpr int kMThreads = kMWarps * 32;
constexpr int kMBK = 64;  // keys per tile

template <int DP>
struct MmaSmem {
  static constexpr int kStride = DP + 8;  // bf16; +8 spreads the banks
  static constexpr int q = 0;
  static constexpr int k = q + kRows * kStride;
  static constexpr int v = k + kMBK * kStride;
  static constexpr int bytes = (v + kMBK * kStride) * 2;
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragment (k16 x n8) of rows p .. p + 15 of a row-major [k][n] tile,
// columns n0 .. n0 + 7 (p already points at column n0 of row lane % 16).
__device__ __forceinline__ void ldsm_x2_trans(const __nv_bfloat16* p,
                                              uint32_t& b0, uint32_t& b1) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(addr));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Warp w owns rows 16w .. 16w + 15.  In the m16n8 fragments a lane holds
// rows lane/4 and lane/4 + 8 (h = 0, 1) and columns 2*(lane%4) + {0, 1}.
template <int DP>
__global__ void __launch_bounds__(kMThreads)
flash_fwd_mma_kernel(const Args a) {
  using T = __nv_bfloat16;
  constexpr int kS = MmaSmem<DP>::kStride;
  constexpr int kKS = DP / 16;    // k-steps of the scores over D
  constexpr int kND = DP / 8;     // n-tiles of the output over D
  constexpr int kNT = kMBK / 8;   // n-tiles of the scores over the keys
  constexpr int kC = DP / 8;      // 16-byte chunks per row
  extern __shared__ uint4 smem_u4[];
  T* smem = reinterpret_cast<T*>(smem_u4);
  T* sQ = smem + MmaSmem<DP>::q;
  T* sK = smem + MmaSmem<DP>::k;
  T* sV = smem + MmaSmem<DP>::v;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Tile tile(a, kMBK);

  for (int c = tid; c < kRows * kC; c += kMThreads) {
    const int r = c / kC, d = (c % kC) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < tile.nrows) val = load16(q + tile.q_off(a, r), d, a.D, a.vec);
    *reinterpret_cast<uint4*>(sQ + r * kS + d) = val;
  }
  __syncthreads();

  const int r0 = warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  uint32_t qf[kKS][4];
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
    const T* p = sQ + r0 * kS + ks * 16 + cq;
    qf[ks][0] = lds32(p);
    qf[ks][1] = lds32(p + 8 * kS);
    qf[ks][2] = lds32(p + 8);
    qf[ks][3] = lds32(p + 8 * kS + 8);
  }

  int qpos[2];
  float m_i[2], l_i[2], o[kND][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qpos[h] = tile.qpos(r0 + 8 * h, a.G);
    m_i[h] = kNegInf;
    l_i[h] = 0.f;
  }
#pragma unroll
  for (int nd = 0; nd < kND; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nd][i] = 0.f;

  for (int kt = tile.kt_lo; kt <= tile.kt_hi; ++kt) {
    const int k0 = kt * kMBK;
    __syncthreads();  // the last tile's K/V reads are done
    for (int c = tid; c < kMBK * kC; c += kMThreads) {
      const int j = c / kC, d = (c % kC) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + j < a.T) {
        const long long off = tile.kv_off(a, k0 + j);
        kv = load16(k + off, d, a.D, a.vec);
        vv = load16(v + off, d, a.D, a.vec);
      }
      *reinterpret_cast<uint4*>(sK + j * kS + d) = kv;
      *reinterpret_cast<uint4*>(sV + j * kS + d) = vv;
    }
    __syncthreads();

    // Scores S = Q K^T for 16 rows x 64 keys, fp32 in registers.
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
      const T* p = sK + (nt * 8 + (lane >> 2)) * kS + cq;
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks)
        mma_bf16(s[nt], qf[ks], lds32(p + ks * 16), lds32(p + ks * 16 + 8));
    }

    // Mask and online softmax; a row's four lanes (a quad) reduce by
    // shuffles.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1, key = k0 + nt * 8 + cq + (i & 1);
        s[nt][i] = visible(key, qpos[h], a) ? s[nt][i] * a.scale : kNegInf;
        mx[h] = fmaxf(mx[h], s[nt][i]);
      }
    float corr[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_i[h], mx[h]);
      corr[h] = expf(m_i[h] - m_new);
      m_i[h] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = expf(s[nt][i] - m_i[i >> 1]);
        ls[i >> 1] += s[nt][i];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 1);
      ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 2);
      l_i[h] = l_i[h] * corr[h] + ls[h];
    }
#pragma unroll
    for (int nd = 0; nd < kND; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[nd][i] *= corr[i >> 1];

    // o += P V: the score fragments of keys 16kk .. 16kk + 15 are the A
    // fragment of one k-step; V's B fragments come transposed by ldmatrix.
#pragma unroll
    for (int kk = 0; kk < kMBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const T* p = sV + (kk * 16 + (lane & 15)) * kS;
#pragma unroll
      for (int nd = 0; nd < kND; ++nd) {
        uint32_t b0, b1;
        ldsm_x2_trans(p + nd * 8, b0, b1);
        mma_bf16(o[nd], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= tile.nrows) continue;
    T* row = out + tile.out_row(a, r) * a.D;
    const float l = fmaxf(l_i[h], 1e-30f);
#pragma unroll
    for (int nd = 0; nd < kND; ++nd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = nd * 8 + cq + e;
        if (d < a.D) row[d] = __float2bfloat16(o[nd][2 * h + e] / l);
      }
  }
}

// ------------------------------------------------------------------ //
// fp32: CUDA cores
// ------------------------------------------------------------------ //

constexpr int kFWarps = 8;
constexpr int kFThreads = kFWarps * 32;
constexpr int kRPW = kRows / kFWarps;  // rows per warp
constexpr int kFBK = 32;               // keys per tile: one per lane

template <int DP>
struct SimtSmem {
  static constexpr int kKStride = DP + 4;  // floats; +4 spreads the banks
  static constexpr int q = 0;
  static constexpr int k = q + kRows * DP;
  static constexpr int v = k + kFBK * kKStride;
  static constexpr int p = v + kFBK * DP;
  static constexpr int bytes = (p + kRows * kFBK) * 4;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// EPL consecutive floats of shared memory at p (aligned to EPL floats).
template <int EPL>
__device__ __forceinline__ void lds(const float* p, float (&f)[EPL]) {
  if constexpr (EPL == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  } else if constexpr (EPL == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    f[0] = u.x; f[1] = u.y;
  } else {
    f[0] = p[0];
  }
}

// Warp w owns rows kRPW*w .. kRPW*w + kRPW - 1.
template <int DP>
__global__ void __launch_bounds__(kFThreads, 2)
flash_fwd_simt_kernel(const Args a) {
  constexpr int EPL = DP / 32;
  constexpr int kKS = SimtSmem<DP>::kKStride;
  constexpr int kC = DP / 4;  // 16-byte chunks per row
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* sQ = smem + SimtSmem<DP>::q;
  float* sK = smem + SimtSmem<DP>::k;
  float* sV = smem + SimtSmem<DP>::v;
  float* sP = smem + SimtSmem<DP>::p;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  float* out = static_cast<float*>(a.out);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Tile tile(a, kFBK);

  for (int c = tid; c < kRows * kC; c += kFThreads) {
    const int r = c / kC, d = (c % kC) * 4;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < tile.nrows) val = load16(q + tile.q_off(a, r), d, a.D, a.vec);
    *reinterpret_cast<uint4*>(sQ + r * DP + d) = val;
  }

  float m_i[kRPW], l_i[kRPW], acc[kRPW][EPL];
  int qpos[kRPW];
#pragma unroll
  for (int m = 0; m < kRPW; ++m) {
    qpos[m] = tile.qpos(warp * kRPW + m, a.G);
    m_i[m] = kNegInf;
    l_i[m] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[m][e] = 0.f;
  }
  float* pw = sP + warp * kRPW * kFBK;
  const float* qw = sQ + warp * kRPW * DP;

  for (int kt = tile.kt_lo; kt <= tile.kt_hi; ++kt) {
    const int k0 = kt * kFBK;
    __syncthreads();  // the last tile's K/V reads are done (and Q stored)
    for (int c = tid; c < kFBK * kC; c += kFThreads) {
      const int j = c / kC, d = (c % kC) * 4;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + j < a.T) {
        const long long off = tile.kv_off(a, k0 + j);
        kv = load16(k + off, d, a.D, a.vec);
        vv = load16(v + off, d, a.D, a.vec);
      }
      *reinterpret_cast<uint4*>(sK + j * kKS + d) = kv;
      *reinterpret_cast<uint4*>(sV + j * DP + d) = vv;
    }
    __syncthreads();

    // Scores: lane = key k0 + lane, kRPW rows of this warp.
    float s[kRPW];
#pragma unroll
    for (int m = 0; m < kRPW; ++m) s[m] = 0.f;
    const float* kr = sK + lane * kKS;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int m = 0; m < kRPW; ++m) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + m * DP + d);
        s[m] = fmaf(qv.x, kv.x, s[m]);
        s[m] = fmaf(qv.y, kv.y, s[m]);
        s[m] = fmaf(qv.z, kv.z, s[m]);
        s[m] = fmaf(qv.w, kv.w, s[m]);
      }
    }

    // Online softmax, one row at a time across the warp's lanes.
    const int key = k0 + lane;
#pragma unroll
    for (int m = 0; m < kRPW; ++m) {
      const float sc = visible(key, qpos[m], a) ? s[m] * a.scale : kNegInf;
      const float m_new = fmaxf(m_i[m], warp_max(sc));
      const float corr = expf(m_i[m] - m_new);
      const float p = expf(sc - m_new);
      l_i[m] = l_i[m] * corr + warp_sum(p);
      m_i[m] = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[m][e] *= corr;
      pw[m * kFBK + lane] = p;
    }
    __syncwarp();

    // acc += P · V: lane owns columns lane * EPL .. + EPL - 1.
#pragma unroll 2
    for (int j = 0; j < kFBK; j += 4) {
      float vf[4][EPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        lds<EPL>(sV + (j + jj) * DP + lane * EPL, vf[jj]);
#pragma unroll
      for (int m = 0; m < kRPW; ++m) {
        const float4 p = *reinterpret_cast<const float4*>(pw + m * kFBK + j);
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          float x = acc[m][e];
          x = fmaf(p.x, vf[0][e], x);
          x = fmaf(p.y, vf[1][e], x);
          x = fmaf(p.z, vf[2][e], x);
          x = fmaf(p.w, vf[3][e], x);
          acc[m][e] = x;
        }
      }
    }
    __syncwarp();  // P is read before the next tile overwrites it
  }

#pragma unroll
  for (int m = 0; m < kRPW; ++m) {
    const int r = warp * kRPW + m;
    if (r >= tile.nrows) continue;
    float* row = out + tile.out_row(a, r) * a.D;
    const float l = fmaxf(l_i[m], 1e-30f);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = lane * EPL + e;
      if (d < a.D) row[d] = acc[m][e] / l;
    }
  }
}

// ------------------------------------------------------------------ //

template <typename Kernel>
int launch(Kernel kernel, int smem_bytes, int threads, bool& opted_in,
           const Args& a) {
  if (smem_bytes > 48 * 1024 && !opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;  // the attribute is set once per process
  }
  const int bq = kRows / a.G;
  const dim3 grid((a.S + bq - 1) / bq, a.B * a.KH);
  kernel<<<grid, threads, smem_bytes, a.stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int run(const Args& a, int dtype) {
  static bool opted_mma = false, opted_simt = false;
  if (dtype == 1)
    return launch(flash_fwd_mma_kernel<DP>, MmaSmem<DP>::bytes, kMThreads,
                  opted_mma, a);
  return launch(flash_fwd_simt_kernel<DP>, SimtSmem<DP>::bytes, kFThreads,
                opted_simt, a);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) % 16) == 0;
}

}  // namespace

// q: (B, S, KH*G, D) with strides (q_sb, q_ss, q_sh, 1) in elements;
// k, v: (B, T, KH, D) with strides (k_sb, k_ss, k_sh, 1), the same for
// both; out: (B, S, KH*G, D) contiguous.  S <= T, D <= 128, G <= 64;
// window <= 0 means none.  dtype 0 = float32, 1 = bfloat16.  Launches on
// `stream` and returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int S,
                                   int T, int KH, int G, int D,
                                   long long q_sb, long long q_ss,
                                   long long q_sh, long long k_sb,
                                   long long k_ss, long long k_sh,
                                   int window, float scale, int dtype,
                                   void* stream) {
  if (B <= 0 || S <= 0 || T < S || KH <= 0 || G <= 0 || G > kRows ||
      D <= 0 || D > 128 || B * KH > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = dtype == 0 ? 4 : 8;  // elements in 16 bytes
  const bool vec = D % n == 0 && q_sb % n == 0 && q_ss % n == 0 &&
                   q_sh % n == 0 && k_sb % n == 0 && k_ss % n == 0 &&
                   k_sh % n == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v);
  const Args a{q,    k,    v,    out,  B,      S,     T,   KH,
               G,    D,    q_sb, q_ss, q_sh,   k_sb,  k_ss, k_sh,
               window, scale, vec, static_cast<cudaStream_t>(stream)};
  if (D <= 32) return run<32>(a, dtype);
  if (D <= 64) return run<64>(a, dtype);
  return run<128>(a, dtype);
}
