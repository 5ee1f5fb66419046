// Grouped (per-expert) matmul for Hopper (sm_90a): the MoE experts.
//
// Replaces the Pallas TPU kernel moe_gmm_ecd in
// src/repro/kernels/moe_gmm/kernel.py (wrapper moe_gmm in ops.py) and keeps
// its contract: for x (E, C, D) and w (E, D, F), y[e] = x[e] @ w[e] with
// fp32 accumulation, rows c >= n_valid[e] zeroed (all rows valid when
// n_valid is null), y (E, C, F) in x's type.  Any E, C, D and F: the tails
// of C, D and F are masked here, nothing is padded in memory.
//
// Bound: bytes.  At the serving shapes C is 8 (a decode step) to 24 (a
// prefill chunk) rows per expert against D x F = 6144 x 16384 weights, so
// each weight is used C times: 2 C operations per 2 bytes of bf16, far
// below the card's balance of about 295 operations per byte.  The launch
// is a stream of the weights.  What the design does about it:
//   * One CTA per (F tile of 128 columns, C tile, expert): E * F / 128 =
//     1024 CTAs at the serving shapes, each streaming a 128-column panel
//     of w[e] once along D.
//   * w and x arrive in 16-byte cp.async copies (coalesced: a warp reads
//     512 contiguous bytes of a w row), three stages deep, so two tiles
//     are in flight while the third is multiplied.
//   * Rows at or past n_valid[e] are never read: their x rows are zero
//     filled in shared memory, and a C tile that lies wholly past
//     n_valid[e] writes its zeros without reading w, so an expert that no
//     token chose costs only those writes.
//   * bf16 runs on the tensor cores (mma.sync m16n8k16, fp32 accumulate;
//     w's B fragments by ldmatrix.trans from its row-major tile); fp32 runs
//     on the CUDA cores (fp32 FMAs from shared memory), since the tensor
//     cores would round the inputs.
//   * Without 16-byte alignment (D or F not a multiple of 16 bytes, or an
//     unaligned base) the tiles are loaded element by element instead.
// wgmma, TMA and a persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Planted faults for tools/moe_gmm_fault_check.py; 0 is the sound kernel.
// 1 skips the last K tile, 2 ignores n_valid, 3 gives the last expert
// expert 0's weights, 4 leaves the last F tile unwritten.
#ifndef MOE_GMM_FAULT
#define MOE_GMM_FAULT 0
#endif

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kBN = 128;       // output columns per CTA
constexpr int kStages = 3;     // cp.async pipeline depth

struct Args {
  const void* x;
  const void* w;
  const int* n_valid;  // null: every row valid
  void* y;
  int E, C, D, F;
};

// Tile shapes by element type: rows of x per CTA, depth of a K tile, and
// the shared-memory row strides (padded to spread the banks, multiples of
// 16 bytes).
template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int kBM = 32, kBK = 64, kXS = kBK + 8, kWS = kBN + 8;
  static constexpr int kStage = kBM * kXS + kBK * kWS;  // elements
};
template <>
struct Cfg<float> {
  static constexpr int kBM = 16, kBK = 32, kXS = kBK + 4, kWS = kBN + 4;
  static constexpr int kStage = kBM * kXS + kBK * kWS;
};

// 16 bytes from global to shared memory; zeros when !pred (nothing read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The CTA's place: F tile blockIdx.x, C tile blockIdx.y, expert blockIdx.z.
template <typename T>
struct Tile {
  int e, m0, n0, nv;
  __device__ __forceinline__ explicit Tile(const Args& a) {
    e = blockIdx.z;
    m0 = blockIdx.y * Cfg<T>::kBM;
    n0 = blockIdx.x * kBN;
    nv = a.C;
#if MOE_GMM_FAULT != 2
    if (a.n_valid != nullptr) nv = min(max(a.n_valid[e], 0), a.C);
#endif
  }
};

// Stage `kt` of x (rows m0.., K columns kt*BK..) and w (K rows, columns
// n0..) into buffer `buf`.  Rows of x at or past nv and everything past D
// or F are zeros.
template <typename T, bool VEC>
__device__ __forceinline__ void load_stage(const Args& a, const Tile<T>& t,
                                           T* buf, int kt) {
  using C = Cfg<T>;
  constexpr int kE = 16 / sizeof(T);  // elements per 16-byte chunk
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  int ew = t.e;
#if MOE_GMM_FAULT == 3
  if (t.e == a.E - 1) ew = 0;
#endif
  T* sx = buf;
  T* sw = buf + C::kBM * C::kXS;
  const int k0 = kt * C::kBK;
  for (int c = threadIdx.x; c < C::kBM * (C::kBK / kE); c += kThreads) {
    const int r = c / (C::kBK / kE), kc = (c % (C::kBK / kE)) * kE;
    const int row = t.m0 + r, k = k0 + kc;
    const bool ok = row < t.nv;
    const T* src = x + ((long long)t.e * a.C + row) * a.D + k;
    T* dst = sx + r * C::kXS + kc;
    if (VEC) {
      cp_async16(dst, ok && k < a.D ? src : x, ok && k < a.D);
    } else {
#pragma unroll
      for (int i = 0; i < kE; ++i)
        dst[i] = ok && k + i < a.D ? src[i] : T(0.f);
    }
  }
  for (int c = threadIdx.x; c < C::kBK * (kBN / kE); c += kThreads) {
    const int r = c / (kBN / kE), nc = (c % (kBN / kE)) * kE;
    const int k = k0 + r, col = t.n0 + nc;
    const bool ok = k < a.D;
    const T* src = w + ((long long)ew * a.D + k) * a.F + col;
    T* dst = sw + r * C::kWS + nc;
    if (VEC) {
      cp_async16(dst, ok && col < a.F ? src : w, ok && col < a.F);
    } else {
#pragma unroll
      for (int i = 0; i < kE; ++i)
        dst[i] = ok && col + i < a.F ? src[i] : T(0.f);
    }
  }
}

// The K loop: stages kt + 1 and kt + 2 are in flight while stage kt is
// multiplied by `mul(buffer)`.
template <typename T, bool VEC, typename Mul>
__device__ __forceinline__ void k_loop(const Args& a, const Tile<T>& t,
                                       T* smem, Mul mul) {
  int nk = (a.D + Cfg<T>::kBK - 1) / Cfg<T>::kBK;
#if MOE_GMM_FAULT == 1
  if (nk > 1) --nk;
#endif
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage<T, VEC>(a, t, smem + s * Cfg<T>::kStage, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed
    __syncthreads();               // ... for every thread; kt - 1 is done
    const int next = kt + kStages - 1;
    if (next < nk)
      load_stage<T, VEC>(a, t, smem + (next % kStages) * Cfg<T>::kStage,
                         next);
    cp_async_commit();
    mul(smem + (kt % kStages) * Cfg<T>::kStage);
  }
}

// Writes zeros over the CTA's whole tile (a C tile past n_valid).
template <typename T>
__device__ void write_zeros(const Args& a, const Tile<T>& t) {
  T* y = static_cast<T*>(a.y);
  const int rows = min(Cfg<T>::kBM, a.C - t.m0);
  const int cols = min(kBN, a.F - t.n0);
  for (int i = threadIdx.x; i < rows * cols; i += kThreads)
    y[((long long)t.e * a.C + t.m0 + i / cols) * a.F + t.n0 + i % cols] =
        T(0.f);
}

// ------------------------------------------------------------------ //
// bf16: tensor cores (mma.sync.m16n8k16, fp32 accumulate)
// ------------------------------------------------------------------ //

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of two neighbouring n8 tiles (k16 x n16 of a row-major
// [k][n] tile): lane l addresses row l % 16, column 8 * (l / 16).
__device__ __forceinline__ void ldsm_x4_trans(const __nv_bfloat16* p,
                                              uint32_t (&b)[4]) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Warp w computes the CTA's 32 rows (two m16 tiles) by columns
// 32 w .. 32 w + 31 (four n8 tiles).  In an m16n8 fragment a lane holds
// rows lane / 4 and lane / 4 + 8 and columns 2 (lane % 4) + {0, 1}.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
moe_gmm_mma_kernel(const Args a) {
  using T = __nv_bfloat16;
  using C = Cfg<T>;
  extern __shared__ uint4 smem_u4[];
  T* smem = reinterpret_cast<T*>(smem_u4);
#if MOE_GMM_FAULT == 4
  if (blockIdx.x == gridDim.x - 1) return;
#endif
  const Tile<T> t(a);
  if (t.m0 >= t.nv) {
    write_zeros<T>(a, t);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wn = warp * 32;
  float acc[2][4][4] = {};

  k_loop<T, VEC>(a, t, smem, [&](const T* buf) {
    const T* sx = buf;
    const T* sw = buf + C::kBM * C::kXS;
#pragma unroll
    for (int ks = 0; ks < C::kBK / 16; ++ks) {
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const T* p = sx + (mt * 16 + (lane >> 2)) * C::kXS + ks * 16 +
                     (lane & 3) * 2;
        af[mt][0] = lds32(p);
        af[mt][1] = lds32(p + 8 * C::kXS);
        af[mt][2] = lds32(p + 8);
        af[mt][3] = lds32(p + 8 * C::kXS + 8);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4_trans(sw + (ks * 16 + (lane & 15)) * C::kWS + wn + np * 16 +
                          (lane >> 4) * 8,
                      bf[np]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], af[mt], bf[nt >> 1][(nt & 1) * 2],
                   bf[nt >> 1][(nt & 1) * 2 + 1]);
    }
  });

  T* y = static_cast<T*>(a.y);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = t.m0 + mt * 16 + (lane >> 2) + 8 * h;
      if (row >= a.C) continue;
      T* yr = y + ((long long)t.e * a.C + row) * a.F;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = t.n0 + wn + nt * 8 + (lane & 3) * 2 + j;
          if (col < a.F)
            yr[col] = __float2bfloat16(row < t.nv ? acc[mt][nt][2 * h + j]
                                                  : 0.f);
        }
    }
}

// ------------------------------------------------------------------ //
// fp32: CUDA cores
// ------------------------------------------------------------------ //

// Thread i computes column n0 + i of the CTA's 16 rows.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
moe_gmm_fp32_kernel(const Args a) {
  using T = float;
  using C = Cfg<T>;
  extern __shared__ uint4 smem_u4[];
  T* smem = reinterpret_cast<T*>(smem_u4);
#if MOE_GMM_FAULT == 4
  if (blockIdx.x == gridDim.x - 1) return;
#endif
  const Tile<T> t(a);
  if (t.m0 >= t.nv) {
    write_zeros<T>(a, t);
    return;
  }
  float acc[C::kBM] = {};

  k_loop<T, VEC>(a, t, smem, [&](const T* buf) {
    const T* sx = buf;
    const T* sw = buf + C::kBM * C::kXS;
#pragma unroll
    for (int k = 0; k < C::kBK; k += 4) {
      float wk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) wk[i] = sw[(k + i) * C::kWS + threadIdx.x];
#pragma unroll
      for (int r = 0; r < C::kBM; ++r) {
        const float4 xv =
            *reinterpret_cast<const float4*>(sx + r * C::kXS + k);
        acc[r] = fmaf(xv.x, wk[0], acc[r]);
        acc[r] = fmaf(xv.y, wk[1], acc[r]);
        acc[r] = fmaf(xv.z, wk[2], acc[r]);
        acc[r] = fmaf(xv.w, wk[3], acc[r]);
      }
    }
  });

  T* y = static_cast<T*>(a.y);
  const int col = t.n0 + threadIdx.x;
  if (col >= a.F) return;
#pragma unroll
  for (int r = 0; r < C::kBM; ++r) {
    const int row = t.m0 + r;
    if (row < a.C)
      y[((long long)t.e * a.C + row) * a.F + col] = row < t.nv ? acc[r] : 0.f;
  }
}

template <typename T, typename K>
cudaError_t launch(K kernel, const Args& a, cudaStream_t stream) {
  constexpr int bytes = kStages * Cfg<T>::kStage * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.F + kBN - 1) / kBN, (a.C + Cfg<T>::kBM - 1) / Cfg<T>::kBM,
                  a.E);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x (E, C, D), w (E, D, F), y (E, C, F), contiguous, one type: dtype 0 =
// float32, 1 = bfloat16.  n_valid: (E,) int32 or null.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int moe_gmm_fwd(const void* x, const void* w, const int* n_valid,
                           void* y, int E, int C, int D, int F, int dtype,
                           cudaStream_t stream) {
  if (E <= 0 || C <= 0 || F <= 0 || D < 0 || C > 65535 * 16 ||
      E > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, w, n_valid, y, E, C, D, F};
  const int elems = dtype ? 8 : 4;  // per 16 bytes
  const bool vec = D % elems == 0 && F % elems == 0 &&
                   (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(w) % 16) == 0;
  cudaError_t err;
  if (dtype == 1)
    err = vec ? launch<__nv_bfloat16>(moe_gmm_mma_kernel<true>, a, stream)
              : launch<__nv_bfloat16>(moe_gmm_mma_kernel<false>, a, stream);
  else
    err = vec ? launch<float>(moe_gmm_fp32_kernel<true>, a, stream)
              : launch<float>(moe_gmm_fp32_kernel<false>, a, stream);
  return static_cast<int>(err);
}
