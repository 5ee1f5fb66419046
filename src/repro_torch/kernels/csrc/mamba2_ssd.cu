// Mamba2 SSD (state-space dual) chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mamba2_ssd_bhlp in
// src/repro/kernels/mamba2_ssd/kernel.py (wrapper mamba2_ssd in ops.py) and
// keeps its contract: per (batch, head), from the state h0 (zero when null)
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t (x) B_t,   y_t = C_t . h_t + D x_t,
// with B and C shared by every head (n_groups = 1), fp32 state math, y in
// x's type (D x added in fp32 before its one rounding) and the final state
// in fp32.  Within a chunk of L positions the recurrence is unrolled into
// matrix products against decay-weighted masks, as the TPU kernel does:
//   seg_t  = sum_{u<=t} dt_u A                      (fp32 segment sums)
//   y_t    = exp(seg_t) C_t . h^T                   (carried state)
//          + sum_{u<=t} (C_t . B_u) exp(seg_t - seg_u) dt_u x_u
//          + D x_t
//   h     <- exp(seg_L) h + sum_u exp(seg_L - seg_u) dt_u x_u (x) B_u.
// Above the diagonal the weight is selected as 0 (exp of a positive number
// may overflow; no mask multiplies an exp).  The tail of S past the last
// full chunk is staged as dt = 0 with x, B, C = 0: decay 1, no update, so
// the final state is the state after position S - 1.
//
// Layout: x (b, S, H, P), dt (b, S, H), B and C (b, S, N) are read through
// their strides in the model layout (x, B and C are views of the causal
// conv's output); y (b, S, H, P) and h_out (b, H, P, N) are contiguous;
// h0 (b, H, P, N) fp32 contiguous or null.  P and N are multiples of 8 up
// to 64 (zero-filled to 64 in shared memory); rows are read in 16-byte
// loads.
//
// Bound: bytes.  Reading x and writing y dominate (2 b S H P elements);
// the operations, 2 L (N + P) + 4 N P per position and head, come to
// about 190 per byte of x and y in bf16 at L = 128, P = N = 64: under the
// card's balance of about 295.  What the design does:
//   * One CTA per (batch, head) walks its chunks in order, the (P, N)
//     state carried in registers between chunks: the inter-chunk
//     recurrence never touches device memory.  x, y and dt are read or
//     written once; B and C once per head.
//   * bf16 (L = 128, eight warps) runs the three products on the tensor
//     cores (mma.sync m16n8k16, fp32 accumulate): C B^T with exact bf16
//     operands; the fp32 operands (the decay-weighted mask, the state for
//     C h^T, and the decay-weighted x for the state update) are split into
//     two bf16 parts, hi + lo, each multiplied, so each product keeps about
//     16 bits and only y's final rounding costs bf16 precision.  A warp
//     owns 16 rows of the chunk for y and a 16 x 32 block of the state.
//   * fp32 (L = 64) runs on the CUDA cores (fp32 FMAs from shared memory),
//     since the tensor cores would round the inputs.
// C B^T is recomputed for every head; sharing it across heads, wgmma, TMA
// and overlapping the next chunk's loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Planted faults for tools/mamba2_ssd_fault_check.py; 0 is the sound
// kernel.  1 (no_carry) drops the carried-state term after the first
// chunk, 2 (diag_shift) excludes the diagonal from the causal mask, 3
// (tail_dt) leaves the tail's dt unmasked (it repeats dt at S - 1).
#ifndef MAMBA2_SSD_FAULT
#define MAMBA2_SSD_FAULT 0
#endif

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // eight warps
constexpr int kDim = 64;       // P and N as staged (zero-filled past them)

struct Args {
  const void *x, *B, *C;
  const float *dt, *A, *D, *h0;
  void* y;
  float* h_out;
  int b, S, H, P, N;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, B_sb, B_ss, C_sb, C_ss;
};

// dt of position s (0 past S: the tail's decay is 1 and it adds nothing).
__device__ __forceinline__ float load_dt(const Args& a, int bi, int hd,
                                         long long s) {
  if (s >= a.S) {
#if MAMBA2_SSD_FAULT == 3
    s = a.S - 1;
#else
    return 0.f;
#endif
  }
  return a.dt[bi * a.dt_sb + s * a.dt_ss + hd * a.dt_sh];
}

// Segment sums of chunk `dts` (warp 0 alone): seg[t] = sum_{u<=t} dt_u A,
// wk[t] = exp(seg[L-1] - seg[t]) dt_t (the state update's weights) and
// es[t] = exp(seg[t]) (the carried state's decay).  Each lane sums L / 32
// consecutive positions, then the lanes' totals are scanned by shuffles.
template <int L>
__device__ __forceinline__ void segment_sums(float A, const float* dts,
                                             float* seg, float* wk,
                                             float* es) {
  constexpr int E = L / 32;
  const int lane = threadIdx.x & 31;
  float v[E];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    run += dts[lane * E + e] * A;
    v[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  const float seg_last = __shfl_sync(0xffffffffu, excl + v[E - 1], 31);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int t = lane * E + e;
    const float s = excl + v[e];
    seg[t] = s;
    wk[t] = expf(seg_last - s) * dts[t];
    es[t] = expf(s);
  }
}

// Causal weight of (row t, column u) of the chunk: G exp(seg_t - seg_u)
// dt_u on and below the diagonal, 0 above it (selected, never multiplied).
__device__ __forceinline__ float causal_weight(float g, int t, int u,
                                               const float* seg,
                                               const float* dts) {
#if MAMBA2_SSD_FAULT == 2
  const bool keep = u < t;
#else
  const bool keep = u <= t;
#endif
  return keep ? g * expf(seg[t] - seg[u]) * dts[u] : 0.f;
}

// ------------------------------------------------------------------ //
// bf16: tensor cores (mma.sync.m16n8k16, fp32 accumulate), L = 128
// ------------------------------------------------------------------ //

constexpr int kL = 128;       // chunk length
constexpr int kS = kDim + 8;  // bf16 row stride in shared memory (144 B)
constexpr int kMmaSmem = (5 * kL * kS + 2 * kDim * kS) * 2 + 4 * kL * 4;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 b16 matrices, transposed: lane l addresses a row of matrix
// l / 8.
__device__ __forceinline__ void ldsm_x4_trans(const bf16* p,
                                              uint32_t (&r)[4]) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (v0, v1) = hi + lo + O(2^-16 |v|), each part a packed bf16 pair.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// L rows of `cols` bf16 from a (b, S, ...) tensor into `dst` (row stride
// kS), zeros past S and past `cols`.
__device__ __forceinline__ void stage_rows(const bf16* src, long long ss,
                                           int S, long long s0, int cols,
                                           bf16* dst) {
  for (int i = threadIdx.x; i < kL * (kDim / 8); i += kThreads) {
    const int t = i / (kDim / 8), col = (i % (kDim / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (s0 + t < S && col < cols)
      v = *reinterpret_cast<const uint4*>(src + (s0 + t) * ss + col);
    *reinterpret_cast<uint4*>(dst + t * kS + col) = v;
  }
}

// In an m16n8 accumulator a lane holds rows lane / 4 (+ 8) and columns
// 2 (lane % 4) + {0, 1}.  Warp w computes y for rows 16 w .. 16 w + 15 of
// the chunk and holds the state block p in 16 (w % 4) .. + 15, n in
// 32 (w / 4) .. + 31.
__global__ void __launch_bounds__(kThreads, 1) ssd_mma_kernel(const Args a) {
  extern __shared__ uint4 smem_u4[];
  bf16* xs = reinterpret_cast<bf16*>(smem_u4);  // [kL][kS]  x of the chunk
  bf16* Bs = xs + kL * kS;                      // [kL][kS]  B
  bf16* Cs = Bs + kL * kS;                      // [kL][kS]  C
  bf16* xwh = Cs + kL * kS;                     // [kL][kS]  wk x, hi part
  bf16* xwl = xwh + kL * kS;                    //           and lo part
  bf16* hh = xwl + kL * kS;                     // [kDim][kS] state, hi
  bf16* hl = hh + kDim * kS;                    //            and lo
  float* dts = reinterpret_cast<float*>(hl + kDim * kS);
  float* seg = dts + kL;
  float* wk = seg + kL;
  float* es = wk + kL;

  const int bi = blockIdx.x / a.H, hd = blockIdx.x % a.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q2 = 2 * (lane & 3);
  const float A = a.A[hd], Dh = a.D[hd];
  const bf16* xg = static_cast<const bf16*>(a.x) + bi * a.x_sb + hd * a.x_sh;
  const bf16* Bg = static_cast<const bf16*>(a.B) + bi * a.B_sb;
  const bf16* Cg = static_cast<const bf16*>(a.C) + bi * a.C_sb;
  bf16* yg = static_cast<bf16*>(a.y) + (long long)bi * a.S * a.H * a.P +
             (long long)hd * a.P;
  const long long hbase = ((long long)bi * a.H + hd) * a.P * a.N;

  // The state block of this warp: hacc[nt][i] is (p, n) below.
  const int p0 = 16 * (warp & 3) + g, nb = 32 * (warp >> 2);
  float hacc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + 8 * (i >> 1), n = nb + nt * 8 + q2 + (i & 1);
      hacc[nt][i] = a.h0 != nullptr && p < a.P && n < a.N
                        ? a.h0[hbase + (long long)p * a.N + n]
                        : 0.f;
    }

  const int r0 = 16 * warp + g;  // this warp's rows of y: r0 and r0 + 8
  const int nc = (a.S + kL - 1) / kL;
  for (int c = 0; c < nc; ++c) {
    const long long s0 = (long long)c * kL;
    // -- stage the chunk and the carried state (hi and lo parts) --------
    stage_rows(xg, a.x_ss, a.S, s0, a.P, xs);
    stage_rows(Bg, a.B_ss, a.S, s0, a.N, Bs);
    stage_rows(Cg, a.C_ss, a.S, s0, a.N, Cs);
    for (int t = threadIdx.x; t < kL; t += kThreads)
      dts[t] = load_dt(a, bi, hd, s0 + t);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int off = (p0 + 8 * rr) * kS + nb + nt * 8 + q2;
        uint32_t hi, lo;
        split2(hacc[nt][2 * rr], hacc[nt][2 * rr + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(hh + off) = hi;
        *reinterpret_cast<uint32_t*>(hl + off) = lo;
      }
    __syncthreads();
    if (warp == 0) segment_sums<kL>(A, dts, seg, wk, es);
    __syncthreads();

    // -- wk x in two bf16 parts, for the state update -------------------
    for (int i = threadIdx.x; i < kL * kDim / 2; i += kThreads) {
      const int u = i / (kDim / 2), off = u * kS + (i % (kDim / 2)) * 2;
      const float2 xv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + off));
      uint32_t hi, lo;
      split2(xv.x * wk[u], xv.y * wk[u], hi, lo);
      *reinterpret_cast<uint32_t*>(xwh + off) = hi;
      *reinterpret_cast<uint32_t*>(xwl + off) = lo;
    }

    // -- y of rows r0, r0 + 8: carried state, then the causal block -----
    uint32_t cf[4][4];  // C's A fragments over N (k steps of 16)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const bf16* p = Cs + r0 * kS + ks * 16 + q2;
      cf[ks][0] = lds32(p);
      cf[ks][1] = lds32(p + 8 * kS);
      cf[ks][2] = lds32(p + 8);
      cf[ks][3] = lds32(p + 8 * kS + 8);
    }
    float yacc[8][4] = {};
#if MAMBA2_SSD_FAULT == 1
    if (c == 0)
#endif
    {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int off = (nt * 8 + g) * kS + ks * 16 + q2;
          mma_bf16(yacc[nt], cf[ks], lds32(hh + off), lds32(hh + off + 8));
          mma_bf16(yacc[nt], cf[ks], lds32(hl + off), lds32(hl + off + 8));
        }
    }
    {
      const float e0 = es[r0], e1 = es[r0 + 8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        yacc[nt][0] *= e0;
        yacc[nt][1] *= e0;
        yacc[nt][2] *= e1;
        yacc[nt][3] *= e1;
      }
    }
    for (int j = 0; j <= warp; ++j) {  // columns u in 16 j .. 16 j + 15
      float gacc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const bf16* p = Bs + (16 * j + 8 * hf + g) * kS + ks * 16 + q2;
          mma_bf16(gacc[hf], cf[ks], lds32(p), lds32(p + 8));
        }
      // The weighted block as A fragments: a[rr + 2 hf] holds row
      // r0 + 8 rr, columns 16 j + 8 hf + q2 + {0, 1}.
      uint32_t ah[4], al[4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int t = r0 + 8 * rr, u = 16 * j + 8 * hf + q2;
          split2(causal_weight(gacc[hf][2 * rr], t, u, seg, dts),
                 causal_weight(gacc[hf][2 * rr + 1], t, u + 1, seg, dts),
                 ah[rr + 2 * hf], al[rr + 2 * hf]);
        }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bx[4];
        ldsm_x4_trans(xs + (16 * j + (lane & 15)) * kS + np * 16 +
                          (lane >> 4) * 8,
                      bx);
        mma_bf16(yacc[2 * np], ah, bx[0], bx[1]);
        mma_bf16(yacc[2 * np + 1], ah, bx[2], bx[3]);
        mma_bf16(yacc[2 * np], al, bx[0], bx[1]);
        mma_bf16(yacc[2 * np + 1], al, bx[2], bx[3]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int t = r0 + 8 * rr;
      if (s0 + t >= a.S) continue;
      bf16* yr = yg + (s0 + t) * a.H * a.P;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int p = nt * 8 + q2;
        if (p >= a.P) continue;
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xs + t * kS + p));
        *reinterpret_cast<__nv_bfloat162*>(yr + p) = __floats2bfloat162_rn(
            yacc[nt][2 * rr] + Dh * xv.x, yacc[nt][2 * rr + 1] + Dh * xv.y);
      }
    }
    __syncthreads();  // wk x is staged

    // -- state update: h = exp(seg_L) h + (wk x)^T B --------------------
    const float decay = expf(seg[kL - 1]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) hacc[nt][i] *= decay;
#pragma unroll
    for (int ks = 0; ks < kL / 16; ++ks) {
      // A = (wk x)^T: m = p, k = u, from the [u][p] tile by ldmatrix.trans
      const int arow = ks * 16 + (lane & 7) + 8 * (lane >> 4);
      const int acol = 16 * (warp & 3) + 8 * ((lane >> 3) & 1);
      uint32_t ah[4], al[4];
      ldsm_x4_trans(xwh + arow * kS + acol, ah);
      ldsm_x4_trans(xwl + arow * kS + acol, al);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bb[4];
        ldsm_x4_trans(Bs + (ks * 16 + (lane & 15)) * kS + nb + np * 16 +
                          (lane >> 4) * 8,
                      bb);
        mma_bf16(hacc[2 * np], ah, bb[0], bb[1]);
        mma_bf16(hacc[2 * np + 1], ah, bb[2], bb[3]);
        mma_bf16(hacc[2 * np], al, bb[0], bb[1]);
        mma_bf16(hacc[2 * np + 1], al, bb[2], bb[3]);
      }
    }
    __syncthreads();  // the chunk's tiles are free
  }

#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + 8 * (i >> 1), n = nb + nt * 8 + q2 + (i & 1);
      if (p < a.P && n < a.N)
        a.h_out[hbase + (long long)p * a.N + n] = hacc[nt][i];
    }
}

// ------------------------------------------------------------------ //
// fp32: CUDA cores, L = 64
// ------------------------------------------------------------------ //

constexpr int kLF = 64;        // chunk length
constexpr int kF = kDim + 1;   // fp32 row stride in shared memory (words)
constexpr int kFp32Smem = (4 * kLF * kF + kDim * kF + 4 * kLF) * 4;

// kLF rows of `cols` floats into `dst` (row stride kF), zeros past S and
// past `cols`.
__device__ __forceinline__ void stage_rows_f(const float* src, long long ss,
                                             int S, long long s0, int cols,
                                             float* dst) {
  for (int i = threadIdx.x; i < kLF * (kDim / 4); i += kThreads) {
    const int t = i / (kDim / 4), col = (i % (kDim / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s0 + t < S && col < cols)
      v = *reinterpret_cast<const float4*>(src + (s0 + t) * ss + col);
    float* d = dst + t * kF + col;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

// Thread i owns column i % 64 and rows i / 64 + 4 k (k < 16) of each
// 64 x 64 product: of the mask (t, u), of y (t, p) and of the state
// (p, n), which it carries in registers.
__global__ void __launch_bounds__(kThreads) ssd_fp32_kernel(const Args a) {
  extern __shared__ uint4 smem_u4[];
  float* xs = reinterpret_cast<float*>(smem_u4);  // [kLF][kF]  x
  float* Bs = xs + kLF * kF;                      // [kLF][kF]  B
  float* Cs = Bs + kLF * kF;                      // [kLF][kF]  C
  float* Ws = Cs + kLF * kF;                      // [kLF][kF]  mask weights
  float* hs = Ws + kLF * kF;                      // [kDim][kF] state
  float* dts = hs + kDim * kF;
  float* seg = dts + kLF;
  float* wk = seg + kLF;
  float* es = wk + kLF;

  const int bi = blockIdx.x / a.H, hd = blockIdx.x % a.H;
  const int col = threadIdx.x % 64, row0 = threadIdx.x / 64;
  const float A = a.A[hd], Dh = a.D[hd];
  const float* xg = static_cast<const float*>(a.x) + bi * a.x_sb + hd * a.x_sh;
  const float* Bg = static_cast<const float*>(a.B) + bi * a.B_sb;
  const float* Cg = static_cast<const float*>(a.C) + bi * a.C_sb;
  float* yg = static_cast<float*>(a.y) + (long long)bi * a.S * a.H * a.P +
              (long long)hd * a.P;
  const long long hbase = ((long long)bi * a.H + hd) * a.P * a.N;

  float h[16];  // state (p = row0 + 4 k, n = col)
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int p = row0 + 4 * k;
    h[k] = a.h0 != nullptr && p < a.P && col < a.N
               ? a.h0[hbase + (long long)p * a.N + col]
               : 0.f;
  }

  const int nc = (a.S + kLF - 1) / kLF;
  for (int c = 0; c < nc; ++c) {
    const long long s0 = (long long)c * kLF;
    stage_rows_f(xg, a.x_ss, a.S, s0, a.P, xs);
    stage_rows_f(Bg, a.B_ss, a.S, s0, a.N, Bs);
    stage_rows_f(Cg, a.C_ss, a.S, s0, a.N, Cs);
    for (int t = threadIdx.x; t < kLF; t += kThreads)
      dts[t] = load_dt(a, bi, hd, s0 + t);
#pragma unroll
    for (int k = 0; k < 16; ++k) hs[(row0 + 4 * k) * kF + col] = h[k];
    __syncthreads();
    if (threadIdx.x < 32) segment_sums<kLF>(A, dts, seg, wk, es);
    __syncthreads();

    // mask weights W[t][u], u = col
    {
      float acc[16] = {};
      for (int n = 0; n < a.N; ++n) {
        const float bv = Bs[col * kF + n];
#pragma unroll
        for (int k = 0; k < 16; ++k)
          acc[k] = fmaf(Cs[(row0 + 4 * k) * kF + n], bv, acc[k]);
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int t = row0 + 4 * k;
        Ws[t * kF + col] = causal_weight(acc[k], t, col, seg, dts);
      }
    }
    __syncthreads();

    // y[t][p], p = col
    {
      float ci[16] = {}, yi[16] = {};
#if MAMBA2_SSD_FAULT == 1
      if (c == 0)
#endif
        for (int n = 0; n < a.N; ++n) {
          const float hv = hs[col * kF + n];
#pragma unroll
          for (int k = 0; k < 16; ++k)
            ci[k] = fmaf(Cs[(row0 + 4 * k) * kF + n], hv, ci[k]);
        }
      for (int u = 0; u < kLF; ++u) {
        const float xv = xs[u * kF + col];
#pragma unroll
        for (int k = 0; k < 16; ++k)
          yi[k] = fmaf(Ws[(row0 + 4 * k) * kF + u], xv, yi[k]);
      }
      if (col < a.P) {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int t = row0 + 4 * k;
          if (s0 + t < a.S)
            yg[(s0 + t) * a.H * a.P + col] =
                es[t] * ci[k] + yi[k] + Dh * xs[t * kF + col];
        }
      }
    }

    // state: h[p][n] = exp(seg_L) h + sum_u wk_u x[u][p] B[u][n], n = col
    {
      const float decay = expf(seg[kLF - 1]);
#pragma unroll
      for (int k = 0; k < 16; ++k) h[k] *= decay;
      for (int u = 0; u < kLF; ++u) {
        const float bv = Bs[u * kF + col] * wk[u];
#pragma unroll
        for (int k = 0; k < 16; ++k)
          h[k] = fmaf(xs[u * kF + row0 + 4 * k], bv, h[k]);
      }
    }
    __syncthreads();  // the chunk's tiles are free
  }

#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int p = row0 + 4 * k;
    if (p < a.P && col < a.N)
      a.h_out[hbase + (long long)p * a.N + col] = h[k];
  }
}

template <typename K>
cudaError_t launch(K kernel, int smem, const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.b * a.H, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x (b, S, H, P), B and C (b, S, N) in one type (dtype 0 = float32, 1 =
// bfloat16), unit last stride, other strides in elements; dt (b, S, H),
// A and D (H,) float32; h0 (b, H, P, N) float32 contiguous or null.
// Writes y (b, S, H, P) contiguous in x's type and h_out (b, H, P, N)
// float32.  Returns the CUDA error of the launch (0 on success).
extern "C" int mamba2_ssd_fwd(const void* x, const float* dt, const void* B,
                              const void* C, const float* A, const float* D,
                              const float* h0, void* y, float* h_out, int b,
                              int S, int H, int P, int N, long long x_sb,
                              long long x_ss, long long x_sh,
                              long long dt_sb, long long dt_ss,
                              long long dt_sh, long long B_sb,
                              long long B_ss, long long C_sb,
                              long long C_ss, int dtype, void* stream) {
  if (b <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || P > kDim ||
      N > kDim || P % 8 || N % 8 || (long long)b * H > 2147483647LL ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,    B,    C,    dt,   A,    D,    h0,   y,    h_out,
               b,    S,    H,    P,    N,    x_sb, x_ss, x_sh, dt_sb,
               dt_ss, dt_sh, B_sb, B_ss, C_sb, C_ss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1
                              ? launch(ssd_mma_kernel, kMmaSmem, a, st)
                              : launch(ssd_fp32_kernel, kFp32Smem, a, st);
  return static_cast<int>(err);
}
