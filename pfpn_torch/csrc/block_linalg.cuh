// Block-cooperative small-matrix pieces shared by spd_inverse.cu,
// substep_lin.cu and megastep.cu.
//
// Every function here is the body of one thread of a block: it takes its
// thread index `tid` and the block's thread count `nt`, works on matrices
// in the block's shared memory, and separates dependent phases with
// BL_SYNC(). In device code BL_SYNC() is __syncthreads(). Built as plain
// C++ (g++ -x c++, the host library of the CPU tests) it is nothing and the
// caller passes tid = 0, nt = 1: one thread then runs every phase in turn,
// with the same per-element arithmetic. A source that runs the block body
// on several host threads defines BL_SYNC() as its barrier before including
// this header (megastep.cu does).

#pragma once

#include <math.h>
#include <stddef.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define BL_HD __host__ __device__ __forceinline__
#else
#define BL_HD inline
#endif
#ifndef BL_SYNC
#ifdef __CUDA_ARCH__   // nvcc's device pass
#define BL_SYNC() __syncthreads()
#else
#define BL_SYNC() ((void)0)
#endif
#endif

// In-place unpivoted Gauss-Jordan inverse of the n x n row-major matrix `a`
// (SPD, so every pivot is a positive Schur-complement diagonal). Same sign
// convention and operation order as _spd_inverse_kernel
// (pfpn_tpu/ops/linalg.py:32-48): for each pivot k,
//   a[i][j] -= col_k[i] * (row_k[j] / d)     (i != k, j != k)
//   a[k][j]  = row_k[j] / d,  a[i][k] = col_k[i] / d,  a[k][k] = -1 / d
// with 1/d taken once, then a = -a at the end. `scratch` holds 2n floats:
// row k and column k are copied there before the update, so every element
// of the update pass reads only its own old value and the copies.
BL_HD void gj_sweep(float* a, int n, float* scratch, int tid, int nt) {
  float* rk = scratch;
  float* ck = scratch + n;
  const int nn = n * n;
  for (int k = 0; k < n; ++k) {
    for (int i = tid; i < n; i += nt) {
      rk[i] = a[k * n + i];
      ck[i] = a[i * n + k];
    }
    BL_SYNC();
    const float inv_d = 1.0f / rk[k];
    for (int e = tid; e < nn; e += nt) {
      const int i = e / n, j = e % n;
      float x;
      if (i == k)
        x = (j == k) ? -inv_d : rk[j] * inv_d;
      else if (j == k)
        x = ck[i] * inv_d;
      else
        x = a[e] - ck[i] * (rk[j] * inv_d);
      a[e] = x;
    }
    BL_SYNC();
  }
  for (int e = tid; e < nn; e += nt) a[e] = -a[e];
  BL_SYNC();
}

// gj_sweep of two n x n matrices at once, stacked in `a` (2n rows of n),
// in the same barrier phases: each element's arithmetic is gj_sweep's. The
// copies of pivot k+1's row and column are written by the update of pivot
// k (from its results), into the other half of a double buffer, so a pivot
// costs one barrier instead of two; the last pivot writes the negated
// result. Each matrix has its own loop, so that 1/d is loop-invariant (with
// one loop over both, nvcc moved the division into the loop, one precise
// division per element); the three cases of an element are selects, not
// branches; and a thread loads BL_GJ_CHUNK of its elements before it
// stores any. `scratch` holds 8n floats.
#define BL_GJ_CHUNK 4
BL_HD void gj_sweep_pair(float* a, int n, float* scratch, int tid, int nt) {
  const int nn = n * n;
  // buffer b = k & 1 at scratch + 4n b: rows k of both matrices, then
  // columns k of both
  for (int i = tid; i < 2 * n; i += nt) {
    const int m = i >= n ? 1 : 0, r = i - m * n;
    scratch[m * n + r] = a[m * nn + r];
    scratch[2 * n + m * n + r] = a[m * nn + r * n];
  }
  BL_SYNC();
  const int di = nt / n, dj = nt % n;   // element e = i n + j steps by nt
  const int i0 = tid / n, j0 = tid % n;
  for (int k = 0; k < n; ++k) {
    const float* cur = scratch + 4 * n * (k & 1);
    float* nxt = scratch + 4 * n * ((k + 1) & 1);
    const bool last = k == n - 1;
    for (int m = 0; m < 2; ++m) {
      float* am = a + m * nn;
      const float* rk = cur + m * n;
      const float* ck = cur + 2 * n + m * n;
      float* rn = nxt + m * n;
      float* cn = nxt + 2 * n + m * n;
      const float inv_d = 1.0f / rk[k];
      int i = i0, j = j0;
      for (int e0 = tid; e0 < nn; e0 += BL_GJ_CHUNK * nt) {
        float x[BL_GJ_CHUNK], rj[BL_GJ_CHUNK], ci[BL_GJ_CHUNK];
        int li[BL_GJ_CHUNK], lj[BL_GJ_CHUNK];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
        for (int c = 0; c < BL_GJ_CHUNK; ++c) {
          li[c] = i;
          lj[c] = j;
          if (e0 + c * nt < nn) {
            x[c] = am[e0 + c * nt];
            rj[c] = rk[j];
            ci[c] = ck[i];
          }
          i += di;
          j += dj;
          if (j >= n) { j -= n; ++i; }
        }
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
        for (int c = 0; c < BL_GJ_CHUNK; ++c) {
          const int e = e0 + c * nt;
          if (e >= nn) break;
          const float rjd = rj[c] * inv_d;
          float y = x[c] - ci[c] * rjd;                 // i != k, j != k
          y = lj[c] == k ? ci[c] * inv_d : y;           // column k
          y = li[c] == k ? (lj[c] == k ? -inv_d : rjd) : y;   // row k
          if (last) {
            y = -y;
          } else {
            if (li[c] == k + 1) rn[lj[c]] = y;
            if (lj[c] == k + 1) cn[li[c]] = y;
          }
          am[e] = y;
        }
      }
    }
    BL_SYNC();
  }
}

// sum_k a[k sa] b[k sb] for k = 0..n-1 (n >= 1), accumulated in k order
// as the TPU kernels' static loops and the one-thread kernels do: the
// first product, then one multiply-add per term. The loads of each batch
// of 8 terms are issued before its arithmetic, so their latency is paid
// once a batch.
BL_HD float dot_in_order(const float* a, int sa, const float* b, int sb, int n) {
  float s = a[0] * b[0];
  int k = 1;
  for (; k + 8 <= n; k += 8) {
    float x[8], y[8];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int c = 0; c < 8; ++c) {
      x[c] = a[(k + c) * sa];
      y[c] = b[(k + c) * sb];
    }
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int c = 0; c < 8; ++c) s += x[c] * y[c];
  }
  for (; k < n; ++k) s += a[k * sa] * b[k * sb];
  return s;
}


// ---- Register-resident Gauss-Jordan, one warp per matrix --------------------
//
// Used by spd_inverse.cu and substep_lin.cu (not by megastep.cu). The
// functions below are the body of the lanes of one or more warps, written so
// that one host thread can also run several lanes: with `nt` threads, thread
// `tid` runs the lanes g = tid + q nt for q = 0..LPT-1 (LPT lanes per
// thread). On the card nt is the block's thread count and LPT = 1, so the
// per-lane arrays below are registers (every index is a compile-time
// constant once the loops are unrolled). Lane g belongs to warp g / 32.
// BL_WSYNC() orders shared memory among the lanes of one warp: __syncwarp()
// on the card; a source that runs the lanes on several host threads
// defines it as its per-warp barrier before including this header.

#ifndef BL_WSYNC
#ifdef __CUDA_ARCH__
#define BL_WSYNC() __syncwarp()
#else
#define BL_WSYNC() ((void)0)
#endif
#endif

#ifdef __CUDA_ARCH__
#define BL_UNROLL _Pragma("unroll")
#else
#define BL_UNROLL
#endif

// 4 floats at p (16-byte aligned in shared memory): one 128-bit access on
// the card.
BL_HD void bl_ld4(const float* p, float* x) {
#ifdef __CUDA_ARCH__
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
#else
  for (int u = 0; u < 4; ++u) x[u] = p[u];
#endif
}

BL_HD void bl_st4(float* p, float x0, float x1, float x2, float x3) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<float4*>(p) = make_float4(x0, x1, x2, x3);
#else
  p[0] = x0; p[1] = x1; p[2] = x2; p[3] = x3;
#endif
}

// N floats of a 16-byte-aligned shared row into registers
template <int N>
BL_HD void bl_row(const float* p, float* x) {
  BL_UNROLL
  for (int i = 0; i + 4 <= N; i += 4) bl_ld4(p + i, x + i);
  BL_UNROLL
  for (int i = N & ~3; i < N; ++i) x[i] = p[i];
}

// sum_k x[k] y[k], k = 0..N-1, in k order (the first product, then one
// multiply-add per term), with x in registers and y in shared memory
// (16-byte aligned) read 4 floats at a time.
template <int N>
BL_HD float bl_dot_reg(const float* x, const float* y) {
  float s = 0.0f;
  BL_UNROLL
  for (int k0 = 0; k0 < N; k0 += 4) {
    float t[4];
    if (k0 + 4 <= N) {
      bl_ld4(y + k0, t);
    } else {
      for (int u = 0; u < 4; ++u) t[u] = k0 + u < N ? y[k0 + u] : 0.0f;
    }
    BL_UNROLL
    for (int u = 0; u < 4; ++u)
      if (k0 + u < N) s = k0 + u == 0 ? x[0] * t[0] : fmaf(x[k0 + u], t[u], s);
  }
  return s;
}

// How one warp holds an N x N matrix (32 < N <= 64): lane l holds column l
// whole, and rows l and l + 32 (if < N) of each of the XC = N - 32 last
// columns, so that every lane does nearly the same work. A pivot's column
// buffer holds column k, then row k of the last XC columns (LDB floats).
template <int N> struct BlWarpShape {
  static_assert(N > 32 && N <= 64, "a warp holds 32 < N <= 64 columns");
  static constexpr int XC = N - 32;
  static constexpr int LDB = (N + XC + 3) & ~3;
};

// In-register unpivoted Gauss-Jordan inverse of one SPD N x N matrix per
// warp. For lane g (warp g / 32, l = g % 32): c[q][i] is row i of column l,
// x[q][h][e] row l + 32 h of column 32 + e (zero where l + 32 h >= N); on
// return they hold the same entries of the inverse. `buf` holds 2 LDB
// floats per warp (warp w's at buf + 2 LDB w).
//
// Pivot k: the holders of column k store it into one half of the warp's
// double buffer and replace it by e_k, the identity column it stands for
// (the in-place form of [M | I] -> [I | M^-1]), and the holder of row k
// stores that row's entries of the last XC columns; after one BL_WSYNC()
// every lane reads the buffer as broadcasts and updates its entries with
// the arithmetic of gj_sweep: with 1/d taken once, row k becomes
// rjd = M[k][j] (1/d) and every other row M[i][j] - M[i][k] rjd (one fused
// multiply-add). The inverse comes out with its sign, so the final
// negation of gj_sweep is not needed. The next pivot writes the other half
// of the buffer, so a pivot costs one sync.
template <int N, int LPT>
BL_HD void gj_warp_sweep(float (&c)[LPT][N], float (&x)[LPT][2][BlWarpShape<N>::XC],
                         float* buf, int tid, int nt) {
  constexpr int XC = BlWarpShape<N>::XC, LDB = BlWarpShape<N>::LDB;
  BL_UNROLL
  for (int k = 0; k < N; ++k) {
    BL_UNROLL
    for (int q = 0; q < LPT; ++q) {
      const int g = tid + q * nt, l = g & 31;
      float* cb = buf + 2 * LDB * (g >> 5) + (k & 1) * LDB;
      if (k < 32) {
        if (l == k) {
          BL_UNROLL
          for (int i = 0; i + 4 <= N; i += 4)
            bl_st4(cb + i, c[q][i], c[q][i + 1], c[q][i + 2], c[q][i + 3]);
          BL_UNROLL
          for (int i = N & ~3; i < N; ++i) cb[i] = c[q][i];
          BL_UNROLL
          for (int i = 0; i < N; ++i) c[q][i] = i == k ? 1.0f : 0.0f;
        }
      } else {     // column k is one of the last XC: each lane holds 1-2 rows
        cb[l] = x[q][0][k - 32];
        x[q][0][k - 32] = 0.0f;
        if (l + 32 < N) {
          cb[l + 32] = x[q][1][k - 32];
          x[q][1][k - 32] = l + 32 == k ? 1.0f : 0.0f;
        }
      }
      if (l == (k & 31)) {   // row k of the last XC columns, after the above
        BL_UNROLL
        for (int e = 0; e < XC; ++e) cb[N + e] = x[q][k >> 5][e];
      }
    }
    BL_WSYNC();
    BL_UNROLL
    for (int q = 0; q < LPT; ++q) {
      const int g = tid + q * nt, l = g & 31;
      const float* cb = buf + 2 * LDB * (g >> 5) + (k & 1) * LDB;
      const float inv_d = 1.0f / cb[k];
      const float rjd = c[q][k] * inv_d;
      float rjx[XC];
      BL_UNROLL
      for (int i0 = 0; i0 < N + XC; i0 += 4) {
        float t[4];
        bl_ld4(cb + i0, t);
        BL_UNROLL
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u;
          if (i < N)
            c[q][i] = i == k ? rjd : fmaf(-t[u], rjd, c[q][i]);
          else if (i < N + XC)
            rjx[i - N] = t[u] * inv_d;
        }
      }
      BL_UNROLL
      for (int h = 0; h < 2; ++h) {
        const int i = l + 32 * h;
        if (i >= N) continue;
        const float ci = cb[i];
        BL_UNROLL
        for (int e = 0; e < XC; ++e)
          x[q][h][e] = i == k ? rjx[e] : fmaf(-ci, rjx[e], x[q][h][e]);
      }
    }
  }
}
