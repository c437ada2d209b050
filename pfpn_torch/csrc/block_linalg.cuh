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

