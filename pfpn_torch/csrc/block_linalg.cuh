// Block-cooperative small-matrix pieces shared by spd_inverse.cu and
// substep_lin.cu.
//
// Every function here is the body of one thread of a block: it takes its
// thread index `tid` and the block's thread count `nt`, works on matrices
// in the block's shared memory, and separates dependent phases with
// BL_SYNC(). In device code BL_SYNC() is __syncthreads(). Built as plain
// C++ (g++ -x c++, the host library of the CPU tests) it is nothing and the
// caller passes tid = 0, nt = 1: one thread then runs every phase in turn,
// with the same per-element arithmetic.

#pragma once

#include <math.h>
#include <stddef.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define BL_HD __host__ __device__ __forceinline__
#else
#define BL_HD inline
#endif
#ifdef __CUDA_ARCH__   // nvcc's device pass
#define BL_SYNC() __syncthreads()
#else
#define BL_SYNC() ((void)0)
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

// y[i] = sum_k m[i][k] x[k] for the rows i of this thread (m row-major,
// rows x cols), summed in k order as the TPU kernel's static loop does.
BL_HD float row_dot(const float* m, int cols, int i, const float* x) {
  float acc = 0.0f;
  for (int k = 0; k < cols; ++k) acc += m[i * cols + k] * x[k];
  return acc;
}
