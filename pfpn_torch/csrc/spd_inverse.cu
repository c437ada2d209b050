// Batched inverse of small symmetric positive-definite matrices for Hopper.
//
// Replaces the TPU kernel pfpn_tpu/ops/linalg.py:_spd_inverse_kernel (:32),
// launched by _spd_inverse_pallas (:51) for the entries spd_inverse and
// spd_inverse_pair (:84-125): an unpivoted in-place Gauss-Jordan sweep of
// each (N, N) matrix, fp32. The TPU kernel puts 128 matrices in the lanes
// and pads the batch with identities; neither is needed here.
//
// Bound on this card. Each matrix is read once and its inverse written
// once, 8 N^2 bytes, against ~2 N^3 operations for the inverse: for N = 34
// that is 9.2 KB and ~79 KFLOP per matrix, ~8.5 operations per byte, below
// the H100's ~20 fp32 operations per byte of HBM. So bytes bound it: 16,384
// matrices (the pair entry at B = 8192) move 151.5 MB, 0.045 ms at
// 3.35 TB/s, against 0.019 ms of fp32 work at 67 TFLOP/s (the refinement
// step below adds 2 N^3, half of it in fp64, which the bound leaves out as
// work beyond the inverse itself).
//
// Design. One thread block per matrix, which sits in shared memory with
// its copy and a residual (3 N^2 + 2N floats: 14,008 bytes for N = 34).
// Each of the N pivot steps updates the N^2 elements in parallel across the
// block's threads, with a barrier between pivots (gj_sweep in
// block_linalg.cuh). The loads and stores are coalesced row-major copies.
// Every element's arithmetic is the same whatever the thread count, so the
// host build (one thread) computes the kernel's numbers up to the device's
// fused multiply-adds.
//
// Precision; this departs from the TPU kernel. The humanoid's H has
// cond ~ 4e4 and entries of H^-1 near 1e3, so the sweep alone leaves a
// relative error of ~4.5e-7 in the inverse, which torques near the motor
// limits carry into ~7e-5 of velocity per substep. One Newton-Schulz step,
// X <- X + X (I - A X), follows the sweep. The residual I - A X is summed in
// double: its terms reach |A||X| ~ 1e4 and cancel to ~1e-5, below what an
// fp32 sum resolves. The correction X (I - A X) is small and stays fp32.
// The refined inverse is ~3e-8 from the exact one, the fp32 rounding floor
// (ROADMAP.md, "Faults").

#include "block_linalg.cuh"

BL_HD void spd_inverse_one(const float* a, float* out, int n, float* sh,
                           int tid, int nt) {
  const int nn = n * n;
  float* x = sh;
  float* a0 = sh + nn;
  float* r = sh + 2 * nn;
  for (int e = tid; e < nn; e += nt) x[e] = a0[e] = a[e];
  BL_SYNC();
  gj_sweep(x, n, sh + 3 * nn, tid, nt);
  // one refinement step: R = I - A X in double, then X + X R
  for (int e = tid; e < nn; e += nt) {
    const int i = e / n, j = e % n;
    double s = (i == j) ? 1.0 : 0.0;
    for (int k = 0; k < n; ++k) s -= (double)a0[i * n + k] * (double)x[k * n + j];
    r[e] = (float)s;
  }
  BL_SYNC();
  for (int e = tid; e < nn; e += nt) {
    const int i = e / n, j = e % n;
    float s = 0.0f;
    for (int k = 0; k < n; ++k) s += x[i * n + k] * r[k * n + j];
    out[e] = x[e] + s;
  }
}

static inline size_t spd_inverse_shared_floats(int n) {
  return 3 * (size_t)n * n + 2 * (size_t)n;
}

#ifdef __CUDACC__

__global__ void spd_inverse_kernel(const float* __restrict__ a,
                                   float* __restrict__ out, int n) {
  extern __shared__ float sh[];
  const size_t off = (size_t)blockIdx.x * n * n;
  spd_inverse_one(a + off, out + off, n, sh, threadIdx.x, blockDim.x);
}

// Invert `count` matrices (count, n, n) on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int pfpn_spd_inverse_launch(const float* a, float* out, int count,
                                       int n, void* stream) {
  if (count <= 0) return 0;
  const int threads = 256;
  const size_t shared = spd_inverse_shared_floats(n) * sizeof(float);
  spd_inverse_kernel<<<count, threads, shared, (cudaStream_t)stream>>>(a, out, n);
  return (int)cudaGetLastError();
}

#else

#include <vector>

// Host build of the same body (g++ -x c++), for the CPU tests.
extern "C" int pfpn_spd_inverse_host(const float* a, float* out, int count,
                                     int n) {
  std::vector<float> sh(spd_inverse_shared_floats(n));
  for (int m = 0; m < count; ++m) {
    const size_t off = (size_t)m * n * n;
    spd_inverse_one(a + off, out + off, n, sh.data(), 0, 1);
  }
  return 0;
}

#endif
