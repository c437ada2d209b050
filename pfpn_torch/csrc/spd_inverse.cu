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
// Design for N = 34 (the humanoid's dofs, the only size the port uses):
// one warp per matrix, two matrices per 64-thread block, the matrix in
// registers. Lane l holds column l and rows l and l + 32 of columns 32 and
// 33, so every lane does nearly the same work; N is a template parameter,
// so every index is a constant. Each
// pivot passes only column k through shared memory, double-buffered, with
// one __syncwarp() (gj_warp_sweep in block_linalg.cuh): no block barrier,
// no integer division, and every multiply-add reads one operand from
// registers and one broadcast. Global loads and stores read and write one
// matrix row per instruction, which is coalesced while each lane keeps its
// columns. The refinement: after the sweep X goes to shared memory; lane j
// forms column j of R = I - A X in fp64 from its column of X (in
// registers) and broadcasts of A's rows, read two doubles at a time (A is
// staged in double at load, symmetric from its lower triangle, the part a
// Cholesky factorisation reads), then X + X R from broadcasts of X's rows
// and R's column in registers. Columns 32 and 33 are refined by all 32
// lanes, row by row, as the sweep holds them. Each double sum runs as two
// partial sums (even and odd terms) to halve its chain of dependent
// multiply-adds. Shared memory: 15,264 bytes a warp; 168 registers.
//
// Every other N (1 <= N <= 63) runs the first design as its own kernel:
// one 256-thread block per matrix in shared memory, each pivot's N^2
// updates split across the block between two barriers (gj_sweep).
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
//
// The host build (g++, the CPU tests) runs the same bodies on host threads:
// the warp body on 32 threads with a std::barrier for __syncwarp(), or on
// one thread that runs all 32 lanes; the block body on any thread count
// with a std::barrier for __syncthreads().

#include <math.h>
#include <stddef.h>

#if defined(__CUDA_ARCH__) || defined(__CUDACC__)
// nvcc: block_linalg.cuh's defaults (__syncthreads, __syncwarp on the card)
#else
#include <barrier>
#include <thread>
#include <vector>
// the host build's barrier, one per run of host threads
static thread_local std::barrier<>* si_host_barrier = nullptr;
static inline void si_host_sync() {
  if (si_host_barrier) si_host_barrier->arrive_and_wait();
}
#define BL_SYNC() si_host_sync()
#define BL_WSYNC() si_host_sync()
#endif
#include "block_linalg.cuh"

#define SI_N 34          // the size of the warp kernel
#define SI_WARPS 2       // matrices (warps) per block of the warp kernel
// __launch_bounds__'s blocks per SM for the warp kernel: it caps the
// registers at 168 (a few bytes spill), the fastest of the caps from 128 to
// 255 timed on the H100
#define SI_MIN_BLOCKS 5
#define SI_THREADS 256   // threads per block of the block kernel

// ---- N = SI_N: one warp per matrix -------------------------------------------

// Shared memory of one warp (floats; 16-byte aligned offsets): A in double
// (rows of LDD), X (rows of LD floats), the sweep's two column buffers, and
// the XC = N - 32 last columns of X in double and of the residual R in
// float.
template <int N> struct SiWarpLayout {
  static_assert(N % 2 == 0, "A's rows are read two doubles at a time");
  static constexpr int XC = BlWarpShape<N>::XC, LD = (N + 3) & ~3;
  static constexpr int LDD = N;                       // doubles
  static constexpr int ad = 0;
  static constexpr int x = ad + ((2 * N * LDD + 3) & ~3);
  static constexpr int buf = x + N * LD;
  static constexpr int rx = buf + 2 * BlWarpShape<N>::LDB;
  static constexpr int xdx = rx + XC * LD;
  static constexpr int total = xdx + ((2 * XC * LDD + 3) & ~3);
};

// acc - sum_k a[k] b[k] (k = 0..N-1, N even) in double: two partial sums,
// of the even and of the odd terms in k order (one fused multiply-add per
// term), so that the chain of dependent multiply-adds is half as long; a
// is in shared memory (16-byte aligned), read two at a time.
template <int N>
BL_HD double si_sub_dot(double acc, const double* a, const double* b) {
  double odd = 0.0;
  BL_UNROLL
  for (int k = 0; k < N; k += 2) {
    double a0, a1;
#ifdef __CUDA_ARCH__
    const double2 v = *reinterpret_cast<const double2*>(a + k);
    a0 = v.x; a1 = v.y;
#else
    a0 = a[k]; a1 = a[k + 1];
#endif
    acc = fma(-a0, b[k], acc);
    odd = fma(-a1, b[k + 1], odd);
  }
  return acc + odd;
}

// One matrix (row-major a, out) by the 32 lanes of one warp, run by `nt`
// threads of LPT lanes each (nt LPT = 32); sw is the warp's shared memory.
template <int N, int LPT>
BL_HD void spd_inverse_warp(const float* a, float* out, float* sw, int tid, int nt) {
  using L = SiWarpLayout<N>;
  constexpr int LD = L::LD, LDD = L::LDD, XC = L::XC;
  double* ad = reinterpret_cast<double*>(sw + L::ad);
  double* xdx = reinterpret_cast<double*>(sw + L::xdx);
  float* sx = sw + L::x;
  float* rx = sw + L::rx;
  float c[LPT][N], x[LPT][2][XC];
  // the lanes' entries into registers (column l: one row per load across
  // the lanes); A in double, symmetric from its lower triangle
  BL_UNROLL
  for (int q = 0; q < LPT; ++q) {
    const int l = tid + q * nt;
    BL_UNROLL
    for (int i = 0; i < N; ++i) {
      c[q][i] = a[i * N + l];
      if (i >= l) ad[i * LDD + l] = ad[l * LDD + i] = (double)c[q][i];
    }
    BL_UNROLL
    for (int h = 0; h < 2; ++h) {
      const int i = l + 32 * h;
      BL_UNROLL
      for (int e = 0; e < XC; ++e) {
        x[q][h][e] = i < N ? a[i * N + 32 + e] : 0.0f;
        if (i < N && i >= 32 + e)
          ad[i * LDD + 32 + e] = ad[(32 + e) * LDD + i] = (double)x[q][h][e];
      }
    }
  }
  gj_warp_sweep<N, LPT>(c, x, sw + L::buf, tid, nt);
  // X to shared memory; its last XC columns also in double
  BL_UNROLL
  for (int q = 0; q < LPT; ++q) {
    const int l = tid + q * nt;
    BL_UNROLL
    for (int i = 0; i < N; ++i) sx[i * LD + l] = c[q][i];
    BL_UNROLL
    for (int h = 0; h < 2; ++h) {
      const int i = l + 32 * h;
      if (i >= N) continue;
      BL_UNROLL
      for (int e = 0; e < XC; ++e) {
        sx[i * LD + 32 + e] = x[q][h][e];
        xdx[e * LDD + i] = (double)x[q][h][e];
      }
    }
  }
  BL_WSYNC();
  // one refinement step, X + X (I - A X)
  // (1) columns 0..31, one per lane: r = e_j - A x_j in double with x_j in
  // registers and A's rows read as broadcasts, then out_j = x_j + X r
  for (int q = 0; q < LPT; ++q) {
    const int j = tid + q * nt;
    double xd[N];
    BL_UNROLL
    for (int k = 0; k < N; ++k) xd[k] = (double)sx[k * LD + j];
    float r[N];
    BL_UNROLL
    for (int i = 0; i < N; ++i) r[i] = (float)si_sub_dot<N>(i == j ? 1.0 : 0.0, ad + i * LDD, xd);
    BL_UNROLL
    for (int i = 0; i < N; ++i) {
      float xr[N];
      bl_row<N>(sx + i * LD, xr);
      float acc = 0.0f;
      BL_UNROLL
      for (int k = 0; k < N; ++k) acc = fmaf(xr[k], r[k], acc);
      out[i * N + j] = sx[i * LD + j] + acc;
    }
  }
  // (2) the last XC columns, spread over the lanes by rows as the sweep
  // holds them: lane l takes rows l and l + 32
  BL_UNROLL
  for (int q = 0; q < LPT; ++q) {
    const int l = tid + q * nt;
    BL_UNROLL
    for (int h = 0; h < 2; ++h) {
      const int i = l + 32 * h;
      if (i >= N) continue;
      BL_UNROLL
      for (int e = 0; e < XC; ++e) {
        double xe[N];
        BL_UNROLL
        for (int k = 0; k < N; ++k) xe[k] = xdx[e * LDD + k];
        rx[e * LD + i] = (float)si_sub_dot<N>(i == 32 + e ? 1.0 : 0.0, ad + i * LDD, xe);
      }
    }
  }
  BL_WSYNC();
  BL_UNROLL
  for (int q = 0; q < LPT; ++q) {
    const int l = tid + q * nt;
    BL_UNROLL
    for (int h = 0; h < 2; ++h) {
      const int i = l + 32 * h;
      if (i >= N) continue;
      float xr[N];
      bl_row<N>(sx + i * LD, xr);
      BL_UNROLL
      for (int e = 0; e < XC; ++e) {
        float acc = 0.0f;
        BL_UNROLL
        for (int k0 = 0; k0 < N; k0 += 4) {
          float t[4];
          if (k0 + 4 <= N) {
            bl_ld4(rx + e * LD + k0, t);
          } else {
            for (int u = 0; u < 4; ++u) t[u] = k0 + u < N ? rx[e * LD + k0 + u] : 0.0f;
          }
          BL_UNROLL
          for (int u = 0; u < 4; ++u)
            if (k0 + u < N) acc = fmaf(xr[k0 + u], t[u], acc);
        }
        out[i * N + 32 + e] = xr[32 + e] + acc;
      }
    }
  }
}

// ---- any other N: one block per matrix (the first design) ----------------------

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

__global__ void __launch_bounds__(32 * SI_WARPS, SI_MIN_BLOCKS)
spd_inverse_warp_kernel(const float* __restrict__ a, float* __restrict__ out, int count) {
  __shared__ __align__(16) float sh[SI_WARPS * SiWarpLayout<SI_N>::total];
  const int w = threadIdx.x >> 5;
  const size_t m = (size_t)blockIdx.x * SI_WARPS + w;
  if (m >= (size_t)count) return;    // whole warps; no block barrier follows
  const size_t off = m * SI_N * SI_N;
  spd_inverse_warp<SI_N, 1>(a + off, out + off, sh + w * SiWarpLayout<SI_N>::total,
                            threadIdx.x & 31, 32);
}

__global__ void spd_inverse_kernel(const float* __restrict__ a,
                                   float* __restrict__ out, int n) {
  extern __shared__ float sh[];
  const size_t off = (size_t)blockIdx.x * n * n;
  spd_inverse_one(a + off, out + off, n, sh, threadIdx.x, blockDim.x);
}

// Invert `count` matrices (count, n, n) on `stream`: the warp kernel for
// n = SI_N, the block kernel otherwise. Returns cudaGetLastError() (0 =
// launched).
extern "C" int pfpn_spd_inverse_launch(const float* a, float* out, int count,
                                       int n, void* stream) {
  if (count <= 0) return 0;
  if (n == SI_N) {
    const int blocks = (count + SI_WARPS - 1) / SI_WARPS;
    spd_inverse_warp_kernel<<<blocks, 32 * SI_WARPS, 0, (cudaStream_t)stream>>>(
        a, out, count);
    return (int)cudaGetLastError();
  }
  const size_t shared = spd_inverse_shared_floats(n) * sizeof(float);
  spd_inverse_kernel<<<count, SI_THREADS, shared, (cudaStream_t)stream>>>(a, out, n);
  return (int)cudaGetLastError();
}

#else

// Host build of the same bodies (g++ -x c++), for the CPU tests. For
// n = SI_N, `threads` is 32 (a warp's lanes, one host thread each, with a
// std::barrier for __syncwarp) or 1 (one thread runs the 32 lanes); for any
// other n, any count of host threads runs the block body with a
// std::barrier for __syncthreads. Returns 1 if `threads` is refused.
extern "C" int pfpn_spd_inverse_host(const float* a, float* out, int count,
                                     int n, int threads) {
  const bool warp = n == SI_N;
  if (threads < 1 || (warp && threads != 1 && threads != 32)) return 1;
  std::vector<float> sh(warp ? SiWarpLayout<SI_N>::total + 4
                             : spd_inverse_shared_floats(n));
  // 16-byte alignment for the warp body's vector accesses
  float* base = sh.data();
  while (reinterpret_cast<size_t>(base) % 16) ++base;
  std::barrier<> bar(threads);
  auto body = [&](int tid) {
    si_host_barrier = threads > 1 ? &bar : nullptr;
    for (int m = 0; m < count; ++m) {
      const size_t off = (size_t)m * n * n;
      if (!warp)
        spd_inverse_one(a + off, out + off, n, base, tid, threads);
      else if (threads == 1)
        spd_inverse_warp<SI_N, 32>(a + off, out + off, base, 0, 1);
      else
        spd_inverse_warp<SI_N, 1>(a + off, out + off, base, tid, 32);
      BL_SYNC();   // the next matrix reuses the shared memory
    }
    si_host_barrier = nullptr;
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(body, t);
  body(0);
  for (auto& th : pool) th.join();
  return 0;
}

#endif

// Threads that run one matrix on the card: a warp for n = SI_N, a block
// otherwise.
extern "C" int pfpn_spd_inverse_group_threads(int n) { return n == SI_N ? 32 : SI_THREADS; }
