// K9: the sigma integrals of the checkerboard driver, the mass product and
// the row dots fused.
//
// Replaces homogenization_jl_tpu/models/checkerboard.py::_integrals_fns
// (area, first_term, terms: an einsum with the reference mass matrix, a row
// sum and a masked dot that XLA lowers on the TPU). Its next_rhs is kernel
// K1 with the one-piece stack [mass] and is not here.
//
// Every form reduces to one scalar
//
//   total = scale * sum_e mask[e] * s[e],
//
// with, per element row e (Mx = M x[e], M the symmetric [n, n] mass matrix):
//   mode 0, terms:               s = detJ * sum_i (x + v)_i (Mx)_i
//   mode 1, first_term (quirk):  s = detJ * (sum_i x_i (Mx)_i + sum_i x_i b0_i)
//   mode 2, first_term:          s = sum_i x_i b0_i + detJ * sum_i x_i (Mx)_i
//   mode 3, area:                s = detJ          (scale = sum of M)
//   mode 4, dot_M:               s = detJ * sum_i w_i (Mx)_i
//
// Mode 4 is the M-inner product of the multishift recurrence (kernel K14b,
// homogenization_jl_tpu/models/multishift.py:152-155: dot_M(u, v) =
// sum_e detJ_e u_e . (M v_e), with x = v and w = u), unmasked (mask NULL)
// and with scale 1; the mass apply's output is never written.
//
// Bound on the H100: operations. At the flagship's finest level (E =
// 196,608, n = 969) the mass product is 2 E n^2 = 3.7e11 FLOP, 5.5 ms at
// 67 TFLOP/s FP32, against 1.5 GB of x and v / b0 (0.45 ms at 3.35 TB/s).
//
// Design, three launches:
//   1. K1's shared-memory tiled GEMM on the CUDA cores with one piece and no
//      coefficient (the same tiles, K order and register blocking). Its
//      epilogue does not store M x: each thread multiplies its register tile
//      by the matching entries of u (x, or x + v) and of b0, the threads of a
//      row add their sums in shared memory in thread order, and one partial
//      per (row, column tile) goes to device memory: E * ceil(n / BN) values
//      (6 MB at the flagship size) instead of the 0.76 GB of M x.
//   2. A fixed grid of RED_BLOCKS blocks: each thread walks its block's rows
//      in a fixed stride, adds a row's tile partials in tile order, forms s
//      and multiplies by the mask; the block adds its threads in a fixed tree.
//   3. One block adds the block sums in a fixed tree.
// No atomics and no launch-dependent order: two launches give the same bits,
// which the driver's stopping rule needs (it reads this scalar after every
// iteration).

#include <cuda_runtime.h>

namespace {

constexpr int RED_BLOCKS = 264;  // pass-2 grid: fixed, so the order is too
constexpr int RED_THREADS = 256;

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ void load4(const double* p, double* o) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
integrals_rows_kernel(const T* __restrict__ x, const T* __restrict__ M,
                      const T* __restrict__ w, int mode, T* __restrict__ partA,
                      T* __restrict__ partB, int E, int n) {
  constexpr int NTX = BN / TN;
  constexpr int NTY = BM / TM;
  constexpr int NT = NTX * NTY;
  constexpr int SGM = NTY * 4;
  constexpr int SGN = NTX * 4;
  constexpr int PAD = 4;
  constexpr int A_PER = BM * BK / NT;
  constexpr int B_PER = BK * BN / NT;
  static_assert(TM % 4 == 0 && TN % 4 == 0, "4-wide register groups");
  static_assert(A_PER * NT == BM * BK && B_PER * NT == BK * BN, "tile split");
  __shared__ __align__(16) T As[BK][BM + PAD];
  __shared__ __align__(16) T Bs[BK][BN];
  __shared__ T redA[BM][NTX + 1];
  __shared__ T redB[BM][NTX + 1];

  const int tid = threadIdx.x;
  const int tx = tid % NTX;
  const int ty = tid / NTX;
  const int m0 = blockIdx.x * BN;
  const long long e0 = (long long)blockIdx.y * BM;
  const int ntile = gridDim.x;

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

  T xv[A_PER], sv[B_PER];
  auto load_x = [&](int k0) {
#pragma unroll
    for (int q = 0; q < A_PER; ++q) {
      const int i = tid + q * NT;
      const long long e = e0 + i / BK;
      const int k = k0 + i % BK;
      xv[q] = (e < E && k < n) ? x[e * n + k] : T(0);
    }
  };
  auto load_s = [&](int k0) {
#pragma unroll
    for (int q = 0; q < B_PER; ++q) {
      const int i = tid + q * NT;
      const int k = k0 + i / BN, m = m0 + i % BN;
      sv[q] = (k < n && m < n) ? M[(long long)k * n + m] : T(0);
    }
  };

  load_x(0);
  load_s(0);
  for (int k0 = 0; k0 < n; k0 += BK) {
#pragma unroll
    for (int q = 0; q < A_PER; ++q) {
      const int i = tid + q * NT;
      As[i % BK][i / BK] = xv[q];
    }
#pragma unroll
    for (int q = 0; q < B_PER; ++q) {
      const int i = tid + q * NT;
      Bs[i / BN][i % BN] = sv[q];
    }
    __syncthreads();
    if (k0 + BK < n) {
      load_x(k0 + BK);
      load_s(k0 + BK);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T a[TM], bb[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) load4(&As[kk][g * SGM + ty * 4], a + 4 * g);
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) load4(&Bs[kk][g * SGN + tx * 4], bb + 4 * g);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * bb[j];
    }
    __syncthreads();
  }

  // epilogue: the row dots of this thread's tile, then its row's threads
  // added in thread order
  const bool with_b = mode == 1 || mode == 2;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = (i / 4) * SGM + ty * 4 + i % 4;
    const long long e = e0 + r;
    T sa = T(0), sb = T(0);
    if (e < E) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int m = m0 + (j / 4) * SGN + tx * 4 + j % 4;
        if (m >= n) continue;
        const long long o = e * n + m;
        const T xo = x[o];
        const T u = mode == 0 ? xo + w[o] : (mode == 4 ? w[o] : xo);
        sa += u * acc[i][j];
        if (with_b) sb += xo * w[o];
      }
    }
    redA[r][tx] = sa;
    redB[r][tx] = sb;
  }
  __syncthreads();
  for (int r = tid; r < BM; r += NT) {
    const long long e = e0 + r;
    if (e >= E) continue;
    T sa = T(0), sb = T(0);
#pragma unroll
    for (int t = 0; t < NTX; ++t) {
      sa += redA[r][t];
      sb += redB[r][t];
    }
    partA[e * ntile + blockIdx.x] = sa;
    if (with_b) partB[e * ntile + blockIdx.x] = sb;
  }
}

// fixed-order tree over the block's RED_THREADS values in sh[]; the sum
// ends in sh[0]
template <typename T>
__device__ __forceinline__ void block_tree(T* sh) {
  for (int s = RED_THREADS / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
integrals_reduce_kernel(const T* __restrict__ partA, const T* __restrict__ partB,
                        int ntile, const T* __restrict__ detJ,
                        const T* __restrict__ mask, int mode, long long E,
                        T* __restrict__ blocksum) {
  __shared__ T sh[RED_THREADS];
  const long long chunk = (E + RED_BLOCKS - 1) / RED_BLOCKS;
  const long long lo = blockIdx.x * chunk;
  const long long hi = lo + chunk < E ? lo + chunk : E;
  T s = T(0);
  for (long long e = lo + threadIdx.x; e < hi; e += RED_THREADS) {
    T a = T(0), b = T(0);
    if (mode != 3)
      for (int t = 0; t < ntile; ++t) a += partA[e * ntile + t];
    if (mode == 1 || mode == 2)
      for (int t = 0; t < ntile; ++t) b += partB[e * ntile + t];
    T v;
    if (mode == 0 || mode == 4)
      v = detJ[e] * a;
    else if (mode == 1)
      v = detJ[e] * (a + b);
    else if (mode == 2)
      v = b + detJ[e] * a;
    else
      v = detJ[e];
    s += mask == nullptr ? v : v * mask[e];
  }
  sh[threadIdx.x] = s;
  block_tree(sh);
  if (threadIdx.x == 0) blocksum[blockIdx.x] = sh[0];
}

template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
integrals_final_kernel(const T* __restrict__ blocksum, double scale,
                       T* __restrict__ out) {
  __shared__ T sh[RED_THREADS];
  T s = T(0);
  for (int b = threadIdx.x; b < RED_BLOCKS; b += RED_THREADS) s += blocksum[b];
  sh[threadIdx.x] = s;
  block_tree(sh);
  if (threadIdx.x == 0) out[0] = T(scale) * sh[0];
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
int launch_rows(const T* x, const T* M, const T* w, int mode, T* partA,
                T* partB, int E, int n, int ntile, cudaStream_t stream) {
  const int tiles = (n + BN - 1) / BN;
  if (tiles != ntile) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(tiles, (E + BM - 1) / BM);
  dim3 block((BM / TM) * (BN / TN));
  integrals_rows_kernel<T, BM, BN, BK, TM, TN>
      <<<grid, block, 0, stream>>>(x, M, w, mode, partA, partB, E, n);
  return 0;
}

template <typename T>
int launch_integrals(int mode, const void* x, const void* M, const void* w,
                     const void* detJ, const void* mask, void* partA,
                     void* partB, void* blocksum, void* out, int E, int n,
                     int ntile, double scale, cudaStream_t stream) {
  const T* xx = static_cast<const T*>(x);
  const T* mm = static_cast<const T*>(M);
  const T* ww = static_cast<const T*>(w);
  T* pa = static_cast<T*>(partA);
  T* pb = static_cast<T*>(partB);
  int err = 0;
  if (mode != 3) {
    // the tile shapes of K1 (csrc/element_apply.cu), chosen the same way
    bool done = false;
    if constexpr (sizeof(T) == 4) {
      if (n > 64) {
        err = launch_rows<T, 128, 128, 8, 8, 8>(xx, mm, ww, mode, pa, pb, E, n, ntile, stream);
        done = true;
      }
    }
    if (!done) {
      if (n > 16)
        err = launch_rows<T, 64, 64, 8, 4, 4>(xx, mm, ww, mode, pa, pb, E, n, ntile, stream);
      else
        err = launch_rows<T, 128, 16, 8, 4, 4>(xx, mm, ww, mode, pa, pb, E, n, ntile, stream);
    }
    if (err) return err;
  }
  integrals_reduce_kernel<T><<<RED_BLOCKS, RED_THREADS, 0, stream>>>(
      pa, pb, ntile, static_cast<const T*>(detJ), static_cast<const T*>(mask),
      mode, E, static_cast<T*>(blocksum));
  integrals_final_kernel<T><<<1, RED_THREADS, 0, stream>>>(
      static_cast<const T*>(blocksum), scale, static_cast<T*>(out));
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = float64; mode as above. x, M, w and partA/partB
// may be NULL where the mode does not read them (area reads none of them);
// mask may be NULL (every row counts once).
// ntile = ceil(n / BN) of the tile shape the dtype and n select (checked);
// partA/partB hold [E, ntile], blocksum [RED_BLOCKS], out one value.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a wrong ntile.
extern "C" int hz_integrals(int dtype, int mode, const void* x, const void* M,
                            const void* w, const void* detJ, const void* mask,
                            void* partA, void* partB, void* blocksum,
                            void* out, int E, int n, int ntile, double scale,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      dtype == 0
          ? launch_integrals<float>(mode, x, M, w, detJ, mask, partA, partB,
                                    blocksum, out, E, n, ntile, scale, s)
          : launch_integrals<double>(mode, x, M, w, detJ, mask, partA, partB,
                                     blocksum, out, E, n, ntile, scale, s);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
