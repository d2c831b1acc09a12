// K18: the state-sized elementwise passes of the solver.
//
// Replaces the elementwise expressions of homogenization_jl_tpu/solver/
// multigrid.py and ops/interfaces.py that XLA fuses into passes on the TPU,
// where the port would otherwise run PyTorch's own elementwise kernels:
//
//   mask:         out = x * m                      (ops/interfaces.py:58
//                 apply_mask; the mask constraint, the smoothers' b * bm)
//   mul:          out = a * b                      (the Lanczos matvec's
//                 dinv * y, solver/multigrid.py:580)
//   lanczos:      out = (u - alpha v) - beta w     (the three-term update,
//                 :610; alpha, beta device scalars; without w, the first
//                 step's u - alpha v, which is the bits of the JAX form's
//                 (u - alpha v) - beta * 0 from a zero v_prev)
//   div_nz:       out = v / (s == 0 ? 1 : s)       (the normalizations,
//                 :604, :612; s a device scalar)
//   inv_positive: out = d > 0 ? 1 / d : 0          (the Jacobi inverse,
//                 :575, :690)
//   diagonal:     out[e, m] = sum_p c[e, p] dref[p, m]  (the assembled
//                 diagonal before its combine, einsum at :541-548)
//
// Bound on the H100: bytes. At the finest level (E * n = 190.5M values,
// 0.76 GB per float32 state) the mask moves 1.71 GB (0.51 ms at 3.35 TB/s),
// the three-term update 3.05 GB. Design: one thread per entry, no reuse to
// exploit; every product, sum and quotient rounded on its own (the _rn
// intrinsics: nothing is contracted into an FMA), so each entry gives the
// bits of its plain PyTorch form (ops/elementwise.py). ``out`` may alias the
// first operand.
//
// The diagonal is bound by its output alone (0.76 GB written against 5.5
// MB of coefficients at P = 7: 0.229 ms), but a thread per entry made it
// issue bound (1.226 ms, slower than one torch.matmul): a 64-bit division
// per entry and 2P loads for one store. Now a block stages the [P, W]
// window of dref's columns in shared memory once and walks groups of
// DIAG_ROWS rows: each thread loads the group's P coefficients of each row
// into registers once (uniform loads), then for each of its columns reads
// the P staged values once for all the group's rows and stores an entry of
// each, the lanes striding the window's columns (coalesced stores). No
// division per entry; a 64-bit row base per group. Narrow windows (the
// coarse levels, n < 256) put row groups of whole warps (or of W threads
// below a warp) side by side in a block.
// What bounds it is the write stream: two blocks per SM, each writing its
// rows (more at once ran slower). Rows of odd n start off the 32-byte
// sectors, so most warp stores write partial sectors; with 7 pieces the
// arithmetic between stores hides that, with one piece (the mass solves'
// diagonal) it lost to torch.matmul. So the one-piece form first writes the
// block's rows into a shared-memory tile, placed so that out's 128-byte
// lines meet aligned tile lines, and stores it in 16-byte vectors of whole
// lines. The sum runs in piece order from +0 as the plain form's loop does
// (XLA's einsum may order it otherwise). A launch takes up to DIAG_PIECES
// pieces (the port's stacks have 7 or 1) and the columns of a window that
// shared memory holds: a wider row is several launches (hz_ew_diagonal
// plans them: diag_width, diag_lanes).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

__device__ __forceinline__ long long entry() {
  return (long long)blockIdx.x * THREADS + threadIdx.x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mask_kernel(const T* x, const bool* __restrict__ m, T* out, long long N) {
  const long long i = entry();
  if (i < N) out[i] = mul_rn(x[i], T(m[i]));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mul_kernel(const T* a, const T* b, T* out, long long N) {
  const long long i = entry();
  if (i < N) out[i] = mul_rn(a[i], b[i]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
lanczos_kernel(const T* u, const T* v, const T* w, const T* __restrict__ alpha,
               const T* __restrict__ beta, T* out, long long N) {
  const long long i = entry();
  if (i >= N) return;
  const T y = sub_rn(u[i], mul_rn(*alpha, v[i]));
  out[i] = w == nullptr ? y : sub_rn(y, mul_rn(*beta, w[i]));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
div_nz_kernel(const T* v, const T* __restrict__ s, T* out, long long N) {
  const long long i = entry();
  if (i >= N) return;
  const T d = *s;
  out[i] = div_rn(v[i], d == T(0) ? T(1) : d);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
inv_positive_kernel(const T* d, T* out, long long N) {
  const long long i = entry();
  if (i >= N) return;
  const T v = d[i];
  out[i] = v > T(0) ? div_rn(T(1), v) : T(0);
}

constexpr int DIAG_THREADS = 256;
constexpr int DIAG_ROWS = 4;
constexpr int DIAG_PIECES = 8;
constexpr int DIAG_LINE = 128;  // bytes
constexpr size_t DIAG_SMEM_MAX = 227 * 1024;
// blocks per SM for a window of DIAG_THREADS columns or more: each writes
// DIAG_ROWS rows at once, and more of these streams at once ran slower
// (float32, n = 969); narrower windows take as many as the SM holds
constexpr int DIAG_BLOCKS_PER_SM = 2;

// threads of a row group for a window of W columns: the block's for a wide
// window; for a narrower one whole warps, the most that W fills (a power of
// two, so the groups fill the block), or W itself below a warp
int diag_lanes(int W) {
  if (W >= DIAG_THREADS) return DIAG_THREADS;
  if (W < 32) return W;
  int lanes = 32;
  while (lanes * 2 <= W) lanes *= 2;
  return lanes;
}

// shared memory of a launch: the staged [P, W] window, rounded to 16 bytes,
// and for one piece the tile of the block's rows with a line to spare
template <typename T>
size_t diag_smem(int P, int W) {
  constexpr size_t V = 16 / sizeof(T);
  size_t entries = ((size_t)P * W + V - 1) / V * V;
  if (P == 1) entries += (size_t)DIAG_ROWS * (DIAG_THREADS / diag_lanes(W)) * W + DIAG_LINE / sizeof(T);
  return entries * sizeof(T);
}

// the widest window of a row of n columns that shared memory holds (n on
// every path of the port: a wider row is several launches)
template <typename T>
int diag_width(int P, int n) {
  const long long most = (long long)(DIAG_SMEM_MAX / (sizeof(T) * (P + (P == 1 ? DIAG_ROWS : 0))));
  int W = most < n ? (int)most : n;
  if (W < 1) W = 1;
  while (W > 1 && diag_smem<T>(P, W) > DIAG_SMEM_MAX) --W;
  return W;
}

// columns [m0, m0 + W) of out [E, n] = sum_p c[e, p] dref[p, m]; ``lanes``
// threads take a row group, DIAG_THREADS / lanes groups side by side in a
// block
template <typename T, int P>
__global__ void __launch_bounds__(DIAG_THREADS)
diagonal_kernel(const T* __restrict__ c, const T* __restrict__ dref, T* __restrict__ out,
                long long E, int n, int m0, int W, int lanes) {
  constexpr int R = DIAG_ROWS;
  constexpr int V = 16 / sizeof(T);
  constexpr bool TILE = P == 1;
  extern __shared__ __align__(16) unsigned char diag_smem_raw[];
  T* ds = reinterpret_cast<T*>(diag_smem_raw);  // [P, W]: dref[:, m0:m0 + W]
  T* tile = ds + (P * W + V - 1) / V * V;       // TILE: the block's rows
  for (int i = threadIdx.x; i < P * W; i += DIAG_THREADS) {
    const int p = i / W;
    ds[i] = dref[(long long)p * n + m0 + (i - p * W)];
  }
  __syncthreads();
  const int subs = DIAG_THREADS / lanes;
  const int sub = threadIdx.x / lanes;
  const int lane = threadIdx.x - sub * lanes;
  const long long groups = (E + R - 1) / R;
  // a block takes `subs` consecutive groups a step (the same steps for all
  // its threads: the tile's barriers)
  for (long long g0 = (long long)blockIdx.x * subs; g0 < groups;
       g0 += (long long)gridDim.x * subs) {
    const long long e0 = (g0 + sub) * R;
    const int rows = sub < subs && e0 < E ? (E - e0 < R ? (int)(E - e0) : R) : 0;
    T* o = out + e0 * n + m0;
    T* ob = out + g0 * R * n + m0;  // the block's first row
    // the tile holds out's entries from ob on, `shift` entries into its
    // line, so out's lines and the tile's start together
    const int shift =
        TILE && W == n ? (int)((reinterpret_cast<size_t>(ob) % DIAG_LINE) / sizeof(T)) : 0;
    T* tb = tile + shift + sub * R * W;
    if (rows > 0) {
      T cr[R][P];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int p = 0; p < P; ++p) cr[r][p] = r < rows ? c[(e0 + r) * P + p] : T(0);
      for (int j = lane; j < W; j += lanes) {
        T dv[P];
#pragma unroll
        for (int p = 0; p < P; ++p) dv[p] = ds[p * W + j];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < rows) {
            T acc = T(0);
#pragma unroll
            for (int p = 0; p < P; ++p) acc = add_rn(acc, mul_rn(cr[r][p], dv[p]));
            if constexpr (TILE)
              tb[r * W + j] = acc;
            else
              o[(long long)r * n + j] = acc;
          }
        }
      }
    }
    if constexpr (TILE) {
      __syncthreads();
      const long long left = E - g0 * R;
      const int total = (int)(left < (long long)subs * R ? left : (long long)subs * R) * W;
      if (W == n) {  // the rows are one flat range: 16-byte vectors of whole lines
        T* oa = ob - shift;
        for (int q = threadIdx.x; q < (total + shift + V - 1) / V; q += DIAG_THREADS) {
          const int lo = q * V - shift;
          if (lo >= 0 && lo + V <= total) {
            if constexpr (V == 4)
              *reinterpret_cast<float4*>(oa + q * V) = *reinterpret_cast<const float4*>(tile + q * V);
            else
              *reinterpret_cast<double2*>(oa + q * V) = *reinterpret_cast<const double2*>(tile + q * V);
          } else {
            for (int k = 0; k < V; ++k)
              if (lo + k >= 0 && lo + k < total) ob[lo + k] = tile[q * V + k];
          }
        }
      } else {  // a window: row by row
        for (int t = threadIdx.x; t < total; t += DIAG_THREADS) {
          const int r = t / W;
          ob[(long long)r * n + (t - r * W)] = tile[t];
        }
      }
      __syncthreads();
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

template <typename T, int P>
int launch_diagonal(const void* c, const void* dref, void* out, long long E, int n, int m0,
                    int W, int lanes, cudaStream_t st) {
  auto kern = diagonal_kernel<T, P>;
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DIAG_SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = true;
  }
  const size_t smem = diag_smem<T>(P, W);
  const int subs = DIAG_THREADS / lanes;
  const long long groups = (E + DIAG_ROWS - 1) / DIAG_ROWS;
  const long long need = (groups + subs - 1) / subs;
  int per_sm = DIAG_BLOCKS_PER_SM;
  if (W < DIAG_THREADS) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, DIAG_THREADS, smem);
  const long long most = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
  kern<<<static_cast<unsigned>(need < most ? need : most), DIAG_THREADS, smem, st>>>(
      static_cast<const T*>(c), static_cast<const T*>(dref), static_cast<T*>(out), E, n, m0, W,
      lanes);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_diagonal_p(const void* c, const void* dref, void* out, long long E, int P, int n,
                      int m0, int W, int lanes, cudaStream_t st) {
  switch (P) {
    case 1: return launch_diagonal<T, 1>(c, dref, out, E, n, m0, W, lanes, st);
    case 2: return launch_diagonal<T, 2>(c, dref, out, E, n, m0, W, lanes, st);
    case 3: return launch_diagonal<T, 3>(c, dref, out, E, n, m0, W, lanes, st);
    case 4: return launch_diagonal<T, 4>(c, dref, out, E, n, m0, W, lanes, st);
    case 5: return launch_diagonal<T, 5>(c, dref, out, E, n, m0, W, lanes, st);
    case 6: return launch_diagonal<T, 6>(c, dref, out, E, n, m0, W, lanes, st);
    case 7: return launch_diagonal<T, 7>(c, dref, out, E, n, m0, W, lanes, st);
    default: return launch_diagonal<T, 8>(c, dref, out, E, n, m0, W, lanes, st);
  }
}

// one launch per window of the row (one on every path of the port)
template <typename T>
int diagonal_windows(const void* c, const void* dref, void* out, long long E, int P, int n,
                     cudaStream_t st) {
  const int width = diag_width<T>(P, n);
  for (int m0 = 0; m0 < n; m0 += width) {
    const int W = n - m0 < width ? n - m0 : width;
    const int e = launch_diagonal_p<T>(c, dref, out, E, P, n, m0, W, diag_lanes(W), st);
    if (e != 0) return e;
  }
  return 0;
}

unsigned blocks(long long N) { return static_cast<unsigned>((N + THREADS - 1) / THREADS); }

template <typename T>
T* p(void* q) { return static_cast<T*>(q); }
template <typename T>
const T* p(const void* q) { return static_cast<const T*>(q); }

}  // namespace

// dtype: 0 = float32, 1 = float64. N entries each; masks are bool; alpha,
// beta and s are one value each on the device; w may be NULL. ``out`` may
// alias x / a / u / v / d. Each returns cudaGetLastError().
extern "C" int hz_ew_mask(int dtype, const void* x, const void* m, void* out, long long N,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N > 0) {
    if (dtype == 0)
      mask_kernel<float><<<blocks(N), THREADS, 0, st>>>(p<float>(x), p<bool>(m), p<float>(out), N);
    else
      mask_kernel<double><<<blocks(N), THREADS, 0, st>>>(p<double>(x), p<bool>(m), p<double>(out), N);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hz_ew_mul(int dtype, const void* a, const void* b, void* out, long long N,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N > 0) {
    if (dtype == 0)
      mul_kernel<float><<<blocks(N), THREADS, 0, st>>>(p<float>(a), p<float>(b), p<float>(out), N);
    else
      mul_kernel<double><<<blocks(N), THREADS, 0, st>>>(p<double>(a), p<double>(b), p<double>(out), N);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hz_ew_lanczos(int dtype, const void* u, const void* v, const void* w,
                             const void* alpha, const void* beta, void* out, long long N,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N > 0) {
    if (dtype == 0)
      lanczos_kernel<float><<<blocks(N), THREADS, 0, st>>>(
          p<float>(u), p<float>(v), p<float>(w), p<float>(alpha), p<float>(beta), p<float>(out), N);
    else
      lanczos_kernel<double><<<blocks(N), THREADS, 0, st>>>(
          p<double>(u), p<double>(v), p<double>(w), p<double>(alpha), p<double>(beta),
          p<double>(out), N);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hz_ew_div_nz(int dtype, const void* v, const void* s, void* out, long long N,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N > 0) {
    if (dtype == 0)
      div_nz_kernel<float><<<blocks(N), THREADS, 0, st>>>(p<float>(v), p<float>(s), p<float>(out), N);
    else
      div_nz_kernel<double><<<blocks(N), THREADS, 0, st>>>(p<double>(v), p<double>(s), p<double>(out), N);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hz_ew_inv_positive(int dtype, const void* d, void* out, long long N,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N > 0) {
    if (dtype == 0)
      inv_positive_kernel<float><<<blocks(N), THREADS, 0, st>>>(p<float>(d), p<float>(out), N);
    else
      inv_positive_kernel<double><<<blocks(N), THREADS, 0, st>>>(p<double>(d), p<double>(out), N);
  }
  return static_cast<int>(cudaGetLastError());
}

// c [E, P], dref [P, n], out [E, n] (must not alias c or dref); P pieces
// from 1 to DIAG_PIECES (more is refused: cudaErrorInvalidValue).
extern "C" int hz_ew_diagonal(int dtype, const void* c, const void* dref, void* out, long long E,
                              int P, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P < 1 || P > DIAG_PIECES || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (E > 0 && n > 0) {
    const int e = dtype == 0 ? diagonal_windows<float>(c, dref, out, E, P, n, st)
                             : diagonal_windows<double>(c, dref, out, E, P, n, st);
    if (e != 0) return e;
  }
  return static_cast<int>(cudaGetLastError());
}
