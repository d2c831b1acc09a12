// K2: structured interface combine on a full-box hypercube base.
//
// Replaces homogenization_jl_tpu/ops/structured.py::combine_structured
// (with and without constrain) and ::constrain_structured, which the JAX
// package builds from shifted slice-adds that XLA lowers on the TPU.
//
// Every shared face/edge/corner DOF group belongs to a translation-invariant
// orbit: its owners sit at fixed (cube offset D_j, simplex type t_j, local
// cell l_j) positions relative to the group's lattice anchor p. The combine
// writes, to every copy, the sum of all copies; the constraint zeroes the
// groups whose anchor lies outside the orbit's interior box.
//
// Bound on the H100: memory. Each output reads the valence (1-6) copies of
// its group and writes once; the tables are a few KB and stay in L1/L2.
//
// Design: one thread per (element, column). Head columns (< i0, element
// interiors) pass through. For a tail column the thread decodes its cube c
// and type t from the element index (type-major or cube-major order), looks
// up its cell's orbit and offset D, takes the anchor p = c - D, and sums
// x[p + D_j, t_j, col(l_j) + w] over the orbit's pattern IN PATTERN ORDER,
// skipping owners outside the box (the zero padding of the JAX form). No
// atomics and no [E, n] index tables: every copy of a group computes the
// same sum in the same order, so all copies come out bitwise equal.
//
// Modes: 0 = combine, 1 = combine with the zero-Dirichlet fold,
//        2 = constraint only (box test, no sum).
// Optional bool mask [E, n_local] (mode 0 only): the store multiplies by it,
// so combine-then-mask-constraint (the per-step Dirichlet masks of the
// driver's lattice geometry) stays one pass. Multiplying by 0/1 is exact.
//
// Table layout (int32, built by ops/structured.py::flatten_structured):
//   tab[0] = ncell, tab[1..7] = offsets of
//   col_cell[tw], col_w[tw]          cell id and in-cell offset per tail col
//   cell_orbit[ept*ncell]            orbit of cell (t, g)
//   cell_delta[ept*ncell*3]          its offset D (padded to 3 axes)
//   orb_pat[n_orb+1]                 CSR start of each orbit's pattern
//   orb_box[n_orb*7]                 has_interior, int_lo[3], int_hi[3]
//   pat[n_pat*5]                     D_j[3], t_j, first column of cell l_j

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void structured_combine_kernel(const T* __restrict__ x,
                                          T* __restrict__ out,
                                          const bool* __restrict__ mask,
                                          long long total,
                                          int n_local, int i0, int n, int d,
                                          int ept, int type_major, int mode,
                                          const int* __restrict__ tab) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long e = idx / n_local;
  const int j = (int)(idx - e * n_local);
  if (j < i0) {
    out[idx] = mask ? x[idx] * T(mask[idx]) : x[idx];
    return;
  }
  const int ncell = tab[0];
  const int* col_cell = tab + tab[1];
  const int* col_w = tab + tab[2];
  const int* cell_orbit = tab + tab[3];
  const int* cell_delta = tab + tab[4];
  const int* orb_pat = tab + tab[5];
  const int* orb_box = tab + tab[6];
  const int* pat = tab + tab[7];

  long long nd = 1;
  for (int k = 0; k < d; ++k) nd *= n;
  int t;
  long long cube;
  if (type_major) {
    t = (int)(e / nd);
    cube = e - (long long)t * nd;
  } else {
    t = (int)(e % ept);
    cube = e / ept;
  }
  int c[3] = {0, 0, 0};
  for (int k = d - 1; k >= 0; --k) {
    c[k] = (int)(cube % n);
    cube /= n;
  }
  const int jj = j - i0;
  const int cell = t * ncell + col_cell[jj];
  const int w = col_w[jj];
  const int orb = cell_orbit[cell];
  int p[3];
  for (int k = 0; k < 3; ++k) p[k] = c[k] - cell_delta[cell * 3 + k];

  if (mode != 0) {
    const int* box = orb_box + orb * 7;
    bool inside = box[0] != 0;
    for (int k = 0; k < d; ++k)
      inside = inside && p[k] >= box[1 + k] && p[k] <= box[4 + k];
    if (!inside) {
      out[idx] = T(0);
      return;
    }
    if (mode == 2) {
      out[idx] = x[idx];
      return;
    }
  }

  T acc = T(0);
  for (int q = orb_pat[orb]; q < orb_pat[orb + 1]; ++q) {
    const int* pq = pat + q * 5;
    bool ok = true;
    long long cb = 0;
    for (int k = 0; k < d; ++k) {
      const int s = p[k] + pq[k];
      ok = ok && s >= 0 && s < n;
      cb = cb * n + s;
    }
    if (!ok) continue;
    const long long e2 = type_major ? (long long)pq[3] * nd + cb
                                    : cb * ept + pq[3];
    acc += x[e2 * n_local + pq[4] + w];
  }
  out[idx] = mask ? acc * T(mask[idx]) : acc;
}

template <typename T>
void launch_combine(const void* x, void* out, const void* mask, long long E,
                    int n_local, int i0, int n, int d, int ept, int type_major,
                    int mode, const void* tab, cudaStream_t stream) {
  const long long total = E * n_local;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  structured_combine_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<const bool*>(mask), total, n_local, i0, n, d, ept,
      type_major, mode, static_cast<const int*>(tab));
}

}  // namespace

// dtype: 0 = float32, 1 = float64. out must not alias x for modes 0 and 1.
// mask (bool, or NULL) is read in mode 0 only. Returns cudaGetLastError().
extern "C" int hz_structured_combine(int dtype, const void* x, void* out,
                                     const void* mask, long long E,
                                     int n_local, int i0, int n, int d,
                                     int ept, int type_major, int mode,
                                     const void* tab, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_combine<float>(x, out, mask, E, n_local, i0, n, d, ept, type_major,
                          mode, tab, s);
  else
    launch_combine<double>(x, out, mask, E, n_local, i0, n, d, ept,
                           type_major, mode, tab, s);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K11: the same combine on one rank's slab of a cube-major state.
//
// Replaces homogenization_jl_tpu/ops/structured.py::combine_structured_slab
// (:902, with and without constrain) and ::constrain_structured_slab
// (:1091), which the JAX package runs inside shard_map on a halo-extended
// slab of shifted slice-adds.
//
// The rank holds the rows of W planes of cubes, global planes [x0, x0 + W):
// row = ((plane - x0) * n^(d-1) + rest) * ept + t. The halos hold the tail
// columns [i0, n_local) of the pad planes below x0 (halo_lo) and from
// x0 + W up (halo_hi), in the same row order, as the exchange of
// parallel/group.py delivers them.
//
// Bound on the H100: memory, as K2: each output reads its group's owners
// (a halo plane is read by the rows next to it only) and writes once.
//
// Design: K2's, over the plane window. One thread per (local row, column);
// the cube's global anchor is p = (x0 + local plane, c1, c2) - D. Owners are
// summed in K2's pattern order and an owner outside [0, n) on any axis is
// skipped, as in K2 (a zero halo is never added: -0.0 + 0.0 would change a
// bit). An owner plane below x0 reads halo_lo, one at x0 + W or above
// halo_hi (|D_j - D| <= pad <= W keeps it inside the halo). So K11 on a
// slab's rows with the true halos equals K2 on the full state's rows bit
// for bit, and with x0 = 0, W = n it is K2. The modes and the mask are K2's.
namespace {

template <typename T>
__global__ void structured_combine_slab_kernel(
    const T* __restrict__ x, const T* __restrict__ halo_lo,
    const T* __restrict__ halo_hi, T* __restrict__ out,
    const bool* __restrict__ mask, long long total, int n_local, int i0,
    int n, int d, int ept, int x0, int W, int pad, int mode,
    const int* __restrict__ tab) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long e = idx / n_local;
  const int j = (int)(idx - e * n_local);
  if (j < i0) {
    out[idx] = mask ? x[idx] * T(mask[idx]) : x[idx];
    return;
  }
  const int ncell = tab[0];
  const int* col_cell = tab + tab[1];
  const int* col_w = tab + tab[2];
  const int* cell_orbit = tab + tab[3];
  const int* cell_delta = tab + tab[4];
  const int* orb_pat = tab + tab[5];
  const int* orb_box = tab + tab[6];
  const int* pat = tab + tab[7];

  long long n2 = 1;  // cubes per plane
  for (int k = 1; k < d; ++k) n2 *= n;
  const int t = (int)(e % ept);
  long long cube = e / ept;
  int c[3] = {0, 0, 0};
  for (int k = d - 1; k >= 1; --k) {
    c[k] = (int)(cube % n);
    cube /= n;
  }
  c[0] = x0 + (int)cube;
  const int jj = j - i0;
  const int cell = t * ncell + col_cell[jj];
  const int w = col_w[jj];
  const int orb = cell_orbit[cell];
  int p[3];
  for (int k = 0; k < 3; ++k) p[k] = c[k] - cell_delta[cell * 3 + k];

  if (mode != 0) {
    const int* box = orb_box + orb * 7;
    bool inside = box[0] != 0;
    for (int k = 0; k < d; ++k)
      inside = inside && p[k] >= box[1 + k] && p[k] <= box[4 + k];
    if (!inside) {
      out[idx] = T(0);
      return;
    }
    if (mode == 2) {
      out[idx] = x[idx];
      return;
    }
  }

  const int tw = n_local - i0;
  T acc = T(0);
  for (int q = orb_pat[orb]; q < orb_pat[orb + 1]; ++q) {
    const int* pq = pat + q * 5;
    bool ok = true;
    long long rest = 0;
    for (int k = 0; k < d; ++k) {
      const int s = p[k] + pq[k];
      ok = ok && s >= 0 && s < n;
      if (k > 0) rest = rest * n + s;
    }
    if (!ok) continue;
    const int s0 = p[0] + pq[0];
    const int col = pq[4] + w;
    if (s0 < x0) {
      const long long row = ((long long)(s0 - x0 + pad) * n2 + rest) * ept + pq[3];
      acc += halo_lo[row * tw + (col - i0)];
    } else if (s0 >= x0 + W) {
      const long long row = ((long long)(s0 - x0 - W) * n2 + rest) * ept + pq[3];
      acc += halo_hi[row * tw + (col - i0)];
    } else {
      const long long row = ((long long)(s0 - x0) * n2 + rest) * ept + pq[3];
      acc += x[row * n_local + col];
    }
  }
  out[idx] = mask ? acc * T(mask[idx]) : acc;
}

template <typename T>
void launch_slab(const void* x, const void* halo_lo, const void* halo_hi,
                 void* out, const void* mask, long long B, int n_local, int i0,
                 int n, int d, int ept, int x0, int W, int pad, int mode,
                 const void* tab, cudaStream_t stream) {
  const long long total = B * n_local;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks == 0) return;
  structured_combine_slab_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(halo_lo),
      static_cast<const T*>(halo_hi), static_cast<T*>(out),
      static_cast<const bool*>(mask), total, n_local, i0, n, d, ept, x0, W,
      pad, mode, static_cast<const int*>(tab));
}

}  // namespace

// dtype: 0 = float32, 1 = float64; x [B, n_local] with B = W n^(d-1) ept;
// halo_lo / halo_hi [pad n^(d-1) ept, n_local - i0] (NULL in mode 2, and
// halo_lo at x0 = 0 and halo_hi at x0 + W = n, which are never read); out
// must not alias x or the halos. mask (bool, or NULL) as in K2. Returns
// cudaGetLastError().
extern "C" int hz_structured_combine_slab(int dtype, const void* x,
                                          const void* halo_lo,
                                          const void* halo_hi, void* out,
                                          const void* mask, long long B,
                                          int n_local, int i0, int n, int d,
                                          int ept, int x0, int W, int pad,
                                          int mode, const void* tab,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_slab<float>(x, halo_lo, halo_hi, out, mask, B, n_local, i0, n, d,
                       ept, x0, W, pad, mode, tab, s);
  else
    launch_slab<double>(x, halo_lo, halo_hi, out, mask, B, n_local, i0, n, d,
                        ept, x0, W, pad, mode, tab, s);
  return static_cast<int>(cudaGetLastError());
}
