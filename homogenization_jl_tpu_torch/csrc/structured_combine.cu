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
// Bound on the H100: memory. Each output is read and written once (the
// bound); the partner copies a tail entry also reads (1 face, 3-5 edge, 23
// corner) come mostly from L2, since the rows of a cube and of its
// neighbours are walked close together. The first design (one thread per
// entry) was bound by instructions and latency instead, at 8.8x the bytes
// bound: each thread decoded its element with 64-bit divisions and walked a
// five-deep chain of table loads before its one load of x, and the head
// columns went one 4-byte entry at a time. What bounds this design is the
// latency of the tail's dependent loads (column row, owner row, x): the
// constraint mode, which reads and writes the same bytes without the sums,
// runs near a copy of the state, and the sums' partner reads add the rest
// (chip_smoke.py phase 3 times the modes beside a copy).
//
// Design: one warp per element row (a group of lanes per row when the rows
// are short), the rows walked in cube-major order whatever the storage
// order, so the six simplices of a cube and the cubes next to it are read
// close together. The warp decodes its row's cube coordinates and type t
// once, in 32-bit arithmetic, into the cube's boundary bits (c_k = 0,
// c_k = n - 1). Head columns (< i0, element interiors) are copied with
// 16-byte loads and stores when the operands are aligned, several vectors
// of a lane in flight and the mask applied in the same pass. A lane takes
// COLS tail columns at a time: one row of K2's column table each (its
// owners' range, and the boundary bits that put its group outside the
// interior box), then the first FIRST owners of each column (a face has
// two), each an element offset, a column offset and the boundary bits that
// drop it, and all of those loads of x go out before any add; an edge's or
// a corner's further owners follow OWNER_BATCH at a time. No coordinate
// arithmetic per entry. An owner outside the box is skipped (the zero
// padding of the JAX form), and the sum starts from +0 and adds in PATTERN
// ORDER as the first design and K11 do, so every copy of a group comes out
// bitwise equal, and equal to K11's.
//
// Modes: 0 = combine, 1 = combine with the zero-Dirichlet fold,
//        2 = constraint only (box test, no sum).
// Optional bool mask [E, n_local] (mode 0 only): the store multiplies by it,
// so combine-then-mask-constraint (the per-step Dirichlet masks of the
// driver's lattice geometry) stays one pass. Multiplying by 0/1 is exact.
//
// Table layout (int32, built by ops/structured.py::flatten_structured):
//   tab[0] = ncell, tab[1..9] = offsets of
//   col_cell[tw], col_w[tw]          cell id and in-cell offset per tail col
//   cell_orbit[ept*ncell]            orbit of cell (t, g)
//   cell_delta[ept*ncell*3]          its offset D (padded to 3 axes)
//   orb_pat[n_orb+1]                 CSR start of each orbit's pattern
//   orb_box[n_orb*7]                 has_interior, int_lo[3], int_hi[3]
//   pat[n_pat*5]                     D_j[3], t_j, first column of cell l_j
//   cols[ept*tw*4]       (K2)        per (type, tail column): its owners'
//                                    range q0, q1, and the boundary bits
//                                    that put its group outside the box
//   owners[n_own*4]      (K2)        forbid bits, element offset, column
//                                    offset, 0 (_walk_tables)
// K2 reads cols and owners; K11 the first seven.

#include <cuda_runtime.h>

#include "fixed_sum.cuh"
#include "row_head.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 2;         // tail columns of one lane whose loads go out together
constexpr int FIRST = 2;        // owners of a column loaded with the columns (a face's two)
constexpr int OWNER_BATCH = 4;  // the rest (an edge's, a corner's), this many at a time
constexpr int OUTSIDE = 1 << 30;  // ops/structured.py::OUTSIDE, a bit every cube has

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
structured_combine_kernel(const T* __restrict__ x, T* __restrict__ out,
                          const bool* __restrict__ mask, int E, int n_local, int i0, int n,
                          int d, int ept, int type_major, int mode, int width,
                          const int* __restrict__ tab) {
  const int lane_w = threadIdx.x & 31;
  const int lane = lane_w & (width - 1);
  // this lane's row, in cube-major order
  const int r = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * (32 / width) + lane_w / width;
  if (r >= E) return;
  const int cube = r / ept;
  const int t = r - cube * ept;
  int bnd = OUTSIDE;  // bit 2k: c_k == 0; bit 2k + 1: c_k == n - 1
  for (int k = d - 1, q = cube; k >= 0; --k) {
    const int qn = q / n;
    const int ck = q - qn * n;
    q = qn;
    bnd |= (ck == 0) << (2 * k) | (ck == n - 1) << (2 * k + 1);
  }
  const int e = type_major ? t * (E / ept) + cube : r;
  const long long row = (long long)e * n_local;
  hz::copy_head<T, VEC>(x, out, mask, row, i0, lane, width);

  // tail: COLS columns of the lane at a time, their first owners' loads
  // (mode 2: the entries', and the mask's) issued before any add
  const int tw = n_local - i0;
  const int4* __restrict__ cols = reinterpret_cast<const int4*>(tab + tab[8]) + t * tw;
  const int4* __restrict__ owners = reinterpret_cast<const int4*>(tab + tab[9]);
  const T* __restrict__ xt = x + row + i0;
  T* __restrict__ ot = out + row + i0;
  for (int jb = lane; jb < tw; jb += COLS * width) {
    int4 ce[COLS];  // q0, q1, box bits
    bool keep[COLS], ok[COLS][FIRST], mv[COLS];
    T v[COLS][FIRST];
#pragma unroll
    for (int u = 0; u < COLS; ++u) {
      const int jj = jb + u * width;
      ce[u] = jj < tw ? __ldg(cols + jj) : make_int4(0, 0, OUTSIDE, 0);
      keep[u] = mode == 0 ? jj < tw : (ce[u].z & bnd) == 0;
    }
#pragma unroll
    for (int u = 0; u < COLS; ++u) {
      const int jj = jb + u * width;
#pragma unroll
      for (int f = 0; f < FIRST; ++f) {
        const int q = ce[u].x + f;
        ok[u][f] = false;
        if (mode == 2) {
          if (f == 0 && keep[u]) {
            ok[u][0] = true;
            v[u][0] = xt[jj];
          }
        } else if (keep[u] && q < ce[u].y) {
          const int4 o = __ldg(owners + q);  // forbid, element offset, column offset
          ok[u][f] = (o.x & bnd) == 0;
          if (ok[u][f]) v[u][f] = xt[jj + (long long)o.y * n_local + o.z];
        }
      }
      mv[u] = mask != nullptr && keep[u] && mask[row + i0 + jj];
    }
#pragma unroll
    for (int u = 0; u < COLS; ++u) {
      const int jj = jb + u * width;
      if (jj >= tw) break;
      if (!keep[u] || mode == 2) {
        ot[jj] = keep[u] ? v[u][0] : T(0);
        continue;
      }
      // the group's sum, in pattern order from +0
      T acc = T(0);
#pragma unroll
      for (int f = 0; f < FIRST; ++f)
        if (ok[u][f]) acc += v[u][f];
      for (int q = ce[u].x + FIRST; q < ce[u].y; q += OWNER_BATCH) {
        T w[OWNER_BATCH];
        bool okb[OWNER_BATCH];
#pragma unroll
        for (int b = 0; b < OWNER_BATCH; ++b) {
          okb[b] = false;
          if (q + b < ce[u].y) {
            const int4 o = __ldg(owners + q + b);
            okb[b] = (o.x & bnd) == 0;
            if (okb[b]) w[b] = xt[jj + (long long)o.y * n_local + o.z];
          }
        }
#pragma unroll
        for (int b = 0; b < OWNER_BATCH; ++b)
          if (okb[b]) acc += w[b];
      }
      ot[jj] = mask ? acc * T(mv[u]) : acc;
    }
  }
}

template <typename T>
int launch_combine(const void* x, void* out, const void* mask, long long E, int n_local,
                   int i0, int n, int d, int ept, int type_major, int mode, const void* tab,
                   cudaStream_t stream) {
  if (E <= 0) return 0;
  if (E >= (1ll << 31) || !hz::aligned16(tab)) return static_cast<int>(cudaErrorInvalidValue);
  // lanes per row: a power of two, the whole warp from 32 columns up
  int width = 1;
  while (width < 32 && width < n_local) width *= 2;
  const long long rows_per_block = (long long)WARPS * (32 / width);
  const unsigned blocks = static_cast<unsigned>((E + rows_per_block - 1) / rows_per_block);
  constexpr int VW = 16 / sizeof(T);
  const bool vec = hz::aligned16(x) && hz::aligned16(out) &&
                   (mask == nullptr || reinterpret_cast<unsigned long long>(mask) % VW == 0);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const bool* mp = static_cast<const bool*>(mask);
  const int* tp = static_cast<const int*>(tab);
  if (vec)
    structured_combine_kernel<T, true><<<blocks, THREADS, 0, stream>>>(
        xp, op, mp, (int)E, n_local, i0, n, d, ept, type_major, mode, width, tp);
  else
    structured_combine_kernel<T, false><<<blocks, THREADS, 0, stream>>>(
        xp, op, mp, (int)E, n_local, i0, n, d, ept, type_major, mode, width, tp);
  return 0;
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
  const int err =
      dtype == 0 ? launch_combine<float>(x, out, mask, E, n_local, i0, n, d, ept, type_major,
                                         mode, tab, s)
                 : launch_combine<double>(x, out, mask, E, n_local, i0, n, d, ept, type_major,
                                          mode, tab, s);
  if (err != 0) return err;
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
