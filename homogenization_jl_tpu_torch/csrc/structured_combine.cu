// K2 and K11: the structured interface combine on a full-box hypercube
// base, on the whole state (K2) or on one rank's slab of planes (K11).
//
// K2 replaces homogenization_jl_tpu/ops/structured.py::combine_structured
// (with and without constrain) and ::constrain_structured, which the JAX
// package builds from shifted slice-adds that XLA lowers on the TPU. K11
// replaces ::combine_structured_slab (:902, with and without constrain) and
// ::constrain_structured_slab (:1091), which the JAX package runs inside
// shard_map on a halo-extended slab of shifted slice-adds.
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
// entry, which K11 kept until it took this one) was bound by instructions
// and latency instead, at 8.8x the bytes bound: each thread decoded its
// element with 64-bit divisions and walked a five-deep chain of table loads
// before its one load of x, and the head columns went one 4-byte entry at a
// time. What bounds this design is the latency of the tail's dependent
// loads (column row, owner row, x): the constraint mode, which reads and
// writes the same bytes without the sums, runs near a copy of the state,
// and the sums' partner reads add the rest (chip_smoke.py phase 3 times the
// modes beside a copy, phase 11 K11 beside K2).
//
// Design: one warp per element row (a group of lanes per row when the rows
// are short), the rows walked in cube-major order whatever the storage
// order, so the six simplices of a cube and the cubes next to it are read
// close together. The warp decodes its row's cube coordinates and type t
// once, in 32-bit arithmetic, into the cube's boundary bits (c_k = 0,
// c_k = n - 1). Head columns (< i0, element interiors) are copied with
// 16-byte loads and stores when the operands are aligned, several vectors
// of a lane in flight and the mask applied in the same pass. A lane takes
// COLS tail columns at a time: one row of the column table each (its
// owners' range, and the boundary bits that put its group outside the
// interior box), then the first FIRST owners of each column (a face has
// two), each an element offset, a column offset and the boundary bits that
// drop it, and all of those loads of x go out before any add; an edge's or
// a corner's further owners follow OWNER_BATCH at a time. No coordinate
// arithmetic per entry. An owner outside the box is skipped (the zero
// padding of the JAX form; a zero halo is never added, since -0.0 + 0.0
// would change a bit), and the sum starts from +0 and adds in PATTERN
// ORDER, so every copy of a group comes out bitwise equal.
//
// The window (K11, a compile-time parameter; K2's instantiation has none):
// the rank holds the rows of W planes of cubes of a cube-major state,
// global planes [x0, x0 + W), B = W n^(d-1) ept rows. The boundary bits use
// the global plane x0 + local plane. An owner's row is the copy's local row
// plus its element offset (|plane offset| <= 1 <= pad): below 0 it is row
// r + rel + h of halo_lo (h = pad n^(d-1) ept rows, the pad planes below
// x0), at B or above row r + rel - B of halo_hi (the planes from x0 + W),
// both [h, n_local - i0] tail columns, the column jj + dcol; any other row
// is read from x as K2 reads it. An owner that the boundary bits keep lies
// inside the box, so a missing halo (a domain end) is never read. K11 on a
// slab with the true halos therefore equals K2 on the full state's rows
// bit for bit, and with x0 = 0, W = n it is K2's walk. K11 is two
// launches: the rows of the planes next to no halo in K2's own tail code
// (HALO = false), and the rows of an edge plane next to a halo (HALO =
// true; a row's owners lie at most one plane away), whose owner loads
// select the row base (x, halo_lo or halo_hi) before one load. On an H100,
// one launch with a per-owner branch on every row ran 21% slower than K2
// at S = 1, and a tail function shared by both paths slowed K2 by 4%.
//
// Modes: 0 = combine, 1 = combine with the zero-Dirichlet fold,
//        2 = constraint only (box test, no sum, no halo).
// Optional bool mask [rows, n_local] (mode 0 only): the store multiplies by
// it, so combine-then-mask-constraint (the per-step Dirichlet masks of the
// driver's lattice geometry) stays one pass. Multiplying by 0/1 is exact.
//
// Table layout (int32, built by ops/structured.py::flatten_structured):
//   tab[0], tab[1] = offsets of (16-byte aligned)
//   cols[ept*tw*4]    per (type, tail column): its owners' range q0, q1,
//                     and the boundary bits that put its group outside
//                     the box
//   owners[n_own*4]   forbid bits, element offset, column offset, 0
//                     (_walk_tables)

#include <cuda_runtime.h>

#include <algorithm>

#include "fixed_sum.cuh"
#include "row_head.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 2;         // tail columns of one lane whose loads go out together
constexpr int FIRST = 2;        // owners of a column loaded with the columns (a face's two)
constexpr int OWNER_BATCH = 4;  // the rest (an edge's, a corner's), this many at a time
constexpr int OUTSIDE = 1 << 30;  // ops/structured.py::OUTSIDE, a bit every cube has

// the plane window of K11 (unused by K2's instantiation)
template <typename T>
struct Window {
  const T* lo;  // halo_lo [h, tw] (NULL at x0 = 0)
  const T* hi;  // halo_hi [h, tw] (NULL at x0 + W = n)
  int x0;       // global plane of the first local plane
  int h;        // rows of a halo
  // this launch's rows: the q-th is r0 + q, plus skip from q = split on
  int rows, r0, split, skip;
};

// owner o of tail column jj of local row r (rows [0, E) in x); xt is row
// r's tail in x. HALO: the row lies in an edge plane next to a halo, so the
// owner's row may lie in it (the row base is selected, one load either way)
template <typename T, bool HALO>
__device__ __forceinline__ T owner_value(const T* __restrict__ xt, const Window<T>& win, int r,
                                         int E, int n_local, int tw, int jj, int4 o) {
  if (HALO) {
    const int orow = r + o.y;
    const T* base = orow < 0    ? win.lo + (long long)(orow + win.h) * tw
                    : orow >= E ? win.hi + (long long)(orow - E) * tw
                                : xt + (long long)o.y * n_local;
    return base[jj + o.z];
  }
  return xt[jj + (long long)o.y * n_local + o.z];
}

template <typename T, bool VEC, bool WINDOW, bool HALO>
__global__ void __launch_bounds__(THREADS)
structured_combine_kernel(const T* __restrict__ x, T* __restrict__ out,
                          const bool* __restrict__ mask, int E, int n_local, int i0, int n,
                          int d, int ept, int type_major, int mode, int width,
                          const int* __restrict__ tab, Window<T> win) {
  const int lane_w = threadIdx.x & 31;
  const int lane = lane_w & (width - 1);
  // this lane's row, in cube-major order
  int r = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * (32 / width) + lane_w / width;
  if (r >= (WINDOW ? win.rows : E)) return;
  if (WINDOW) r = win.r0 + r + (r >= win.split ? win.skip : 0);
  const int cube = r / ept;
  const int t = r - cube * ept;
  int bnd = OUTSIDE;  // bit 2k: c_k == 0; bit 2k + 1: c_k == n - 1
  for (int k = d - 1, q = cube; k >= 0; --k) {
    int ck;
    if (WINDOW && k == 0) {
      ck = win.x0 + q;  // the global plane
    } else {
      const int qn = q / n;
      ck = q - qn * n;
      q = qn;
    }
    bnd |= (ck == 0) << (2 * k) | (ck == n - 1) << (2 * k + 1);
  }
  const int e = type_major ? t * (E / ept) + cube : r;
  const long long row = (long long)e * n_local;
  hz::copy_head<T, VEC>(x, out, mask, row, i0, lane, width);

  // tail: COLS columns of the lane at a time, their first owners' loads
  // (mode 2: the entries', and the mask's) issued before any add
  const int tw = n_local - i0;
  const int4* __restrict__ cols = reinterpret_cast<const int4*>(tab + tab[0]) + t * tw;
  const int4* __restrict__ owners = reinterpret_cast<const int4*>(tab + tab[1]);
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
          if (ok[u][f]) v[u][f] = owner_value<T, HALO>(xt, win, r, E, n_local, tw, jj, o);
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
            if (okb[b]) w[b] = owner_value<T, HALO>(xt, win, r, E, n_local, tw, jj, o);
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

// one launch over win.rows rows (K2: all E of them); WINDOW = false is K2
template <typename T, bool WINDOW, bool HALO>
int launch_combine(const void* x, void* out, const void* mask, long long E, int n_local,
                   int i0, int n, int d, int ept, int type_major, int mode, const void* tab,
                   Window<T> win, cudaStream_t stream) {
  const long long rows = WINDOW ? win.rows : E;
  if (rows <= 0) return 0;
  if (E >= (1ll << 31) || !hz::aligned16(tab)) return static_cast<int>(cudaErrorInvalidValue);
  // lanes per row: a power of two, the whole warp from 32 columns up
  int width = 1;
  while (width < 32 && width < n_local) width *= 2;
  const long long rows_per_block = (long long)WARPS * (32 / width);
  const unsigned blocks = static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block);
  constexpr int VW = 16 / sizeof(T);
  const bool vec = hz::aligned16(x) && hz::aligned16(out) &&
                   (mask == nullptr || reinterpret_cast<unsigned long long>(mask) % VW == 0);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const bool* mp = static_cast<const bool*>(mask);
  const int* tp = static_cast<const int*>(tab);
  if (vec)
    structured_combine_kernel<T, true, WINDOW, HALO><<<blocks, THREADS, 0, stream>>>(
        xp, op, mp, (int)E, n_local, i0, n, d, ept, type_major, mode, width, tp, win);
  else
    structured_combine_kernel<T, false, WINDOW, HALO><<<blocks, THREADS, 0, stream>>>(
        xp, op, mp, (int)E, n_local, i0, n, d, ept, type_major, mode, width, tp, win);
  return static_cast<int>(cudaGetLastError());
}

// K11: the interior planes' rows in K2's code, then the edge planes next to
// a halo (owners lie at most one plane away) with the halo branch
template <typename T>
int launch_slab(const void* x, const void* halo_lo, const void* halo_hi, void* out,
                const void* mask, long long B, int n_local, int i0, int n, int d, int ept,
                int x0, int W, int pad, int mode, const void* tab, cudaStream_t stream) {
  long long n2 = 1;  // cubes per plane
  for (int k = 1; k < d; ++k) n2 *= n;
  const long long h = (long long)pad * n2 * ept;
  if (B != (long long)W * n2 * ept || pad > W || h >= (1ll << 31) || B >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rpp = static_cast<int>(n2 * ept);
  // edge rows [0, lo_rows) next to halo_lo and [hi_from, B) next to halo_hi
  const int lo_rows = halo_lo != nullptr ? rpp : 0;
  const int hi_from = halo_hi != nullptr ? std::max(static_cast<int>(B) - rpp, lo_rows)
                                         : static_cast<int>(B);
  Window<T> win{static_cast<const T*>(halo_lo), static_cast<const T*>(halo_hi), x0,
                static_cast<int>(h), 0, 0, 0, 0};
  win.rows = hi_from - lo_rows;
  win.r0 = lo_rows;
  win.split = win.rows;
  int err = launch_combine<T, true, false>(x, out, mask, B, n_local, i0, n, d, ept, 0, mode,
                                           tab, win, stream);
  if (err != 0) return err;
  win.rows = lo_rows + static_cast<int>(B - hi_from);
  win.r0 = 0;
  win.split = lo_rows;
  win.skip = hi_from - lo_rows;
  return launch_combine<T, true, true>(x, out, mask, B, n_local, i0, n, d, ept, 0, mode, tab,
                                       win, stream);
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
  return dtype == 0 ? launch_combine<float, false, false>(x, out, mask, E, n_local, i0, n, d,
                                                          ept, type_major, mode, tab,
                                                          Window<float>{}, s)
                    : launch_combine<double, false, false>(x, out, mask, E, n_local, i0, n, d,
                                                           ept, type_major, mode, tab,
                                                           Window<double>{}, s);
}

// K11. dtype: 0 = float32, 1 = float64; x [B, n_local] with
// B = W n^(d-1) ept rows of a cube-major state, global planes [x0, x0 + W);
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
  return dtype == 0 ? launch_slab<float>(x, halo_lo, halo_hi, out, mask, B, n_local, i0, n, d,
                                         ept, x0, W, pad, mode, tab, s)
                    : launch_slab<double>(x, halo_lo, halo_hi, out, mask, B, n_local, i0, n,
                                          d, ept, x0, W, pad, mode, tab, s);
}
