// K1: matrix-free element apply, y[e] = sum_p coeff[e,p] * (S_p @ x[e]),
// over the nonzeros of the stack.
//
// Replaces homogenization_jl_tpu/ops/apply.py::element_apply (a chain of P
// batched matmuls that XLA lowers on the TPU). The JAX package multiplies
// the dense [P, n, n] stack only to feed the TPU's matrix unit; the slices
// are almost empty. At n = 969 the union of the seven slices has 12,121
// nonzeros (12.5 per row, at most 19), 1.3% of the dense product, and the
// zeros are exact. The Julia reference applies these operators as
// per-element sparse products (src/apply_local_operators.jl); so does
// this kernel, over the row table of the stack (ops/apply.py::stack_table,
// in K1's layout: a word per slot and the stack's distinct slot vectors,
// the P pieces of a slot padded to PP = 1, 4 or 8).
//
// Bound on the H100: bytes. At the finest main-path level (E = 196,608,
// n = 969, P = 7) the residual form moves x, b and out (2.29 GB, 0.68 ms
// at 3.35 TB/s) against 2 * E * 66,418 = 26.1 GFLOP of nonzero work (0.39
// ms at 67 TFLOP/s FP32). Tensor cores would not help: at ~12.5 nonzeros
// per row there is no dense tile to feed them, and the dense product they
// could run (DMMA, TF32 wgmma) is 77 times the work.
//
// Design: a persistent pipeline. One block of 16 warps per SM loops over
// steps of G consecutive elements (block i takes steps i, i + grid, ...):
//   * The table stays in shared memory for the whole launch, landed once
//     per block with the first step: a slot word per (row, slot), its
//     column | the index of its vector << 16, rows in groups of 16 (a warp
//     item's rows side by side, each group's row counts after its R
//     slots), and the V distinct slot vectors of PP pieces (353 of them at
//     n = 969 in float32; ops/apply.py::slot_layout). The walk reads no
//     table from L2, which held the first design at a third of its issue
//     rate.
//   * While the warps walk step k, one thread's bulk copy (cp.async.bulk,
//     completing on an mbarrier) lands step k + 1's x rows and
//     coefficients raw, one contiguous run each, from its first 16-byte
//     boundary to its last; threads fetch the head and tail (under 16 bytes
//     each) into the landing as they walk. So each SM streams its next x
//     while it computes.
//   * Between two walks the block widens each landed value to the state
//     type (and, in the residual form, subtracts the shift x[e, 0]: the one
//     rounding the first design's stage made) and writes it transposed: a
//     chunk group of the elements whose values of one column fill 64 bytes
//     (16 float32, 8 float64) lies column by column, so a lane reads its 8
//     (float32) or 4 (float64) elements of a column as two 16-byte vectors.
//     Each column's 16-byte units are swapped pairwise where bit 1 of the
//     column is set (col_elem), so that the four rows of a quarter-warp
//     meet different banks when their columns differ mod 4.
//   * A warp item is 16 rows of one chunk group, 2 lanes a row; a lane
//     walks row m's real slots in order, two slots a turn, each slot's word
//     read two slots ahead and its vector and x values one slot ahead,
//     keeping GC * P accumulators: the per-piece partials sum_k S_p[m, k]
//     x_k of the JAX form's order, then y = sum_p coeff[e, p] * partial_p
//     in piece order.
// The sums run in a fixed order with no atomics: two launches give the same
// bits, the first design's bits (one block of 32 elements per SM, the table
// read through L1), and K16's apply on the widened x is K1's bit for bit.
//
// Shared memory at n = 969 in float32 (G = 16 elements a step): slot words
// 78,208 B (61 groups x 20 slot rows x 16 rows x 4 B, and two spare slot
// rows read ahead), slot vectors 11,296 B, coefficients and shifts 576 B,
// transposed rows 62,016 B, landing runs 62,032 + 464 B, the mbarrier 16 B:
// 214,608 B of the SM's 227 KB. A narrower row takes more chunk groups a
// step (at least 64 warp items where the memory holds them). Where one
// chunk group's landing does not fit beside the table (float64 with 8
// pieces at n = 969: 853 slot vectors) x is read from device memory as it
// is transposed, without the overlap; where the table itself does not fit
// (a dense stack's) the walk reads it from device memory.
//
// The optional epilogue computes b - y (the smoother's entry residual and
// its in-place r -= A p update; each b is read by the lane that writes its
// out, before it writes) so the residual never takes a second pass. A lane
// issues its b and mask loads before it walks the item, so they arrive
// while it computes; the row sums, a small cached table, it reads after.
//
// The optional bool mask multiplies each output at the store (the mask
// constraint after the apply, ``apply_mask(A x, m)`` or ``apply_mask(b - A x,
// m)`` of the JAX smoothers): y * 1 or y * 0, rounded on its own, so the
// result has the bits of the unmasked output times the mask, a -0.0 or a
// NaN included, and the masked state never takes a second pass.
//
// The residual form is shifted. Near convergence each output of b - A x is
// a small difference of products of the size of S_p * x, so the rounding
// of the running float32 sum, not the iterate, sets the floor of the
// solve's residual. The residual form therefore multiplies x[e] - s_e, with
// s_e = x[e, 0], and adds s_e * sum_p coeff[e, p] * rs[p, m] back in the
// epilogue, where rs[p] = S_p 1 are the stack's row sums (zero up to the
// rounding of S for the stiffness pieces). The algebra is exact; the
// products shrink to the variation of x inside an element.
//
// The stored type TX of x may be narrower than the state type T (K16: the
// smoothers' direction vectors in bfloat16 or float16, or float32 under a
// float64 state): each value lands as stored and is widened exactly as it
// is transposed, so the result is the state-type kernel's on the widened
// x, bit for bit. element_apply.cu instantiates TX = T,
// element_apply_half.cu the narrower types (two sources: nvcc builds them
// side by side).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "stencil_rows.cuh"
#include "widen.cuh"

namespace {

using hz::widen;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// a warp item: APPLY_ROWS rows of one chunk group, APPLY_LANES lanes a row
// (the slot words of ops/apply.py::stack_table group the same rows)
constexpr int APPLY_ROWS = 16;
constexpr int APPLY_LANES = 32 / APPLY_ROWS;
// a chunk group's column, split between the APPLY_LANES lanes of a row
constexpr int APPLY_COL_BYTES = 64;
// the fewest warp items a step (4 per warp): narrow rows take more groups
constexpr int APPLY_ITEMS = 4 * hz::ROW_WARPS;

// elements of a chunk group, and of a lane
template <typename T>
__host__ __device__ constexpr int group_elems() {
  return APPLY_COL_BYTES / static_cast<int>(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int lane_elems() {
  return group_elems<T>() / APPLY_LANES;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the step's mbarrier, one arrival a phase (the thread that issues the
// copies)
__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// the phase of ``parity`` complete: the copies it expected have landed. A
// copy that never lands traps after ~2^34 cycles instead of hanging the card
__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  const long long t0 = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// A run of len values at src, landed at land + lead (lead: src's offset in
// values from its 16-byte boundary): values [lo, hi) arrive by the bulk
// copy, whose ends are 16-byte aligned on both sides; the head [0, lo) and
// the tail [hi, len) come from device memory (x's fetched into the landing
// by threads, the coefficients' read where they are used).
struct Run {
  int lead, lo, hi;
};

template <typename V>
__device__ __forceinline__ Run run_of(const V* src, int len) {
  constexpr int Q = 16 / static_cast<int>(sizeof(V));
  Run r;
  r.lead = static_cast<int>(reinterpret_cast<uintptr_t>(src) % 16) / static_cast<int>(sizeof(V));
  r.lo = r.lead ? Q - r.lead : 0;
  if (r.lo > len) r.lo = len;
  r.hi = r.lo + (len - r.lo) / Q * Q;
  return r;
}

template <typename V>
__device__ __forceinline__ unsigned run_bytes(const Run& r) {
  return static_cast<unsigned>(r.hi - r.lo) * sizeof(V);
}

template <typename V>
__device__ __forceinline__ void run_copy(V* land, const V* src, const Run& r,
                                         unsigned long long* bar) {
  if (r.hi > r.lo)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
            "r"(smem_addr(land + r.lead + r.lo)),
        "l"(src + r.lo), "r"(run_bytes<V>(r)), "r"(smem_addr(bar))
        : "memory");
}

template <typename V>
__device__ __forceinline__ V run_value(const V* land, const V* src, const Run& r, int i) {
  return (i >= r.lo && i < r.hi) ? land[r.lead + i] : src[i];
}

// one 16-byte unit of a column from shared memory
__device__ __forceinline__ void load_unit(const char* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void load_unit(const char* p, double* v) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  v[0] = a.x;
  v[1] = a.y;
}

// where element e of a chunk group's column c lies in the column: its
// 16-byte units 0-3 swapped pairwise (0, 1 <-> 2, 3) where bit 1 of c is
// set, so that the four rows of a quarter-warp, reading half a column
// each, meet four different 32-byte slots of the bank lines when their
// columns differ mod 4 (as neighbouring rows' columns mostly do)
template <typename T>
__device__ __forceinline__ int col_elem(int c, int e) {
  constexpr int CG = group_elems<T>();
  return c * CG + (e ^ (((c >> 1) & 1) * (CG / 2)));
}

// VW consecutive values of a slot vector in shared memory (VW = 1, 2 or 4:
// one read)
template <int VW>
__device__ __forceinline__ void load_vals(const float* p, float* o) {
  if constexpr (VW == 1) {
    o[0] = *p;
  } else {
    const float4 a = *reinterpret_cast<const float4*>(p);
    o[0] = a.x;
    o[1] = a.y;
    o[2] = a.z;
    o[3] = a.w;
  }
}
template <int VW>
__device__ __forceinline__ void load_vals(const double* p, double* o) {
  if constexpr (VW == 1) {
    o[0] = *p;
  } else {
    const double2 a = *reinterpret_cast<const double2*>(p);
    o[0] = a.x;
    o[1] = a.y;
  }
}

__host__ __device__ constexpr long long up16(long long v) { return (v + 15) / 16 * 16; }

// the slot words' rows of APPLY_ROWS words: R slots and the counts per row
// group, and two spare zero rows after the last group, which the walk reads
// ahead (ops/apply.py::slot_layout)
__host__ __device__ constexpr long long slot_rows(int n, int R) {
  return static_cast<long long>((n + APPLY_ROWS - 1) / APPLY_ROWS) * (R + 1) + 2;
}

// the shared memory of a step of G elements: the mbarrier, the table (where
// ``table``: the slot words and the V slot vectors, landed once), the
// coefficients [G][PP] (zero-padded), the shifts [G], the transposed rows
// [G / CG][n][CG], the landing run of x (where ``land``) and that of the
// coefficients
template <typename T, typename TX>
struct ApplySmem {
  long long words, values, coeff, shift, xt, xland, cland, total;
  __host__ __device__ ApplySmem(int G, int n, int P, int PP, int R, int V, bool table,
                                bool land) {
    const long long t = sizeof(T);
    words = 16;
    values = words + (table ? 4ll * slot_rows(n, R) * APPLY_ROWS : 0);
    coeff = up16(values + (table ? static_cast<long long>(V) * PP * t : 0));
    shift = coeff + G * PP * t;
    xt = shift + G * t;
    xland = up16(xt + static_cast<long long>(G) * n * t);
    cland = land ? up16(xland + static_cast<long long>(G) * n * sizeof(TX) + 16) : xland;
    total = up16(cland + G * P * t + 16);
  }
  // the table's bytes (0 where it stays in device memory)
  __host__ __device__ unsigned table_bytes() const {
    return static_cast<unsigned>(coeff - words);
  }
};

// PP: the pieces a table slot holds (1, 4, 8); NP <= PP: the pieces
// multiplied (P, or PP when P < PP pads with zero pieces). words: the slot
// words [slot_rows][APPLY_ROWS] (a slot's column | its vector's index <<
// 16), values: the V distinct slot vectors [PP / VW][V][VW], both with
// sizes in whole 16-byte units (ops/apply.py::stack_table). TS: the table
// in shared memory (else it is read from device memory, through L1: a
// table too large for it, such as a dense stack's)
template <typename T, typename TX, int PP, int NP, bool RES, bool TS>
__global__ void __launch_bounds__(hz::ROW_THREADS, 1)
element_apply_kernel(const TX* __restrict__ x, const T* __restrict__ coeff,
                     const int* __restrict__ words, const T* __restrict__ values,
                     int R, int V,
                     const T* b, const T* __restrict__ rs, const bool* __restrict__ mask,
                     T* out, long long E, int n, int P, int G, bool land) {
  constexpr int CG = group_elems<T>();
  constexpr int GC = lane_elems<T>();
  constexpr int EU = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte unit
  constexpr int VW = PP < 16 / sizeof(T) ? PP : 16 / sizeof(T);  // a slot's values per read
  constexpr int NQ = PP / VW;
  extern __shared__ __align__(16) unsigned char smem[];
  const ApplySmem<T, TX> L(G, n, P, PP, R, V, TS, land);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
  const int* Ws = TS ? reinterpret_cast<const int*>(smem + L.words) : words;
  const T* Vs = TS ? reinterpret_cast<const T*>(smem + L.values) : values;
  T* Cs = reinterpret_cast<T*>(smem + L.coeff);
  T* Ss = reinterpret_cast<T*>(smem + L.shift);
  T* xt = reinterpret_cast<T*>(smem + L.xt);
  TX* xland = reinterpret_cast<TX*>(smem + L.xland);
  T* cland = reinterpret_cast<T*>(smem + L.cland);

  const int tid = threadIdx.x;
  const long long steps = (E + G - 1) / G;
  const long long stride = gridDim.x;
  auto rows_of = [&](long long s) {
    return static_cast<int>(E - s * G < G ? E - s * G : G);
  };
  // a step's x run: landed in bulk, or (where the table leaves no room for
  // the landing) read from device memory as it is transposed
  auto x_run = [&](const TX* xs, int len) { return land ? run_of(xs, len) : Run{0, len, len}; };
  // thread 0 issues step s's copies on the mbarrier (and, first, the
  // table's: the words' and vectors' sizes are whole 16-byte units)
  auto issue = [&](long long s, unsigned table) {
    const long long e0 = s * G;
    const int Gb = rows_of(s);
    const Run xr = x_run(x + e0 * n, Gb * n), cr = run_of(coeff + e0 * P, Gb * P);
    const unsigned bytes = run_bytes<TX>(xr) + run_bytes<T>(cr);
    if (bytes + table == 0) return;
    bar_expect(bar, bytes + table);
    if (table) {
      const int nw = static_cast<int>(L.values - L.words) / 4;
      const Run wr{0, 0, nw};
      const Run vr{0, 0, static_cast<int>((table - 4 * nw) / sizeof(T))};
      run_copy(const_cast<int*>(Ws), words, wr, bar);
      run_copy(const_cast<T*>(Vs), values, vr, bar);
    }
    run_copy(xland, x + e0 * n, xr, bar);
    run_copy(cland, coeff + e0 * P, cr, bar);
  };

  // the head and tail of step s2's x run, which its bulk copy leaves out
  // (under 16 bytes each), fetched by the threads below 32 / sizeof(TX):
  // returns where the fetched value goes in the landing, or -1
  auto edge_of = [&](long long s2, TX& v) {
    if (!land) return -1;
    const long long e2 = s2 * G;
    const int len = rows_of(s2) * n;
    const Run r2 = run_of(x + e2 * n, len);
    const int i = tid < r2.lo ? tid : r2.hi + tid - r2.lo;
    if (i >= len) return -1;
    v = x[e2 * n + i];
    return r2.lead + i;
  };

  if (tid == 0) bar_init(bar);
  {
    TX v;
    const int at = edge_of(blockIdx.x, v);
    if (at >= 0) xland[at] = v;
  }
  __syncthreads();
  if (tid == 0) issue(blockIdx.x, L.table_bytes());

  const int ng = G / CG;
  const int items = ng * ((n + APPLY_ROWS - 1) / APPLY_ROWS);
  const int lane = tid % 32, r = lane / APPLY_LANES, ch = lane % APPLY_LANES;
  unsigned parity = 0;
  for (long long s = blockIdx.x; s < steps; s += stride) {
    const long long e0 = s * G;
    const int Gb = rows_of(s);
    const TX* xs = x + e0 * n;
    const T* cs = coeff + e0 * P;
    const Run xr = x_run(xs, Gb * n), cr = run_of(cs, Gb * P);
    const unsigned table = s == blockIdx.x ? L.table_bytes() : 0;
    if (table + run_bytes<TX>(xr) + run_bytes<T>(cr) > 0) {  // as ``issue`` expected
      bar_wait(bar, parity);
      parity ^= 1;
    }
    // the landed step: coefficients zero-padded to PP pieces and past the
    // last element; x widened, shifted and transposed, zero past the last
    // element. Thread t takes element t % CG of each chunk group, every
    // (ROW_THREADS / CG)-th column from t / CG.
    for (int i = tid; i < G * PP; i += blockDim.x) {
      const int g = i / PP, p = i % PP;
      Cs[i] = (g < Gb && p < P) ? run_value(cland, cs, cr, g * P + p) : T(0);
    }
    auto transpose = [&](const TX* xsrc) {
      for (int q = 0; q < ng; ++q) {
        const int g = q * CG + tid % CG;
        T* xq = xt + q * n * CG;
        const TX* xg = xsrc + g * n;
        const T shift = (RES && g < Gb) ? T(widen(xg[0])) : T(0);
#pragma unroll 4
        for (int c = tid / CG; c < n; c += hz::ROW_THREADS / CG) {
          T t = T(0);
          if (g < Gb) {
            t = T(widen(xg[c]));
            if constexpr (RES) t -= shift;
          }
          xq[col_elem<T>(c, tid % CG)] = t;
        }
        if (RES && tid < CG) Ss[g] = shift;
      }
    };
    if (land)
      transpose(xland + xr.lead);
    else
      transpose(xs);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (tid == 0 && s + stride < steps) issue(s + stride, 0);
    TX ev;
    const int ea = s + stride < steps ? edge_of(s + stride, ev) : -1;

    for (int W = tid / 32; W < items; W += hz::ROW_WARPS) {
      const int q = W % ng, oc = W / ng;
      const int m = oc * APPLY_ROWS + r;
      if (m < n) {
        const int* wm = Ws + oc * (R + 1) * APPLY_ROWS + r;
        const int cnt = wm[R * APPLY_ROWS];
        // the lane's elements: units ch and 2 + ch of the chunk group
        auto elem = [&](int j) { return q * CG + EU * (2 * (j / EU) + ch) + j % EU; };
        // the epilogue's loads first, in flight during the walk (each b is
        // read before the same thread writes its out: out may alias b)
        T bo[GC];
        bool mo[GC];
#pragma unroll
        for (int j = 0; j < GC; ++j) {
          const long long o = (e0 + elem(j)) * n + m;
          if (elem(j) < Gb) {
            if constexpr (RES) bo[j] = b[o];
            if (mask) mo[j] = mask[o];
          }
        }
        // the walk: slots in order, two slots a turn; a slot's word is read
        // two slots ahead, its vector and x values one slot ahead (past the
        // row's count: a pad, the count row, the next group's or a spare
        // zero word, read and not used). Addresses in shared memory count
        // bytes.
        T acc[GC][NP];
#pragma unroll
        for (int j = 0; j < GC; ++j)
#pragma unroll
          for (int p = 0; p < NP; ++p) acc[j][p] = T(0);
        const char* xc = reinterpret_cast<const char*>(xt + q * n * CG) + 16 * ch;
        const char* vc = reinterpret_cast<const char*>(Vs);
        const int quad = V * VW * static_cast<int>(sizeof(T));
        auto slot_load = [&](int word, T (&sv)[PP], T (&xv)[GC]) {
          const char* vw = vc + (word >> 16) * (VW * static_cast<int>(sizeof(T)));
#pragma unroll
          for (int u = 0; u < NQ; ++u)
            load_vals<VW>(reinterpret_cast<const T*>(vw + u * quad), sv + u * VW);
          const int c = word & 0xffff;
          const char* xw = xc + c * APPLY_COL_BYTES;
          const int h = (c << 4) & 32;  // col_elem's swap
          load_unit(xw + h, xv);
          load_unit(xw + (h ^ 32), xv + EU);
        };
        auto slot_fma = [&](const T (&sv)[PP], const T (&xv)[GC]) {
#pragma unroll
          for (int j = 0; j < GC; ++j)
#pragma unroll
            for (int p = 0; p < NP; ++p) acc[j][p] += sv[p] * xv[j];
        };
        T va[PP], vb[PP], xa[GC], xb[GC];
        int wa = wm[0], wb = wm[APPLY_ROWS];
        slot_load(wa, va, xa);
        for (int k = 0; k < cnt; k += 2) {
          slot_load(wb, vb, xb);
          wa = wm[(k + 2) * APPLY_ROWS];
          slot_fma(va, xa);
          if (k + 1 == cnt) break;
          slot_load(wa, va, xa);
          wb = wm[(k + 3) * APPLY_ROWS];
          slot_fma(vb, xb);
        }
        // the row sums after the walk (a cached table: no registers held
        // across the walk)
        T rsm[NP];
        if constexpr (RES) {
#pragma unroll
          for (int p = 0; p < NP; ++p)
            rsm[p] = p < P ? __ldg(rs + static_cast<long long>(p) * n + m) : T(0);
        }
#pragma unroll
        for (int j = 0; j < GC; ++j) {
          const int g = elem(j);
          if (g < Gb) {
            const T* cg = Cs + g * PP;
            T y = T(0);
#pragma unroll
            for (int p = 0; p < NP; ++p) y += cg[p] * acc[j][p];
            T v;
            if constexpr (RES) {
              // y = A (x - s) + s * (A 1), the row sums in piece order
              T t = T(0);
#pragma unroll
              for (int p = 0; p < NP; ++p) t += cg[p] * rsm[p];
              v = bo[j] - (y + Ss[g] * t);
            } else {
              v = y;
            }
            out[(e0 + g) * n + m] = mask ? mul_rn(v, T(mo[j])) : v;
          }
        }
      }
    }
    if (ea >= 0) xland[ea] = ev;
    __syncthreads();
  }
}

// the SMs of the current device (read once per device)
inline int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (count[dev] == 0) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 1;
}

template <typename T, typename TX, int PP, int NP, bool RES>
int launch_pp(const TX* x, const T* coeff, const int* words, const T* values, int R, int V,
              const T* b, const T* rs, const bool* mask, T* out, long long E, int n, int P,
              cudaStream_t stream) {
  constexpr int CG = group_elems<T>();
  static bool allowed = false;
  if (!allowed) {
    hz::allow_smem(element_apply_kernel<T, TX, PP, NP, RES, true>);
    hz::allow_smem(element_apply_kernel<T, TX, PP, NP, RES, false>);
    allowed = true;
  }
  // the table in shared memory where it fits beside one chunk group's
  // rows, then x landed in bulk where its landing fits too; chunk groups a
  // step: enough warp items for every warp, no more than the elements need,
  // as many as the shared memory holds
  auto smem_of = [&](long long ng, bool table, bool land) {
    return ApplySmem<T, TX>(static_cast<int>(ng) * CG, n, P, PP, R, V, table, land).total;
  };
  const bool table = smem_of(1, true, false) <= hz::ROW_SMEM;
  const bool land = smem_of(1, table, true) <= hz::ROW_SMEM;
  const int row_groups = (n + APPLY_ROWS - 1) / APPLY_ROWS;
  long long ng = (APPLY_ITEMS + row_groups - 1) / row_groups;
  const long long need = (E + CG - 1) / CG;
  if (ng > need) ng = need;
  if (ng < 1) ng = 1;
  while (ng > 1 && smem_of(ng, table, land) > hz::ROW_SMEM) --ng;
  const long long smem = smem_of(ng, table, land);
  if (smem > hz::ROW_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (E == 0) return 0;
  const int G = static_cast<int>(ng) * CG;
  const long long steps = (E + G - 1) / G;
  const int grid = static_cast<int>(steps < sm_count() ? steps : sm_count());
  if (table)
    element_apply_kernel<T, TX, PP, NP, RES, true><<<grid, hz::ROW_THREADS, smem, stream>>>(
        x, coeff, words, values, R, V, b, rs, mask, out, E, n, P, G, land);
  else
    element_apply_kernel<T, TX, PP, NP, RES, false><<<grid, hz::ROW_THREADS, smem, stream>>>(
        x, coeff, words, values, R, V, b, rs, mask, out, E, n, P, G, land);
  return 0;
}

template <typename T, typename TX = T>
int launch_apply(const void* x, const void* coeff, const void* words, const void* values, int R,
                 int PP, int V, const void* b, const void* rs, const void* mask, void* out,
                 long long E, int n, int P, cudaStream_t stream) {
  const TX* xx = static_cast<const TX*>(x);
  const T* cc = static_cast<const T*>(coeff);
  const int* wi = static_cast<const int*>(words);
  const T* vv = static_cast<const T*>(values);
  const T* bb = static_cast<const T*>(b);
  const T* rr = static_cast<const T*>(rs);
  const bool* mm = static_cast<const bool*>(mask);
  T* oo = static_cast<T*>(out);
  if (P > PP || R < 1 || V < 1 || n > 0xffff) return static_cast<int>(cudaErrorInvalidValue);
#define HZ_APPLY(PPV, NPV)                                                                      \
  return b ? launch_pp<T, TX, PPV, NPV, true>(xx, cc, wi, vv, R, V, bb, rr, mm, oo, E, n, P,    \
                                              stream)                                           \
           : launch_pp<T, TX, PPV, NPV, false>(xx, cc, wi, vv, R, V, bb, rr, mm, oo, E, n, P,   \
                                               stream);
  if (PP == 1) HZ_APPLY(1, 1)
  if (PP == 4) HZ_APPLY(4, 4)
  // the 3D stacks: six conductivity pieces and the mass
  if (PP == 8 && P == 7) HZ_APPLY(8, 7)
  if (PP == 8) HZ_APPLY(8, 8)
#undef HZ_APPLY
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
