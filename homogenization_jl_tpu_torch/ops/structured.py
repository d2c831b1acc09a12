"""Structured-mesh interface combine (host tables in NumPy, device in PyTorch).

Port of homogenization_jl_tpu/ops/structured.py. On a full-box
lexicographic hypercube base (``hypercube(d, n)``, cube-major or type-major
element order, ``ept`` = 2 (2D) / 6 (3D) simplices per cube, identical split
in every cube) the interface topology is TRANSLATION INVARIANT: the owners
of every shared face/edge/corner group sit at fixed (cube-offset,
simplex-type, local-cell) positions relative to the group's lattice anchor.

The host half (``Orbit``, ``StructuredCombine``, ``detect_structured``, the
orbit derivations and their validators) is a copy of the JAX package's: the
orbit patterns are extracted and cross-validated from the plan's general
gather tables, so the structured forms provably compute the same sums.

The device half:
  * ``flatten_structured`` turns one level's rules into a small int32 table;
  * ``combine_structured`` / ``constrain_structured`` run kernel K2
    (csrc/structured_combine.cu) on CUDA tensors and the plain PyTorch
    shifted-slice form (``*_plain``, the JAX package's algorithm) on CPU
    tensors;
  * ``combine_structured_slab`` / ``constrain_structured_slab``, the same
    on one rank's x-plane slab of a cube-major state with its halo planes
    (parallel/slab.py), run kernel K11 (K2's kernel with the plane window,
    the second entry of csrc/structured_combine.cu) on CUDA tensors and
    their plain forms on CPU tensors.
(Reference baseline for the operation: broadcast_interfaces!,
src/implicit_fine_grid.jl:209-328.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..csrc.build import LAUNCHES, launch
from ..utils.logging import span


@dataclasses.dataclass(frozen=True)
class Orbit:
    """One translation-invariant family of interface groups."""

    pattern: tuple  # ((delta (d-tuple), t, l), ...) — the owners
    p_min: tuple  # componentwise anchor range over this orbit's groups
    p_max: tuple
    # anchors inside [int_lo, int_hi] (inclusive) are INTERIOR groups; the
    # rest lie on the domain boundary (zero-Dirichlet). None = every group
    # of this orbit is boundary. Validated exhaustively against the plan's
    # boundary mask at build time.
    int_lo: tuple | None = None
    int_hi: tuple | None = None


@dataclasses.dataclass(frozen=True)
class StructuredCombine:
    """Static shift rules for one level of one plan."""

    n: int
    d: int
    ept: int
    n_local: int
    order: str  # "cube" (e = cube*ept + t) or "type" (e = t*n^d + cube)
    # per class: (orbits, rebuild) with rebuild[(t, l)] = (orbit_idx, delta)
    classes: dict  # name -> (orbits: list[Orbit], rebuild: dict, offsets, width)
    pad: int  # halo padding applied to the state view


def _cube_coords(e: np.ndarray, n: int, d: int, ept: int, order: str):
    if order == "cube":
        cube = e // ept
        t = e % ept
    else:  # type-major
        t = e // n**d
        cube = e % n**d
    out = np.empty((len(e), d), dtype=np.int64)
    for k in range(d - 1, -1, -1):
        out[:, k] = cube % n
        cube = cube // n
    return out, t


def detect_structured(base) -> tuple | None:
    """(n, ept, order) if ``base`` is a lexicographic full-box hypercube
    mesh in cube-major or type-major generator order, else None."""
    from ..solver.coarse import detect_box

    box = detect_box(base)
    if box is None:
        return None
    origin, n, h = box
    d = base.dim
    ept = 2 if d == 2 else 6
    # centroid of element e must lie in the cube its order implies
    centers = base.nodes[base.elements].mean(axis=1)
    cube_of = np.floor((centers - origin[None, :]) / h).astype(np.int64)
    cube_of = np.clip(cube_of, 0, n - 1)
    e = np.arange(base.nelements)
    order = None
    for cand in ("cube", "type"):
        expect, _ = _cube_coords(e, n, d, ept, cand)
        if np.array_equal(cube_of, expect):
            order = cand
            break
    if order is None:
        return None

    # verify identical per-cube split: node pattern of cube 0 replicated
    def els_of_cube(c):
        if order == "cube":
            return base.elements[c * ept : (c + 1) * ept]
        return base.elements[c :: n**d]

    nid_stride = np.array([(n + 1) ** (d - 1 - k) for k in range(d)])
    first = els_of_cube(0)
    for c in (1, base.nelements // ept - 1):
        blk = els_of_cube(c)
        coord = np.array(np.unravel_index(c, (n,) * d))
        off = (coord * nid_stride).sum()
        if not np.array_equal(np.sort(blk.reshape(-1)) - off, np.sort(first.reshape(-1))):
            return None
        if not np.array_equal(blk - blk.min(), first - first.min()):
            return None
    return n, ept, order


def build_structured_combine(
    plan, k: int, det: "tuple | None" = None
) -> "StructuredCombine | None":
    """Derive the shift rules for level ``k`` from the general gather
    tables, or None when the base is not a structured box."""
    base = plan.base
    if det is None:
        det = detect_structured(base)
    if det is None or plan.reference.layout is None:
        return None
    n, ept, order = det
    d = base.dim
    lp = plan.levels[k]
    lay = plan.reference.layout[k]
    n_local = plan.n_local(k)

    class_specs = []
    if lp.gather.face is not None:
        class_specs.append(("face", lp.gather.face, lay.face_offsets, lay.npf))
    if lp.gather.edge is not None and lay.npe > 0:
        class_specs.append(("edge", lp.gather.edge, lay.edge_offsets, lay.npe))
    if lp.gather.corner is not None:
        class_specs.append(("corner", lp.gather.corner, lay.corner_cols, 1))

    classes = {}
    max_abs_delta = 1
    for name, (oe, ol, om, gmap), offsets, width in class_specs:
        G, M = oe.shape
        valid = om > 0
        c_all, t_all = _cube_coords(
            oe.reshape(-1).astype(np.int64), n, d, ept, order
        )
        c_all = c_all.reshape(G, M, d)
        t_all = t_all.reshape(G, M)
        l_all = ol.astype(np.int64)

        counts = valid.sum(axis=1)
        # canonical per-group pattern key relative to the min owner cube
        a_min = np.where(valid[:, :, None], c_all, np.iinfo(np.int64).max).min(axis=1)
        delta = c_all - a_min[:, None, :]
        # encode (delta in [0..3]^d, t, l) as one small int; invalid -> big
        code = np.zeros((G, M), dtype=np.int64)
        for kk in range(d):
            dk = delta[:, :, kk]
            assert ((dk >= 0) & (dk <= 3) | ~valid).all()
            code = code * 4 + np.where(valid, dk, 0)
        code = (code * ept + np.where(valid, t_all, 0)) * 64 + np.where(
            valid, l_all, 0
        )
        code = np.where(valid, code, np.iinfo(np.int64).max)
        code_sorted = np.sort(code, axis=1)  # valid codes first, sentinels last

        # valence can legitimately differ between orbits (e.g. axis edges vs
        # the cube diagonal): peel orbits off in decreasing valence until
        # every group is classified. Interior (full-valence) groups define
        # each orbit's pattern; lower-valence boundary groups attach to an
        # existing orbit when their owners are exactly the in-range part of
        # its pattern — which is also the proof that zero-padded shifts
        # reproduce their partial sums.
        orbit_patterns: list[list] = []
        orbit_of = np.full(G, -1, dtype=np.int64)
        anchor = np.zeros((G, d), dtype=np.int64)

        def decode(cd):
            l = cd % 64
            cd //= 64
            t = cd % ept
            cd //= ept
            dl = []
            for _ in range(d):
                dl.append(cd % 4)
                cd //= 4
            return tuple(reversed(dl)), int(t), int(l)

        remaining = np.arange(G)
        while len(remaining):
            cnt_r = counts[remaining]
            top = cnt_r.max()
            cand = remaining[cnt_r == top]
            # attach to existing orbits first (a boundary group of a
            # high-valence orbit can tie an interior group of a lower one)
            attached = np.zeros(len(cand), dtype=bool)
            for oi, pat in enumerate(orbit_patterns):
                att = _try_attach(
                    cand, c_all, t_all, l_all, valid, pat, n, orbit_of, anchor, oi
                )
                attached |= att
            todo = cand[~attached]
            if len(todo):
                rows_t = code_sorted[todo]
                uniq2, inv2 = np.unique(rows_t, axis=0, return_inverse=True)
                for ui, u in enumerate(uniq2):
                    pat = [decode(int(cd)) for cd in u if cd != np.iinfo(np.int64).max]
                    oi = len(orbit_patterns)
                    orbit_patterns.append(pat)
                    grp = todo[inv2 == ui]
                    ok = _try_attach(
                        grp, c_all, t_all, l_all, valid, pat, n, orbit_of, anchor, oi
                    )
                    assert ok.all(), f"{name}: self-attach failed"
            new_remaining = remaining[orbit_of[remaining] < 0]
            assert len(new_remaining) < len(remaining), (
                f"{name}: no classification progress ({len(remaining)} left)"
            )
            remaining = new_remaining

        # rebuild map: every (t, l) belongs to exactly one (orbit, delta)
        rebuild: dict = {}
        for oi, pat in enumerate(orbit_patterns):
            for dlt, t, l in pat:
                key = (t, l)
                val = (oi, dlt)
                assert rebuild.get(key, val) == val, (
                    f"{name}: ({t},{l}) in two orbits"
                )
                rebuild[key] = val
        L = gmap.shape[1]
        assert len(rebuild) == ept * L, (
            f"{name}: rebuild covers {len(rebuild)} != {ept * L} cells"
        )

        # cross-validate: every group's owners == pattern ∩ range, and gmap
        # agrees with the anchor arithmetic
        _validate(
            name, G, M, c_all, t_all, l_all, valid, orbit_of, anchor,
            orbit_patterns, n, gmap, ept, order,
        )

        # boundary classification: a group is boundary iff its cells are
        # zeroed by the Dirichlet mask (cells zero as whole blocks). For a
        # full box this must be an axis-aligned anchor-range condition per
        # orbit — asserted exhaustively, which is what licenses the
        # structured constraint (zeroing static shells of the sums arrays).
        bmask = lp.boundary_mask
        g_boundary = (
            bmask[oe[:, 0].astype(np.int64), np.asarray(offsets)[ol[:, 0]]] == 0
        )

        orbits = []
        for oi, pat in enumerate(orbit_patterns):
            sel = orbit_of == oi
            p = anchor[sel]
            gb = g_boundary[sel]
            if gb.all():
                int_lo = int_hi = None
            else:
                pi = p[~gb]
                int_lo = tuple(int(v) for v in pi.min(axis=0))
                int_hi = tuple(int(v) for v in pi.max(axis=0))
                inside = ((p >= pi.min(axis=0)) & (p <= pi.max(axis=0))).all(axis=1)
                assert (inside == ~gb).all(), (
                    f"{name}: orbit {oi} boundary set is not an anchor box"
                )
            orbits.append(
                Orbit(
                    pattern=tuple((tuple(int(x) for x in dlt), int(t), int(l)) for dlt, t, l in pat),
                    p_min=tuple(int(v) for v in p.min(axis=0)),
                    p_max=tuple(int(v) for v in p.max(axis=0)),
                    int_lo=int_lo,
                    int_hi=int_hi,
                )
            )
            for dlt, _, _ in pat:
                max_abs_delta = max(max_abs_delta, *(abs(int(x)) for x in dlt))

        classes[name] = (orbits, rebuild, tuple(int(o) for o in offsets), int(width))

    # element-interior (head) columns must never carry boundary DOFs — what
    # licenses the structured constraint to touch only interface columns
    if class_specs:
        i0 = min(min(offs) for _, _, offs, w in class_specs if len(offs))
        assert (plan.levels[k].boundary_mask[:, :i0] != 0).all(), (
            "element-interior columns unexpectedly contain boundary DOFs"
        )

    return StructuredCombine(
        n=n, d=d, ept=ept, n_local=n_local, order=order, classes=classes,
        pad=max_abs_delta,
    )


# cache of small boxes used by the rescaled build, keyed by
# (dim, nlevels, order, n_small) -> GridPlan / (..., k) -> StructuredCombine
_SMALL_CACHE: dict = {}


def build_structured_combine_auto(
    plan, k: int, threshold: int = 16, det: "tuple | None" = None
) -> "StructuredCombine | None":
    """Direct orbit derivation for small bases, rescaled small-box
    derivation (O(1) in base size) at n >= ``threshold`` where the direct
    census over all groups starts to dominate plan setup. ``det`` feeds a
    precomputed detect_structured result through (the detection is an O(E)
    centroid pass — callers building every level pass it once)."""
    if det is None:
        det = detect_structured(plan.base)
    if det is None or plan.reference.layout is None:
        return None
    if det[0] >= threshold:
        return build_structured_combine_scaled(plan, k, det=det)
    return build_structured_combine(plan, k, det=det)


def build_structured_combine_scaled(
    plan, k: int, n_small: tuple = (6, 7), det: "tuple | None" = None
) -> "StructuredCombine | None":
    """Like :func:`build_structured_combine` but O(1) in the base size: the
    orbit rules are translation invariant, so they are derived once on two
    small boxes (n0, n0+1) and every anchor range — affine in n with slope
    0 or 1 — is rescaled to the plan's n. The direct build's census over
    all G groups (~65 s at a 1.5M-element base) collapses to two seconds of
    small-box work plus an exact global count check and a 4096-group sampled
    owner-set validation against the plan's real gather tables.
    """
    if det is None:
        det = detect_structured(plan.base)
    if det is None or plan.reference.layout is None:
        return None
    n, ept, order = det
    n0, n1 = n_small
    assert n1 == n0 + 1
    if n <= n1:
        return build_structured_combine(plan, k, det=det)
    from ..mesh.grid import hypercube
    from .plan import build_grid_plan

    d = plan.base.dim
    nlevels = plan.nlevels
    scs = []
    for ns in n_small:
        ck = (d, nlevels, order, ns, k)
        sc = _SMALL_CACHE.get(ck)
        if sc is None:
            pk = (d, nlevels, order, ns)
            plan_s = _SMALL_CACHE.get(pk)
            if plan_s is None:
                plan_s = build_grid_plan(
                    hypercube(d, ns, order=order), nlevels, slot_tables=False
                )
                _SMALL_CACHE[pk] = plan_s
            sc = build_structured_combine(plan_s, k)
            _SMALL_CACHE[ck] = sc
        scs.append(sc)
    sc0, sc1 = scs

    def affine(v0, v1):
        # componentwise: slope must be 0 or 1 (ranges are either pinned to
        # the origin side or track the far boundary)
        out = []
        for a, b in zip(v0, v1):
            s = b - a
            assert s in (0, 1), f"anchor range slope {s} not in {{0,1}}"
            out.append(int(a + s * (n - n0)))
        return tuple(out)

    assert set(sc0.classes) == set(sc1.classes)
    classes = {}
    for name in sc0.classes:
        orbits0, rebuild0, offsets0, width0 = sc0.classes[name]
        orbits1, rebuild1, offsets1, width1 = sc1.classes[name]
        assert offsets0 == offsets1 and width0 == width1, name
        by_pat1 = {ob.pattern: i for i, ob in enumerate(orbits1)}
        assert len(by_pat1) == len(orbits1), f"{name}: duplicate patterns"
        assert len(orbits0) == len(orbits1), (
            f"{name}: orbit count differs between n={n0} and n={n1}"
        )
        orbits = []
        o_map = {}  # sc0 orbit index -> scaled orbit (same index order)
        for oi, ob0 in enumerate(orbits0):
            ob1 = orbits1[by_pat1[ob0.pattern]]
            o_map[by_pat1[ob0.pattern]] = oi
            assert (ob0.int_lo is None) == (ob1.int_lo is None), name
            orbits.append(
                Orbit(
                    pattern=ob0.pattern,
                    p_min=affine(ob0.p_min, ob1.p_min),
                    p_max=affine(ob0.p_max, ob1.p_max),
                    int_lo=None if ob0.int_lo is None else affine(ob0.int_lo, ob1.int_lo),
                    int_hi=None if ob0.int_hi is None else affine(ob0.int_hi, ob1.int_hi),
                )
            )
        # the (t, l) -> (orbit, delta) map must agree between the two sizes
        assert set(rebuild0) == set(rebuild1), name
        for key, (oi1, dlt1) in rebuild1.items():
            oi0, dlt0 = rebuild0[key]
            assert o_map[oi1] == oi0 and dlt0 == dlt1, f"{name}: rebuild mismatch {key}"
        classes[name] = (orbits, dict(rebuild0), offsets0, width0)

    assert sc0.pad == sc1.pad
    sc = StructuredCombine(
        n=n, d=d, ept=ept, n_local=plan.n_local(k), order=order,
        classes=classes, pad=sc0.pad,
    )
    _validate_scaled(plan, k, sc)
    return sc


def _validate_scaled(plan, k: int, sc: StructuredCombine, n_sample: int = 4096):
    """Exact global checks + sampled owner-set check of a rescaled
    StructuredCombine against the plan's real gather tables."""
    n, d, ept, order = sc.n, sc.d, sc.ept, sc.order
    lp = plan.levels[k]
    lay = plan.reference.layout[k]
    bmask = lp.boundary_mask
    specs = {}
    if lp.gather.face is not None:
        specs["face"] = (lp.gather.face, lay.face_offsets)
    if lp.gather.edge is not None and lay.npe > 0:
        specs["edge"] = (lp.gather.edge, lay.edge_offsets)
    if lp.gather.corner is not None:
        specs["corner"] = (lp.gather.corner, lay.corner_cols)
    assert set(specs) == set(sc.classes)

    stride = np.array([n ** (d - 1 - kk) for kk in range(d)], dtype=np.int64)

    def eid(pos, t):
        cube = int((pos * stride).sum())
        return cube * ept + t if order == "cube" else t * n**d + cube

    rng = np.random.default_rng(0)
    for name, ((oe, ol, om, gmap), offsets) in specs.items():
        orbits, rebuild, offs, width = sc.classes[name]
        G, M = oe.shape
        E, L = gmap.shape
        # exact: total group count == sum over orbits of the anchor-box size
        tot = sum(
            int(np.prod([hi - lo + 1 for lo, hi in zip(ob.p_min, ob.p_max)]))
            for ob in orbits
        )
        assert tot == G, f"{name}: scaled anchor boxes cover {tot} != {G} groups"
        # exact: boundary-group count == sum of (box - interior box) sizes
        g_bnd = bmask[oe[:, 0].astype(np.int64), np.asarray(offs)[ol[:, 0]]] == 0
        tot_b = 0
        for ob in orbits:
            box = int(np.prod([hi - lo + 1 for lo, hi in zip(ob.p_min, ob.p_max)]))
            if ob.int_lo is None:
                tot_b += box
            else:
                tot_b += box - int(
                    np.prod([hi - lo + 1 for lo, hi in zip(ob.int_lo, ob.int_hi)])
                )
        assert tot_b == int(g_bnd.sum()), (
            f"{name}: scaled boundary boxes cover {tot_b} != {int(g_bnd.sum())}"
        )
        # sampled: the group each (element, cell) rebuilds from has exactly
        # the owner set the orbit pattern predicts at the implied anchor
        sample = rng.choice(E * L, size=min(n_sample, E * L), replace=False)
        e_s = (sample // L).astype(np.int64)
        l_s = (sample % L).astype(np.int64)
        c_e, t_e = _cube_coords(e_s, n, d, ept, order)
        for i in range(len(sample)):
            oi, dlt = rebuild[(int(t_e[i]), int(l_s[i]))]
            ob = orbits[oi]
            p = c_e[i] - np.asarray(dlt)
            assert (p >= ob.p_min).all() and (p <= ob.p_max).all(), (
                f"{name}: anchor {p} outside scaled box of orbit {oi}"
            )
            gi = int(gmap[e_s[i], l_s[i]])
            actual = {
                (int(oe[gi, j]), int(ol[gi, j])) for j in range(M) if om[gi, j] > 0
            }
            expect = set()
            for dlt2, t2, l2 in ob.pattern:
                pos = p + np.asarray(dlt2)
                if ((pos >= 0) & (pos < n)).all():
                    expect.add((eid(pos, t2), l2))
            assert actual == expect, (
                f"{name}: owner set mismatch at group {gi} (anchor {p})"
            )
            bnd = bool(g_bnd[gi])
            inside = ob.int_lo is not None and (
                (p >= ob.int_lo).all() and (p <= ob.int_hi).all()
            )
            assert bnd == (not inside), f"{name}: boundary flag mismatch at {gi}"

    # element-interior (head) columns must never carry boundary DOFs
    i0 = min(
        min(offs) for (_, _, offs, _) in sc.classes.values() if len(offs)
    )
    assert (bmask[:, :i0] != 0).all(), (
        "element-interior columns unexpectedly contain boundary DOFs"
    )


def _try_attach(groups, c_all, t_all, l_all, valid, pat, n, orbit_of, anchor, oi):
    """Vectorized: attach each group in ``groups`` to orbit ``pat`` if its
    owners are exactly the pattern entries whose position lands in range.
    Returns a bool mask over ``groups``; updates orbit_of/anchor in place."""
    d = c_all.shape[2]
    pat_map = {(t, l): np.array(dlt) for dlt, t, l in pat}
    nG = len(groups)
    ok = np.ones(nG, dtype=bool)
    anch = np.full((nG, d), np.iinfo(np.int64).min)
    have = np.zeros(nG, dtype=np.int64)
    M = c_all.shape[1]
    for j in range(M):
        v = valid[groups, j]
        tj = t_all[groups, j]
        lj = l_all[groups, j]
        cj = c_all[groups, j]
        dlt = np.full((nG, d), np.iinfo(np.int64).min)
        known = np.zeros(nG, dtype=bool)
        for (t, l), dv in pat_map.items():
            m = v & (tj == t) & (lj == l)
            dlt[m] = dv
            known[m] = True
        ok &= ~v | known
        imp = cj - dlt
        first = v & known & (anch[:, 0] == np.iinfo(np.int64).min)
        anch[first] = imp[first]
        same = (~(v & known)) | (imp == anch).all(axis=1)
        ok &= same
        have += (v & known).astype(np.int64)
    # all pattern entries within range must be present
    exp = np.zeros(nG, dtype=np.int64)
    for (t, l), dv in pat_map.items():
        pos = anch + dv[None, :]
        inside = ((pos >= 0) & (pos < n)).all(axis=1)
        exp += inside.astype(np.int64)
    ok &= have == exp
    ok &= anch[:, 0] != np.iinfo(np.int64).min
    g_ok = groups[ok]
    fresh = orbit_of[g_ok] < 0
    orbit_of[g_ok[fresh]] = oi
    anchor[g_ok[fresh]] = anch[ok][fresh]
    return ok


def _validate(
    name, G, M, c_all, t_all, l_all, valid, orbit_of, anchor, orbit_patterns,
    n, gmap, ept, order,
):
    """Sampled check that anchor arithmetic reproduces gmap exactly."""
    E, L = gmap.shape
    d = c_all.shape[2]
    e = np.arange(E)
    c_e, t_e = _cube_coords(e, n, d, ept, order)
    # group lookup keyed by (orbit, flattened anchor)
    flat_anchor = np.zeros(G, dtype=np.int64)
    for kk in range(d):
        flat_anchor = flat_anchor * (n + 3) + (anchor[:, kk] + 1)
    key = orbit_of * (n + 3) ** d + flat_anchor
    order = np.argsort(key)
    key_sorted = key[order]
    assert (np.diff(key_sorted) > 0).all(), f"{name}: duplicate (orbit, anchor)"
    rebuild = {}
    for oi, pat in enumerate(orbit_patterns):
        for dlt, t, l in pat:
            rebuild[(t, l)] = (oi, np.asarray(dlt))
    rng = np.random.default_rng(0)
    sample = rng.choice(E * L, size=min(4096, E * L), replace=False)
    for s in sample:
        ee, ll = int(s // L), int(s % L)
        oi, dlt = rebuild[(int(t_e[ee]), ll)]
        p = c_e[ee] - dlt
        fa = 0
        for kk in range(d):
            fa = fa * (n + 3) + (int(p[kk]) + 1)
        q = oi * (n + 3) ** d + fa
        pos = np.searchsorted(key_sorted, q)
        assert pos < G and key_sorted[pos] == q, (
            f"{name}: no group at orbit {oi} anchor {p}"
        )
        assert order[pos] == gmap[ee, ll], f"{name}: gmap mismatch at ({ee},{ll})"




# --------------------------------------------------------------------- #
# device tables for the hand kernel
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class StructuredTables:
    """One level's structured combine: the host rules (for the plain form)
    and their flattening into one small int32 table (for kernels K2 and
    K11).

    ``tab`` layout (see csrc/structured_combine.cu): a header of 4 ints
    (the offsets of the column rows and of the owner rows,
    ``_walk_tables``, then two zeros), followed by those two arrays, each
    from a 16-byte boundary."""

    sc: StructuredCombine
    i0: int  # iface_start: first tail (interface) column
    tab: torch.Tensor  # int32, on the solver's device


_CLASS_ORDER = ("face", "edge", "corner")
_HEADER = 4  # the offsets of the two arrays, padded to 16 bytes
OUTSIDE = 1 << 30  # K2's box bit that every cube has: no group is interior


def _walk_tables(sc: StructuredCombine, cell_of, col_cell, orbits_flat, cell_orbit, cell_delta):
    """K2's tables (csrc/structured_combine.cu). For every (type t, tail
    column) one row [q0, q1, box, 0]: the range of its group's owners, and
    the bits of the cube's boundary that put the group outside the orbit's
    interior box (bit 2k: c_k = 0, bit 2k + 1: c_k = n - 1; ``OUTSIDE``:
    every group of the orbit is boundary). For every owner, in the orbit's
    pattern order, one row [forbid, rel, dcol, 0]: ``forbid`` has bit 2k
    (2k + 1) set when the owner lies one cube below (above) on axis k, so it
    is missing when c_k = 0 (n - 1); ``rel`` is its element minus the
    copy's, ``dcol`` its cell's first column minus the copy's. All depend on
    (t, cell) alone: the kernel does no coordinate arithmetic per entry."""
    n, d, ept = sc.n, sc.d, sc.ept
    strides = np.array([n ** (d - 1 - k) for k in range(d)])
    first_col = {(name, l): sc.classes[name][2][l] for name, l in cell_of}
    cells = np.zeros((ept, len(cell_of), 4), np.int64)
    owners = []
    for t in range(ept):
        for (name, l), g in cell_of.items():
            cname, ob = orbits_flat[cell_orbit[t, g]]
            D = cell_delta[t, g, :d]
            q0 = len(owners)
            for dj, tj, lj in ob.pattern:
                delta = np.asarray(dj) - D
                assert np.abs(delta).max() <= 1, f"{name}: owner {delta} cubes away"
                forbid = sum((1 << (2 * k)) if delta[k] < 0 else (1 << (2 * k + 1))
                             for k in range(d) if delta[k] != 0)
                lin = int(delta @ strides)
                rel = (tj - t) * n**d + lin if sc.order == "type" else lin * ept + (tj - t)
                owners.append([forbid, rel, first_col[(cname, lj)] - first_col[(name, l)], 0])
            box = OUTSIDE
            if ob.int_lo is not None:
                # the interior anchors p = c - D, as boundary bits of c
                lo, hi = np.asarray(ob.int_lo) + D, np.asarray(ob.int_hi) + D
                assert np.isin(lo, (0, 1)).all() and np.isin(hi, (n - 2, n - 1)).all(), (lo, hi)
                box = sum((1 << (2 * k)) * int(lo[k] == 1) + (1 << (2 * k + 1)) * int(hi[k] == n - 2)
                          for k in range(d))
            cells[t, g] = [q0, len(owners), box, 0]
    return cells[:, np.asarray(col_cell)], np.asarray(owners, np.int64).reshape(-1, 4)


def flatten_structured(sc: StructuredCombine, iface_start: int, device="cpu"):
    """Flatten ``sc`` into the int32 table of kernels K2 and K11.

    Per tail column: its cell id g (cells of all classes numbered in layout
    order face, edge, corner). Per (type t, cell g): the orbit and the
    offset D from the anchor. From these ``_walk_tables`` derives the rows
    the kernels walk. The tail columns must be exactly the class blocks
    laid end to end from ``iface_start`` to ``n_local`` — the contiguous
    interface layout (mesh/reference.py) — which is asserted."""
    d, ept = sc.d, sc.ept
    col_cell = []
    cell_of = {}  # (class, l) -> global cell id
    orbit_base = {}  # class -> index of its first orbit in the flat list
    orbits_flat = []
    cursor = iface_start
    for name in _CLASS_ORDER:
        if name not in sc.classes:
            continue
        orbits, rebuild, offsets, width = sc.classes[name]
        orbit_base[name] = len(orbits_flat)
        orbits_flat += [(name, ob) for ob in orbits]
        for l, off in enumerate(offsets):
            assert off == cursor, f"{name}: cell {l} at column {off}, expected {cursor}"
            cell_of[(name, l)] = len(cell_of)
            col_cell += [cell_of[(name, l)]] * width
            cursor += width
    assert cursor == sc.n_local, f"tail ends at {cursor}, n_local {sc.n_local}"
    ncell = len(cell_of)

    cell_orbit = np.zeros((ept, ncell), np.int64)
    cell_delta = np.zeros((ept, ncell, 3), np.int64)
    for (name, l), g in cell_of.items():
        _, rebuild, _, _ = sc.classes[name]
        for t in range(ept):
            oi, dlt = rebuild[(t, l)]
            cell_orbit[t, g] = orbit_base[name] + oi
            cell_delta[t, g, :d] = dlt

    cols, owners = _walk_tables(sc, cell_of, col_cell, orbits_flat, cell_orbit, cell_delta)
    # both arrays are int4 rows, so each starts 16-byte aligned after the header
    flat = np.concatenate([[_HEADER, _HEADER + cols.size, 0, 0], cols.ravel(), owners.ravel()])
    assert flat.max() < 2**31 and flat.min() >= -(2**31)
    tab = torch.as_tensor(flat.astype(np.int32), device=device)
    return StructuredTables(sc=sc, i0=int(iface_start), tab=tab)


# --------------------------------------------------------------------- #
# plain PyTorch forms (the JAX package's shifted slice-adds)
# --------------------------------------------------------------------- #
def _type_block(x, sc: StructuredCombine, t, col, width):
    """Rows of simplex type t, columns [col, col + width), as [n]*d + [w]."""
    n, d, ept = sc.n, sc.d, sc.ept
    nd = n**d
    if sc.order == "type":
        blk = x[t * nd : (t + 1) * nd, col : col + width]
    else:
        blk = x[t::ept, col : col + width]
    return blk.reshape((n,) * d + (width,))


def _shifted(blk, lo, hi):
    """blk[lo:hi per grid axis], out-of-range positions read zero (each grid
    axis ranges over blk's own extent)."""
    lo = np.asarray(lo)
    hi = np.asarray(hi)
    ext = np.asarray(blk.shape[:-1])
    lo_c = np.clip(lo, 0, ext)
    hi_c = np.clip(hi, 0, ext)
    src = tuple(slice(int(a), int(b)) for a, b in zip(lo_c, hi_c))
    if (lo_c == lo).all() and (hi_c == hi).all():
        return blk[src]
    out = blk.new_zeros(tuple(int(b - a) for a, b in zip(lo, hi)) + blk.shape[-1:])
    dst = tuple(
        slice(int(lc - l), int(hc - l)) for l, lc, hc in zip(lo, lo_c, hi_c)
    )
    out[dst] = blk[src]
    return out


def _keep_box(acc, lo, hi):
    """Zero acc outside the per-axis index box [lo, hi)."""
    ext = np.asarray(acc.shape[:-1])
    if (lo == 0).all() and (hi == ext).all():
        return acc
    out = torch.zeros_like(acc)
    if (lo < hi).all():
        idx = tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))
        out[idx] = acc[idx]
    return out


def _zero_shell(acc, p_lo, ob: Orbit):
    """Zero every anchor of the orbit's sums array that is a boundary group
    (outside the orbit's interior box)."""
    if ob.int_lo is None:
        return torch.zeros_like(acc)
    return _keep_box(
        acc, np.array(ob.int_lo) - p_lo, np.array(ob.int_hi) + 1 - p_lo
    )


def _assemble_tail(x, sc: StructuredCombine, i0, cell_block):
    """Write cell_block(t, name, l, offset, width) -> [planes] + [n]*(d-1) +
    [width] into the tail columns, in layout order, for every simplex type
    (planes = n, or a slab's plane count)."""
    tails = []
    for t in range(sc.ept):
        cols = []
        for name in _CLASS_ORDER:
            if name not in sc.classes:
                continue
            _, _, offsets, width = sc.classes[name]
            for l in range(len(offsets)):
                cols.append(cell_block(t, name, l, offsets[l], width))
        tail_t = torch.cat(cols, dim=-1)
        tails.append(tail_t.reshape(-1, tail_t.shape[-1]))
    if sc.order == "type":
        tail = torch.cat(tails, dim=0)
    else:
        tail = torch.stack(tails, dim=1).reshape(x.shape[0], -1)
    out = x.clone()
    out[:, i0:] = tail
    return out


def combine_structured_plain(x, st: StructuredTables, constrain: bool = False):
    """Plain PyTorch form of the structured combine: per orbit, the sum of
    the shifted type blocks in pattern order (zero-padded out of range);
    then every cell block is sliced out of its orbit's sums."""
    sc = st.sc
    n = sc.n
    class_sums = {}
    for name, (orbits, _, offsets, width) in sc.classes.items():
        sums = []
        for ob in orbits:
            p_lo = np.array(ob.p_min)
            p_hi = np.array(ob.p_max) + 1
            acc = None
            for dlt, t, l in ob.pattern:
                piece = _shifted(
                    _type_block(x, sc, t, offsets[l], width),
                    p_lo + np.array(dlt), p_hi + np.array(dlt),
                )
                acc = piece if acc is None else acc + piece
            if constrain:
                acc = _zero_shell(acc, p_lo, ob)
            sums.append((p_lo, acc))
        class_sums[name] = sums

    def cell_block(t, name, l, off, width):
        _, rebuild, _, _ = sc.classes[name]
        oi, dlt = rebuild[(t, l)]
        p_lo, acc = class_sums[name][oi]
        lo = -np.array(dlt) - p_lo
        return acc[tuple(slice(int(a), int(a) + n) for a in lo)]

    return _assemble_tail(x, sc, st.i0, cell_block)


def constrain_structured_plain(x, st: StructuredTables):
    """Plain PyTorch form of the structured constraint: keep each cell
    block where its group's anchor (c - D) lies in the orbit's interior
    box, zero elsewhere."""
    sc = st.sc
    n = sc.n

    def cell_block(t, name, l, off, width):
        orbits, rebuild, _, _ = sc.classes[name]
        oi, dlt = rebuild[(t, l)]
        ob = orbits[oi]
        blk = _type_block(x, sc, t, off, width)
        if ob.int_lo is None:
            return torch.zeros_like(blk)
        lo = np.maximum(np.array(ob.int_lo) + np.array(dlt), 0)
        hi = np.minimum(np.array(ob.int_hi) + 1 + np.array(dlt), n)
        return _keep_box(blk, lo, hi)

    return _assemble_tail(x, sc, st.i0, cell_block)


# --------------------------------------------------------------------- #
# slab forms (one rank's x-plane slab of a cube-major state)
# --------------------------------------------------------------------- #
def slab_halo_rows(sc: StructuredCombine) -> int:
    """Rows of one halo: ``pad`` planes of cubes, ``ept`` rows per cube."""
    return sc.pad * sc.n ** (sc.d - 1) * sc.ept


def _axis0_keep(acc, g, lo, hi):
    """acc times the 0/1 test lo <= g <= hi on its first axis (the JAX
    form's dynamic iota mask, a multiply as there)."""
    m = ((g >= lo) & (g <= hi)).to(acc.dtype)
    return acc * m.reshape((-1,) + (1,) * (acc.dim() - 1))


def combine_structured_slab_plain(x, halo_lo, halo_hi, st: StructuredTables, x0: int,
                                  W: int, constrain: bool = False):
    """Plain PyTorch form of the slab combine (the JAX package's
    ``combine_structured_slab``, ops/structured.py:902): the single-device
    shifted slice-adds on the halo-extended slab.

    ``x``: the rank's rows [W * n^(d-1) * ept, n_local] of a cube-major
    state, its W planes of cubes starting at global plane ``x0``;
    ``halo_lo`` / ``halo_hi``: the tail columns [i0, n_local) of the pad
    planes below x0 and from x0 + W up ([slab_halo_rows, n_local - i0]),
    zero or None beyond the domain ends (None reads as zero, JAX's
    ppermute fill). Orbit sums are taken for the anchors of
    ext planes [0, W + pad) (global x0 - pad + ext) in pattern order, axes
    1+ zero-padded; ``constrain`` zeroes the boundary anchors (static shells
    on axes 1+, the global anchor test on axis 0). Every owner is read from
    the same values as on one device, so the sums equal the single-device
    combine's rows."""
    sc = st.sc
    n, d, ept, pad = sc.n, sc.d, sc.ept, sc.pad
    n2 = n ** (d - 1)
    i0 = st.i0
    tw = x.shape[1] - i0
    A = W + 2 * pad
    zero = x.new_zeros((slab_halo_rows(sc), tw))
    halos = [zero if h is None else h for h in (halo_lo, halo_hi)]
    Tv = torch.cat([halos[0], x[:, i0:], halos[1]], dim=0).reshape(A * n2, ept, tw)

    def type_block(t, col, width):
        return Tv[:, t, col - i0 : col - i0 + width].reshape((A,) + (n,) * (d - 1) + (width,))

    Wp = W + pad  # anchors computed: ext planes [0, W + pad)
    g = torch.arange(Wp, device=x.device) + (x0 - pad)  # their global planes
    class_sums = {}
    for name, (orbits, _, offsets, width) in sc.classes.items():
        sums = []
        for ob in orbits:
            p_lo = np.array((0,) + ob.p_min[1:])
            p_hi = np.array((Wp,) + tuple(v + 1 for v in ob.p_max[1:]))
            acc = None
            for dlt, t, l in ob.pattern:
                piece = _shifted(type_block(t, offsets[l], width),
                                 p_lo + np.array(dlt), p_hi + np.array(dlt))
                acc = piece if acc is None else acc + piece
            if constrain:
                if ob.int_lo is None:
                    acc = torch.zeros_like(acc)
                else:
                    acc = _keep_box(
                        acc, np.r_[0, np.array(ob.int_lo[1:]) - p_lo[1:]],
                        np.r_[Wp, np.array(ob.int_hi[1:]) + 1 - p_lo[1:]])
                    acc = _axis0_keep(acc, g, ob.int_lo[0], ob.int_hi[0])
            sums.append((p_lo, acc))
        class_sums[name] = sums

    def cell_block(t, name, l, off, width):
        _, rebuild, _, _ = sc.classes[name]
        oi, dlt = rebuild[(t, l)]
        p_lo, acc = class_sums[name][oi]
        # own planes sit at ext [pad, W + pad); anchor = plane - D
        lo0 = pad - dlt[0]
        idx = (slice(lo0, lo0 + W),) + tuple(
            slice(int(-dlt[ax] - p_lo[ax]), int(-dlt[ax] - p_lo[ax]) + n) for ax in range(1, d)
        )
        return acc[idx]

    return _assemble_tail(x, sc, i0, cell_block)


def constrain_structured_slab_plain(x, st: StructuredTables, x0: int, W: int):
    """Plain PyTorch form of the slab constraint (the JAX package's
    ``constrain_structured_slab``, ops/structured.py:1091): per cell block,
    the static keep-box on axes 1+ and the global anchor test on axis 0. No
    halo: a pure mask."""
    sc = st.sc
    n, d, ept = sc.n, sc.d, sc.ept
    n2 = n ** (d - 1)
    xv = x.reshape(W * n2, ept, x.shape[1])
    xg = torch.arange(W, device=x.device) + x0  # global planes of the rows

    def cell_block(t, name, l, off, width):
        orbits, rebuild, _, _ = sc.classes[name]
        oi, dlt = rebuild[(t, l)]
        ob = orbits[oi]
        blk = xv[:, t, off : off + width].reshape((W,) + (n,) * (d - 1) + (width,))
        if ob.int_lo is None:
            return torch.zeros_like(blk)
        lo = np.maximum(np.array(ob.int_lo[1:]) + np.array(dlt[1:]), 0)
        hi = np.minimum(np.array(ob.int_hi[1:]) + 1 + np.array(dlt[1:]), n)
        if (lo >= hi).any():
            return torch.zeros_like(blk)
        blk = _keep_box(blk, np.r_[0, lo], np.r_[W, hi])
        return _axis0_keep(blk, xg - int(dlt[0]), ob.int_lo[0], ob.int_hi[0])

    return _assemble_tail(x, sc, st.i0, cell_block)


# --------------------------------------------------------------------- #
# wrappers: plain form on CPU, kernel K2 on CUDA
# --------------------------------------------------------------------- #
_DTYPES = {torch.float32: 0, torch.float64: 1}


def _structured_kernel(x, st: StructuredTables, mode: int, mask=None):
    sc = st.sc
    E = sc.ept * sc.n**sc.d
    if x.dtype not in _DTYPES:
        raise TypeError(f"structured combine: unsupported dtype {x.dtype}")
    if x.dim() != 2 or tuple(x.shape) != (E, sc.n_local):
        raise ValueError(
            f"structured combine: x shape {tuple(x.shape)}, expected {(E, sc.n_local)}"
        )
    if not x.is_contiguous():
        raise ValueError("structured combine: x must be contiguous")
    dev = x.device
    if mask is not None:
        if mask.dtype != torch.bool or mask.shape != x.shape or mask.device != dev:
            raise ValueError("structured combine: mask must be a bool tensor shaped like x")
        if not mask.is_contiguous():
            raise ValueError("structured combine: mask must be contiguous")
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"structured combine: unsupported device {dev}")
    if st.tab.device != dev:
        raise ValueError(f"structured combine: tables on {st.tab.device}, x on {dev}")
    out = torch.empty_like(x)
    LAUNCHES["structured_combine"] += 1
    launch(
        "hz_structured_combine", _DTYPES[x.dtype], x.data_ptr(), out.data_ptr(),
        None if mask is None else mask.data_ptr(),
        E, sc.n_local, st.i0, sc.n, sc.d, sc.ept, int(sc.order == "type"),
        mode, st.tab.data_ptr(),
    )
    return out


def combine_structured(x, st: StructuredTables, constrain: bool = False, mask=None):
    """Interface combine of x [E, n_local] on a full-box hypercube base:
    every copy of a shared face/edge/corner DOF gets the sum of all copies.
    ``constrain=True`` folds in the zero-Dirichlet constraint (boundary
    groups come out zero): equal to combine(constrain(x)). ``mask`` (bool,
    x's shape) multiplies the combined result instead: the mask constraint
    after the combine (``apply_mask(combine(x), mask)`` of the JAX solver),
    in the same pass. Kernel K2 for CUDA tensors, the plain form for CPU
    tensors."""
    if constrain and mask is not None:
        raise ValueError("combine_structured: pass constrain=True or a mask, not both")
    with span("hz.op.combine_structured"):
        out = _structured_kernel(x, st, 1 if constrain else 0, mask)
        if out is None:
            out = combine_structured_plain(x, st, constrain)
            return out if mask is None else out * mask
        return out


def constrain_structured(x, st: StructuredTables):
    """Zero-Dirichlet constraint without a resident [E, n_local] mask:
    zeroes every copy of a boundary DOF. Kernel K2 (constraint mode) for
    CUDA tensors, the plain form for CPU tensors."""
    with span("hz.op.constrain_structured"):
        out = _structured_kernel(x, st, 2)
        if out is None:
            return constrain_structured_plain(x, st)
        return out


def _slab_kernel(x, halo_lo, halo_hi, st: StructuredTables, x0, W, mode: int, mask=None):
    """Checks of the slab wrappers; launches kernel K11 on CUDA tensors (a
    launch over the planes next to no halo, one over the edge planes next
    to a halo) and returns its output, or None for CPU tensors (the plain
    form's turn)."""
    sc = st.sc
    if sc.order != "cube":
        raise ValueError("slab combine: needs a cube-major base")
    if not (0 <= x0 and W >= sc.pad and x0 + W <= sc.n):
        raise ValueError(f"slab combine: planes [{x0}, {x0 + W}) of {sc.n}, pad {sc.pad}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"slab combine: unsupported dtype {x.dtype}")
    B = W * sc.n ** (sc.d - 1) * sc.ept
    if x.dim() != 2 or tuple(x.shape) != (B, sc.n_local):
        raise ValueError(f"slab combine: x shape {tuple(x.shape)}, expected {(B, sc.n_local)}")
    dev = x.device
    shape = (slab_halo_rows(sc), sc.n_local - st.i0)
    # a halo may be missing only at a domain end, where no owner is read
    optional = dict(mask=True, halo_lo=mode == 2 or x0 == 0, halo_hi=mode == 2 or x0 + W == sc.n)
    for name, t in (("x", x), ("halo_lo", halo_lo), ("halo_hi", halo_hi), ("mask", mask)):
        if t is None:
            if not optional.get(name, False):
                raise ValueError(f"slab combine: {name} is required")
            continue
        if name.startswith("halo") and (t.dtype != x.dtype or tuple(t.shape) != shape):
            raise ValueError(f"slab combine: {name} must be {x.dtype} {shape}")
        if name == "mask" and (t.dtype != torch.bool or t.shape != x.shape):
            raise ValueError("slab combine: mask must be a bool tensor shaped like x")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"slab combine: {name} must be contiguous on {dev}")
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"slab combine: unsupported device {dev}")
    if st.tab.device != dev:
        raise ValueError(f"slab combine: tables on {st.tab.device}, x on {dev}")
    out = torch.empty_like(x)

    def ptr(t):
        return None if t is None else t.data_ptr()

    LAUNCHES["slab_combine"] += 1
    launch(
        "hz_structured_combine_slab", _DTYPES[x.dtype], x.data_ptr(), ptr(halo_lo),
        ptr(halo_hi), out.data_ptr(), ptr(mask), B, sc.n_local, st.i0, sc.n, sc.d,
        sc.ept, int(x0), int(W), sc.pad, mode, st.tab.data_ptr(),
    )
    return out


def combine_structured_slab(x, halo_lo, halo_hi, st: StructuredTables, x0: int, W: int,
                            constrain: bool = False, mask=None):
    """Interface combine of one rank's slab (see
    ``combine_structured_slab_plain`` for the arguments): every copy of a
    shared DOF in the slab gets the sum of all copies, the halos supplying
    the owners on the neighbours' planes. ``constrain=True`` folds in the
    zero-Dirichlet constraint; ``mask`` (bool, x's shape) multiplies the
    result instead, in the same pass. Kernel K11 for CUDA tensors (equal bit
    for bit to K2 on the full state's rows), the plain form for CPU
    tensors."""
    if constrain and mask is not None:
        raise ValueError("combine_structured_slab: pass constrain=True or a mask, not both")
    out = _slab_kernel(x, halo_lo, halo_hi, st, x0, W, 1 if constrain else 0, mask)
    if out is None:
        out = combine_structured_slab_plain(x, halo_lo, halo_hi, st, x0, W, constrain)
        return out if mask is None else out * mask
    return out


def constrain_structured_slab(x, st: StructuredTables, x0: int, W: int):
    """Zero-Dirichlet constraint of one rank's slab (rows of planes [x0,
    x0 + W)); needs no halo. Kernel K11 (constraint mode) for CUDA tensors,
    the plain form for CPU tensors."""
    out = _slab_kernel(x, None, None, st, x0, W, 2)
    if out is None:
        return constrain_structured_slab_plain(x, st, x0, W)
    return out
