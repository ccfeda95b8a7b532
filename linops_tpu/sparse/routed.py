"""Clos-routed unstructured SpMV: pack + device pipeline.

This module turns unstructured SpMV into a fixed sequence of gathers
within 128-element windows and transposes (``format="routed"``). On the
H100, plain CSR (one gather + ``segment_sum``) is faster forward and
transpose, so ``format="auto"`` never picks this layout (PERF.md).

1. **Pack (host, this file):** nnz are laid out col-block-major, each
   128-column block's segment padded to a multiple of 128 — so fetching
   ``x[col]`` for a whole 128-wide window is ONE gather from a single
   128-element x block. Rows are split into width-``w`` sub-row slots
   (ELL-style) on the output side.
2. **Route:** moving each product from its gather-friendly position to its
   row-slot is a STATIC permutation, realized by a radix-128 Clos network
   (sparse/routing.py): 3 or 5 crossbar stages, each crossbar = one
   window gather, wirings = transposes. The input crossbar (G1) folds
   into pack-time ordering, so the device runs at most 4 gathers per
   routing level.
3. **Apply (device):** phase-1 fused gather·multiply, the crossbar chain,
   and a ``(slots/w, w)`` reshape-sum into sub-row partials.
4. **Combine:** rows are tiled by 128 and each tile's sub-rows are padded
   to a shared per-tile slot count K at PACK time; the partial→row
   reduction is one segment sum over the tiles' row ids. Pathological
   tiles (K beyond ``TILED_MAX_K``) fall back to a chain of smaller routed
   ReducePass rounds.

Matrices beyond one routing domain (2^21 slots) are chunked by row-tile
ranges; chunks share shapes and run batched.

The reference's whole unstructured story is delegation to SparseArrays CSC
mul! on the host (reference: src/constructors.jl:25-27).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .formats import _register, check_int32_range
from .routing import RADIX, clos_route

__all__ = ["RoutedSpMV", "RoutedTranspose", "pack_routed_csr",
           "routed_matvec", "routed_rmatvec", "routed_matmat",
           "routed_rmatmat", "CLOS_MAX_SLOTS"]

CLOS_MID = RADIX * RADIX          # 16384: largest 3-stage domain
CLOS_MAX_SLOTS = RADIX ** 3       # 2^21: largest single routing domain
_REDUCE_U = 8                     # combine-pass window (divides 128)
TILED_MAX_K = 32768               # per-tile slot cap for the tiled combine


class ReducePass(NamedTuple):
    """One routed combine pass: slice per-chunk input spans, pad each to the
    shared domain N, route, reshape-sum by u, concatenate."""

    stages: tuple            # full crossbar list (G1 first), (C, ...) int8
    u: int                   # static: reshape-sum width
    n_in: int                # static: padded per-chunk domain size N
    in_spans: tuple          # static: per-chunk (lo, hi) input position spans
    out_keep: tuple          # static: per-chunk kept output length (None =
    #                          keep all N/u — used by intermediate passes)


_register(ReducePass, ("u", "n_in", "in_spans", "out_keep"))


class RoutedSpMV(NamedTuple):
    """A packed routing program (C chunks sharing a slot count N = m·128).

    vals/lane_idx are in post-G1 col-block-major window order; ``stages``
    holds the remaining crossbar index arrays (0, 2 or 4 of them). The
    middle (G3) crossbar is padded to 128 wide when B < 128.
    """

    vals: jnp.ndarray        # (C, m, 128) products' left factors (0 at pads)
    lane_idx: jnp.ndarray    # (C, m, 128) int8: col % 128
    win_block: jnp.ndarray   # (C, m) int32: x block id per window
    stages: tuple            # per-stage (C, ...) int8 gather arrays
    rowid: jnp.ndarray       # (T, K) int8 row-within-tile per sub-row slot
    #                          (-1 = trash) for the tiled combine; None when
    #                          the fallback ReducePass chain is used
    passes: tuple            # ReducePass combine chain (fallback / empty)
    shape: Tuple[int, int]   # static: (nrow, ncol)
    w: int                   # static: slots per sub-row (divides 128)
    chunk_keep: tuple        # static: per-chunk kept partial count (tiled)

    @property
    def nnz_slots(self):
        return self.vals.shape[0] * self.vals.shape[1] * RADIX


_register(RoutedSpMV, ("shape", "w", "chunk_keep"))


class RoutedTranspose(NamedTuple):
    """Transpose program DERIVED from the forward pack — no router run.

    A Clos route is a sequence of per-window lane permutations (crossbars)
    and fixed wirings (XLA transposes); its INVERSE is the reversed
    sequence of per-window inverse permutations with the same wirings
    (W1/W2 are self-inverse). ``Aᵀu`` therefore runs the forward network
    backwards: expand u to the row slots (each slot takes u[its row] —
    annihilation of pad/trash slots is guaranteed because the forward pack
    maps pad positions onto exactly the non-real slots, and pad positions
    carry vals 0), route back to the pre-G1 col-block-major positions,
    multiply by the pre-G1 values and reduce per column. The per-column
    reduction is a boundary segment sum (``_segsum_from_z``): the pack
    sorts each block segment by column, so same-column entries are
    contiguous within each 128-wide window, and the per-window column sums
    are gathered per block and reshape-summed.

    Derivation is O(N) numpy (stage-array inversion + index composition) —
    measured ~0.1× the forward pack vs ~1.0× for the old CSC re-pack.
    The reference gets transpose-at-forward-cost by construction
    (reference: src/adjtrans.jl:158-205); this is the routed equivalent.
    """

    vals_pre: jnp.ndarray     # (C, m, 128) PRE-G1 values (0 at pads)
    g1inv: jnp.ndarray        # (C, m, 128) int8: inverse input crossbar
    expand_tile: jnp.ndarray  # (C, m) int32: u-tile id per slot window
    expand_idx: jnp.ndarray   # (C, m, 128) int8: row-within-tile ∘ G5⁻¹
    stages_t: tuple           # inverse middle crossbars, per-stage (C, ...)
    bnd_lo: jnp.ndarray       # (C, m, 128) int8: column-run boundaries
    bnd_hi: jnp.ndarray       # (C, m, 128) int8
    win_rows: jnp.ndarray     # (nb, Wb) int32: S rows per col block (the
    #                           index C·m points at an appended zero row)
    n_tiles: int              # static: u is padded to n_tiles·128
    shape: Tuple[int, int]    # static: FORWARD (nrow, ncol)


_register(RoutedTranspose, ("n_tiles", "shape"))


def _invert_rows(g):
    """Per-row inverse of row-wise permutations: inv[r, g[r, c]] = c."""
    g = np.asarray(g)
    inv = np.empty(g.shape, np.int32)
    np.put_along_axis(
        inv, np.asarray(g, np.int64),
        np.broadcast_to(np.arange(g.shape[1], dtype=np.int32), g.shape), axis=1)
    return inv


# ----------------------------------------------------------------------------
# Pack (host, numpy)
# ----------------------------------------------------------------------------


def _clos_size(slots: int) -> int:
    """Smallest valid Clos domain size ≥ slots (≤ CLOS_MAX_SLOTS).

    5-stage domains are rounded so B = N/16384 is a multiple of 8."""
    if slots <= CLOS_MID:
        return max(-(-slots // RADIX) * RADIX, RADIX)
    step = 8 * CLOS_MID
    return -(-slots // step) * step


def _auto_width(nnz_row: np.ndarray) -> int:
    """Pick w minimizing the TILE-PADDED slot count T·K(w)·w — the true
    routed-domain size under the tiled combine layout."""
    n_r = nnz_row.shape[0]
    tiles = np.arange(n_r) // RADIX
    T = -(-n_r // RADIX)
    best, best_cost = 8, None
    for w in (4, 8, 16, 32, 64, 128):
        n_sub = -(-nnz_row // w)
        tile_cnt = np.bincount(tiles, weights=n_sub.astype(np.float64),
                               minlength=T)
        K = max(-(-int(tile_cnt.max(initial=1.0)) // RADIX) * RADIX, RADIX)
        cost = T * K * w
        if best_cost is None or cost < best_cost:
            best, best_cost = w, cost
    return best


def _col_padded_slots(cols: np.ndarray) -> int:
    """Col-side slots: each nonempty 128-col block padded to ×128."""
    counts = np.unique(cols // RADIX, return_counts=True)[1]
    return int(((-(-counts // RADIX)) * RADIX).sum())


def _pad_middle_stage(stages):
    """Lane-pad the middle crossbar of a 5-stage route when B < 128."""
    stages = list(stages)
    if len(stages) == 5:
        g3 = stages[2]
        if g3.shape[1] < RADIX:
            stages[2] = np.pad(g3, ((0, 0), (0, RADIX - g3.shape[1])))
    return stages


def _clos_route_fast(dest):
    """Native (C++) router when available — ~50x the numpy router at the
    2^21 domain — with the pure-Python implementation as fallback/oracle."""
    try:
        from ..native import clos_route_native

        r = clos_route_native(dest)
        if r is not None:
            return r
    except ValueError:
        raise
    except Exception:
        pass
    return clos_route(dest)


def _route_int8(dest):
    """clos_route + middle-stage padding + int8 cast."""
    return [g.astype(np.int8) for g in _pad_middle_stage(_clos_route_fast(dest))]


def _build_reduce_passes(seg0: np.ndarray, n_rows: int):
    """Build the routed combine chain.

    seg0: row id per initial partial position (-1 = trash), nondecreasing
    over the real entries. Returns a tuple of ReducePass. After the final
    pass, position r of the output holds y[r].
    """
    passes = []
    seg = seg0
    while True:
        real = seg >= 0
        pos_real = np.flatnonzero(real)
        segs = seg[pos_real]
        counts = np.bincount(segs, minlength=n_rows)
        final = counts.max(initial=0) <= _REDUCE_U
        if final:
            u = int(2 ** np.ceil(np.log2(max(int(counts.max(initial=1)), 1))))
            u = max(u, 1)
            gcnt = np.ones(n_rows, np.int64)
            gbase = np.arange(n_rows, dtype=np.int64)
        else:
            u = _REDUCE_U
            gcnt = -(-counts // u)
            cum = np.zeros(n_rows + 1, np.int64)
            np.cumsum(gcnt, out=cum[1:])
            gbase = cum[:-1]

        L = seg.shape[0]
        # rank of each real element within its row (real entries sorted)
        starts = np.zeros(n_rows + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        rank = np.arange(segs.shape[0]) - starts[segs]
        dest_of_real = (gbase[segs] + rank // u) * u + rank % u

        # input position upper bound per row (for row-range chunking)
        row_hi = np.zeros(n_rows, np.int64)
        np.maximum.at(row_hi, segs, pos_real + 1)
        row_hi = np.maximum.accumulate(row_hi)

        chunks = []  # (r0, r1, in_lo, in_hi)
        r0, in_lo = 0, 0

        def fits(r0, r1, in_lo):
            in_hi = max(int(row_hi[r1 - 1]), in_lo)
            out_span = int((gbase[r1 - 1] + gcnt[r1 - 1] - gbase[r0]) * u)
            return max(in_hi - in_lo, out_span) <= CLOS_MAX_SLOTS

        while r0 < n_rows:
            if fits(r0, n_rows, in_lo):
                r1 = n_rows
            else:
                lo, hi = r0 + 1, n_rows
                while lo < hi:
                    mid = (lo + hi + 1) // 2
                    if fits(r0, mid, in_lo):
                        lo = mid
                    else:
                        hi = mid - 1
                r1 = lo
            in_hi = max(int(row_hi[r1 - 1]), in_lo)
            # positions past the last real one are all trash (zeros) and
            # are DROPPED, never routed: the per-chunk in_spans simply do
            # not cover them, which also keeps the shared domain N from
            # inflating to route known-zero data
            chunks.append((r0, r1, in_lo, in_hi))
            r0, in_lo = r1, in_hi

        N = 1
        for (r0c, r1c, ilo, ihi) in chunks:
            out_span = int((gbase[r1c - 1] + gcnt[r1c - 1] - gbase[r0c]) * u)
            N = max(N, _clos_size(max(ihi - ilo, out_span)))

        stage_l, next_seg_parts, out_keep = [], [], []
        for (r0c, r1c, ilo, ihi) in chunks:
            Lc = ihi - ilo
            out_base = int(gbase[r0c]) * u
            mask = (pos_real >= ilo) & (pos_real < ihi)
            dest_c = np.full(N, -1, np.int64)
            dest_c[pos_real[mask] - ilo] = dest_of_real[mask] - out_base
            realc = dest_c >= 0
            used = np.zeros(N, bool)
            used[dest_c[realc]] = True
            dest = np.empty(N, np.int64)
            dest[realc] = dest_c[realc]
            dest[~realc] = np.flatnonzero(~used)  # trash + pads -> free slots
            stage_l.append(_route_int8(dest))
            grp_rows = np.repeat(np.arange(r0c, r1c), gcnt[r0c:r1c])
            seg_part = np.full(N // u, -1, np.int64)
            seg_part[: grp_rows.shape[0]] = grp_rows
            next_seg_parts.append(seg_part)
            out_keep.append(r1c - r0c if final else N // u)

        stages_stacked = tuple(
            jnp.asarray(np.stack([s[i] for s in stage_l]))
            for i in range(len(stage_l[0]))
        )
        passes.append(ReducePass(
            stages=stages_stacked, u=int(u), n_in=int(N),
            in_spans=tuple((int(a), int(b)) for (_, _, a, b) in chunks),
            out_keep=tuple(int(k) for k in out_keep),
        ))
        if final:
            break
        seg = np.concatenate(next_seg_parts)
    return tuple(passes)


def _run_bounds(keys, lanes, n_windows):
    """Per-window segment boundaries for the segsum kernels.

    keys = window·128 + output-lane per entry (SORTED nondecreasing);
    lanes = source lane of the entry within its window (sorted within each
    key run). Returns (lo, hi) int8 (n_windows, 128): hi = last lane of
    the run (-1 empty), lo = first lane - 1 (-1 when starting at lane 0).
    """
    first = np.full(n_windows * RADIX, -1, np.int16)
    last = np.full(n_windows * RADIX, -1, np.int16)
    if keys.size:
        change = np.empty(keys.shape[0], bool)
        change[0] = True
        change[1:] = keys[1:] != keys[:-1]
        starts = np.flatnonzero(change)
        ends = np.r_[starts[1:], keys.shape[0]] - 1
        first[keys[starts]] = lanes[starts]
        last[keys[starts]] = lanes[ends]
    hi = last.astype(np.int8).reshape(n_windows, RADIX)
    lo = np.where(last >= 0, first - 1, -1).astype(np.int8).reshape(
        n_windows, RADIX)
    return lo, hi


def pack_routed_csr(data, indices, indptr, shape, w="auto", dtype=None,
                    with_transpose=False, to_device=True):
    """Pack host CSR arrays into a RoutedSpMV routing program.

    ``with_transpose=True`` additionally returns the DERIVED transpose
    program (RoutedTranspose) — or None when the layout cannot support it
    (ReducePass-fallback combines, or column-count skew that would blow up
    the per-block window gather) — as a second tuple element.

    ``to_device=False`` leaves every program leaf as a host numpy array
    (upload later with one ``jax.device_put(program)``): separates the
    CPU pack cost from the host→device transfer. The ReducePass fallback
    combine is device-resident either way.
    """
    _up = jnp.asarray if to_device else (lambda a: a)
    n_r, n_c = int(shape[0]), int(shape[1])
    check_int32_range(shape, int(data.shape[0]))
    data = np.asarray(data)
    if dtype is not None:
        data = data.astype(dtype)
    indices = np.asarray(indices, np.int64)
    indptr = np.asarray(indptr, np.int64)
    nnz = int(data.shape[0])
    if nnz == 0:
        raise ValueError("cannot route an empty matrix")
    if indptr.shape[0] != n_r + 1 or indptr[0] != 0 or indptr[-1] != nnz:
        raise ValueError(
            f"indptr must be (nrow+1,) with indptr[0]=0, indptr[-1]=nnz; got "
            f"shape {indptr.shape}, ends ({indptr[0]}, {indptr[-1]}) vs nnz {nnz}")
    nnz_row = np.diff(indptr)
    if (nnz_row < 0).any():
        raise ValueError("indptr must be nondecreasing")
    if indices.min(initial=0) < 0 or indices.max(initial=0) >= n_c:
        raise ValueError("column indices out of range")
    if w == "auto":
        w = _auto_width(nnz_row)
    if RADIX % w:
        raise ValueError(f"w must divide {RADIX}, got {w}")

    # sub-rows: row r contributes ceil(nnz_r / w) of them, in row order
    n_sub = -(-nnz_row // w)
    S0 = int(n_sub.sum())
    sub_base = np.zeros(n_r + 1, np.int64)
    np.cumsum(n_sub, out=sub_base[1:])
    row_of_sub = np.repeat(np.arange(n_r, dtype=np.int64), n_sub)
    # nnz range covered by each sub-row (CSR order is contiguous per row)
    j_of_sub = np.arange(S0) - np.repeat(sub_base[:-1], n_sub)
    sub_start = np.repeat(indptr[:-1], n_sub) + j_of_sub * w
    sub_end = np.minimum(sub_start + w, np.repeat(indptr[1:], n_sub))

    row_of_nnz = np.repeat(np.arange(n_r, dtype=np.int64), nnz_row)
    k_in_row = np.arange(nnz, dtype=np.int64) - np.repeat(indptr[:-1], nnz_row)
    sub_of_nnz = sub_base[row_of_nnz] + k_in_row // w

    # combine layout: tile rows by 128 and pad every tile's sub-row list to
    # a shared K, so the partial->row reduction is ONE segment sum over
    # the tiles. The routed ReducePass chain remains as fallback for
    # pathological tiles.
    T = -(-n_r // RADIX)
    tile_cnt = np.bincount(row_of_sub // RADIX, minlength=T).astype(np.int64)
    K = max(-(-int(tile_cnt.max(initial=1)) // RADIX) * RADIX, RADIX)
    trivial = bool((n_sub == 1).all())
    tiled = (not trivial) and K * w <= CLOS_MAX_SLOTS and K <= TILED_MAX_K

    rowid = None
    if trivial:
        # every row is exactly one sub-row: partials ARE the rows
        dest_global = sub_of_nnz * w + k_in_row % w
        slot_of_sub = np.arange(S0)
    elif tiled:
        tile_first = np.zeros(T + 1, np.int64)
        np.cumsum(tile_cnt, out=tile_first[1:])
        tile_of_sub = row_of_sub // RADIX
        slot_of_sub = tile_of_sub * K + (np.arange(S0) - tile_first[tile_of_sub])
        dest_global = slot_of_sub[sub_of_nnz] * w + k_in_row % w
        rowid = np.full((T, K), -1, np.int8)
        rowid[tile_of_sub, slot_of_sub - tile_of_sub * K] = (
            row_of_sub % RADIX).astype(np.int8)
    else:
        dest_global = sub_of_nnz * w + k_in_row % w
        slot_of_sub = np.arange(S0)

    # chunk split: contiguous slot ranges (tile-aligned when tiled) fitting
    # both the sub-row slots and the padded col-side layout in one domain
    if tiled:
        def chunk_units():  # (unit slot size, unit count, nnz bounds fn)
            def nnz_range(t0, t1):
                return indptr[t0 * RADIX], indptr[min(t1 * RADIX, n_r)]
            return K * w, T, nnz_range
    else:
        def chunk_units():
            def nnz_range(s0, s1):
                return sub_start[s0], sub_end[s1 - 1]
            return w, S0, nnz_range

    unit_slots, n_units, nnz_range = chunk_units()

    def fits(u0, u1, cap):
        if (u1 - u0) * unit_slots > cap:
            return False
        lo, hi = nnz_range(u0, u1)
        return _col_padded_slots(indices[lo:hi]) <= cap

    # derived-transpose eligibility: the trivial layout additionally needs
    # chunk starts aligned so every slot window maps to ONE u-tile
    align_ok = True
    q_align = max(RADIX // w, 1) if (with_transpose and trivial) else 1

    bounds = [0]
    while bounds[-1] < n_units:
        u0 = bounds[-1]
        lo = u0 + 1
        hi = min(u0 + CLOS_MAX_SLOTS // unit_slots, n_units)
        if fits(u0, hi, CLOS_MAX_SLOTS):
            if hi < n_units and hi % q_align:
                hi -= hi % q_align  # keep the NEXT chunk's start aligned
                if hi <= u0:
                    align_ok = False
                    hi = min(u0 + CLOS_MAX_SLOTS // unit_slots, n_units)
            bounds.append(hi)
            continue
        while lo < hi:  # largest u1 with fits(u0, u1)
            mid = (lo + hi + 1) // 2
            if fits(u0, mid, CLOS_MAX_SLOTS):
                lo = mid
            else:
                hi = mid - 1
        if lo == u0:
            raise ValueError(
                "a single row tile exceeds the routing domain; use the "
                "gather/segment-sum CSR path for this pattern")
        if lo < n_units and lo % q_align:
            lo_al = lo - lo % q_align
            if lo_al > u0:
                lo = lo_al
            else:
                align_ok = False
        bounds.append(lo)
    # rebalance multi-chunk splits to EQUAL sizes: stacked chunk arrays
    # share one domain N = max over chunks, and the greedy largest-fit
    # split leaves a half-empty last chunk padded up to the full ones —
    # slot utilization 0.667 vs 0.799 single-chunk at the bench shape.
    # Equal chunks shrink N for everyone; fall back to the
    # greedy bounds when a balanced chunk fails the fits() check.
    if len(bounds) > 2:
        nch = len(bounds) - 1
        per = -(-n_units // nch)
        if q_align > 1:
            per = -(-per // q_align) * q_align
        bal = [min(i * per, n_units) for i in range(nch)] + [n_units]
        if (all(b1 > b0 for b0, b1 in zip(bal[:-1], bal[1:]))
                and all(fits(b0, b1, CLOS_MAX_SLOTS)
                        for b0, b1 in zip(bal[:-1], bal[1:]))):
            bounds = bal
    chunks = list(zip(bounds[:-1], bounds[1:]))
    derive_t = with_transpose and (trivial or tiled) and align_ok

    # shared domain size N across chunks (stacking requires equal shapes)
    N = 0
    for u0, u1 in chunks:
        lo, hi = nnz_range(u0, u1)
        need = max((u1 - u0) * unit_slots, _col_padded_slots(indices[lo:hi]))
        N = max(N, _clos_size(need))

    m = N // RADIX
    vals_l, lane_l, winb_l, stage_l = [], [], [], []
    t_valsp, t_g1inv, t_etile, t_eidx = [], [], [], []
    t_stages, t_blo, t_bhi = [], [], []
    blk_win_rows = [[] for _ in range(-(-n_c // RADIX))] if derive_t else None

    def _pack_chunk(c_u0_u1):
        # per-chunk pack: pure function of read-only outer arrays, so the
        # multi-chunk build fans out over a thread pool (numpy and the
        # ctypes native router release the GIL)
        c, (u0, u1) = c_u0_u1
        lo, hi = nnz_range(u0, u1)
        cols_c = indices[lo:hi]
        vals_c = data[lo:hi]
        dest_c = dest_global[lo:hi] - u0 * unit_slots
        nnz_c = cols_c.shape[0]

        # col-block-major layout with per-block ×128 padding. Entries are
        # sorted by COLUMN (not just block): forward applies don't care
        # about within-block order, and same-column contiguity per window
        # is what makes the derived transpose's segsum combine possible.
        blk = cols_c // RADIX
        order = np.argsort(cols_c, kind="stable")
        ublk, counts = np.unique(blk, return_counts=True)
        padded = (-(-counts // RADIX)) * RADIX
        seg_off = np.zeros(ublk.shape[0] + 1, np.int64)
        np.cumsum(padded, out=seg_off[1:])
        rank = np.arange(nnz_c) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)])[:-1], counts
        )
        pos = np.repeat(seg_off[:-1], counts) + rank  # col-side position

        col_in = np.zeros(N, np.int64)
        val_in = np.zeros(N, data.dtype)
        col_in[: seg_off[-1]] = np.repeat(ublk * RADIX, padded)  # pad cols
        col_in[pos] = cols_c[order]
        val_in[pos] = vals_c[order]

        # destination permutation: real nnz to their slots, pads to the
        # remaining (row-pad + trash) slots in order
        is_real = np.zeros(N, bool)
        is_real[pos] = True
        used = np.zeros(N, bool)
        used[dest_c] = True
        dest = np.empty(N, np.int64)
        dest[pos] = dest_c[order]
        dest[~is_real] = np.flatnonzero(~used)

        stages = _clos_route_fast(dest)
        g1 = stages[0]
        f_vals = np.take_along_axis(val_in.reshape(m, RADIX), g1, axis=1)
        f_lane = np.take_along_axis(
            (col_in % RADIX).reshape(m, RADIX), g1, axis=1).astype(np.int8)
        f_winb = (col_in.reshape(m, RADIX)[:, 0] // RADIX).astype(np.int32)
        f_stages = [g.astype(np.int8) for g in _pad_middle_stage(stages)[1:]]

        if not derive_t:
            return f_vals, f_lane, f_winb, f_stages, None

        # ---- derived transpose: invert the stage arrays (O(N)) ----
        g1inv_store = _invert_rows(g1)
        if len(stages) > 1:
            inv_last = _invert_rows(stages[-1])
        else:
            inv_last = np.broadcast_to(
                np.arange(RADIX, dtype=np.int32), (m, RADIX))
        if len(stages) == 5:
            ig3 = _invert_rows(stages[2])
            if ig3.shape[1] < RADIX:  # mirror _pad_middle_stage
                ig3 = np.pad(ig3, ((0, 0), (0, RADIX - ig3.shape[1])))
            st_t = [_invert_rows(stages[3]).astype(np.int8),
                    ig3.astype(np.int8),
                    _invert_rows(stages[1]).astype(np.int8)]
        elif len(stages) == 3:
            st_t = [_invert_rows(stages[1]).astype(np.int8)]
        else:
            st_t = []

        # expand: slot window i draws u[row] from tile expand_tile[i] with
        # the per-slot row id composed through the final inverse crossbar.
        # Values entering non-real slots are ANNIHILATED downstream (the
        # forward pack maps pad positions onto exactly the non-real slots
        # and pad positions carry vals_pre = 0), so clips are safe.
        widx = np.arange(m, dtype=np.int64)[:, None] * RADIX + inv_last
        if tiled:
            lt = (np.arange(m, dtype=np.int64) * RADIX) // (K * w)
            tg = np.minimum(u0 + lt, T - 1)
            sub = (widx % (K * w)) // w
            eidx = rowid[tg[:, None], sub]
            etile = tg.astype(np.int32)
        else:  # trivial: sub-row == row; chunk starts are q_align-aligned
            rows_g = u0 + widx // w
            etile = np.minimum(
                (u0 + np.arange(m, dtype=np.int64) * (RADIX // w)) // RADIX,
                T - 1).astype(np.int32)
            eidx = (np.minimum(rows_g, n_r - 1) % RADIX).astype(np.int8)

        # per-window column-run boundaries at the PRE-G1 layout (sorted by
        # construction: pos is ascending and within-block order is by col)
        lcol = (cols_c[order] % RADIX).astype(np.int64)
        keys = (pos // RADIX) * RADIX + lcol
        blo, bhi = _run_bounds(keys, pos % RADIX, m)

        # the final per-block gather: S rows (global, chunk-major) holding
        # each block's per-window column sums
        win_entries = [
            (int(ublk[j]),
             range(c * m + int(seg_off[j] // RADIX),
                   c * m + int(seg_off[j + 1] // RADIX)))
            for j in range(ublk.shape[0])
        ]
        tpart = (np.maximum(eidx.astype(np.int16), 0).astype(np.int8),
                 etile, g1inv_store.astype(np.int8), st_t,
                 val_in.reshape(m, RADIX), blo, bhi, win_entries)
        return f_vals, f_lane, f_winb, f_stages, tpart

    if len(chunks) > 1:
        import os as _os
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(
                max_workers=min(len(chunks), _os.cpu_count() or 1)) as ex:
            results = list(ex.map(_pack_chunk, enumerate(chunks)))
    else:
        results = [_pack_chunk((0, chunks[0]))]
    for f_vals, f_lane, f_winb, f_stages, tpart in results:
        vals_l.append(f_vals)
        lane_l.append(f_lane)
        winb_l.append(f_winb)
        stage_l.append(f_stages)
        if tpart is not None:
            eidx8, etile, g1inv8, st_t, valsp, blo, bhi, win_entries = tpart
            t_eidx.append(eidx8)
            t_etile.append(etile)
            t_g1inv.append(g1inv8)
            t_stages.append(st_t)
            t_valsp.append(valsp)
            t_blo.append(blo)
            t_bhi.append(bhi)
            for b, rng_ in win_entries:
                blk_win_rows[b].extend(rng_)

    stages_stacked = tuple(
        _up(np.stack([s[i] for s in stage_l]))
        for i in range(len(stage_l[0]))
    )

    # combine: tiled (rowid segment sum) / trivial (partials ARE rows) /
    # fallback routed ReducePass chain
    S_pad = N // w
    passes = ()
    if trivial or tiled:
        keep = tuple(int(u1 - u0) * (K if tiled else 1) for u0, u1 in chunks)
    else:
        keep = ()  # ReducePass chain consumes the FULL per-chunk partials
        seg0 = np.full(len(chunks) * S_pad, -1, np.int64)
        for c, (s0, s1) in enumerate(chunks):
            seg0[c * S_pad: c * S_pad + (s1 - s0)] = row_of_sub[s0:s1]
        passes = _build_reduce_passes(seg0, n_r)

    fwd = RoutedSpMV(
        vals=_up(np.stack(vals_l)),
        lane_idx=_up(np.stack(lane_l)),
        win_block=_up(np.stack(winb_l)),
        stages=stages_stacked,
        rowid=None if rowid is None else _up(rowid),
        passes=passes,
        shape=(n_r, n_c),
        w=int(w),
        chunk_keep=keep,
    )
    if not with_transpose:
        return fwd

    derived = None
    if derive_t:
        nb = -(-n_c // RADIX)
        Wb = max((len(v) for v in blk_win_rows), default=1)
        Wb = max(Wb, 1)
        # skew guard: a block touched by vastly more windows than average
        # (a near-dense column block) would blow up the padded gather
        if nb * Wb <= 4 * len(chunks) * m + 1024:
            wr = np.full((nb, Wb), len(chunks) * m, np.int32)
            for b, v in enumerate(blk_win_rows):
                wr[b, : len(v)] = v
            derived = RoutedTranspose(
                vals_pre=_up(np.stack(t_valsp)),
                g1inv=_up(np.stack(t_g1inv)),
                expand_tile=_up(np.stack(t_etile)),
                expand_idx=_up(np.stack(t_eidx)),
                stages_t=tuple(
                    _up(np.stack([s[i] for s in t_stages]))
                    for i in range(len(t_stages[0]))
                ),
                bnd_lo=_up(np.stack(t_blo)),
                bnd_hi=_up(np.stack(t_bhi)),
                win_rows=_up(wr),
                n_tiles=int(T),
                shape=(n_r, n_c),
            )
    return fwd, derived


# ----------------------------------------------------------------------------
# Device pipeline
# ----------------------------------------------------------------------------


def _take(a, idx):
    return jnp.take_along_axis(a, idx.astype(jnp.int32), axis=1)


def _take_rep(a, idx, rep):
    """Gather a (rep·R0, L) rep-outer array by a SHARED (R0, L) idx."""
    if rep == 1:
        return _take(a, idx)
    m, L = idx.shape
    return jnp.take_along_axis(
        a.reshape(rep, m, L), idx.astype(jnp.int32)[None], axis=2
    ).reshape(rep * m, L)


def _segsum_from_z(z, lo, hi):
    """Per-window segmented lane sums by the prefix-difference trick.

    z: (..., 128) addends whose equal-segment entries are CONTIGUOUS
    within each 128-lane window. lo/hi: int8 per OUTPUT lane c — the
    inclusive-prefix boundary lanes of segment c in that window:
    ``S[i, c] = cs[i, hi] - cs[i, lo]`` with cs the inclusive lane prefix
    sum; lo = (first lane of the run) - 1 or -1 when the run starts at
    lane 0; hi = last lane of the run or -1 for an empty run (-1 terms
    read as 0). Leading dims of lo/hi broadcast against z.

    The prefix-then-difference order bounds the rounding error by the
    window's prefix magnitudes, not the segment's own."""
    cs = jnp.cumsum(z, axis=-1)
    lo_i = lo.astype(jnp.int32)
    hi_i = hi.astype(jnp.int32)
    bcast = jnp.broadcast_shapes(cs.shape, lo_i.shape)
    cs = jnp.broadcast_to(cs, bcast)
    hi_g = jnp.take_along_axis(cs, jnp.broadcast_to(jnp.maximum(hi_i, 0),
                                                    bcast), axis=-1)
    lo_g = jnp.take_along_axis(cs, jnp.broadcast_to(jnp.maximum(lo_i, 0),
                                                    bcast), axis=-1)
    zero = jnp.zeros((), z.dtype)
    return jnp.where(hi_i >= 0, hi_g, zero) - jnp.where(lo_i >= 0, lo_g, zero)


def _route_and_sum(a, stages, g1_folded, w):
    """Crossbar chain on (m, 128) tiles — mirroring
    routing.py::clos_apply exactly (minus G1 when folded) — fused with the
    final width-w slot reduction. Returns the (m·128/w,) partials."""
    m = a.shape[0]
    stages = list(stages)
    if not g1_folded and stages:
        a = _take(a, stages.pop(0))
    if stages and m <= RADIX:   # 3-stage: run G3/G5 (tiny domains)
        g3, g5 = stages
        a = _take(a.T, g3)
        a = _take(a.T, g5)
        stages = []
    if not stages:
        return a.reshape(-1, w).sum(axis=1)
    b = m // RADIX              # 5-stage: run G2/G3/G4/G5
    g2, g3, g4, g5 = stages
    a = a.T.reshape(RADIX * b, RADIX)                               # W1
    a = _take(a, g2)
    a = a.reshape(RADIX, b, RADIX).transpose(0, 2, 1).reshape(RADIX * RADIX, b)
    if b < RADIX:
        # the middle crossbar is lane-padded at pack time
        a = _take(jnp.pad(a, ((0, 0), (0, RADIX - b))), g3)[:, :b]
    else:
        a = _take(a, g3)
    a = a.reshape(RADIX, RADIX, b).transpose(0, 2, 1).reshape(RADIX * b, RADIX)
    a = _take(a, g4)
    a = a.reshape(RADIX, b * RADIX).T.reshape(m, RADIX)
    a = _take(a, g5)
    return a.reshape(-1, w).sum(axis=1)


def _route_and_sum_batched(a, stages, w, rep=1):
    """Batched-over-chunks crossbar chain + final width-w slot reduction.

    a: (rep·C, m, 128) post-phase-1 products. stages: per-stage (C, ...)
    int8 arrays, SHARED across the ``rep`` repeats (RHS columns — the
    routing program is column-independent). Every crossbar level is one
    gather over all chunks and repeats, and every wiring is one batched
    transpose. Returns (rep·C, m·128/w).
    """
    C = stages[0].shape[0] if stages else a.shape[0] // rep
    m = a.shape[1]
    BT = rep * C

    def take_flat(arr2d, g):
        return _take_rep(arr2d, g.reshape(arr2d.shape[0] // rep, -1), rep)

    stages = list(stages)
    if stages and m <= RADIX:  # 3-stage: G3 on (128, m) windows, then G5
        g3, g5 = stages
        at = a.transpose(0, 2, 1).reshape(BT * RADIX, m)
        at = _take_rep(at, g3.reshape(C * RADIX, m), rep)
        a = at.reshape(BT, RADIX, m).transpose(0, 2, 1).reshape(BT * m, RADIX)
        a = _take_rep(a, g5.reshape(C * m, RADIX), rep)
        return a.reshape(BT, -1, w).sum(axis=2)
    if not stages:
        return a.reshape(BT, -1, w).sum(axis=2)

    b = m // RADIX
    g2, g3, g4, g5 = stages
    a = a.transpose(0, 2, 1).reshape(BT * RADIX * b, RADIX)  # W1
    a = take_flat(a, g2)
    a = a.reshape(BT, RADIX, b, RADIX).transpose(0, 1, 3, 2).reshape(
        BT * RADIX * RADIX, b)  # W2
    if b < RADIX:
        a = take_flat(jnp.pad(a, ((0, 0), (0, RADIX - b))), g3)[:, :b]
    else:
        a = take_flat(a, g3)
    a = a.reshape(BT, RADIX, RADIX, b).transpose(0, 1, 3, 2).reshape(
        BT * RADIX * b, RADIX)  # W2ᵀ
    a = take_flat(a, g4)
    a = a.reshape(BT, RADIX, b * RADIX).transpose(0, 2, 1).reshape(
        BT * m, RADIX)  # W1ᵀ
    a = _take_rep(a, g5.reshape(C * m, RADIX), rep)
    return a.reshape(BT, -1, w).sum(axis=2)


def _reduce_pass(q, p: ReducePass):
    """Route partials into width-u per-row windows and reshape-sum."""
    outs = []
    for c, (lo, hi) in enumerate(p.in_spans):
        qc = q[lo:hi]
        if qc.shape[0] < p.n_in:
            qc = jnp.pad(qc, (0, p.n_in - qc.shape[0]))
        a = qc.reshape(-1, RADIX)
        part = _route_and_sum(a, tuple(s[c] for s in p.stages),
                              g1_folded=False, w=p.u)
        outs.append(part[: p.out_keep[c]])
    return outs[0] if len(outs) == 1 else jnp.concatenate(outs)


def _combine_segments(p: RoutedSpMV):
    """(T·K,) row ids of the sub-row partials for the tiled combine
    (``T·128`` = trash)."""
    T, _ = p.rowid.shape
    rid = p.rowid.astype(jnp.int32)
    seg = jnp.where(rid >= 0,
                    jnp.arange(T, dtype=jnp.int32)[:, None] * RADIX + rid,
                    T * RADIX)
    return seg.reshape(-1)


def routed_matvec(p: RoutedSpMV, x):
    """y = A @ x through the packed routing program ``p``."""
    n_r, n_c = p.shape
    x = jnp.asarray(x)  # host numpy x must not fancy-index tracers below
    nb = -(-n_c // RADIX)
    if x.shape[0] < nb * RADIX:
        x = jnp.pad(x, (0, nb * RADIX - x.shape[0]))
    x2 = x.reshape(nb, RADIX)

    # batched pipeline: all chunks share every gather and wiring
    C, m = p.vals.shape[0], p.vals.shape[1]
    xw = x2[p.win_block.reshape(-1)]  # (C·m, 128) x-block fetch, batched
    lane_flat = p.lane_idx.reshape(C * m, RADIX)
    vals_flat = p.vals.reshape(C * m, RADIX)
    g = jnp.take_along_axis(xw, lane_flat.astype(jnp.int32), axis=1)
    a = (vals_flat * g).astype(jnp.result_type(vals_flat.dtype, x2.dtype))
    P = _route_and_sum_batched(a.reshape(C, m, RADIX), p.stages, p.w)
    parts_list = [P[c] for c in range(C)]

    if p.passes:  # fallback routed combine (pathological tiles)
        q = parts_list[0] if C == 1 else jnp.concatenate(parts_list)
        for rp in p.passes:
            q = _reduce_pass(q, rp)
        return q[:n_r]

    kept = [pp[:k] for pp, k in zip(parts_list, p.chunk_keep)]
    q = kept[0] if len(kept) == 1 else jnp.concatenate(kept)
    if p.rowid is None:
        return q[:n_r]  # trivial: every row is exactly one sub-row
    T, K = p.rowid.shape
    if q.shape[0] < T * K:
        q = jnp.pad(q, (0, T * K - q.shape[0]))
    y = jax.ops.segment_sum(q, _combine_segments(p), num_segments=T * RADIX)
    return y[:n_r]


def routed_rmatvec(pt: RoutedTranspose, u):
    """y = Aᵀ @ u through the DERIVED transpose program ``pt``.

    Runs the forward Clos network BACKWARDS (see RoutedTranspose): expand
    u into the row-slot domain, apply the inverse crossbars with the same
    W1/W2 wirings, multiply by the pre-G1 values and reduce per column
    with the boundary segment sums, then gather each column block's
    per-window sums and reshape-sum. Cost ≈ one forward apply."""
    return routed_rmatmat(pt, jnp.asarray(u)[None, :], panel=True)[0]


def routed_matmat(p: RoutedSpMV, X, panel=False):
    """Y = A @ X (k RHS columns) through ONE shared routing program.

    The crossbar index arrays, values, and combine row ids are column-
    independent, so the k columns ride the same program: every gather
    runs over a column-outer stack of the k columns against one copy of
    the shared index arrays.

    ``panel=True``: X arrives TRANSPOSED as (k, n) row panels and Y is
    returned as (k, n_r) — the ``apply_matrix_t`` protocol layout. The
    pipeline's native layout is column-outer on BOTH ends, so this skips
    the two boundary relayouts ((n, k) → column-outer in, (k, n_r) →
    (n_r, k) out) that the dense-API form pays per apply.
    """
    n_r, n_c = p.shape
    X = jnp.asarray(X)
    if not panel:
        X = X.T  # column-outer (k, n): the pipeline's native layout
    k = X.shape[0]
    if k == 1:
        y = routed_matvec(p, X[0])
        return y[None, :] if panel else y[:, None]
    if p.passes:  # ReducePass fallback layouts: per-column loop (rare)
        Y = jax.lax.map(lambda c: routed_matvec(p, c), X)
        return Y if panel else Y.T
    nb = -(-n_c // RADIX)
    if X.shape[1] < nb * RADIX:
        X = jnp.pad(X, ((0, 0), (0, nb * RADIX - X.shape[1])))
    X3 = X.reshape(k, nb, RADIX)

    C, m = p.vals.shape[0], p.vals.shape[1]
    xw = X3[:, p.win_block.reshape(-1)].reshape(k * C * m, RADIX)
    lane_flat = p.lane_idx.reshape(C * m, RADIX)
    vals_flat = p.vals.reshape(C * m, RADIX)
    g = jnp.take_along_axis(xw.reshape(k, C * m, RADIX),
                            lane_flat.astype(jnp.int32)[None], axis=2)
    a = (vals_flat[None] * g).astype(
        jnp.result_type(vals_flat.dtype, X.dtype)
    ).reshape(k * C * m, RADIX)
    P = _route_and_sum_batched(a.reshape(k * C, m, RADIX), p.stages, p.w,
                               rep=k)

    S_pad = m * RADIX // p.w
    P = P.reshape(k, C, S_pad)
    kept = [P[:, c, :kc] for c, kc in enumerate(p.chunk_keep)]
    q = kept[0] if len(kept) == 1 else jnp.concatenate(kept, axis=1)
    if p.rowid is None:  # trivial: partials ARE rows
        return q[:, :n_r] if panel else q[:, :n_r].T
    T, K = p.rowid.shape
    if q.shape[1] < T * K:
        q = jnp.pad(q, ((0, 0), (0, T * K - q.shape[1])))
    seg = _combine_segments(p)
    y = jax.vmap(lambda qq: jax.ops.segment_sum(
        qq, seg, num_segments=T * RADIX))(q)
    return y[:, :n_r] if panel else y[:, :n_r].T


def routed_rmatmat(pt: RoutedTranspose, U, panel=False):
    """Y = Aᵀ @ U (k RHS columns) through the shared derived-transpose
    program — the multi-column form of ``routed_rmatvec``.

    ``panel=True``: U in as (k, n) row panels, Y out as (k, n_c) — see
    ``routed_matmat``."""
    n_r, n_c = pt.shape
    U = jnp.asarray(U)
    if not panel:
        U = U.T  # column-outer, see routed_matmat
    k = U.shape[0]
    if U.shape[1] < pt.n_tiles * RADIX:
        U = jnp.pad(U, ((0, 0), (0, pt.n_tiles * RADIX - U.shape[1])))
    U3 = U.reshape(k, pt.n_tiles, RADIX)

    C, m, _ = pt.vals_pre.shape
    uw = U3[:, pt.expand_tile.reshape(-1)].reshape(k * C * m, RADIX)
    a = _take_rep(uw, pt.expand_idx.reshape(C * m, RADIX), k)
    st = list(pt.stages_t)
    BT = k * C
    if st and m <= RADIX:  # 3-stage inverse: W1, G3⁻¹, W1ᵀ
        at = a.reshape(BT, m, RADIX).transpose(0, 2, 1).reshape(BT * RADIX, m)
        at = _take_rep(at, st[0].reshape(C * RADIX, m), k)
        a = at.reshape(BT, RADIX, m).transpose(0, 2, 1).reshape(BT * m, RADIX)
    elif st:  # 5-stage inverse middle chain (same wirings as forward)
        b = m // RADIX
        ig4, ig3, ig2 = st
        a = a.reshape(BT, m, RADIX).transpose(0, 2, 1).reshape(
            BT * RADIX * b, RADIX)                                  # W1
        a = _take_rep(a, ig4.reshape(C * RADIX * b, RADIX), k)
        a = a.reshape(BT, RADIX, b, RADIX).transpose(0, 1, 3, 2).reshape(
            BT * RADIX * RADIX, b)                                  # W2
        if b < RADIX:
            a = _take_rep(jnp.pad(a, ((0, 0), (0, RADIX - b))),
                          ig3.reshape(C * RADIX * RADIX, RADIX), k)[:, :b]
        else:
            a = _take_rep(a, ig3.reshape(C * RADIX * RADIX, b), k)
        a = a.reshape(BT, RADIX, RADIX, b).transpose(0, 1, 3, 2).reshape(
            BT * RADIX * b, RADIX)                                  # W2ᵀ
        a = _take_rep(a, ig2.reshape(C * RADIX * b, RADIX), k)
        a = a.reshape(BT, RADIX, b * RADIX).transpose(0, 2, 1).reshape(
            BT * m, RADIX)                                          # W1ᵀ
    # final: G1⁻¹ ∘ multiply(vals_pre) ∘ per-column segment sums
    g1inv_flat = pt.g1inv.reshape(C * m, RADIX)
    valsp_flat = pt.vals_pre.reshape(C * m, RADIX)
    lo_flat = pt.bnd_lo.reshape(C * m, RADIX)
    hi_flat = pt.bnd_hi.reshape(C * m, RADIX)
    g = jnp.take_along_axis(a.reshape(k, C * m, RADIX),
                            g1inv_flat.astype(jnp.int32)[None], axis=2)
    z = (valsp_flat[None] * g).astype(
        jnp.result_type(valsp_flat.dtype, a.dtype))
    S4 = _segsum_from_z(z, lo_flat[None], hi_flat[None])
    Sz = jnp.concatenate([S4, jnp.zeros((k, 1, RADIX), S4.dtype)], axis=1)
    nb, Wb = pt.win_rows.shape
    y = Sz[:, pt.win_rows.reshape(-1)].reshape(k, nb, Wb, RADIX).sum(axis=2)
    y2 = y.reshape(k, -1)[:, :n_c]
    return y2 if panel else y2.T
