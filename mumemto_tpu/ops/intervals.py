"""Vectorized LCP-interval analysis: the match-finding scan as array ops.

The reference streams SA rows through a stack machine (include/
mem_finder.hpp:304-355). The set of intervals that machine tests is exactly
the set of canonical LCP intervals: for each boundary p (1 <= p < n) with
L = LCP[p] >= min_match_len,

  s(p) = PSV(p) = max q < p with LCP[q] < L   (interval rows are [s, e-1])
  e(p) = NSV(p) = min q > p with LCP[q] < L   (interval closes at row e)

deduplicated to the leftmost boundary attaining L inside (s, e). Intervals
whose NSV does not exist (still open when the stream ends) are never emitted
by the reference — we preserve that by dropping p with no NSV.

Emission conditions (mem_finder.hpp:320-344), translated per-interval:
  L >= min_match_len
  size = e - s >= num_distinct
  no_max_freq or size <= max_total_freq
  doc filter over DA[s..e-1] (per-doc count <= f; distinct >= k)
  left-maximality: some BWT change strictly inside (s, e-1]

and the stack context values used by merge thresholds are
  prev_ctx = LCP[s],  next_ctx = LCP[e]   (mem_finder.hpp:311-347).

Emission order in the output file equals pop order = sort by (e asc, L desc).

Cost model: sorts, slices and scans stream through memory; random gathers
and scatters do not. Design rules used here: never build tables with
gathers (use slices), replace range queries with scatter + directional
scans where possible, replace per-element searches with sorts. Remaining
gathers: the PSV/NSV log-walks and O(1) lookups.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from mumemto_tpu.ops.suffix import _num_levels

INT32_MAX = jnp.iinfo(jnp.int32).max


def _shifted(arr, k: int, fill):
    """out[i] = arr[i + k] (k may be negative), `fill` past the ends — the
    windowed stencil primitive: a slice + pad, never a gather."""
    if k == 0:
        return arr
    pad = jnp.full((abs(k),), fill, arr.dtype)
    if k > 0:
        return jnp.concatenate([arr[k:], pad])
    return jnp.concatenate([pad, arr[:k]])


def _sparse_min_table(values: jax.Array, max_level: int | None = None) -> list:
    """table[l][x] = min(values[x : x + 2^l]) with end-clamping, built with
    slices only (no gathers). max_level caps the table height (enough for
    walks of bounded distance)."""
    n = values.shape[0]
    L = _num_levels(n)
    if max_level is not None:
        L = min(L, max_level)
    table = [values]
    for lvl in range(1, L + 1):
        half = 1 << (lvl - 1)
        prev = table[-1]
        if half >= n:
            table.append(prev)
            continue
        shifted = jnp.concatenate(
            [prev[half:], jnp.broadcast_to(prev[-1:], (half,))])
        table.append(jnp.minimum(prev, shifted))
    return table


def _psv_walk(table_min: list, p: jax.Array, thresh: jax.Array,
              max_dist: int | None = None):
    """max q < p with LCP[q] < thresh (exists whenever LCP[0] < thresh).

    max_dist bounds every PROBE (not just the result) to positions
    >= p - max_dist: exact whenever the true PSV is within max_dist of p
    (blocks fully inside (PSV, p) are never guard-blocked), and walks whose
    PSV lies farther stop on a >= thresh position, which the caller's
    found-check then invalidates. This is what makes the walk BLOCK-LOCAL:
    inside a shard_map over haloed blocks (parallel/widepfp.py), a halo of
    max_dist + 1 rows per side covers every position the walk can touch."""
    n = table_min[0].shape[0]
    cur = p - 1
    for lvl in range(len(table_min) - 1, -1, -1):
        width = 1 << lvl
        start = cur - width + 1
        ok = start >= 0
        if max_dist is not None:
            ok = ok & (start >= p - max_dist)
        blockmin = jnp.take(table_min[lvl], jnp.clip(start, 0, n - 1))
        take = ok & (blockmin >= thresh)
        cur = jnp.where(take, cur - width, cur)
    return cur


def _nsv_walk(table_min: list, p: jax.Array, thresh: jax.Array,
              max_dist: int | None = None):
    """min q > p with LCP[q] < thresh, or n if none (open interval).
    max_dist: probe guard, mirror of _psv_walk's."""
    n = table_min[0].shape[0]
    cur = p + 1
    for lvl in range(len(table_min) - 1, -1, -1):
        width = 1 << lvl
        ok = cur + width <= n
        if max_dist is not None:
            ok = ok & (cur + width <= p + 1 + max_dist)
        blockmin = jnp.take(table_min[lvl], jnp.clip(cur, 0, n - 1))
        take = ok & (blockmin >= thresh)
        cur = jnp.where(take, cur + width, cur)
    return cur


def _psv_nsv_windowed(lcp: jax.Array, n: int, cap: int):
    """PSV/NSV restricted to a +-(cap-1) window, via sliced shifts only.

    For intervals that can pass the occurrence filters, p - s and e - p are
    < cap, so scanning k = 1..cap-1 shifted copies of lcp finds the true
    PSV/NSV or proves the interval is wider than the cap. Shifted slices
    are elementwise (XLA fuses the whole chain into a couple of kernels),
    unlike the sparse-table binary descent whose per-level gathers dominate
    the scan cost. Returns (s, e) with e = n marking open/too-wide, s = -1
    marking too-wide on the left.
    """
    p = jnp.arange(n, dtype=jnp.int32)
    s = jnp.full((n,), -1, jnp.int32)
    e = jnp.full((n,), n, jnp.int32)
    s_found = jnp.zeros((n,), bool)
    e_found = jnp.zeros((n,), bool)
    for k in range(1, cap):
        hit = (~s_found) & (_shifted(lcp, -k, 0) < lcp)
        s = jnp.where(hit, p - k, s)
        s_found |= hit
        hit = (~e_found) & (_shifted(lcp, k, -1) < lcp)
        e = jnp.where(hit, jnp.minimum(p + k, n), e)
        e_found |= hit
    # invalidate when either side exceeded the window (cannot pass filters)
    e = jnp.where(s_found & e_found, e, n)
    s = jnp.maximum(s, 0)
    return s, e


def prev_same_doc(da: jax.Array) -> jax.Array:
    """prev[r] = largest r' < r with da[r'] == da[r], else -1 (sort-based)."""
    n = da.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    d_sorted, i_sorted = jax.lax.sort((da, idx), num_keys=1, is_stable=True)
    prev_sorted = jnp.concatenate([
        jnp.full((1,), -1, jnp.int32),
        jnp.where(d_sorted[1:] == d_sorted[:-1], i_sorted[:-1], -1),
    ])
    return jnp.zeros((n,), jnp.int32).at[i_sorted].set(prev_sorted)


def _compose_prev(prev: jax.Array, times: int) -> jax.Array:
    """times-fold composition of the prev-pointer (for per-doc freq > f)."""
    out = prev
    for _ in range(times - 1):
        out = jnp.where(out >= 0, jnp.take(prev, jnp.maximum(out, 0)), -1)
    return out


def _first_violation_from(prevf: jax.Array) -> jax.Array:
    """mindup[s] = min{ r : prevf[r] >= s }, or INT32_MAX if none.

    An interval [s, e) violates the per-doc frequency cap iff mindup[s] < e
    (equivalently max over the window of prevf >= s). Built with one
    scatter-min + one reverse cummin instead of per-interval range queries.
    """
    n = prevf.shape[0]
    r = jnp.arange(n, dtype=jnp.int32)
    a = jnp.full((n,), INT32_MAX, jnp.int32)
    a = a.at[jnp.clip(prevf, 0, n - 1)].min(jnp.where(prevf >= 0, r, INT32_MAX))
    return jax.lax.cummin(a, reverse=True)


def _leftmost_mask(e: jax.Array, lcp: jax.Array, n: int) -> jax.Array:
    """keep[p] = True iff p is the smallest boundary of its interval.

    All boundaries of one canonical interval share (e, L) — and (e, L)
    uniquely identifies the interval (nested intervals popped at the same
    close row have distinct depths). One sort replaces a PSV<=L walk.
    """
    p = jnp.arange(n, dtype=jnp.int32)
    e_s, l_s, p_s = jax.lax.sort((e, lcp, p), num_keys=3)
    first = jnp.concatenate([
        jnp.ones((1,), bool),
        (e_s[1:] != e_s[:-1]) | (l_s[1:] != l_s[:-1]),
    ])
    return jnp.zeros((n,), bool).at[p_s].set(first)


@functools.partial(jax.jit,
                   static_argnames=("n", "max_doc_freq", "size_cap",
                                    "need_ctx"))
def analyze_intervals(lcp: jax.Array, da: jax.Array, bwt: jax.Array,
                      n: int, min_match_len, num_distinct,
                      max_total_freq, max_doc_freq: int,
                      size_cap: int | None = None, need_ctx: bool = True):
    """Evaluate every candidate LCP interval; returns per-boundary arrays.

    Returns dict of n-sized arrays:
      emit      bool — passes all conditions incl. left-maximality
      cand      bool — passes all conditions EXCEPT left-maximality
                (these still update merge thresholds, mem_finder.hpp:326-336)
      s, e, L   interval geometry (valid where cand)
      prev_ctx/next_ctx  LCP[s] / LCP[e] (merge threshold inputs)
      prev_same prev-same-doc pointers (host MEM-mode distinct counting)

    For max_doc_freq != 1 the distinct-count (unique >= k) sub-check of
    check_doc_range is deferred to the host over the compacted candidates.

    size_cap: static upper bound on the size (e - s) of any interval that
    can pass the occurrence filters (num_docs * f, or F) — lets the PSV/NSV
    binary descents run over O(log cap) levels instead of O(log n), which
    is the dominant gather cost. Intervals wider than the cap are exactly
    the ones the doc-frequency/total-frequency conditions reject, so
    invalidating them preserves reference semantics for both emit and cand.
    """
    p = jnp.arange(n, dtype=jnp.int32)
    Lv = lcp
    is_cand = lcp >= min_match_len

    windowed = size_cap is not None and size_cap <= 128
    walk_levels = None
    if windowed:
        # shifted-slice window scan: gather-free, fully fusable
        s, e = _psv_nsv_windowed(lcp, n, size_cap)
    else:
        if size_cap is not None and size_cap < n:
            # levels 0..walk_levels cover walk distances up to
            # 2^(walk_levels+1) - 1 >= size_cap
            walk_levels = max((size_cap + 1).bit_length() - 1, 1)
        guard = size_cap if walk_levels is not None else None
        tmin = _sparse_min_table(lcp, max_level=walk_levels)
        s = _psv_walk(tmin, p, Lv, max_dist=guard)
        e = _nsv_walk(tmin, p, Lv, max_dist=guard)
        if walk_levels is not None:
            # capped descent: if the walk endpoint is not an actual smaller
            # value, the true interval extends beyond the cap -> cannot
            # pass the frequency filters; invalidate (e = n marks it open)
            s_found = jnp.take(lcp, jnp.clip(s, 0, n - 1)) < Lv
            s_found = s_found | (s < 0)  # virtual lcp[-1] = -inf
            e_found = (e < n) & (jnp.take(lcp, jnp.clip(e, 0, n - 1)) < Lv)
            # explicit width rejection: intervals wider than the cap are
            # exactly the ones the occurrence filters reject (docstring),
            # so this changes no cand/emit decision — it pins every
            # SURVIVING interval inside [p - cap + 1, p + cap - 1], which
            # is what makes the capped analyzer correct on haloed blocks
            e = jnp.where(s_found & e_found & (e - s <= size_cap), e, n)
    closed = e < n
    if windowed:
        # p is the leftmost boundary of its interval iff every lcp in
        # (s, p) is strictly greater than L (an equal value q there would
        # share (s, e, L)); p - s < cap, so cap-1 shifted compares replace
        # the (e, L) sort+scatter dedup
        leftmost = jnp.ones((n,), bool)
        for k in range(1, size_cap):
            inside = (p - k) > s
            leftmost &= (~inside) | (_shifted(lcp, -k, 0) > Lv)
    elif walk_levels is not None:
        # same characterization via one more guarded walk: p is leftmost
        # iff no q in (s, p) has lcp[q] <= L, i.e. the max q < p with
        # lcp[q] <= L (= PSV at threshold L+1, integer lcp) is <= s.
        # Unlike the (e, L) sort dedup this couples NO rows beyond the
        # probe window — required for block-local use; byte-identical
        # globally (an lcp[q] < L inside (s, p) contradicts PSV, so the
        # only disqualifiers are equal-L siblings, exactly the sort's)
        thr = jnp.minimum(Lv, INT32_MAX - 1) + 1
        leftmost = _psv_walk(tmin, p, thr, max_dist=size_cap) <= s
    else:
        leftmost = _leftmost_mask(e, lcp, n)

    size = e - s
    cond_size = size >= num_distinct
    cond_freq = (max_total_freq == 0) | (size <= max_total_freq)

    # left-maximality: last BWT change at rows <= e-1 must be > s
    changed = jnp.concatenate([
        jnp.ones((1,), jnp.int32),
        (bwt[1:] != bwt[:-1]).astype(jnp.int32),
    ])
    last_change = jax.lax.cummax(p * changed)
    if windowed:
        # e - p < cap: select shift(last_change, k-1) where e == p + k —
        # cap-1 shifted slices replace an O(n) random gather
        lmv = jnp.full((n,), -1, jnp.int32)
        for k in range(1, size_cap):
            # fill never selected: e == p + k implies p + k - 1 < n
            lmv = jnp.where(e == p + k, _shifted(last_change, k - 1, 0), lmv)
        lm = lmv > s
    else:
        lm = jnp.take(last_change, jnp.clip(e - 1, 0, n - 1)) > s

    # per-doc frequency cap: violated iff some doc occurs > f times in [s, e)
    if windowed and max_doc_freq == 1:
        # a duplicate-doc pair inside an interval is < cap rows apart, so
        # the prev-same-doc pointer only needs window-local accuracy:
        # cap-1 shifted compares instead of a 2-operand sort + scatter
        prev = jnp.full((n,), -1, jnp.int32)
        found = jnp.zeros((n,), bool)
        for k in range(1, size_cap):
            hit = (~found) & (_shifted(da, -k, -1) == da)
            prev = jnp.where(hit, p - k, prev)
            found |= hit
        # violation: some r in (s, e) has prev[r] >= s; r is within
        # cap-2 rows of p on either side, so 2*cap-3 shifted terms
        # replace the scatter-min + reverse-cummin + gather chain
        bad = jnp.zeros((n,), bool)
        for delta in range(-(size_cap - 2), size_cap - 1):
            rpos = p + delta
            bad |= (rpos > s) & (rpos < e) & (_shifted(prev, delta, -1) >= s)
        doc_freq_ok = ~bad
    elif max_doc_freq > 0:
        prev = prev_same_doc(da)
        prevf = _compose_prev(prev, max_doc_freq)
        mindup = _first_violation_from(prevf)
        doc_freq_ok = jnp.take(mindup, jnp.clip(s, 0, n - 1)) >= e
    else:
        prev = prev_same_doc(da)
        doc_freq_ok = jnp.ones((n,), bool)

    cand = is_cand & leftmost & closed & cond_size & cond_freq & doc_freq_ok

    if need_ctx and windowed:
        # merge-threshold inputs (mem_finder.hpp:311-347); p - s and
        # e - p are < cap, so shifted selects replace the two gathers
        prev_ctx = jnp.zeros((n,), jnp.int32)
        next_ctx = jnp.zeros((n,), jnp.int32)
        for k in range(1, size_cap):
            prev_ctx = jnp.where(s == p - k, _shifted(lcp, -k, 0), prev_ctx)
            next_ctx = jnp.where(e == p + k, _shifted(lcp, k, 0), next_ctx)
        # e == n (open) rows read lcp[n] = 0 in the gather form; the
        # select form leaves 0 — identical (clip read lcp[n-1] before,
        # but open intervals are never candidates)
    elif need_ctx:
        # two O(n) gathers only paid when merge metadata is requested
        prev_ctx = jnp.take(lcp, jnp.clip(s, 0, n - 1))
        next_ctx = jnp.take(lcp, jnp.clip(e, 0, n - 1))
    else:
        prev_ctx = next_ctx = jnp.zeros((n,), jnp.int32)

    return {
        "cand": cand,
        "emit": cand & lm,
        "s": s,
        "e": e,
        "L": Lv,
        "prev_ctx": prev_ctx,
        "next_ctx": next_ctx,
        "prev_same": prev,
    }
