"""Suffix array / LCP / BWT / document-array construction in JAX.

Accelerator-native replacement for the reference's gSACAK path (include/
direct_gsacak.hpp:39-116): instead of sequential SA-IS induction, we use
prefix doubling — O(log n) rounds of `jax.lax.sort` over (rank, rank-at-
offset-2^k) key pairs — which maps onto XLA's parallel sort. The per-round
rank arrays are kept as a "rank history"; the LCP array is then computed
exactly (no hashing) by the classic rank-descent: walk levels high→low and
extend the match by 2^l whenever the level-l ranks agree. Everything is
int32, device-resident, static-shaped.

Text convention: input collection text (uint8, '$'-separated docs, see
refbuilder) padded with trailing zeros to the array size. The zero padding
acts as the terminator (the reference appends {1,0}; direct_gsacak.hpp:56-57)
and is output-neutral: pad suffixes sort before all real suffixes, the
boundary LCP into the first real row is 0, every pad row's doc id is
num_docs (outside the collection), so no pad row can ever participate in an
emitted interval (distinct-docs >= 2 is required). This allows bucketing
text lengths to a few compiled shapes.
"""

from __future__ import annotations

import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np


def route_set(target_idx: jax.Array, *values: jax.Array):
    """out_k[target_idx] = values_k where target_idx is a PERMUTATION of
    0..n-1 — the "routing" primitive of the doubling rounds and the PLCP
    phi/isa construction.

    Two byte-identical lowerings, switched at TRACE time by
    MUMEMTO_SORT_ROUTE (prewarm both before flipping mid-process — jit
    caches keep the traced choice):
      * sort-route (default): ONE lax.sort keyed on target_idx carrying
        all values, so k values share one pass;
      * scatter (MUMEMTO_SORT_ROUTE=0): one .at[perm].set per value — a
        random O(n) store pass each.
    Which is faster on a GPU is not measured yet."""
    n = target_idx.shape[0]
    if os.environ.get("MUMEMTO_SORT_ROUTE", "1") != "0":
        out = jax.lax.sort((target_idx, *values), num_keys=1)
        return out[1] if len(values) == 1 else out[1:]
    outs = tuple(
        jnp.zeros((n,), v.dtype).at[target_idx].set(v) for v in values)
    return outs[0] if len(values) == 1 else outs


def _num_levels(n: int) -> int:
    """Number of doubling rounds so that 2^rounds >= n."""
    return max(1, math.ceil(math.log2(max(n, 2))))


def _shift_static(r: jax.Array, k: int, n: int, fill: int) -> jax.Array:
    """r shifted left by the STATIC distance k, filled past the end — a
    slice+pad (elementwise), not a gather."""
    if k >= n:
        return jnp.full((n,), fill, r.dtype)
    return jnp.concatenate([r[k:], jnp.full((k,), fill, r.dtype)])


def _seed_packed8(text: jax.Array, n: int, alpha_thresholds):
    """3-bit alphabet-coded seed: exact 1/2/4/8-char rank rows built with
    shifts only (no sorts). Valid when the text has <= 8 distinct byte
    values; alpha_thresholds are the 7 static split points so that
    code = #{t < char} is order-preserving. A beyond-the-array slot codes
    as 0; a real byte coding to 0 only occurs in the zero-pad tail, where
    the conflation is harmless (pad rows sort first either way and carry
    no consumed structure)."""
    code = jnp.zeros((n,), jnp.int32)
    for t in alpha_thresholds:
        code = code + (text > jnp.uint8(t)).astype(jnp.int32)
    rank8 = code
    for j in range(1, 8):
        rank8 = (rank8 << 3) | _shift_static(code, j, n, 0)
    return code, rank8 >> 18, rank8 >> 12, rank8


@functools.partial(jax.jit, static_argnames=("n", "packed_init", "max_lvl",
                                             "alpha_thresholds"))
def _suffix_array_impl(text: jax.Array, n: int, packed_init: bool = False,
                       max_lvl: int | None = None,
                       alpha_thresholds: tuple | None = None):
    """Prefix-doubling SA. packed_init=True (valid only when every element
    is < 128, e.g. byte texts) seeds the rank history with packed 1-/2-/4-
    char ranks, skipping the first two sort rounds; alpha_thresholds
    (static, <= 7 split points for a <= 8-letter alphabet) upgrades the
    seed to exact 8-char ranks, skipping a third round. Rank rows are only
    ever compared for equality/order, so order-preserving non-compact
    ranks are valid seeds.

    max_lvl caps the doubling depth: the result is then a suffix ordering
    exact up to 2^max_lvl-char prefixes, with ties (suffix pairs sharing
    longer prefixes) left in arbitrary relative order. Valid ONLY for
    consumers that treat such ties as equivalent — the PFP dictionary path
    qualifies (ties beyond maxlen+1 chars are same-group suffixes whose
    order is irrelevant; see pfp_scan); the direct text-SA path must not
    set it. Capped runs also use a statically UNROLLED doubling loop whose
    per-round offset shift is a slice instead of a gather (the while_loop
    variant pays an O(n) gather per round because the shift distance is a
    traced carry)."""
    L = _num_levels(n)
    if max_lvl is not None:
        L = min(L, max_lvl)
    idx = jnp.arange(n, dtype=jnp.int32)
    rank0 = text.astype(jnp.int32)
    hist = jnp.zeros((L + 1, n), dtype=jnp.int32)

    if alpha_thresholds is not None and L >= 3:
        code, rank2, rank4, rank8 = _seed_packed8(text, n, alpha_thresholds)
        hist = hist.at[0].set(code).at[1].set(rank2).at[2].set(rank4) \
                   .at[3].set(rank8)
        start_rank, start_lvl = rank8, 4
        start_sa = jnp.argsort(rank8, stable=True).astype(jnp.int32)
    elif packed_init:
        # 7-bit packed seed ranks covering 2 then 4 chars (all < 2^28).
        # Chars are stored as char+1 (valid while char < 127) so that a
        # beyond-the-array slot packs as 0 = "absent", which sorts before
        # every real char — the same shorter-suffix-first semantics the
        # doubling rounds get from key2 = -1.
        tp = rank0 + 1
        slot1 = jnp.where(idx + 1 < n, _shift_static(tp, 1, n, 0), 0)
        rank2 = (tp << 7) | slot1
        slot23 = jnp.where(idx + 2 < n, _shift_static(rank2, 2, n, 0), 0)
        rank4 = (rank2 << 14) | slot23
        hist = hist.at[0].set(rank0).at[1].set(rank2).at[2].set(rank4)
        start_rank, start_lvl = rank4, 3
        start_sa = jnp.argsort(rank4, stable=True).astype(jnp.int32)
    else:
        hist = hist.at[0].set(rank0)
        start_rank, start_lvl = rank0, 1
        start_sa = jnp.argsort(rank0, stable=True).astype(jnp.int32)

    def round_core(rank, key2):
        r1, r2, perm = jax.lax.sort((rank, key2, idx), num_keys=2)
        changed = jnp.concatenate([
            jnp.zeros((1,), jnp.int32),
            ((r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])).astype(jnp.int32),
        ])
        new_rank_sorted = jnp.cumsum(changed)
        new_rank = route_set(perm, new_rank_sorted)
        return new_rank, perm, new_rank_sorted[-1] == n - 1

    if max_lvl is not None:
        # depth-capped runs (the PFP dictionary): repetitive inputs keep
        # ties alive until the cap, so the early-exit check rarely fires —
        # unroll all rounds with static-k slice shifts
        rank, sa = start_rank, start_sa
        for lvl in range(start_lvl, L + 1):
            k = 1 << (lvl - 1)
            key2 = _shift_static(rank, k, n, -1)
            rank, sa, _done = round_core(rank, key2)
            hist = hist.at[lvl].set(rank)
        return sa, hist, jnp.int32(L + 1)

    def body(carry):
        rank, sa, hist, k, lvl, _done = carry
        # rank of the suffix starting 2^(lvl-1) later; -1 past the end
        key2 = jnp.where(idx + k < n,
                         jnp.take(rank, jnp.minimum(idx + k, n - 1)), -1)
        new_rank, perm, done = round_core(rank, key2)
        hist = jax.lax.dynamic_update_slice(hist, new_rank[None, :], (lvl, 0))
        return new_rank, perm, hist, k * 2, lvl + 1, done

    def cond(carry):
        _rank, _sa, _hist, _k, lvl, done = carry
        return (lvl <= L) & jnp.logical_not(done)

    init = (start_rank, start_sa, hist, jnp.int32(1 << (start_lvl - 1)),
            jnp.int32(start_lvl), jnp.bool_(False))
    rank, sa, hist, _k, lvl, _done = jax.lax.while_loop(cond, body, init)
    return sa, hist, lvl


@functools.partial(jax.jit, static_argnames=("n", "levels",
                                             "bottom_thresholds"))
def _lcp_impl(sa: jax.Array, hist: jax.Array, num_lvl: jax.Array, n: int,
              levels: int | None = None, text: jax.Array | None = None,
              bottom_thresholds: tuple | None = None):
    """lcp[j] = LCP(suffix sa[j-1], suffix sa[j]); lcp[0] = 0.

    Exact rank-descent using the doubling history. Levels above the last
    computed round use the final (all-distinct) rank row: equality there is
    impossible, so they contribute nothing — no special-casing needed.

    levels: static count of computed doubling rounds (the runtime value of
    num_lvl, read back by the caller). Descending from levels-1 instead of
    the worst-case log2(n) skips the provably-no-op top levels — each level
    costs two O(n) gathers, the dominant cost of this function.

    bottom_thresholds (+ text): for alphabets of <= 16 distinct byte
    values, the bottom three levels (4+2+1 chars = at most 7 remaining
    chars once level 3 has run) collapse into ONE comparison of
    precomputed 28-bit packs of 7 alphabet-coded chars: 2 gathers instead
    of 6. The packs use zero fill past the array end; that can only
    overcount LCPs between all-zero pad suffixes (both arguments already
    deep in the zero tail), which sort to the very front of the SA and
    whose lcp values no consumer reads un-guarded (see pfp._dict_groups:
    the first valid row is always a new group and grp_cross[0] is pinned
    to 0)."""
    L = hist.shape[0] - 1
    top = L if levels is None else min(int(levels) - 1, L)
    a = jnp.concatenate([sa[:1], sa[:-1]])  # previous row (a[0] unused)
    b = sa
    h = jnp.zeros((n,), jnp.int32)
    packed_bottom = bottom_thresholds is not None and top >= 3
    stop = 3 if packed_bottom else 0
    for lvl in range(top, stop - 1, -1):
        row = jnp.minimum(jnp.int32(lvl), num_lvl - 1)
        ranks = jax.lax.dynamic_index_in_dim(hist, row, axis=0, keepdims=False)
        ia = a + h
        ib = b + h
        inb = (ia < n) & (ib < n)
        ra = jnp.take(ranks, jnp.minimum(ia, n - 1))
        rb = jnp.take(ranks, jnp.minimum(ib, n - 1))
        h = jnp.where(inb & (ra == rb), h + (1 << lvl), h)
    if packed_bottom:
        code = jnp.zeros((n,), jnp.int32)
        for t in bottom_thresholds:
            code = code + (text > jnp.uint8(t)).astype(jnp.int32)
        pack = code << 24
        for j in range(1, 7):
            pack = pack | (_shift_static(code, j, n, 0) << (4 * (6 - j)))
        ia = a + h
        ib = b + h
        inb = (ia < n) & (ib < n)
        wa = jnp.take(pack, jnp.minimum(ia, n - 1))
        wb = jnp.take(pack, jnp.minimum(ib, n - 1))
        nc = jnp.zeros((n,), jnp.int32)
        for k in range(1, 8):  # top-k nibbles equal => common prefix >= k
            s = 28 - 4 * k
            nc = nc + ((wa >> s) == (wb >> s)).astype(jnp.int32)
        h = jnp.where(inb, h + nc, h)
    return h.at[0].set(0)


def _lcp_plcp_impl(sa: jax.Array, hist: jax.Array, d: jax.Array, n: int,
                   levels: int, probe_thr: tuple, deep_cap: int,
                   num_lvl=None, probe_words: int = 1,
                   deep_cap_small: int | None = None):
    """PLCP (irreducible-LCP) computation of the adjacent-row LCP array —
    the fast path of the dictionary LCP stage (trace-time alternative to
    _lcp_impl; must be called inside a jit).

    The rank descent costs 2 random gathers per level over ALL n rows
    (~16 passes at dict depth). This replaces it with the classic
    irreducible-LCP decomposition, reformulated for a lock-step array
    program:

      * phi[i] = sa[isa[i]-1] (one scatter). A position i is REDUCIBLE
        when d[i] == d[phi[i+1]-1]: prepending the shared character to the
        SA-adjacent pair (phi[i+1], i+1) yields an SA-adjacent pair again,
        so plcp[i] = plcp[i+1] + 1 exactly (Karkkainen-Manzini-Puglisi;
        the no-suffix-between argument needs the shared char >= 1, which
        holds for every consumed row — d==0 rows are the zero-pad class,
        canonicalized by the caller).
      * irreducible rows are BWT run heads; in the PFP dictionary they are
        the minority AND overwhelmingly shallow (measured on the bench
        shape: ~29% irreducible, 92% of those with plcp <= 10). One packed
        word per position — previous char (3 bits) | 9 alphabet-coded
        chars (27 bits) — makes a SINGLE O(n) gather at phi answer both
        the reducibility test and an exact 9-char probe.
      * only irreducible rows whose probe saturates (all 9 chars match,
        ~2-3% of n) take the full rank descent, compacted into a static
        deep_cap buffer; if the buffer would overflow (adversarial
        inputs), lax.cond falls back to the classic full descent — same
        values, never wrong.
      * reducible rows are filled by the chain plcp[i] = plcp[nx] +
        (nx - i) for the nearest irreducible nx >= i: an int64
        flip/cummax scan, no gathers.

    Net: ~3 O(n) random passes (phi scatter, packed-word gather, final
    plcp->lcp gather) + a deep_cap-sized descent, vs ~16 O(n) passes.

    Validity: alphabet <= 8 (probe_thr = the 7 static split points, same
    as the packed SA seed). Output rows whose true LCP exceeds the capped
    doubling depth (tie-interior rows) may differ from _lcp_impl below
    2^levels-1 only in the zero-pad class — the caller canonicalizes
    those; all other rows are exact (tested clamped at maxlen+1 in
    tests/test_plcp.py; the uncapped direct-text case exactly in
    tests/test_suffix.py). Returns (lcp, isa) — isa is a byproduct the
    caller would otherwise recompute.

    num_lvl: traced count of COMPUTED doubling rounds for uncapped
    (early-exiting) histories — hist rows at or above it are zeros, so
    descents clamp to row num_lvl - 1, exactly like _lcp_impl. The
    direct (-g) backend passes it; the depth-capped dict path (all rows
    materialized) leaves it None. Uncapped histories end with an
    all-distinct rank row, so there are no tie-interior rows and the
    result is exact on every non-pad row.

    probe_words=2 extends the probe to 18 chars with a SECOND packed
    word (one extra O(n) gather at phi + elementwise compares): on the
    bench's dictionary most 9-char-saturated rows have plcp in [9, 18)
    — they share only the w-char trigger window that every PFP phrase
    begins with, NOT whole variant phrases — so the deep set collapses
    and the descent (~8 levels x 2 gathers x deep_cap, the dominant PLCP
    cost) shrinks with it. deep_cap_small adds a first-tier compaction
    buffer sized for that regime; rows land in the smallest tier that
    fits (small -> deep_cap -> full-width fallback), all byte-equal."""
    L = hist.shape[0] - 1
    top = min(levels - 1, L)

    def _row(lvl):
        if num_lvl is None:
            return hist[min(lvl, L)]
        return jax.lax.dynamic_index_in_dim(
            hist, jnp.minimum(jnp.int32(lvl), num_lvl - 1), 0,
            keepdims=False)
    idx = jnp.arange(n, dtype=jnp.int32)

    code = jnp.zeros((n,), jnp.int32)
    for t in probe_thr:
        code = code + (d > jnp.uint8(t)).astype(jnp.int32)
    q = code << 24
    for j in range(1, 9):
        q = q | (_shift_static(code, j, n, 0) << (3 * (8 - j)))
    prevc = jnp.concatenate([jnp.zeros((1,), jnp.int32), code[:-1]])
    pw = (prevc << 27) | q

    prev_sa = jnp.concatenate([sa[:1], sa[:-1]])
    # isa + phi in one routing pass (sort-route carries both values)
    isa, phi = route_set(sa, idx, prev_sa)
    pwp = jnp.take(pw, phi)  # THE gather: probe chars + prev char of phi

    isa_n = _shift_static(isa, 1, n, 0)
    phi_n = _shift_static(phi, 1, n, 0)
    pwp_n = _shift_static(pwp, 1, n, 0)
    red = (isa_n > 0) & (phi_n >= 1) & (code == (pwp_n >> 27))
    irr = ~red

    mask9 = (1 << 27) - 1
    qj = pw & mask9
    qp = pwp & mask9
    c9 = jnp.zeros((n,), jnp.int32)
    for k in range(1, 10):
        s = 27 - 3 * k
        c9 = c9 + ((qj >> s) == (qp >> s)).astype(jnp.int32)
    if probe_words == 2:
        # second packed word: chars i+9..i+17 (9 more 3-bit codes), one
        # extra gather at phi; extends exact probe coverage to 18 chars
        q2 = jnp.zeros((n,), jnp.int32)
        for j in range(9, 18):
            q2 = q2 | (_shift_static(code, j, n, 0) << (3 * (17 - j)))
        q2p = jnp.take(q2, phi)
        c2 = jnp.zeros((n,), jnp.int32)
        for k in range(1, 10):
            s = 27 - 3 * k
            c2 = c2 + ((q2 >> s) == (q2p >> s)).astype(jnp.int32)
        probe = c9 + jnp.where(c9 >= 9, c2, 0)
        probe_len = 18
    else:
        probe = c9
        probe_len = 9
    deep = irr & (probe >= probe_len) & (isa > 0)
    n_deep = deep.sum(dtype=jnp.int32)

    def _descend(a, b, m: int):
        """Rank descent for pairs (a, b): levels top..3 over the history,
        then ONE packed 9-char probe for the < 2^3-char residual (same
        structure as _lcp_impl; the 3-bit field counts equal the 4-bit
        ones). Shared by the compacted fast path and the full-width
        fallback so the lax.cond branches cannot drift apart."""
        h = jnp.zeros((m,), jnp.int32)
        for lvl in range(top, 2, -1):
            ranks = _row(lvl)
            ia = a + h
            ib = b + h
            inb = (ia < n) & (ib < n)
            ra = jnp.take(ranks, jnp.minimum(ia, n - 1))
            rb = jnp.take(ranks, jnp.minimum(ib, n - 1))
            h = jnp.where(inb & (ra == rb), h + (1 << lvl), h)
        ia = a + h
        ib = b + h
        inb = (ia < n) & (ib < n)
        wa = jnp.take(pw, jnp.minimum(ia, n - 1)) & mask9
        wb = jnp.take(pw, jnp.minimum(ib, n - 1)) & mask9
        nc = jnp.zeros((m,), jnp.int32)
        for k in range(1, 8):
            s = 27 - 3 * k
            nc = nc + ((wa >> s) == (wb >> s)).astype(jnp.int32)
        return jnp.where(inb, h + nc, h)

    def fast(cap: int):
        def run(_):
            p = jnp.nonzero(deep, size=cap, fill_value=n)[0] \
                .astype(jnp.int32)
            a = jnp.clip(p, 0, n - 1)
            h = _descend(a, jnp.take(phi, a), cap)

            plcp0 = probe.at[p].set(h, mode="drop")
            plcp0 = jnp.where(isa == 0, 0, plcp0)
            # chain fill: plcp[i] = plcp0[nx] + (nx - i) for the nearest
            # irreducible nx >= i (reverse cummin for nx — int32-only,
            # x64 is disabled — then one gather; nx is always valid
            # because row n-1 is irreducible by construction)
            nx = jnp.flip(jax.lax.cummin(
                jnp.flip(jnp.where(irr, idx, n))))
            plcp = jnp.take(plcp0, jnp.minimum(nx, n - 1)) + (nx - idx)
            # plcp -> SA order via isa (the inverse permutation is in
            # hand, so the gather by sa is a routing pass:
            # out[isa[i]] = plcp[i])
            return route_set(isa, plcp).at[0].set(0)
        return run

    def slow(_):
        # classic full-width descent (the _lcp_impl fallback)
        return _descend(prev_sa, sa, n).at[0].set(0)

    if deep_cap_small is not None and deep_cap_small < deep_cap:
        lcp = jax.lax.cond(
            n_deep <= deep_cap_small, fast(deep_cap_small),
            lambda _: jax.lax.cond(n_deep <= deep_cap, fast(deep_cap),
                                   slow, None), None)
    else:
        lcp = jax.lax.cond(n_deep <= deep_cap, fast(deep_cap), slow, None)
    return lcp, isa


def canonicalize_pad_lcp(lcp: jax.Array, sa: jax.Array, total, n: int):
    """Pin adjacent-pair LCPs of the zero-pad suffix class (both positions
    >= total-1: the trailing zero pad plus the terminator row) to one
    SHARED canonical value n - max(pair): descent-based and
    PLCP-chain-based implementations produce different (guard-dependent)
    values there, and no consumer reads them un-guarded. The value is the
    true LCP only for pure zero-pad pairs (for a pair touching the
    terminator row it is merely canonical) — these rows must stay
    unconsumed; the point is bit-for-bit comparability across
    implementations, not exactness."""
    prev_sa = jnp.concatenate([sa[:1], sa[:-1]])
    both_pad = (jnp.minimum(prev_sa, sa) >= total - 1)
    canon = n - jnp.maximum(prev_sa, sa)
    return jnp.where(both_pad, canon, lcp).at[0].set(0)


def suffix_lcp_arrays(text_padded: np.ndarray | jax.Array):
    """Full index construction: (sa, lcp, bwt) as device arrays.

    bwt[j] = text[(sa[j] - 1) mod n], matching direct_gsacak.hpp:64-67.
    Caller contract for the packed seed: >= 4 trailing zero-pad chars and
    every char < 128 (both hold for the engine's padded byte texts).
    """
    n = int(text_padded.shape[0])
    if isinstance(text_padded, np.ndarray) and text_padded.size:
        # packed seed contract (cheap host check; device texts are covered
        # by the refbuilder byte-range validation upstream)
        assert int(text_padded.max()) < 127, \
            "packed SA seed requires all chars < 127"
    text = jnp.asarray(text_padded, dtype=jnp.uint8)
    sa, hist, num_lvl = _suffix_array_impl(text, n, packed_init=True)
    lcp = _lcp_impl(sa, hist, num_lvl, n, levels=int(num_lvl))
    bwt = jnp.take(text, (sa + (n - 1)) % n)
    return sa, lcp, bwt


@functools.partial(jax.jit, static_argnames=("num_docs",))
def doc_array(sa: jax.Array, doc_ends: jax.Array, num_docs: int) -> jax.Array:
    """Doc id per SA row: count of doc ends <= position (sdsl rank
    semantics, ref_builder.cpp:183-190); pad/sentinel rows get num_docs."""
    da = jnp.searchsorted(doc_ends.astype(jnp.int32), sa, side="right")
    return jnp.minimum(da, num_docs).astype(jnp.int32)
