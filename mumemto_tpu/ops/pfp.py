"""Prefix-free parsing pipeline: text -> PFP -> SA-row stream, sort-centric.

Accelerator-native re-design of the reference PFP stack (include/newscan.hpp,
dictionary.hpp, parse.hpp, pfp.hpp, pfp_lcp_mum.hpp). The reference streams
SA rows from the PFP with a priority-queue merge and per-row RMQs; here the
same math becomes array programs:

  1. parse      rolling window hash over the text, break where
                hash % mod == 0 — the EXACT reference Karp-Rabin hash
                (newscan.hpp:84-115,310-325) vectorized in uint32 two-limb
                mod-p arithmetic, so .dict/.parse files interoperate with
                the reference toolchain byte for byte.
  2. dictionary unique phrases sorted lexicographically via a chunked
                multi-round lax.sort (replaces std::sort + hash dedup).
  3. parse SA   prefix doubling over the integer parse (m ~ n/mod elements),
                replacing sacak_int (parse.hpp:85).
  4. dict SA    prefix doubling over the dictionary string D (|D| << n for
                repetitive collections), replacing gsacak (dictionary.hpp:133).
  5. expansion  every text suffix = (valid dict suffix alpha, occurrence);
                SA order = sort by (group id of alpha, ISA_P[next parse
                position]) — ONE n-row 2-key sort replaces the heap merge
                (pfp_lcp_mum.hpp:151-212). LCPs from dict-LCP range minima
                (cross-group) and s_lcp_T range minima (within group,
                pfp_lcp_mum.hpp:284-321), both O(1) RMQs into small tables.

Padding convention: expanded row arrays are bucketed; pad rows get sort key
-1 so they land at the FRONT of the row stream with LCP 0 and doc id
num_docs — provably inert for the interval scan (mirrors the zero-padding
argument in ops/suffix.py; front placement preserves the reference's
"intervals still open at end-of-stream are dropped" semantics).
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from mumemto_tpu.ops import intervals as ops_intervals
from mumemto_tpu.ops import suffix as ops_suffix

DOLLAR_PFP = 2   # artificial phrase decoration char (common.hpp:54)
SEP = 1          # EndOfWord (dict phrase separator)
TERM = 0         # EndOfDict / parse terminator

KR_PRIME = 1999999973  # reference KR window-hash modulus (newscan.hpp:84)

# canonical no-N DNA text alphabet incl. the PFP decoration chars: enables
# the 8-char 3-bit-coded SA seed with ONE compile shared by every ACGT
# input ('$' = 36 is the doc separator byte)
CANON_ALPHA = (0, 1, 2, 36, 65, 67, 71, 84)


def bucket(n: int, lo: int = 1024) -> int:
    n = max(n, lo)
    p = 1 << (n - 1).bit_length()
    if p // 2 + p // 4 >= n:
        return p // 2 + p // 4
    return p


# ---------------------------------------------------------------------------
# 1. parse: window hash + breaks
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("w", "mod", "ne"))
def _break_mask(ext: jax.Array, n_real: jax.Array, w: int, mod: int, ne: int):
    """mask[k] (EXT coords, k = text position + 1) = reference Karp-Rabin
    window hash of the w text chars ending at text position k-1 is 0 mod
    `mod`; also the break count. Byte-exact reference parse semantics
    (newscan.hpp:84-115,321-323): h[i] = sum_j t[i-j]*256^j mod 1999999973
    with zero-filled chars before the start (the reference window
    initializes to 0 and is never reset across documents), break gated to
    i >= w-1 (word.size() > w) and i < n_text (the trailing w Dollars are
    appended without hashing, newscan.hpp:357-359).

    Computed directly on the resident ext array (ext = [Dollar] + text +
    [Dollar]*w + pad) so the text is uploaded once. All arithmetic is
    uint32 two-limb mod-p: per char-offset j the power 256^j mod p splits
    as ph*256 + pl, so every product and running sum stays below 2^32
    (255*((p-1)>>8) < p keeps tj*ph already reduced), and the final
    shi*256 mod p folds by 8 double-and-reduce steps: ~6w elementwise
    passes, no 64-bit arithmetic and no gathers.
    """
    p = jnp.uint32(KR_PRIME)
    # ext[0] is the artificial phrase-decoration Dollar: never hashed
    t = ext.astype(jnp.uint32).at[0].set(0)
    shi = jnp.zeros((ne,), jnp.uint32)
    slo = jnp.zeros((ne,), jnp.uint32)
    pw = 1
    for j in range(w):  # char j positions back carries 256^j (mod p)
        tj = t if j == 0 else jnp.concatenate(
            [jnp.zeros((j,), jnp.uint32), t[:-j]])
        ph, pl = pw >> 8, pw & 255
        shi = shi + tj * jnp.uint32(ph)      # tj*ph < p (see docstring)
        shi = jnp.where(shi >= p, shi - p, shi)
        slo = slo + tj * jnp.uint32(pl)      # total < w*2^16 << p
        pw = (pw * 256) % KR_PRIME
    for _ in range(8):                       # shi := shi*256 mod p
        shi = shi + shi
        shi = jnp.where(shi >= p, shi - p, shi)
    h = shi + slo
    h = jnp.where(h >= p, h - p, h)
    k = jnp.arange(ne, dtype=jnp.int32)
    mask = (h % jnp.uint32(mod) == 0) & (k >= w) & (k <= n_real)
    return mask, mask.sum(dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("n", "mb"))
def _compact_breaks(mask: jax.Array, n: int, mb: int) -> jax.Array:
    """Indices of mask=True, ascending, padded with n to mb entries.
    One 1-operand device sort instead of an n-sized host readback."""
    idx = jnp.arange(n, dtype=jnp.int32)
    key = jnp.where(mask, idx, jnp.int32(n))
    return jax.lax.sort(key)[:mb]


def compute_breaks(ext: jax.Array, n_text: int, w: int, mod: int
                   ) -> np.ndarray:
    """Break positions (indices of window-end chars) in TEXT coords, from
    the resident ext device array.

    Device-side mask + compaction; the only host readbacks are the scalar
    count and the O(#breaks) position array (never move O(n) data to the
    host).
    """
    phase = _phase_logger()
    ne = int(ext.shape[0])
    mask, count = _break_mask(ext, jnp.int32(n_text), w, mod, ne)
    k = int(count)
    phase("    break_mask+count")
    # a break on the very last char would make the final phrase exactly the
    # w-overlap + w dollars; that is fine — but a break at i = n-1 followed
    # by the mandatory final phrase works naturally. No special-casing.
    if k == 0:
        return np.zeros(0, dtype=np.int32)
    mb = bucket(k, lo=64)
    breaks = np.asarray(_compact_breaks(mask, ne, mb))
    phase("    break_compact+readback")
    return breaks[:k] - 1  # ext coord -> text coord


# ---------------------------------------------------------------------------
# 2. dictionary: chunked lexicographic phrase sort + dedup
# ---------------------------------------------------------------------------

def sort_phrases(ext_np: np.ndarray, st_np: np.ndarray,
                 ln_np: np.ndarray):
    """Lex-sort phrase records on the HOST; returns (order, grp) as numpy.

    grp is the 0-based rank group in sorted order; equal phrases share grp.

    Deliberately host-side: there are only m ~ n/mod records (thousands per
    Mbp) and byte-string comparisons early-exit at the first difference, so
    CPython's sort finishes in milliseconds — while a device comparison
    loop needs one ~30ms while_loop round per compared chunk ALL the way to
    maxlen (identical duplicate phrases never resolve earlier), plus a
    multi-minute one-time compile. This is metadata-scale work, the same
    altitude as file IO; the O(n) stages stay on device.
    """
    from mumemto_tpu.native import get_native
    nat = get_native()
    if nat is not None and hasattr(nat, "sort_phrases"):
        order_b, grp_b = nat.sort_phrases(
            np.ascontiguousarray(ext_np),
            np.ascontiguousarray(st_np, dtype=np.int32),
            np.ascontiguousarray(ln_np, dtype=np.int32))
        return (np.frombuffer(order_b, dtype=np.int32).copy(),
                np.frombuffer(grp_b, dtype=np.int32).copy())
    m = int(st_np.size)
    keys = [ext_np[s:s + l].tobytes()
            for s, l in zip(st_np.tolist(), ln_np.tolist())]
    order = sorted(range(m), key=keys.__getitem__)
    grp = np.empty(m, np.int32)
    g = -1
    prev = None
    for rank, rec in enumerate(order):
        k = keys[rec]
        if k != prev:
            g += 1
            prev = k
        grp[rank] = g
    return np.asarray(order, dtype=np.int32), grp


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _segmented_min_after_valid(lcp: jax.Array, valid: jax.Array) -> jax.Array:
    """out[i] = min(lcp[j]) over j in (prev_valid_row(i), i] — running min
    resetting AFTER each valid row, exact AT VALID ROWS (the only rows
    where any consumer reads it: same/new_group/cross are all
    valid-masked).

    A segment is a run of invalid rows followed by one valid row, so a
    valid row is always the LAST row of its segment and its prefix-min
    equals the whole-segment min: one cumsum (segment ids) + one
    scatter-min + one gather, all int32. (The previous formulation used
    lax.associative_scan with a tuple carry, whose compile time blew up at
    >~10M elements.)"""
    n = lcp.shape[0]
    seg_start = jnp.concatenate([jnp.ones((1,), bool), valid[:-1]])
    seg_id = jnp.cumsum(seg_start.astype(jnp.int32)) - 1
    seg_min = jnp.full((n,), ops_intervals.INT32_MAX, jnp.int32
                       ).at[seg_id].min(lcp)
    return jnp.take(seg_min, seg_id)


def _rmq_prepare(values: jax.Array):
    """Sparse min table for O(1) two-window range-min queries."""
    return ops_intervals._sparse_min_table(values)


def _rmq_query(table, lo, hi):
    """min(values[lo..hi]) inclusive, lo <= hi, vectorized O(1).

    Lowered as TWO 1-D gathers into a LEVEL-MAJOR FLAT copy of the
    sparse table (flat index lvl*n + pos, a plain 1-D concatenate): one
    element fetched per query, query-sized s32 temporaries, and — the
    part every earlier formulation got wrong — an UNPADDED table copy.

    Earlier formulations gathered whole (L+1)-column rows of a 2-D
    (n, L+1) table, or a position-major flat copy built by a reshape of
    the stacked levels; a compiler that tiles the minor dimension pads
    the ~20-26 levels of either layout to its tile width, which
    multiplied the table's memory several times over. A 1-D concatenate
    has no minor dim to pad: the copy is exactly n*(L+1) ints. Requires
    n*(L+1) < 2^31 for int32 flat indexing — n <= ~80M at 26 levels;
    guarded by the assert."""
    n = table[0].shape[0]
    L1 = len(table)
    assert n * L1 < 2**31, "flat RMQ index would overflow int32"
    length = hi - lo + 1
    # floor(log2(length)) in integers: a float log2 can land just below an
    # exact power of two, and a level one too low leaves the two windows
    # short of covering [lo, hi]
    lvl = 31 - jax.lax.clz(jnp.maximum(length, 1).astype(jnp.int32))
    lvl = jnp.clip(lvl, 0, L1 - 1)
    width = jnp.int32(1) << lvl
    flat = jnp.concatenate(list(table))  # level-major, unpadded
    base = lvl * n
    ia = base + jnp.clip(lo, 0, n - 1)
    ib = base + jnp.clip(hi - width + 1, 0, n - 1)
    return jnp.minimum(jnp.take(flat, ia), jnp.take(flat, ib))


# ---------------------------------------------------------------------------
# main pipeline
# ---------------------------------------------------------------------------

@dataclass
class PFPData:
    """Host-side metadata + device arrays for one parsed collection."""
    w: int
    n_text: int
    m: int                 # number of parse entries
    num_phrases: int       # unique phrases
    d_len: int             # dictionary string length
    ext: jax.Array         # [2] + text + [2]*w (uint8)
    parse: np.ndarray      # phrase ids (1-based), length m
    phrase_st: np.ndarray  # ext start per unique phrase id (1-based index 0 unused)
    phrase_ln: np.ndarray  # char length per unique phrase id
    alpha: tuple           # distinct byte values present in ext (sorted);
    #                        REQUIRED: the 8-char SA seed keys off it, and a
    #                        wrong/empty alphabet silently mis-seeds


def seed_thresholds(alpha):
    """(seed_thr, lcp_thr) static split-point tuples for a sorted distinct
    byte list: the 8-char 3-bit SA seed needs <= 8 values, the packed
    7-char LCP bottom <= 16; canonical ACGT alphabets map onto ONE shared
    compile (CANON_ALPHA)."""
    alpha = sorted(alpha)
    if set(alpha) <= set(CANON_ALPHA):
        seed_thr = CANON_ALPHA[:-1]
    elif len(alpha) <= 8:
        seed_thr = tuple(alpha[:-1])
    else:
        seed_thr = None
    lcp_thr = tuple(alpha[:-1]) if len(alpha) <= 16 else None
    if seed_thr is not None and lcp_thr is not None:
        lcp_thr = seed_thr  # share one compile for canonical inputs
    return seed_thr, lcp_thr


def _alphabet(bytes_np: np.ndarray) -> tuple:
    """Sorted distinct byte values via a presence mask (np.bincount on
    uint8 is ~100x slower in this numpy build). The scatter runs over a
    uint16 VIEW — half the elements, into a 64 KB L1-resident table —
    then folds pair presence back to byte presence."""
    bytes_np = np.ascontiguousarray(bytes_np)
    even = bytes_np[:bytes_np.size & ~1]
    present16 = np.zeros(65536, np.bool_)
    present16[even.view(np.uint16)] = True
    pairs = np.flatnonzero(present16)
    present = np.zeros(256, np.bool_)
    present[pairs & 255] = True    # low byte (little-endian first char)
    present[pairs >> 8] = True     # high byte
    if bytes_np.size & 1:
        present[bytes_np[-1]] = True
    return tuple(np.flatnonzero(present).tolist())


# NOTE on phrase-length capping (tried, reverted): inserting artificial
# breaks to cap maxlen (and thus the dict SA/LCP depth) BREAKS the PFP
# sort identity. The expansion orders same-alpha rows by parse rank and
# different-alpha rows by dictionary suffix order, which is only the text
# order when no phrase-END w-window occurs strictly inside another phrase
# (else one alpha is a strict prefix of another and the SEP comparison
# diverges from the text continuation). KR triggers guarantee that
# property globally; position-periodic splits cannot (verified by a
# failing suffix-order diff at split_cap=64).


def build_pfp(text_np: np.ndarray, w: int = 10, mod: int = 100) -> PFPData:
    phase = _phase_logger()
    n_text = int(text_np.size)
    ext_np = np.concatenate([
        np.full(1, DOLLAR_PFP, np.uint8), text_np,
        np.full(w, DOLLAR_PFP, np.uint8)])
    ne = bucket(ext_np.size)
    ext_pad = np.zeros(ne, np.uint8)
    ext_pad[:ext_np.size] = ext_np
    ext = jnp.asarray(ext_pad)
    phase("    ext_asarray")
    alpha = _alphabet(ext_np)
    phase("    ext_alphabet")
    ext.block_until_ready()
    phase("  ext_upload")

    breaks = compute_breaks(ext, n_text, w, mod)  # text coords
    phase("  breaks")
    k = breaks.size
    m = k + 1
    # phrase records in ext coords (inclusive end)
    st = np.empty(m, np.int32)
    en = np.empty(m, np.int32)
    st[0] = 0
    if k:
        st[1:] = breaks - w + 2
        en[:-1] = breaks + 1
    en[-1] = n_text + w
    ln = en - st + 1

    order, grp = sort_phrases(ext_pad, st, ln)
    phase("  phrase_sort")
    num_phrases = int(grp[-1]) + 1 if order.size else 0
    # unique phrase reps (first record of each group in sorted order)
    first = np.concatenate([[True], grp[1:] != grp[:-1]])
    rep = order[first]
    phrase_st = np.zeros(num_phrases + 1, np.int32)
    phrase_ln = np.zeros(num_phrases + 1, np.int32)
    phrase_st[1:] = st[rep]
    phrase_ln[1:] = ln[rep]
    # parse ids per original record
    parse = np.zeros(m, np.int32)
    parse[order] = grp + 1

    # (no tstart table: the expansion uses the structural identity
    # tstart[j] == cumcnt[j] - 1, asserted in _expand_operands' docstring)
    return PFPData(w=w, n_text=n_text, m=m, num_phrases=num_phrases,
                   d_len=int(phrase_ln.sum()) + num_phrases + 1,
                   ext=ext, parse=parse, phrase_st=phrase_st,
                   phrase_ln=phrase_ln, alpha=alpha)


@functools.partial(jax.jit, static_argnames=("nd", "ne"))
def _dict_setup(ext, phrase_st, phrase_ln, d_starts, npz, total,
                nd: int, ne: int):
    """Materialize D = concat(sorted phrases + SEP) + TERM (padded to nd),
    plus the position -> (phrase id, offset, phrase len) tables.

    One fused program; the block id per position comes from a scatter of
    block starts + cummax forward-fill (2 O(nd) passes) instead of a
    searchsorted binary descent (log #phrases gather passes).

    Phrase arrays are bucket-padded (zero-length pad phrases with
    d_starts == total); npz = real phrase count and total = end of the
    last block incl. SEP are traced so different inputs share compiles.
    """
    npzb = phrase_st.shape[0] - 1  # padded phrase slots 1..npzb
    pos = jnp.arange(nd, dtype=jnp.int32)
    ids = jnp.arange(1, npzb + 1, dtype=jnp.int32)
    # drop pad-phrase scatters entirely (their d_starts == total)
    st_idx = jnp.where(ids <= npz, jnp.clip(d_starts[1:], 0, nd - 1), nd)
    # per-position block attributes via delta-scatter + cumsum fills
    # (block starts are ascending): the ONLY remaining O(nd) random
    # gather is the phrase byte fetch itself
    d_start_of = _fill_per_occ(d_starts[1:], st_idx, nd)
    st_of = _fill_per_occ(phrase_st[1:], st_idx, nd)
    plen_of = _fill_per_occ(phrase_ln[1:], st_idx, nd)
    off = pos - d_start_of
    in_phrase = off < plen_of
    ch = jnp.take(ext, jnp.clip(st_of + off, 0, ne - 1))
    d = jnp.where(in_phrase, ch, jnp.uint8(SEP))
    d = jnp.where(pos >= total, jnp.uint8(TERM), d)  # TERM at total, 0-pad after
    # one per-position table instead of (pid, off, plen): the only
    # downstream consumers are "valid proper phrase suffix?" and its char
    # length, so store suf_len for proper (off >= 1) in-phrase positions
    # and -1 elsewhere — _dict_groups gathers it ONCE by saD and applies
    # the >= w validity cut itself
    good = in_phrase & (pos < total) & (off >= 1)
    meta = jnp.where(good, plen_of - off, -1)
    return d, meta.astype(jnp.int32)


def _dict_starts(phrase_ln: np.ndarray) -> np.ndarray:
    """Start offset in D per phrase id (1-based); D blocks are len+1 (SEP)."""
    npz = phrase_ln.size - 1
    starts = np.zeros(npz + 1, np.int64)
    starts[1:] = np.cumsum(phrase_ln[1:] + 1) - (phrase_ln[1:] + 1)
    return starts.astype(np.int32)


@functools.partial(jax.jit, static_argnames=("nd", "ne", "w", "lvl_cap",
                                             "lvl_static", "seed_thr",
                                             "lcp_thr"))
def _dict_index(ext, phrase_st, phrase_ln, d_starts, npz, total,
                nd: int, ne: int, w: int, lvl_cap: int, lvl_static: int,
                seed_thr, lcp_thr):
    """Fused dictionary index: D materialization (_dict_setup) +
    depth-capped SA doubling + LCP descent + ISA + suffix grouping in ONE
    program (one dispatch; the dict string and doubling history never
    round-trip through device memory between programs)."""
    d, pos_meta = _dict_setup(ext, phrase_st, phrase_ln, d_starts, npz,
                              total, nd, ne)
    saD, histD, lvlD = ops_suffix._suffix_array_impl(
        d, nd, packed_init=True, max_lvl=lvl_cap, alpha_thresholds=seed_thr)
    if seed_thr is not None:
        # canonical <= 8-letter alphabet: PLCP/irreducible-LCP path (~4
        # O(nd) random passes instead of ~16 — see _lcp_plcp_impl).
        # probe_words=2 (18-char probe): the 9-char-saturated rows are
        # overwhelmingly suffixes sharing only the w=10-char trigger
        # window every phrase starts with, so far fewer rows saturate
        # 18 chars than 9 on the bench dictionary. The second probe
        # word costs one extra O(nd) gather and shrinks the descent
        # compaction to the nd//16 first tier; nd//3 stays as the
        # second tier for adversarial dictionaries, with the full-width
        # descent behind it (all three byte-equal).
        # MUMEMTO_PLCP_PROBE2=0 restores the single-tier 9-char probe at
        # TRACE time (for A/Bs).
        if os.environ.get("MUMEMTO_PLCP_PROBE2") != "0":
            lcpD, isaD = ops_suffix._lcp_plcp_impl(
                saD, histD, d, nd, lvl_static, seed_thr,
                deep_cap=max(nd // 3, 1024), probe_words=2,
                deep_cap_small=max(nd // 16, 1024))
        else:
            lcpD, isaD = ops_suffix._lcp_plcp_impl(
                saD, histD, d, nd, lvl_static, seed_thr,
                deep_cap=max(nd // 3, 1024))
    else:
        lcpD = ops_suffix._lcp_impl(saD, histD, lvlD, nd,
                                    levels=lvl_static, text=d,
                                    bottom_thresholds=lcp_thr)
        isaD = _isa_dev(saD, nd)
    lcpD = ops_suffix.canonicalize_pad_lcp(lcpD, saD, total, nd)
    grp_of_pos, grp_cross = _dict_groups(d, saD, lcpD, pos_meta, nd, w)
    return d, lcpD, isaD, grp_of_pos, grp_cross


@functools.partial(jax.jit, static_argnames=("nd", "w"))
def _dict_groups(d, saD, lcpD, pos_meta, nd: int, w: int):
    """Group valid dict suffixes (same string across phrases).

    Returns device tables over D coords (no O(nd) host readbacks):
      grp_of_pos[d_pos] = group id of the valid suffix at d_pos, else -1
      grp_cross[g]      = cross-group LCP at the first row of group g
    """
    suf_len = jnp.take(pos_meta, saD)  # proper-suffix char length, else -1
    valid = suf_len >= w

    gapmin = _segmented_min_after_valid(lcpD, valid)

    # previous VALID row's suffix length: index of last valid row before i
    # via cummax, then one gather (parallel forward-fill)
    idx = jnp.arange(nd, dtype=jnp.int32)
    last_valid = jax.lax.cummax(jnp.where(valid, idx, -1))
    prev_valid_idx = jnp.concatenate([jnp.full((1,), -1, jnp.int32),
                                      last_valid[:-1]])
    prev_len = jnp.where(prev_valid_idx >= 0,
                         jnp.take(suf_len, jnp.maximum(prev_valid_idx, 0)),
                         -1)
    same = valid & (gapmin >= suf_len) & (prev_len == suf_len)
    new_group = valid & ~same
    grp_of_row = jnp.cumsum(new_group.astype(jnp.int32)) - 1  # valid rows only
    cross = jnp.where(new_group, gapmin, 0)

    # group tables as device scatters (dropped writes for masked rows);
    # the first group in SA order has id 0 and cross lcp 0 (j==0 -> lcp 0)
    grp_cross = jnp.zeros((nd,), jnp.int32).at[
        jnp.where(new_group, grp_of_row, nd)].set(cross, mode="drop")
    grp_cross = grp_cross.at[0].set(0)
    # saD is a permutation, so the masked scatter is a routing pass:
    # every target is written exactly once, invalid rows carry -1
    grp_of_pos = ops_suffix.route_set(
        saD, jnp.where(valid, grp_of_row, -1))
    return grp_of_pos, grp_cross


@functools.partial(jax.jit, static_argnames=("n",))
def _isa_dev(sa: jax.Array, n: int) -> jax.Array:
    return ops_suffix.route_set(sa, jnp.arange(n, dtype=jnp.int32))


def _pad_phrase_arrays(pfp: PFPData):
    """Bucket-pad the per-phrase arrays for _dict_setup (shared by the scan
    and -P checkpoint paths): zero-length pad phrases whose d_starts sit at
    the end-of-dictionary sentinel. Returns
    (phrase_st, phrase_ln, d_starts_pad, npz, total_real, nd)."""
    d_starts = _dict_starts(pfp.phrase_ln)
    # +4 trailing TERM pads: the packed-init SA seed reads up to 3 chars
    # past a suffix start (ops/suffix.py packed contract)
    nd = bucket(pfp.d_len + 4)
    npz = pfp.num_phrases
    npzb = bucket(npz + 1, lo=64) - 1
    total_real = pfp.d_len - 1  # end of the last block incl. its SEP
    phrase_st = np.zeros(npzb + 1, np.int32)
    phrase_ln = np.zeros(npzb + 1, np.int32)
    d_starts_pad = np.full(npzb + 1, total_real, np.int32)
    phrase_st[:npz + 1] = pfp.phrase_st
    phrase_ln[:npz + 1] = pfp.phrase_ln
    d_starts_pad[:npz + 1] = d_starts
    return phrase_st, phrase_ln, d_starts_pad, npz, total_real, nd


def _phase_logger():
    """MUMEMTO_TPU_PROFILE=1: per-stage wall times to stderr (each stage is
    synced with block_until_ready, so timings are true device costs). Also
    feeds the interactive progress bar when one is active; with neither,
    returns a no-op that adds no device syncs."""
    import os
    from mumemto_tpu import progress
    prof = bool(os.environ.get("MUMEMTO_TPU_PROFILE"))
    bar = progress.active()
    if not prof and bar is None:
        return lambda name, *arrays: None
    import sys
    import time
    state = {"t": time.time()}

    def log(name, *arrays):
        jax.block_until_ready(arrays)
        now = time.time()
        if prof:
            print(f"[pfp_scan] {name}: {now - state['t']:.2f}s",
                  file=sys.stderr, flush=True)
        if bar is not None:
            bar.advance(name.strip())
        state["t"] = now
    return log


def _host_prep(pfp: PFPData, doc_ends: np.ndarray, num_docs: int,
               row_dtype=np.int32):
    """All host-side preparation for a scan: bucket-padded phrase arrays,
    parse arrays, expansion row layout, statics. No device dispatch.

    row_dtype: dtype of ROW/TEXT coordinates (cumcnt, cumC, doc_ends,
    total_rows, n_text). np.int32 for the narrow path; np.uint32 for the
    wide-coordinate path (parallel/widepfp.py), which lifts the row-space
    ceiling from 2^31-1 to ~2^32 rows — past chr19 x 20 with revcomp
    (the reference handles 2^40 via 5-byte SA entries,
    common.hpp:59-61)."""
    w = pfp.w
    phrase_st, phrase_ln, d_starts_pad, npz, total_real, nd = \
        _pad_phrase_arrays(pfp)
    # Depth cap for the dictionary SA/LCP: the pipeline consumes dict-suffix
    # ORDER only up to maxlen+1 chars (suffix pairs sharing longer prefixes
    # are same-string same-length = same group, whose relative order is
    # irrelevant — ordering within a tie block cannot move a group boundary
    # or change any consumed range-min), and every consumed lcpD VALUE is
    # <= maxlen (slt pair LCPs are whole-phrase LCPs; gapmin/cross are
    # bounded by phrase-suffix lengths; larger values are only COMPARED
    # against suffix lengths <= maxlen, and the capped descent clamps them
    # at 2^levels - 1 >= maxlen + 1). So both the doubling depth and the
    # LCP rank-descent run ~log2(maxlen) rounds instead of ~log2(nd) —
    # each round is several O(nd) passes, the dominant cost of this stage.
    maxlen = int(pfp.phrase_ln.max()) if pfp.phrase_ln.size > 1 else 1
    lvl_cap = (maxlen + 2).bit_length()
    # alphabet-coded seeds: the dict alphabet is the ext alphabet + the
    # SEP/TERM separators. <= 8 distinct values unlocks the exact 8-char
    # 3-bit seed (one shared compile for canonical ACGT inputs); <= 16
    # unlocks the packed 7-char bottom step of the LCP descent.
    alpha = sorted(set(pfp.alpha) | {TERM, SEP, DOLLAR_PFP})
    seed_thr, lcp_thr = seed_thresholds(alpha)
    # the depth-capped unrolled doubling always runs min(levels(nd),
    # lvl_cap) rounds — known on host, so NO device readback of lvlD:
    # the whole dict -> parse -> expansion chain dispatches asynchronously
    lvl_run = min(ops_suffix._num_levels(nd), lvl_cap) + 1
    lvl_static = min((lvl_run + 1) // 2 * 2, lvl_run, lvl_cap)

    m = pfp.m
    mp = bucket(m + 1, lo=64)
    pprime = np.zeros(mp, np.int32)
    pprime[:m] = pfp.parse
    charlen = np.zeros(mp + 1, np.int64)
    charlen[:m] = pfp.phrase_ln[pfp.parse] - w
    cumC = np.concatenate([[0], np.cumsum(charlen)]).astype(row_dtype)
    # mask note: SLT rows beyond the real m+1 suffixes (pad positions of
    # P', zeros) sort to the very front with the terminator; their
    # adjacency lcps are 0 anyway since charlen/cumC are 0 there.

    cnt = (pfp.phrase_ln[pfp.parse] - w).astype(np.int64)
    n_rows = int(cnt.sum())
    nr = bucket(n_rows)
    if __import__("os").environ.get("MUMEMTO_TPU_PROFILE"):
        import sys
        print(f"[pfp_scan] shapes: nd={nd} nr={nr} mp={mp} npz={npz} "
              f"maxlen={maxlen} lvl_cap={lvl_cap} lvl_static={lvl_static} "
              f"|alpha|={len(alpha)}", file=sys.stderr, flush=True)
    cumcnt = np.zeros(mp + 1, row_dtype)
    cumcnt[1:m + 1] = np.cumsum(cnt)
    cumcnt[m + 1:] = n_rows
    return {
        "phrase_st": jnp.asarray(phrase_st),
        "phrase_ln": jnp.asarray(phrase_ln),
        "d_starts": jnp.asarray(d_starts_pad),
        "npz": jnp.int32(npz), "total_real": jnp.int32(total_real),
        "parse": jnp.asarray(pprime), "cumC": jnp.asarray(cumC),
        "cumcnt": jnp.asarray(cumcnt), "m": jnp.int32(m),
        "total_rows": jnp.asarray(n_rows, dtype=row_dtype),
        "n_text": jnp.asarray(pfp.n_text, dtype=row_dtype),
        "doc_ends": jnp.asarray(doc_ends.astype(row_dtype)),
        "ne": int(pfp.ext.shape[0]),
        "nd": nd, "nr": nr, "mp": mp, "w": w, "lvl_cap": lvl_cap,
        "lvl_static": lvl_static, "seed_thr": seed_thr, "lcp_thr": lcp_thr,
    }


def pfp_scan_prepare(pfp: PFPData, doc_ends: np.ndarray, num_docs: int,
                     row_dtype=np.int32, dict_mesh=None):
    """Dict/parse-side preparation shared by the seq-sharded scan
    (parallel/seqpfp.py) and the PROFILE-split single-device path:
    dictionary SA/LCP/groups, parse SA/ISA, s_lcp_T RMQ table, and the
    expansion row layout. Everything returned is metadata-scale
    (O(|D| + |P|)), small relative to the O(n) row space — it stays
    replicated under sharding. row_dtype: see _host_prep.

    dict_mesh: (mesh, axis) to run the dict index DISTRIBUTED over that
    axis (parallel/sharddict.py) instead of replicated — outputs are
    bit-identical (tie-order argument in that module's docstring)."""
    phase = _phase_logger()
    h = _host_prep(pfp, doc_ends, num_docs, row_dtype=row_dtype)
    if dict_mesh is not None:
        from mumemto_tpu.parallel import sharddict
        mesh, daxis = dict_mesh
        fn = sharddict.compile_sharded_dict_index(
            mesh, daxis, h["nd"], h["ne"], h["w"], h["lvl_cap"],
            h["lvl_static"], h["seed_thr"], h["lcp_thr"])
        d, lcpD, isaD, grp_of_pos, grp_cross = fn(
            pfp.ext, h["phrase_st"], h["phrase_ln"], h["d_starts"],
            h["npz"], h["total_real"])
    else:
        d, lcpD, isaD, grp_of_pos, grp_cross = _dict_index(
            pfp.ext, h["phrase_st"], h["phrase_ln"], h["d_starts"],
            h["npz"], h["total_real"], h["nd"], h["ne"],
            h["w"], h["lvl_cap"], h["lvl_static"], h["seed_thr"],
            h["lcp_thr"])
    phase("dict_index", grp_of_pos, grp_cross)
    isaP, slt_table = _parse_side(h["parse"], h["cumC"], h["d_starts"],
                                  lcpD, isaD, h["mp"], h["nd"])
    phase("parse_side", slt_table[0])
    h.update({"isaP": isaP, "grp_of_pos": grp_of_pos, "d": d,
              "slt_table": slt_table, "grp_cross": grp_cross})
    return h


@functools.partial(
    jax.jit,
    static_argnames=("nd", "ne", "nr", "mp", "w", "num_docs", "lvl_cap",
                     "lvl_static", "seed_thr", "lcp_thr", "max_doc_freq",
                     "size_cap", "need_ctx"))
def _full_scan(ext, phrase_st, phrase_ln, d_starts, npz, total_real,
               pprime, cumC, cumcnt, m, total_rows, n_text, doc_ends,
               min_match_len, num_distinct, max_total_freq,
               nd: int, ne: int, nr: int, mp: int, w: int, num_docs: int,
               lvl_cap: int, lvl_static: int, seed_thr, lcp_thr,
               max_doc_freq: int, size_cap: int | None, need_ctx: bool):
    """The ENTIRE device scan as ONE program — dict index + parse side +
    expansion/analysis, with no host sync between stages. Production runs
    use this fused program; MUMEMTO_TPU_PROFILE=1 (or an active progress
    bar) uses the split path for per-stage timings."""
    d, lcpD, isaD, grp_of_pos, grp_cross = _dict_index(
        ext, phrase_st, phrase_ln, d_starts, npz, total_real, nd, ne,
        w, lvl_cap, lvl_static, seed_thr, lcp_thr)
    isaP, slt_table = _parse_side(pprime, cumC, d_starts, lcpD, isaD,
                                  mp, nd)
    return _expand_and_analyze(
        pprime, d_starts, cumcnt, m, total_rows, n_text, isaP,
        grp_of_pos, d, slt_table, grp_cross, doc_ends, nr, nd, w,
        num_docs, lvl_cap, min_match_len, num_distinct, max_total_freq,
        max_doc_freq, size_cap, need_ctx)


def pfp_scan(pfp: PFPData, doc_ends: np.ndarray, num_docs: int,
             min_match_len, num_distinct, max_total_freq, max_doc_freq: int,
             size_cap: int | None = None, need_ctx: bool = True):
    """Full PFP expansion + interval scan; returns (res, counts, n_rows_pad)
    compatible with ops/pipeline compaction. Device-resident throughout:
    the only host<->device traffic is small per-phrase uploads."""
    import os
    from mumemto_tpu import progress
    if os.environ.get("MUMEMTO_TPU_PROFILE") or progress.active() is not None:
        # split path: one program per stage — per-stage device timings for
        # profiling, per-stage advance for the progress bar (which syncs
        # every stage anyway)
        prep = pfp_scan_prepare(pfp, doc_ends, num_docs)
        phase = _phase_logger()
        res, counts = _expand_and_analyze(
            prep["parse"], prep["d_starts"], prep["cumcnt"],
            prep["m"], prep["total_rows"], prep["n_text"],
            prep["isaP"], prep["grp_of_pos"], prep["d"],
            prep["slt_table"], prep["grp_cross"], prep["doc_ends"],
            prep["nr"], prep["nd"], pfp.w, num_docs, prep["lvl_cap"],
            jnp.int32(min_match_len), jnp.int32(num_distinct),
            jnp.int32(max_total_freq), max_doc_freq, size_cap, need_ctx)
        phase("expand_analyze", counts)
        return res, counts, prep["nr"]
    h = _host_prep(pfp, doc_ends, num_docs)
    res, counts = _full_scan(
        pfp.ext, h["phrase_st"], h["phrase_ln"], h["d_starts"], h["npz"],
        h["total_real"], h["parse"], h["cumC"], h["cumcnt"], h["m"],
        h["total_rows"], h["n_text"], h["doc_ends"],
        jnp.int32(min_match_len), jnp.int32(num_distinct),
        jnp.int32(max_total_freq),
        nd=h["nd"], ne=h["ne"], nr=h["nr"], mp=h["mp"], w=h["w"],
        num_docs=num_docs, lvl_cap=h["lvl_cap"], lvl_static=h["lvl_static"],
        seed_thr=h["seed_thr"], lcp_thr=h["lcp_thr"],
        max_doc_freq=max_doc_freq, size_cap=size_cap, need_ctx=need_ctx)
    return res, counts, h["nr"]


@functools.partial(jax.jit, static_argnames=("mp", "nd"))
def _parse_side(pprime, cumC, d_starts, lcpD, isaD, mp: int, nd: int):
    """Fused parse-side program: parse SA + rank-descent LCP + ISA +
    s_lcp_T (_build_slt) + its sparse RMQ table, all mp-scale."""
    saP, histP, lvlP = ops_suffix._suffix_array_impl(pprime, mp)
    klcp = ops_suffix._lcp_impl(saP, histP, lvlP, mp)
    isaP = _isa_dev(saP, mp)
    slt = _build_slt(pprime, saP, klcp, cumC, d_starts, lcpD, isaD, mp, nd)
    return isaP, tuple(_rmq_prepare(slt))


@functools.partial(jax.jit, static_argnames=("mp", "nd"))
def _build_slt(pprime, saP, klcp, cumC, d_starts, lcpD, isaD, mp: int, nd: int):
    """SLT[r] = char-LCP of text suffixes at phrase starts of parse-SA rows
    r-1, r (the reference's s_lcp_T, pfp.hpp:210-244)."""
    a = jnp.concatenate([saP[:1], saP[:-1]])
    b = saP
    k = klcp
    # Compute the char-length component in uint32: cumC may be uint32 in
    # the wide-coordinate path, and a true text-LCP component can reach
    # n_text < 2^32 there (an adversarial >2^31-char repeat), where an
    # int32 cast would wrap SILENTLY. The uint32 difference is exact for
    # every representable n_text; the final value then SATURATES at
    # 2^31-1 (a defined, documented limit: the int32 LCP value space caps
    # representable match lengths at 2^31-1 chars — far past the
    # reference's own 5-byte coordinate / uint16 merge-threshold limits,
    # common.hpp:59-61, pfp_mum.hpp:35-36).
    cu = cumC.astype(jnp.uint32)
    c = (jnp.take(cu, jnp.clip(a + k, 0, mp))
         - jnp.take(cu, jnp.clip(a, 0, mp)))
    x = jnp.take(pprime, jnp.clip(a + k, 0, mp - 1))
    y = jnp.take(pprime, jnp.clip(b + k, 0, mp - 1))
    xr = jnp.take(isaD, jnp.take(d_starts, x))
    yr = jnp.take(isaD, jnp.take(d_starts, y))
    lo = jnp.minimum(xr, yr) + 1
    hi = jnp.maximum(xr, yr)
    tab = ops_intervals._sparse_min_table(lcpD)
    pair = _rmq_query(tab, lo, hi)
    pair = jnp.where((x == 0) | (y == 0) | (x == y), 0, pair)
    # c + pair < 2^32 always (an LCP of two distinct text suffixes is
    # < n_text <= 2^32), so the uint32 add is exact; saturate, then cast
    slt = jnp.minimum(c + pair.astype(jnp.uint32),
                      jnp.uint32(2**31 - 1)).astype(jnp.int32)
    return slt.at[0].set(0)


def _fill_per_occ(values, starts_idx, nr: int):
    """row_value[r] = values[j] for rows r in occurrence j, built WITHOUT an
    O(nr) gather: scatter-add the first differences at the occurrence start
    rows, then one int32 cumsum reconstructs the step function exactly
    (a scan streams; a random gather does not)."""
    delta = jnp.concatenate([values[:1], values[1:] - values[:-1]])
    return jnp.cumsum(
        jnp.zeros((nr,), jnp.int32).at[starts_idx].add(delta, mode="drop"))


@functools.partial(
    jax.jit,
    static_argnames=("nr", "nd", "w", "num_docs", "lvl_cap",
                     "max_doc_freq", "size_cap", "need_ctx"))
def _expand_and_analyze(parse, d_starts, cumcnt,
                        m, total_rows, n_text, isaP,
                        grp_of_pos, d, slt_table, grp_cross,
                        doc_ends, nr: int, nd: int,
                        w: int, num_docs: int, lvl_cap: int,
                        min_match_len, num_distinct, max_total_freq,
                        max_doc_freq: int, size_cap: int | None = None,
                        need_ctx: bool = True):
    """Expand (occurrence, offset) rows, sort into SA order, compute LCP,
    and run the interval analysis. m (occurrence count), total_rows and
    n_text are traced so all inputs in a shape bucket share one compile;
    cumcnt is bucket-padded with total_rows past index m.

    Key structural identities (all per-occurrence lookups become
    scatter+scan fills, zero O(nr) gathers on this side):
      * text position of row r is r itself: occurrences tile the text with
        w-overlap, so tstart[j] == cumcnt[j] - 1 and ssa = r.
      * suffix length: suf_len = cumcnt[j+1] + w - 1 - r, with cumcnt[j+1]
        forward-filled from the occurrence starts (values increase, cummax).
      * dict position: dictpos = r + c_j with the per-occurrence constant
        c_j = d_starts[parse[j]] - cumcnt[j] + 1 delta-filled (_fill_per_occ).
      * parse-order key: key2 = isaP[j+1], delta-filled.
      * doc id: one scatter of doc boundaries + cumsum indexed by position
        (= r pre-sort), rides through the sort packed into the ssa operand
        when the bit budget allows (replaces a post-sort searchsorted).
    """
    grp_tab = _grp_tab(d, grp_of_pos, grp_cross, nd)
    ops = _expand_operands(parse, d_starts, cumcnt, m, total_rows, n_text,
                           isaP, grp_tab, doc_ends, nr, nd, w,
                           num_docs, lvl_cap)
    sorted_ops = jax.lax.sort(ops, num_keys=2)
    return _analyze_sorted(sorted_ops, slt_table, nr, nd, w,
                           num_docs, lvl_cap, min_match_len, num_distinct,
                           max_total_freq, max_doc_freq, size_cap, need_ctx)


def _pack_da_mode(nr: int, nd: int, num_docs: int, suf_bits: int):
    """(pack_cross, pack_ops, da_bits): packing modes for the expansion.

    pack_ops: (ssa, da) and (suf_len, bwt) pack into single int32 sort
    operands (4/5-operand sort instead of 6/7); requires suf_len < 2^24,
    guaranteed via suf_bits (= lvl_cap: maxlen < 2^lvl_cap).
    pack_cross: additionally the per-row cross-group LCP (< 2^lvl_cap by
    the descent clamp) packs into the sufbwt operand — no extra sort
    operand at all. Needs 2*suf_bits + 7 <= 31.

    The (group, prev char, cross) table lookup itself is ONE (nd, 3)
    row-gather at every nd (one row fetch per index instead of three
    column gathers), so no shape needs a packed-table tier."""
    da_bits = max(int(num_docs).bit_length(), 1)
    pack_ops = (nr << da_bits) < (1 << 31) and suf_bits + 7 <= 31
    pack_cross = pack_ops and 2 * suf_bits + 7 <= 31
    return pack_cross, pack_ops, da_bits


@functools.partial(jax.jit, static_argnames=("nd",))
def _grp_tab(d, grp_of_pos, grp_cross, nd: int):
    """(nd, 3) int32 expansion lookup table, one row per dict position:
    col 0 group id (-1 invalid), col 1 previous dict char (the BWT char
    of rows at this position), col 2 the group's cross-group LCP. Built
    with ONE O(nd) gather (grp_cross by group id); consumed by ONE O(nr)
    row-gather in _expand_operands."""
    prev_d = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              d[:-1].astype(jnp.int32)])
    cross_of_pos = jnp.take(grp_cross,
                            jnp.clip(grp_of_pos, 0, grp_cross.shape[0] - 1))
    return jnp.stack([grp_of_pos, prev_d, cross_of_pos], axis=1)


def _expand_operands(parse, d_starts, cumcnt, m, total_rows, n_text, isaP,
                     grp_tab, doc_ends, nr: int, nd: int, w: int,
                     num_docs: int, lvl_cap: int):
    """Build the expansion-sort operand tuple (first two are the keys).
    Everything is scans/scatters/slices except ONE O(nr) row-gather into
    the (nd, 3) (group, prev char, cross) table (_grp_tab). Separated from
    the sort + analysis so the seq-sharded path can run the same code
    around a distributed sort."""
    r = jnp.arange(nr, dtype=jnp.int32)
    mp1 = cumcnt.shape[0]
    slots = jnp.arange(mp1 - 1, dtype=jnp.int32)
    # occurrence start rows (pad-slot scatters dropped)
    starts_idx = jnp.where(slots < m, jnp.clip(cumcnt[:-1], 0, nr - 1), nr)
    pad = r >= total_rows

    base = cumcnt[:-1]
    pid_tab = parse[:mp1 - 1]
    next_start = jax.lax.cummax(
        jnp.zeros((nr,), jnp.int32).at[starts_idx].max(
            cumcnt[1:], mode="drop"))
    suf_len = next_start + (w - 1) - r
    dictpos = r + _fill_per_occ(
        jnp.take(d_starts, pid_tab) - base + 1, starts_idx, nr)
    ssa = jnp.minimum(r, n_text)
    k2_vals = jnp.concatenate([isaP[1:mp1 - 1], jnp.zeros((1,), jnp.int32)])
    key2 = jnp.where(pad, 0, _fill_per_occ(k2_vals, starts_idx, nr))

    # doc id by text position: one boundary scatter + cumsum
    ends_idx = jnp.clip(doc_ends, 0, nr - 1)
    da_by_pos = jnp.minimum(
        jnp.cumsum(jnp.zeros((nr,), jnp.int32).at[ends_idx].add(1)),
        num_docs)

    pack_cross, pack_ops, da_bits = _pack_da_mode(nr, nd, num_docs, lvl_cap)
    # THE gather of this side: one (nd, 3) row fetch per row — group id,
    # previous dict char (the row's BWT char), and the group's cross LCP
    g = jnp.take(grp_tab, jnp.clip(dictpos, 0, nd - 1), axis=0)
    key1 = jnp.where(pad, -1, g[:, 0])
    bwt = jnp.where(pad, 0, g[:, 1])
    crossv = jnp.where(pad, 0, g[:, 2])
    if pack_ops:
        ssada = (ssa << da_bits) | da_by_pos
        if pack_cross:
            # cross < 2^lvl_cap (descent clamp) rides inside sufbwt
            sufbwt = jnp.where(
                pad, 0, (((suf_len << 7) | bwt) << lvl_cap) | crossv)
            return key1, key2, ssada, sufbwt
        sufbwt = jnp.where(pad, 0, (suf_len << 7) | bwt)
        return key1, key2, ssada, sufbwt, crossv
    return key1, key2, ssa, suf_len, bwt, da_by_pos, crossv


def _analyze_sorted(sorted_ops, slt_table, nr: int, nd: int,
                    w: int, num_docs: int, lvl_cap: int, min_match_len,
                    num_distinct, max_total_freq, max_doc_freq: int,
                    size_cap: int | None, need_ctx: bool):
    """Post-sort: per-row LCP from the PFP tables + interval analysis.
    The cross-group LCP arrives THROUGH the sort (packed into sufbwt or
    as its own operand) — no post-sort table gather."""
    pack_cross, pack_ops, da_bits = _pack_da_mode(nr, nd, num_docs,
                                                  lvl_cap)
    if pack_ops:
        if pack_cross:
            key1s, key2s, ssadas, sufbwts = sorted_ops
            cross = sufbwts & ((1 << lvl_cap) - 1)
            sufbwts = sufbwts >> lvl_cap
        else:
            key1s, key2s, ssadas, sufbwts, cross = sorted_ops
        ssas = ssadas >> da_bits
        da = ssadas & ((1 << da_bits) - 1)
        sufs = sufbwts >> 7
        bwts = sufbwts & 127
    else:
        key1s, key2s, ssas, sufs, bwts, da, cross = sorted_ops

    same_grp = jnp.concatenate([
        jnp.zeros((1,), bool), key1s[1:] == key1s[:-1]])
    prev_key2 = jnp.concatenate([key2s[:1], key2s[:-1]])
    within = sufs - w + _rmq_query(slt_table,
                                   jnp.minimum(prev_key2, key2s) + 1,
                                   jnp.maximum(prev_key2, key2s))
    lcp = jnp.where(same_grp, within, cross)
    lcp = jnp.where(key1s < 0, 0, lcp).astype(jnp.int32)
    lcp = lcp.at[0].set(0)
    # boundary: first real row after pads gets lcp 0 (cross of first group=0)

    da = jnp.where(key1s < 0, num_docs, da).astype(jnp.int32)

    res = ops_intervals.analyze_intervals(
        lcp, da, bwts.astype(jnp.uint8), nr,
        min_match_len, num_distinct, max_total_freq, max_doc_freq,
        size_cap=size_cap, need_ctx=need_ctx)
    res["sa"] = ssas
    res["da"] = da
    res["lcp"] = lcp
    res["bwt"] = bwts.astype(jnp.uint8)
    # BWT run count over real rows (n/r stat, pfp_mum.cpp:148-150)
    real = key1s >= 0
    change = (bwts[1:] != bwts[:-1]) & real[1:] & real[:-1]
    nruns = change.sum(dtype=jnp.int32) + 1
    counts = jnp.stack([res["emit"].sum(dtype=jnp.int32),
                        res["cand"].sum(dtype=jnp.int32), nruns])
    return res, counts


def scan_collection_pfp(text_np: np.ndarray, doc_ends: np.ndarray,
                        num_docs: int, min_match_len, num_distinct,
                        max_total_freq, max_doc_freq: int,
                        w: int = 10, mod: int = 100,
                        size_cap: int | None = None, need_ctx: bool = True):
    """Drop-in alternative to ops/pipeline.scan_collection via PFP."""
    phase = _phase_logger()
    pfp = build_pfp(text_np, w=w, mod=mod)
    phase("build_pfp")
    return pfp_scan(pfp, doc_ends, num_docs, min_match_len, num_distinct,
                    max_total_freq, max_doc_freq, size_cap=size_cap,
                    need_ctx=need_ctx)


# ---------------------------------------------------------------------------
# .dict/.parse resume files (newscan.hpp:407-419 format)
# ---------------------------------------------------------------------------

def write_parse_files(rb, prefix: str, w: int = 10, mod: int = 100) -> None:
    """-P/--only-parse: write .dict (lex-sorted phrases + EndOfWord each +
    EndOfDict) and .parse (u32 1-based ranks).

    Byte-compatible with the reference toolchain: breaks come from the
    exact KR window hash (newscan.hpp:84-115), phrases carry the same
    Dollar decorations, and ranks are by phrase content (the reference's
    collision-probed 64-bit phrase hashes are an internal detail — its
    files also store content ranks, newscan.hpp:357-423). Golden-fixture
    tested against an independent transcription of the reference parser
    in tests/test_pfp.py."""
    pfp = build_pfp(rb.text, w=w, mod=mod)
    phrase_st, phrase_ln, d_starts_pad, npz, total_real, nd = \
        _pad_phrase_arrays(pfp)
    d = np.asarray(_dict_setup(
        pfp.ext, jnp.asarray(phrase_st), jnp.asarray(phrase_ln),
        jnp.asarray(d_starts_pad), jnp.int32(npz),
        jnp.int32(total_real), nd, pfp.ext.shape[0])[0])
    with open(prefix + ".dict", "wb") as f:
        f.write(d[:pfp.d_len].tobytes())
    with open(prefix + ".parse", "wb") as f:
        f.write(pfp.parse.astype("<u4").tobytes())


def read_parse_files(prefix: str):
    """Load .dict/.parse (either ours or reference-written) back into the
    (phrase strings, parse ids) representation."""
    d = np.fromfile(prefix + ".dict", dtype=np.uint8)
    parse = np.fromfile(prefix + ".parse", dtype="<u4").astype(np.int32)
    # split D on EndOfWord separators; drop trailing EndOfDict
    assert d[-1] == TERM
    body = d[:-1]
    seps = np.flatnonzero(body == SEP)
    starts = np.concatenate([[0], seps[:-1] + 1])
    lens = seps - starts
    return body, starts.astype(np.int32), lens.astype(np.int32), parse


def pfp_from_parse_files(prefix: str, w: int = 10) -> PFPData:
    """-p/--from-parse resume (pfp_mum.cpp:122-123, pfp.hpp:105-129):
    rebuild PFPData from .dict/.parse without re-reading the FASTAs.

    The dict body itself serves as the phrase byte store (`ext`); phrase
    records address phrase bytes within it, so `_dict_setup`
    regenerates exactly the same D. Text positions come from the PFP
    invariant: occurrence j+1 starts (phrase_ln[parse[j]] - w) chars after
    occurrence j, with occurrence 0 starting at -1 (the artificial Dollar).
    """
    body, starts, lens, parse = read_parse_files(prefix)
    num_phrases = int(lens.size)
    m = int(parse.size)
    if parse.size and (int(parse.min()) < 1 or int(parse.max()) > num_phrases):
        raise ValueError(
            f"{prefix}.parse references phrase ids outside the .dict "
            f"(1..{num_phrases})")
    # every PFP phrase ends with the w-char trigger window of the next
    # phrase, so real phrase lengths are >= w+1; shorter ones mean the
    # files were written with a different window than the caller's w
    if lens.size and int(lens.min()) <= w:
        raise ValueError(
            f"{prefix}.dict contains a phrase of length {int(lens.min())} "
            f"<= w={w}: window mismatch with the parse files")
    phrase_st = np.zeros(num_phrases + 1, np.int32)
    phrase_ln = np.zeros(num_phrases + 1, np.int32)
    phrase_st[1:] = starts
    phrase_ln[1:] = lens
    ne = bucket(body.size + 1)
    ext_pad = np.zeros(ne, np.uint8)
    ext_pad[:body.size] = body
    step = (phrase_ln[parse] - w).astype(np.int64)
    n_text = int(step.sum()) - 1
    return PFPData(w=w, n_text=n_text, m=m, num_phrases=num_phrases,
                   d_len=int(phrase_ln.sum()) + num_phrases + 1,
                   ext=jnp.asarray(ext_pad), parse=parse,
                   phrase_st=phrase_st, phrase_ln=phrase_ln,
                   alpha=_alphabet(body))
