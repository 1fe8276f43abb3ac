"""Sharded dictionary index: the dict-side SA/LCP/groups distributed over
the seq mesh axis.

parallel/seqpfp.py shards the O(n) expansion row space but REPLICATES the
whole dictionary index (ops/pfp._dict_index) on every chip — the largest
stage of the single-device scan, which caps multi-chip speedup (Amdahl)
and caps dict size at one chip's memory. This module distributes
every nd-scale dict stage over the same axis with the SAME block-bitonic
sort machinery:

  S1  D materialization per block (ops/pfp._dict_setup with searchsorted
      block carries — phrase starts are ascending, the same technique as
      parallel/widepfp's occurrence fills).
  S2  prefix-doubling rounds: each round = one distributed 2-key sort of
      (rank, key2, idx) + neighbor-halo `changed` flags + a cross-shard
      prefix-sum carry for the new ranks + one distributed 1-key
      PERMUTATION ROUTE (sort by text index) back to text order. key2 is
      a static-k global shift — at most two ppermute block moves.
  S3  the LCP rank descent: the per-level random gathers into the
      (sharded) rank history become MERGED-STREAM ROUTED GATHERS — value
      rows (position, rank) and request rows (address, return slot)
      co-sort in one distributed 1-key sort; a forward last-value fill
      answers every request from its preceding value row; a route-back
      sort restores request order. Deterministic, capacity-free (streams
      are exactly (q+1) x Bd per shard), and reuses the bitonic sort.
  S4  ISA / group tables: permutation routes + cross-shard carries for
      the segmented fills of ops/pfp._dict_groups.

Tie-order note (why outputs match the replicated index bit for bit): the
depth-capped doubling leaves suffix pairs sharing > 2^cap chars tied, and
the distributed bitonic merge orders ties differently than the replicated
stable sort. That difference is PROVABLY inert: tied suffixes have equal
capped rank rows at every level, so rank functions, group membership,
gapmin/cross minima, and every descent h are tie-permutation-invariant;
lcpD entries inside a tie block are all clamped equal. The tests compare
d/lcpD/grp_of_pos/grp_cross exactly and end-to-end .mums bytes
(tests/test_sharddict.py); saD/isaD may differ in tie order only.

Cost model (chr-scale, P chips): the replicated index is ~(rounds +
2*descent_levels + groups) random-gather/scatter passes over nd on EVERY
chip. Sharded, each chip touches nd/P rows per pass; the descent's routed
gathers trade each 2-gather level for two 3*Bd-row distributed sorts, so
whether and from which P it pays depends on the sort-vs-gather cost
ratio of the device (not measured on a GPU yet). Memory: removes the
replicated doubling history ((L+1) x nd int32, the dict side's largest
allocation) and all sort transients; the final tables (d, lcpD, grp_of_pos, grp_cross ~ 4 x nd)
are still all_gathered for the expansion's table gather, and the slt
sparse table stays full-height — both named follow-ups in ROADMAP.md.

Opt-in: find_matches_seq_sharded(..., shard_dict=True) or
MUMEMTO_SHARD_DICT=1. Requires the canonical <= 8-byte alphabet (packed
seed) and nd < 2^29 (the route-back keys of the merged-stream gather
reach 3*nd and must stay below 2^31).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from mumemto_tpu.ops import intervals as ops_intervals
from mumemto_tpu.ops import pfp as ops_pfp
from mumemto_tpu.ops import suffix as ops_suffix
from mumemto_tpu.parallel.seqpfp import _bitonic_block_sort

SEP = ops_pfp.SEP
TERM = ops_pfp.TERM
IMAX = ops_intervals.INT32_MAX


# ---------------------------------------------------------------------------
# cross-shard primitives (all run INSIDE shard_map)
# ---------------------------------------------------------------------------

def _ex_prefix(scalar, axis):
    """Exclusive prefix-sum of a per-shard scalar over `axis`."""
    ps = jax.lax.all_gather(scalar, axis)
    i = jax.lax.axis_index(axis)
    return jnp.sum(jnp.where(jnp.arange(ps.shape[0]) < i, ps, 0))


def _carry_last(has, val, axis, default):
    """Value of the LAST shard before this one with `has`, else default."""
    hs = jax.lax.all_gather(has, axis)
    vs = jax.lax.all_gather(val, axis)
    i = jax.lax.axis_index(axis)
    idxp = jnp.arange(hs.shape[0])
    j = jnp.max(jnp.where((idxp < i) & hs, idxp, -1))
    return jnp.where(j >= 0, vs[jnp.maximum(j, 0)], default)


def _from_shard(arr, j: int, axis, nshards: int):
    """This shard's view of shard (i + j)'s block (zeros past the end)."""
    if j == 0:
        return arr
    if j >= nshards:
        return jnp.zeros_like(arr)
    perm = [(s, s - j) for s in range(j, nshards)]
    return jax.lax.ppermute(arr, axis, perm)


def _shift_k(arr, k: int, axis, nshards: int, Bd: int, fill):
    """out[local r] = global arr[base + r + k] for static k >= 0, with
    `fill` past the global end. At most two block ppermutes."""
    j, r = divmod(k, Bd)
    a = _from_shard(arr, j, axis, nshards)
    if r == 0:
        out = a
    else:
        b = _from_shard(arr, j + 1, axis, nshards)
        out = jnp.concatenate([a[r:], b[:r]])
    i = jax.lax.axis_index(axis)
    gpos = i * Bd + jnp.arange(Bd, dtype=jnp.int32) + k
    return jnp.where(gpos < nshards * Bd, out, fill)


def _prev1(arr, axis, nshards: int, fill):
    """out[r] = global arr[base + r - 1] (one element from the previous
    shard; `fill` before the global start)."""
    if nshards == 1:
        prev = jnp.full((1,), fill, arr.dtype)
    else:
        perm = [(s, (s + 1) % nshards) for s in range(nshards)]
        prev = jax.lax.ppermute(arr[-1:], axis, perm)
        i = jax.lax.axis_index(axis)
        prev = jnp.where(i == 0, jnp.full((1,), fill, arr.dtype), prev)
    return jnp.concatenate([prev, arr[:-1]])


def _perm_route(key_block, payload, axis, nshards: int):
    """Distributed scatter by a PERMUTATION key: sort (key, payload) by
    key; keys are a permutation of [0, nd), so sorted blocks align
    exactly with position blocks."""
    _, out = _bitonic_block_sort((key_block, payload), axis=axis,
                                 nshards=nshards, num_keys=1)
    return out


def _routed_gather(values, addrs, axis, nshards: int, Bd: int, nd: int):
    """Merged-stream routed gather: out[r] = values_global[addrs[r]].

    values: (Bd,) this shard's value block for dict positions
    [i*Bd, (i+1)*Bd); addrs: (q*Bd,) global addresses in [0, nd).
    Stream keys carry a low type bit (value sorts before request at the
    same address); the payload channel carries the value or the request's
    global return slot. A forward last-value fill (with cross-shard
    carry) answers every request; a route-back sort restores request
    order, dumping value rows into a per-shard tail zone so block
    boundaries stay aligned."""
    q = addrs.shape[0] // Bd
    i = jax.lax.axis_index(axis)
    base = i * Bd
    vkey = (base + jnp.arange(Bd, dtype=jnp.int32)) << 1
    rkey = (jnp.clip(addrs, 0, nd - 1) << 1) | 1
    slots = i * (q * Bd) + jnp.arange(q * Bd, dtype=jnp.int32)
    key = jnp.concatenate([vkey, rkey])
    payload = jnp.concatenate([values.astype(jnp.int32), slots])
    key_s, pay_s = _bitonic_block_sort((key, payload), axis=axis,
                                       nshards=nshards, num_keys=1)

    L = key_s.shape[0]
    is_val = (key_s & 1) == 0
    ordv = jnp.cumsum(is_val.astype(jnp.int32))  # 1-based local ordinal
    vtab = jnp.zeros((L,), jnp.int32).at[
        jnp.where(is_val, ordv - 1, L)].set(pay_s, mode="drop")
    carry = _carry_last(ordv[-1] > 0,
                        jnp.take(vtab, jnp.maximum(ordv[-1] - 1, 0)),
                        axis, jnp.int32(0))
    answer = jnp.where(ordv > 0,
                       jnp.take(vtab, jnp.maximum(ordv - 1, 0)), carry)

    tag = pay_s
    ret_req = (tag // (q * Bd)) * ((q + 1) * Bd) + (tag % (q * Bd))
    pos = key_s >> 1
    ret_val = (pos // Bd) * ((q + 1) * Bd) + q * Bd + (pos % Bd)
    ret_key = jnp.where(is_val, ret_val, ret_req)
    _, back = _bitonic_block_sort((ret_key, answer), axis=axis,
                                  nshards=nshards, num_keys=1)
    return back[: q * Bd]


# ---------------------------------------------------------------------------
# S1: block D materialization
# ---------------------------------------------------------------------------

def _block_dict_setup(i, ext, phrase_st, phrase_ln, d_starts, npz, total,
                      Bd: int, nd: int, ne: int):
    """This shard's D block + pos_meta block (ops/pfp._dict_setup over
    positions [i*Bd, (i+1)*Bd) with searchsorted block carries)."""
    base = i * Bd
    pos = base + jnp.arange(Bd, dtype=jnp.int32)
    npzb = phrase_st.shape[0] - 1
    ids = jnp.arange(1, npzb + 1, dtype=jnp.int32)
    st = jnp.where(ids <= npz, d_starts[1:], nd)  # ascending real starts
    loc = jnp.where((st >= base) & (st - base < Bd), st - base, Bd)
    j0p = jnp.searchsorted(st, base, side="left").astype(jnp.int32) - 1

    def fill(vals):
        delta = jnp.concatenate([vals[:1], vals[1:] - vals[:-1]])
        acc = jnp.cumsum(
            jnp.zeros((Bd,), jnp.int32).at[loc].add(delta, mode="drop"))
        carry = jnp.where(j0p < 0, 0,
                          jnp.take(vals, jnp.clip(j0p, 0, npzb - 1)))
        return acc + carry

    d_start_of = fill(st)
    st_of = fill(phrase_st[1:])
    plen_of = fill(phrase_ln[1:])
    off = pos - d_start_of
    in_phrase = off < plen_of
    ch = jnp.take(ext, jnp.clip(st_of + off, 0, ne - 1))
    d = jnp.where(in_phrase, ch, jnp.uint8(SEP))
    d = jnp.where(pos >= total, jnp.uint8(TERM), d)
    good = in_phrase & (pos < total) & (off >= 1)
    meta = jnp.where(good, plen_of - off, -1).astype(jnp.int32)
    return d, meta


# ---------------------------------------------------------------------------
# the sharded index
# ---------------------------------------------------------------------------

_COMPILE_CACHE: dict = {}


def compile_sharded_dict_index(mesh, axis: str, nd: int, ne: int, w: int,
                               lvl_cap: int, lvl_static: int, seed_thr,
                               lcp_thr):
    """jit the fully sharded dict index; outputs are all_gathered to
    replicated (the expansion's packed-table gather consumes them that
    way). Returns fn(ext, phrase_st, phrase_ln, d_starts, npz, total) ->
    (d, lcpD, isaD, grp_of_pos, grp_cross), matching
    ops/pfp._dict_index. Compiled closures are cached on the full static
    signature so repeated scans share one program."""
    ck = (mesh, axis, nd, ne, w, lvl_cap, lvl_static, seed_thr, lcp_thr)
    hit = _COMPILE_CACHE.get(ck)
    if hit is not None:
        return hit
    nshards = int(mesh.shape[axis])
    assert nshards & (nshards - 1) == 0
    assert nd % nshards == 0
    assert nd < (1 << 29), "routed-gather return keys reach 3*nd (int32)"
    assert seed_thr is not None and lcp_thr is not None, \
        "sharded dict requires the packed <=8-byte alphabet seed"
    assert lvl_static >= 4, "packed-bottom descent needs top level >= 3"
    Bd = nd // nshards
    L = min(ops_suffix._num_levels(nd), lvl_cap)

    def body(ext, phrase_st, phrase_ln, d_starts, npz, total):
        i = jax.lax.axis_index(axis)
        base = i * Bd
        idxl = jnp.arange(Bd, dtype=jnp.int32)
        idxg = base + idxl
        row0 = (i == 0) & (idxl == 0)
        d, meta = _block_dict_setup(i, ext, phrase_st, phrase_ln,
                                    d_starts, npz, total, Bd, nd, ne)

        # --- seed: exact 8-char 3-bit ranks from an 8-char next halo
        nxt8 = _shift_k(d, Bd, axis, nshards, Bd, jnp.uint8(0))[:8] \
            if nshards > 1 else jnp.zeros((8,), jnp.uint8)
        dh = jnp.concatenate([d, nxt8])
        code16 = jnp.zeros((Bd + 8,), jnp.int32)
        for t in seed_thr:
            code16 = code16 + (dh > jnp.uint8(t)).astype(jnp.int32)
        # beyond the global end the replicated seed uses 0-fill
        code_ok = jnp.where(
            (base + jnp.arange(Bd + 8, dtype=jnp.int32)) < nd, code16, 0)
        rank8 = code_ok[:Bd]
        for j in range(1, 8):
            rank8 = (rank8 << 3) | code_ok[j: Bd + j]
        hist = [code_ok[:Bd], rank8 >> 18, rank8 >> 12, rank8]

        _, perm = _bitonic_block_sort((rank8, idxg), axis=axis,
                                      nshards=nshards, num_keys=1)
        rank = rank8

        # --- doubling rounds (depth-capped, statically unrolled)
        for lvl in range(4, L + 1):
            k = 1 << (lvl - 1)
            key2 = _shift_k(rank, k, axis, nshards, Bd, jnp.int32(-1)) \
                if k < nd else jnp.full((Bd,), -1, jnp.int32)
            r1, r2, perm = _bitonic_block_sort((rank, key2, idxg),
                                               axis=axis, nshards=nshards,
                                               num_keys=2)
            p1 = _prev1(r1, axis, nshards, jnp.int32(-2))
            p2 = _prev1(r2, axis, nshards, jnp.int32(-2))
            changed = ((r1 != p1) | (r2 != p2)).astype(jnp.int32)
            changed = jnp.where(row0, 0, changed)
            local = jnp.cumsum(changed)
            new_rank_sorted = local + _ex_prefix(local[-1], axis)
            rank = _perm_route(perm, new_rank_sorted, axis, nshards)
            hist.append(rank)

        saD = perm  # sorted-order blocks of text positions

        # --- LCP rank descent (merged-stream routed gathers per level)
        a = _prev1(saD, axis, nshards, jnp.int32(0))
        a = jnp.where(row0, saD, a)  # a[0] = sa[0] (replicated concat)
        b = saD
        h = jnp.zeros((Bd,), jnp.int32)
        top = min(lvl_static - 1, len(hist) - 1)
        for lvl in range(top, 2, -1):
            ranks = hist[min(lvl, len(hist) - 1)]
            ia = a + h
            ib = b + h
            inb = (ia < nd) & (ib < nd)
            got = _routed_gather(
                ranks, jnp.concatenate([jnp.minimum(ia, nd - 1),
                                        jnp.minimum(ib, nd - 1)]),
                axis, nshards, Bd, nd)
            h = jnp.where(inb & (got[:Bd] == got[Bd:]), h + (1 << lvl), h)
        # packed 7-char bottom (ops/suffix._lcp_impl bottom step)
        codeb = jnp.zeros((Bd + 8,), jnp.int32)
        for t in lcp_thr:
            codeb = codeb + (dh > jnp.uint8(t)).astype(jnp.int32)
        codeb = jnp.where(
            (base + jnp.arange(Bd + 8, dtype=jnp.int32)) < nd, codeb, 0)
        pack = codeb[:Bd] << 24
        for j in range(1, 7):
            pack = pack | (codeb[j: Bd + j] << (4 * (6 - j)))
        ia = a + h
        ib = b + h
        inb = (ia < nd) & (ib < nd)
        got = _routed_gather(
            pack, jnp.concatenate([jnp.minimum(ia, nd - 1),
                                   jnp.minimum(ib, nd - 1)]),
            axis, nshards, Bd, nd)
        nc = jnp.zeros((Bd,), jnp.int32)
        for kk in range(1, 8):
            s = 28 - 4 * kk
            nc = nc + ((got[:Bd] >> s) == (got[Bd:] >> s)).astype(jnp.int32)
        h = jnp.where(inb, h + nc, h)
        lcpD = jnp.where(row0, 0, h)
        # canonical zero-pad-class values (ops/suffix.canonicalize_pad_lcp
        # — keeps lcpD bit-comparable with the replicated PLCP-based path)
        prev_sa = _prev1(saD, axis, nshards, jnp.int32(0))
        prev_sa = jnp.where(row0, saD, prev_sa)
        both_pad = jnp.minimum(prev_sa, saD) >= total - 1
        canon = nd - jnp.maximum(prev_sa, saD)
        lcpD = jnp.where(row0, 0, jnp.where(both_pad, canon, lcpD))

        # --- ISA (permutation route: scatter global rank at position sa)
        grank = _ex_prefix(jnp.int32(Bd), axis) + idxl
        isaD = _perm_route(saD, grank, axis, nshards)

        # --- groups (ops/pfp._dict_groups with cross-shard carries)
        suf_len = _routed_gather(meta, jnp.minimum(saD, nd - 1),
                                 axis, nshards, Bd, nd)
        valid = suf_len >= w

        # gapmin: running min of lcpD resetting AFTER each valid row
        seg_start = jnp.concatenate([jnp.ones((1,), bool), valid[:-1]])
        seg_id = jnp.cumsum(seg_start.astype(jnp.int32)) - 1
        seg_min = jnp.full((Bd,), IMAX, jnp.int32).at[seg_id].min(lcpD)
        gapmin = jnp.take(seg_min, seg_id)
        # first local segment extends into previous shards: min over
        # shards [max(last-shard-with-valid, 0), i) of their tail-after-
        # last-valid mins (whole block when a shard has no valid row)
        tail_start = jnp.max(jnp.where(valid, idxl + 1, 0))
        tail_min = jnp.min(jnp.where(idxl >= tail_start, lcpD, IMAX))
        hs = jax.lax.all_gather(valid.any(), axis)
        ts = jax.lax.all_gather(tail_min, axis)
        idxp = jnp.arange(nshards)
        lastv = jnp.max(jnp.where((idxp < i) & hs, idxp, -1))
        carry_min = jnp.min(jnp.where(
            (idxp >= jnp.maximum(lastv, 0)) & (idxp < i), ts, IMAX))
        gapmin = jnp.where(seg_id == 0,
                           jnp.minimum(gapmin, carry_min), gapmin)

        # previous valid row's suffix length (last-value fill + carry)
        ordv = jnp.cumsum(valid.astype(jnp.int32))
        vtab = jnp.zeros((Bd,), jnp.int32).at[
            jnp.where(valid, ordv - 1, Bd)].set(suf_len, mode="drop")
        carry_len = _carry_last(
            ordv[-1] > 0, jnp.take(vtab, jnp.maximum(ordv[-1] - 1, 0)),
            axis, jnp.int32(-1))
        prev_cnt = jnp.concatenate([jnp.zeros((1,), jnp.int32), ordv[:-1]])
        prev_len = jnp.where(prev_cnt > 0,
                             jnp.take(vtab, jnp.maximum(prev_cnt - 1, 0)),
                             carry_len)

        same = valid & (gapmin >= suf_len) & (prev_len == suf_len)
        new_group = valid & ~same
        ngl = jnp.cumsum(new_group.astype(jnp.int32))
        grp_of_row = ngl - 1 + _ex_prefix(ngl[-1], axis)
        cross = jnp.where(new_group, gapmin, 0)

        ag = lambda x: jax.lax.all_gather(x, axis, tiled=True)
        return (ag(d), ag(lcpD), ag(isaD), ag(saD), ag(valid),
                ag(new_group), ag(grp_of_row), ag(cross))

    fn = jax.shard_map(body, mesh=mesh, in_specs=(P(),) * 6,
                       out_specs=(P(),) * 8, check_vma=False)

    def index(ext, phrase_st, phrase_ln, d_starts, npz, total):
        (d, lcpD, isaD, saD, valid, new_group, grp_of_row, cross) = fn(
            ext, phrase_st, phrase_ln, d_starts, npz, total)
        # replicated finalization (ops/pfp._dict_groups tail)
        grp_cross = jnp.zeros((nd,), jnp.int32).at[
            jnp.where(new_group, grp_of_row, nd)].set(cross, mode="drop")
        grp_cross = grp_cross.at[0].set(0)
        grp_of_pos = jnp.full((nd,), -1, jnp.int32).at[
            jnp.where(valid, saD, nd)].set(grp_of_row, mode="drop")
        return d, lcpD, isaD, grp_of_pos, grp_cross

    rep = NamedSharding(mesh, P())
    fn_jit = jax.jit(index, out_shardings=(rep,) * 5)
    _COMPILE_CACHE[ck] = fn_jit
    return fn_jit
