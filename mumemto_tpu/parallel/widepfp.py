"""Block-sharded (shard_map) sequence-parallel PFP scan with uint32 global
row coordinates — the DEFAULT seq-sharded formulation at every scale, and
the only one reaching row spaces past 2^31 - 1 (chr19 x 20, BASELINE
config 5).

Two reasons this formulation is the default (routing:
seqpfp.find_matches_seq_sharded):

1. LINEAR work by construction. The GSPMD alternative (seqpfp.py) lets
   the SPMD partitioner shard the cumulative fills of stage A/C, which it
   lowers with full-window halos — total work QUADRATIC in the row count
   (measured 53x slower at 0.64 Mchar). Here every scan is block-local
   with an explicit carry, the classic blockwise decomposition.
2. COORDINATE WIDTH. A logical GSPMD array indexes with int32, capping
   collections at 2^31 - 1 expansion rows, just *below* chr19 x 20 with
   revcomp (~2.33 G rows). The reference reaches 2^40
   via 5-byte SA entries (common.hpp:59-61). Blocks lift the ceiling to
   ~2^32 rows:

  * local indices stay int32 (each block B = nr/P < 2^31),
  * global coordinates are uint32 VALUES (never array indices),
  * all global arithmetic is modular-uint32 (exact: every true value
    fits in uint32 because nr < 2^32),
  * no logical array ever exceeds 2^31 elements — sidestepping XLA's
    s32 index-space limits entirely.

Stages (mirroring seqpfp, same block-bitonic sort machinery):

  A  per-shard expansion operands from replicated metadata: the
     occurrence step-function fills restart at each block using the
     straddling occurrence j0 = searchsorted(cumcnt, base) - 1 as the
     carry-in (delta-scatter + cumsum/cummax + carry, all local).
  B  block-bitonic global sort by (group id, parse rank) — operands are
     (key1 i32, key2 i32, ssa u32, sufbwt i32, da i32); pads keep the
     narrow path's key1 = -1 front-sorting convention (values, unlike
     keys, never needed a signedness flip).
  C  halo exchange of the SORTED operands (H = size_cap + 1 rows per
     side), per-row LCP + the interval analysis on the padded block in
     LOCAL pad coordinates; every analyzer formulation touches <=
     size_cap + 1 rows around a query row (caps <= 128: unrolled shifted
     stencils; caps 129..4096: probe-guarded sparse-table PSV/NSV walks,
     see ops/intervals.py), so interior-shard halos reproduce the global
     computation exactly. Edge halos are
     neutralized: shard 0's left halo becomes front pads (key1 = -1,
     lcp 0 — the narrow path's bucket-pad semantics), the last shard's
     right halo gets lcp = -1 so intervals still open at the global end
     close INTO the halo and are dropped (e_global == nr), exactly the
     reference's intervals-open-at-end-of-stream rule.
  D  per-shard window compaction in pad coordinates; boundary ownership
     = real region [H, H+B); outputs convert to uint32 global rows.

Memory budget (chr19 x 20, n ~ 2.33 G rows, P = 8): row operands are
5 x 4 B x n/P ~ 5.8 GB/chip plus the bitonic 2x transient on one operand
set and the padded analysis block (~1.3 GB) for the row side. The
REPLICATED dict side is the real chr-scale constraint (nd ~ 0.3-0.6 G
for diverged collections; see ROADMAP) — at high divergence, split
hosts with MumemtoM partitions instead.

Byte-equality with the single-device engine is pinned by
tests/test_widepfp.py (forced wide mode, shard sweeps, all modes), and
the uint32 arithmetic is unit-tested at synthetic row bases > 2^31 via
the offset-shift trick (same tests file).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from mumemto_tpu.ops import intervals as ops_intervals
from mumemto_tpu.ops import pfp as ops_pfp
from mumemto_tpu.ops import pipeline as ops_pipeline
from mumemto_tpu.parallel.seqpfp import _bitonic_block_sort

U32 = jnp.uint32
U32_MAX = np.uint32(0xFFFFFFFF)


class PhrasePackOverflow(ValueError):
    """The dictionary's longest phrase exceeds the (suf_len << 7) | bwt
    int32 pack bound (maxlen >= 2^24). The GSPMD formulation's unpacked
    operand tier still handles such inputs below 2^31 rows —
    find_matches_seq_sharded falls back to it automatically."""


# ---------------------------------------------------------------------------
# stage A: per-shard expansion operands
# ---------------------------------------------------------------------------

def _block_fill(vals, loc, j0p, B: int, dtype):
    """Step-function fill over one block: out[r] = vals[j] for the
    occurrence j covering global row base + r (ops/pfp._fill_per_occ with
    a block carry). loc are the local start rows of in-block occurrences
    (loc = B drops); j0p is the last occurrence starting STRICTLY before
    the block base (-1 if none) — its value is the carry-in; the scattered
    deltas telescope exactly from there (occurrences j0p+1.. all start
    in-block). int32 values use ordinary arithmetic; uint32 global
    coordinates use modular arithmetic, exact for true values < 2^32."""
    delta = jnp.concatenate([vals[:1], vals[1:] - vals[:-1]])
    acc = jnp.cumsum(
        jnp.zeros((B,), dtype).at[loc].add(delta, mode="drop"))
    carry = jnp.where(j0p < 0, jnp.zeros((), dtype),
                      jnp.take(vals, jnp.clip(j0p, 0, vals.shape[0] - 1)))
    return acc + carry


def _block_operands(base, parse, d_starts, cumcnt, m, total_rows, n_text,
                    isaP, grp_tab, doc_ends,
                    B: int, nd: int, w: int, num_docs: int,
                    lvl_cap: int, pack_cross: bool):
    """Expansion operands for global rows [base, base + B), uint32 global
    coordinates (ops/pfp._expand_operands with an explicit block base;
    same structural identities, same pad convention).

    Returns (key1 i32, key2 i32, ssa u32, sufbwt i32, da i32[, cross]):
    key1/key2 are the sort keys; ssa is the uint32 text position (= global
    row id, the r == ssa tiling identity); sufbwt packs (suffix length,
    bwt char[, cross-group LCP when pack_cross]); da is the doc id; the
    cross LCP rides as its own operand when the sufbwt bit budget can't
    hold it. grp_tab: the (nd, 3) (group, prev char, cross) table
    (ops/pfp._grp_tab) — ONE row-gather per row. Pads (global row >=
    total_rows) get key1 = -1 and sort to the global front exactly like
    the narrow path."""
    r = jnp.arange(B, dtype=jnp.int32)
    gr = base + r.astype(U32)
    mp1 = cumcnt.shape[0]
    slots = jnp.arange(mp1 - 1, dtype=jnp.int32)

    # last occurrence starting strictly before the base (-1 if none):
    # occurrences j0p+1.. all start in-block, so scattered deltas
    # telescope exactly from the j0p carry (see _block_fill)
    j0p = jnp.searchsorted(cumcnt, base,
                           side="left").astype(jnp.int32) - 1
    starts = cumcnt[:-1]
    # in-block iff the modular distance is < B (starts < base wrap huge)
    in_blk = (slots < m) & ((starts - base) < U32(B))
    loc = jnp.where(in_blk, (starts - base).astype(jnp.int32), B)

    # next occurrence boundary (u32): cummax fill + straddler carry
    # (carry cumcnt[j0p+1] <= every in-block row's true boundary; max is
    # idempotent so a start coinciding with the base is harmless here)
    nxt = jnp.zeros((B,), U32).at[loc].max(cumcnt[1:], mode="drop")
    next_start = jnp.maximum(
        jax.lax.cummax(nxt),
        jnp.take(cumcnt, jnp.clip(j0p + 1, 0, mp1 - 1)))
    suf_len = (next_start + U32(w - 1) - gr).astype(jnp.int32)

    # dict position: gr + c_j with the per-occurrence modular constant
    # c_j = d_starts[parse[j]] + 1 - cumcnt[j]
    pid_tab = parse[:mp1 - 1]
    c_occ = (jnp.take(d_starts, pid_tab) + 1).astype(U32) - starts
    dictpos = (gr + _block_fill(c_occ, loc, j0p, B, U32)).astype(jnp.int32)

    # parse-order key: isaP of the NEXT parse position
    k2_vals = jnp.concatenate([isaP[1:mp1 - 1], jnp.zeros((1,), jnp.int32)])
    key2 = _block_fill(k2_vals, loc, j0p, B, jnp.int32)

    # doc id by text position: in-block boundary scatter + carry-in count
    de_loc = jnp.where((doc_ends - base) < U32(B),
                       (doc_ends - base).astype(jnp.int32), B)
    init_da = (doc_ends < base).sum(dtype=jnp.int32)
    da = jnp.minimum(
        init_da + jnp.cumsum(
            jnp.zeros((B,), jnp.int32).at[de_loc].add(1, mode="drop")),
        num_docs)

    pad = gr >= total_rows
    g = jnp.take(grp_tab, jnp.clip(dictpos, 0, nd - 1), axis=0)
    key1 = jnp.where(pad, -1, g[:, 0])
    bwt = jnp.where(pad, 0, g[:, 1])
    crossv = jnp.where(pad, 0, g[:, 2])
    key2 = jnp.where(pad, 0, key2)
    ssa = jnp.minimum(gr, n_text)
    if pack_cross:
        sufbwt = jnp.where(
            pad, 0, (((suf_len << 7) | bwt) << lvl_cap) | crossv)
        return key1, key2, ssa, sufbwt, da
    sufbwt = jnp.where(pad, 0, (suf_len << 7) | bwt)
    return key1, key2, ssa, sufbwt, da, crossv


# ---------------------------------------------------------------------------
# stage C: haloed per-row LCP + windowed analysis (pad coordinates)
# ---------------------------------------------------------------------------

def _exchange_halos(ops, H: int, axis: str, nshards: int):
    """[left-halo | block | right-halo] for every operand (seqpfp._haloed
    generalized to tuples; wrap garbage at the edges is neutralized by the
    caller)."""
    out = []
    for a in ops:
        if nshards == 1:
            z = jnp.zeros((H,), a.dtype)
            out.append(jnp.concatenate([z, a, z]))
            continue
        from_prev = [(s, (s + 1) % nshards) for s in range(nshards)]
        from_next = [(s, (s - 1) % nshards) for s in range(nshards)]
        left = jax.lax.ppermute(a[-H:], axis, from_prev)
        right = jax.lax.ppermute(a[:H], axis, from_next)
        out.append(jnp.concatenate([left, a, right]))
    return tuple(out)


def _analyze_block(sorted_ops, slt_table, i, B: int, H: int,
                   nshards: int, w: int, num_docs: int,
                   min_match_len, num_distinct, max_total_freq,
                   max_doc_freq: int, size_cap: int, need_ctx: bool,
                   axis: str, lvl_cap: int, pack_cross: bool):
    """Per-shard LCP + windowed interval analysis on the haloed block
    (local pad coordinates 0..B+2H). Mirrors ops/pfp._analyze_sorted's
    windowed path (cross LCP arrives through the sort, no post-sort
    gather); edge-halo neutralization makes the local computation equal
    the global one for every boundary owned by this shard (see module
    docstring)."""
    B2 = B + 2 * H
    if pack_cross:
        key1, key2, ssa, sufbwt, da = _exchange_halos(
            sorted_ops, H, axis, nshards)
        cross = sufbwt & ((1 << lvl_cap) - 1)
        sufbwt = sufbwt >> lvl_cap
    else:
        key1, key2, ssa, sufbwt, da, cross = _exchange_halos(
            sorted_ops, H, axis, nshards)
    pos = jnp.arange(B2, dtype=jnp.int32)
    # shard 0's left halo = front pads; analysis treats key1 < 0 rows as
    # inert exactly like the narrow path's bucket pads
    left_edge = (i == 0) & (pos < H)
    key1 = jnp.where(left_edge, -1, key1)

    sufs = sufbwt >> 7
    bwts = sufbwt & 127
    same_grp = jnp.concatenate([
        jnp.zeros((1,), bool), key1[1:] == key1[:-1]])
    prev_key2 = jnp.concatenate([key2[:1], key2[:-1]])
    within = sufs - w + ops_pfp._rmq_query(
        slt_table, jnp.minimum(prev_key2, key2) + 1,
        jnp.maximum(prev_key2, key2))
    lcp = jnp.where(same_grp, within, cross)
    lcp = jnp.where(key1 < 0, 0, lcp).astype(jnp.int32)
    # the global first row's lcp is 0 (narrow: lcp.at[0].set(0)); with
    # key1<0 pads in front this is already 0 unless the bucket has no pads
    lcp = jnp.where((i == 0) & (pos == H), 0, lcp)
    # rows past the global end (last shard's right halo) must close and
    # drop any interval reaching them: lcp = -1 < every candidate L
    lcp = jnp.where((i == nshards - 1) & (pos >= H + B), -1, lcp)
    da = jnp.where(key1 < 0, num_docs, da)

    res = ops_intervals.analyze_intervals(
        lcp, da, bwts.astype(jnp.uint8), B2,
        min_match_len, num_distinct, max_total_freq, max_doc_freq,
        size_cap=size_cap, need_ctx=need_ctx)
    real = (pos >= H) & (pos < H + B)
    # ownership + the open-at-global-end drop (e on the -1 halo row means
    # e_global == nr, the narrow path's open marker)
    open_end = (i == nshards - 1) & (res["e"] >= H + B)
    res["emit"] = res["emit"] & real & ~open_end
    res["cand"] = res["cand"] & real & ~open_end
    # BWT run count over real global rows (n/r stat): a run boundary at
    # pad coord q counts when rows q-1, q are both real rows
    realrow = key1 >= 0
    prev_real = jnp.concatenate([jnp.zeros((1,), bool), realrow[:-1]])
    chg = jnp.concatenate(
        [jnp.zeros((1,), bool), bwts[1:] != bwts[:-1]])
    nruns_local = (chg & realrow & prev_real & real).sum(dtype=jnp.int32)
    return res, (ssa, da), nruns_local


def _compact_block(res, ssa_pad, da_pad, base, B: int, H: int, M: int,
                   num_docs: int, mem_mode: bool, need_ctx: bool):
    """Stage D: pop-ordered window compaction in pad coordinates; outputs
    carry uint32 GLOBAL rows (seqpfp._local_compact on the haloed block).
    The halo width H = size_cap + 1 >= W guarantees every window column
    stays inside the padded block."""
    B2 = B + 2 * H
    W = H - 1  # = size_cap

    def to_global(p_pad):
        return base + p_pad.astype(U32) - U32(H)

    def window_cols(s):
        cols = s[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
        return jnp.clip(cols, 0, B2 - 1)

    idx = ops_pipeline._select_ordered(
        res["emit"], res["e"], res["L"], B2, M, big=B2)
    s = jnp.take(res["s"], idx)
    e = jnp.take(res["e"], idx)
    L = jnp.take(res["L"], idx)
    colc = window_cols(s)
    out = {
        "count": res["emit"].sum(dtype=jnp.int32)[None],
        "s": to_global(s), "e": to_global(e), "L": L,
        "w_sa": jnp.take(ssa_pad, colc),
        "w_da": jnp.take(da_pad, colc).astype(
            ops_pipeline._da_dtype(num_docs)),
    }
    if mem_mode:
        prev = res["prev_same"]
        prev_g = jnp.where(prev >= 0, base + prev.astype(U32) - U32(H),
                           U32_MAX)
        out["w_prev"] = jnp.take(prev_g, colc)
    if need_ctx:
        cidx = ops_pipeline._select_ordered(
            res["cand"], res["e"], res["L"], B2, M, big=B2)
        cs = jnp.take(res["s"], cidx)
        ce = jnp.take(res["e"], cidx)
        ccolc = window_cols(cs)
        cols = cs[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
        valid = cols < ce[:, None]
        wda = jnp.take(da_pad, ccolc)
        is0 = valid & (wda == 0)
        has0 = is0.any(axis=1)
        first0 = jnp.argmax(is0, axis=1).astype(jnp.int32)
        sa0_col = jnp.clip(cs + first0, 0, B2 - 1)
        out.update({
            "cand_count": res["cand"].sum(dtype=jnp.int32)[None],
            "c_e": to_global(ce),
            "c_L": jnp.take(res["L"], cidx),
            "c_has0": has0,
            "c_sa0": jnp.take(ssa_pad, sa0_col),
            "c_prev": jnp.take(res["prev_ctx"], cidx),
            "c_next": jnp.take(res["next_ctx"], cidx),
        })
    return out


# ---------------------------------------------------------------------------
# the sharded step + entry point
# ---------------------------------------------------------------------------

def compile_wide_step(mesh, axis: str, nr: int, nd: int, w: int,
                      num_docs: int, max_doc_freq: int, size_cap: int,
                      need_ctx: bool, M: int, mem_mode: bool,
                      lvl_cap: int = 24):
    """jit the wide-coordinate sharded scan (stages A-D, one shard_map).
    lvl_cap: static suffix-length bit width (< 2^lvl_cap); when
    2*lvl_cap + 7 <= 31 the cross LCP packs into the sufbwt operand,
    otherwise it rides as its own sort operand (same fallback as the
    narrow path's _pack_da_mode). The default 24 forces the own-operand
    path for callers that don't pass it."""
    nshards = int(mesh.shape[axis])
    assert nshards & (nshards - 1) == 0, "seq axis must be a power of two"
    assert nr % nshards == 0, "row bucket must divide the shard count"
    assert size_cap is not None and size_cap <= 4096, \
        "block scan requires a bounded interval size cap <= 4096"
    B = nr // nshards
    assert B < 2**31, \
        "wide-scan blocks must stay int32-indexable (add shards)"
    M = min(M, B)
    H = size_cap + 1
    assert H <= B, "shard blocks must cover one halo width"
    rep = NamedSharding(mesh, P())
    spec1 = P(axis)
    pack_cross = 2 * lvl_cap + 7 <= 31

    def shard_body(parse, d_starts, cumcnt, m, total_rows, n_text, isaP,
                   grp_tab, slt_table, doc_ends,
                   min_match_len, num_distinct, max_total_freq):
        i = jax.lax.axis_index(axis)
        base = i.astype(U32) * U32(B)
        ops = _block_operands(base, parse, d_starts, cumcnt, m,
                              total_rows, n_text, isaP, grp_tab,
                              doc_ends, B, nd, w, num_docs,
                              lvl_cap, pack_cross)
        sorted_ops = _bitonic_block_sort(ops, axis=axis, nshards=nshards,
                                         num_keys=2)
        res, (ssa_pad, da_pad), nruns_local = _analyze_block(
            sorted_ops, slt_table, i, B, H, nshards, w,
            num_docs, min_match_len, num_distinct, max_total_freq,
            max_doc_freq, size_cap, need_ctx, axis, lvl_cap, pack_cross)
        windows = _compact_block(res, ssa_pad, da_pad, base, B, H, M,
                                 num_docs, mem_mode, need_ctx)
        counts = jax.lax.psum(
            jnp.stack([res["emit"].sum(dtype=jnp.int32),
                       res["cand"].sum(dtype=jnp.int32),
                       nruns_local]), axis)
        return counts.at[2].add(1), windows

    meta_specs = (P(),) * 13
    step = jax.shard_map(
        shard_body, mesh=mesh, in_specs=meta_specs,
        out_specs=(P(), spec1))

    def full(parse, d_starts, cumcnt, m, total_rows, n_text, isaP,
             grp_of_pos, d, slt_table, grp_cross, doc_ends,
             min_match_len, num_distinct, max_total_freq):
        grp_tab = ops_pfp._grp_tab(d, grp_of_pos, grp_cross, nd)
        return step(parse, d_starts, cumcnt, m, total_rows, n_text, isaP,
                    grp_tab, slt_table, doc_ends,
                    min_match_len, num_distinct, max_total_freq)

    return jax.jit(full, out_shardings=(rep, None))


def find_matches_wide(rb, opts, mesh, axis: str = "seq",
                      pfp_w: int = 10, pfp_mod: int = 100,
                      M: int = 4096, parse_prefix: str | None = None,
                      pfp=None, shard_dict: bool = False):
    """engine.find_matches over a seq-sharded mesh with uint32 row
    coordinates — byte-identical output to the single-device engine, row
    spaces up to ~2^32 (see module docstring). pfp: an already-built
    PFPData (the seqpfp auto-router passes its own). shard_dict: run the
    dict-side index distributed over the same mesh
    (parallel/sharddict.py); its outputs are all_gathered back to
    replicated tables, which the block stages consume unchanged."""
    from mumemto_tpu import engine

    size_cap = engine.interval_size_cap(opts, rb.num_docs)
    if size_cap is None or size_cap > 4096:
        raise ValueError("block scan requires a bounded interval size "
                         "cap <= 4096 (finite f/F; collections up to "
                         "4096 docs in strict-MUM terms)")
    if pfp is None:
        if parse_prefix:
            pfp = ops_pfp.pfp_from_parse_files(parse_prefix, w=pfp_w)
        else:
            pfp = ops_pfp.build_pfp(rb.text, w=pfp_w, mod=pfp_mod)
    prep = ops_pfp.pfp_scan_prepare(
        pfp, rb.doc_ends, rb.num_docs, row_dtype=np.uint32,
        dict_mesh=(mesh, axis) if shard_dict else None)
    if prep["lvl_cap"] + 7 > 31:
        # _block_operands packs (suf_len << 7) | bwt into int32; the
        # narrow path gates this on the same bound (_pack_da_mode) and
        # falls back to unpacked operands — the block scan has no
        # unpacked tier, so refuse instead of corrupting silently (the
        # seqpfp router catches this and retries via the GSPMD unpacked
        # tier when the row space permits)
        raise PhrasePackOverflow(
            "block scan requires phrase maxlen < 2^24 (suffix-length "
            "pack bound); use the GSPMD formulation "
            "(find_matches_seq_sharded(force_gspmd=True)) below 2^31 "
            "rows, or split the collection into per-host partitions")
    nshards = int(mesh.shape[axis])
    nr = prep["nr"]
    assert nr < 2**32 - 1, "wide mode covers row spaces up to 2^32"
    M = min(M, nr // nshards)
    step = compile_wide_step(
        mesh, axis, nr, prep["nd"], pfp.w, rb.num_docs,
        opts.max_doc_freq, size_cap, opts.merge, M,
        mem_mode=not opts.mum_mode, lvl_cap=prep["lvl_cap"])
    counts, windows = step(
        prep["parse"], prep["d_starts"], prep["cumcnt"], prep["m"],
        prep["total_rows"], prep["n_text"], prep["isaP"],
        prep["grp_of_pos"], prep["d"], prep["slt_table"],
        prep["grp_cross"], prep["doc_ends"],
        jnp.int32(opts.min_match_len), jnp.int32(opts.num_distinct),
        jnp.int32(opts.max_total_freq))
    return _assemble_wide(rb, opts, counts, windows, nshards, M)


def _assemble_wide(rb, opts, counts, windows, nshards: int, M: int):
    """Host-side merge: uint32 globals -> int64, then the seqpfp assembly
    path (shared emitters)."""
    from mumemto_tpu.parallel import seqpfp

    win = {}
    for k, v in windows.items():
        a = np.asarray(v)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
            if k == "w_prev":
                # u32 no-previous sentinel -> the narrow path's -1: "no
                # same-doc row within the padded block" means the true
                # previous occurrence (if any) is below base - H < s, so
                # the row counts as its doc's first inside any interval
                a[a == int(U32_MAX)] = -1
        win[k] = a
    return seqpfp._assemble_results(rb, opts, counts, win, nshards, M)
