"""Sequence-parallel PFP scan: ONE collection's expansion row space sharded
over the mesh's 'seq' axis.

This is the multi-chip path for the DEFAULT (PFP) backend — the long-context
analog of the reference's flagship chr19-pangenome workload
(/root/reference/README.md:124-142). The PFP dictionary/parse structures are
metadata-scale (|D| + |P| << n for repetitive collections, the whole point
of PFP) and stay replicated; the O(n) row space — expansion operands, the
big 2-key sort, per-row LCP, and the interval analysis — is sharded.

TWO formulations live here and in parallel/widepfp.py; the entry point
find_matches_seq_sharded routes between them (see its docstring):

  * the BLOCK scan (widepfp.py, the default at every scale): one
    shard_map over stages A-D with explicit per-shard carries — linear
    total work by construction;
  * the GSPMD formulation below (stages A/C as one logical array program
    with sharding constraints): kept for interval size caps > 128 and
    for the sharded-dict prep, but its cumulative fills lower through
    the SPMD partitioner with full-window halos — quadratic total work
    (measured; see find_matches_seq_sharded). Stage B/D (the shard_map
    bitonic sort + compaction) are shared by both formulations.

GSPMD stage map:

  stage A  expansion operands (ops/pfp._expand_operands): scans, scatters
           and one table gather, all sharded by GSPMD with collective
           carries inserted automatically.
  stage B  the global 2-key sort becomes a BLOCK-BITONIC sort under
           shard_map: each shard locally sorts its block, then
           log2(P)*(log2(P)+1)/2 merge-split rounds exchange whole blocks
           with the bitonic partner (ppermute between devices) and keep the
           lower/upper half of the locally merged pair. Deterministic,
           capacity-safe (block sizes never change), and the classic
           accelerator formulation (XLA's own sort lowering is bitonic).
  stage C  per-row LCP + interval analysis (ops/pfp._analyze_sorted):
           shifted-slice stencils become halo exchanges under GSPMD.
  stage D  per-shard compaction under shard_map: each shard compacts the
           intervals whose boundary row lives in its block, gathering SA/DA
           windows from a +-W row halo (interval width < W <= block size,
           so windows never reach past the neighbor block); the host merges
           the P small window sets by the reference pop order (e asc,
           L desc) — (e, L) uniquely identifies a canonical interval
           (ops/intervals._leftmost_mask), so the merge is unambiguous.

Memory budget (chr19 x 20 haplotypes, BASELINE config 5): n ~ 2.33 G rows
with revcomp; the row-space working set is ~6 int32 arrays x n / P per chip
plus a 2x transient during the bitonic merge (~4.5 GB/chip at P = 8), and
the replicated dict-side tables are O(|D|) ~ tens of Mrows.
Row coordinates beyond 2^31 - 1 (just past chr19 x 20 scale) route
automatically to the uint32 wide-coordinate path (parallel/widepfp.py,
~2^32-row ceiling); per-host partitions + MumemtoM merge
(parallel/mumemtom.py) cover anything beyond that.

Correctness: byte-equal to the single-device engine across shard counts,
modes (strict/partial MUM, MEM), and merge metadata (tests/test_seqpfp.py);
__graft_entry__.dryrun_multichip runs it on the virtual CPU mesh.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from mumemto_tpu.ops import pfp as ops_pfp
from mumemto_tpu.ops import pipeline as ops_pipeline
from mumemto_tpu.parallel.partition import _check_capacity


def _bitonic_block_sort(ops, axis: str, nshards: int, num_keys: int):
    """Globally sort equal block shards of a multi-operand sequence.

    Runs INSIDE shard_map: `ops` are the local (B,)-blocks. Classic
    merge-split block bitonic network (block compare-exchange = sort the
    concatenated pair, keep one half); every block stays ascending-sorted
    internally throughout, so the 0-1-principle argument for bitonic
    networks applies at block granularity.

    Duplicate-key safety: both partners of a compare-exchange must sort
    the SAME sequence, or the two kept halves are not a partition — with
    tied keys, stable-sorting [mine, partner] on one side and
    [partner, mine] on the other orders tied payload rows differently,
    silently duplicating some rows and dropping others. The concatenation
    order is therefore canonicalized (lower shard id's block first on
    both sides), making the merged sequence bit-identical on the pair."""
    i = jax.lax.axis_index(axis)
    B = ops[0].shape[0]
    ops = jax.lax.sort(ops, num_keys=num_keys)
    if nshards == 1:
        return ops
    p = nshards.bit_length() - 1
    for k in range(1, p + 1):
        for j in range(k - 1, -1, -1):
            d = 1 << j
            perm = [(s, s ^ d) for s in range(nshards)]
            partner = tuple(jax.lax.ppermute(a, axis, perm) for a in ops)
            asc = ((i >> k) & 1) == 0
            lower_role = (i & d) == 0
            keep_lower = asc == lower_role
            merged = jax.lax.sort(
                tuple(jnp.concatenate([jnp.where(lower_role, a, b),
                                       jnp.where(lower_role, b, a)])
                      for a, b in zip(ops, partner)),
                num_keys=num_keys)
            ops = tuple(jnp.where(keep_lower, mrg[:B], mrg[B:])
                        for mrg in merged)
    return ops


def _haloed(arr, W: int, axis: str, nshards: int):
    """Local block extended by W rows of each neighbor:
    [left-halo | block | right-halo]; local index = global - start + W.
    Edge shards receive wrapped garbage, which no in-range window ever
    reads (window columns are clipped to [0, nr) globally first)."""
    if nshards == 1:
        z = jnp.zeros((W,), arr.dtype)
        return jnp.concatenate([z, arr, z])
    from_prev = [(s, (s + 1) % nshards) for s in range(nshards)]
    from_next = [(s, (s - 1) % nshards) for s in range(nshards)]
    left = jax.lax.ppermute(arr[-W:], axis, from_prev)
    right = jax.lax.ppermute(arr[:W], axis, from_next)
    return jnp.concatenate([left, arr, right])


def _local_compact(res_local, nr: int, B: int, W: int, M: int,
                   num_docs: int, axis: str, nshards: int, mem_mode: bool,
                   need_ctx: bool):
    """Per-shard window compaction (stage D). Interval fields live at the
    interval's boundary row p; s/e are GLOBAL row ids. Window gathers index
    the +-W haloed local sa/da blocks."""
    i = jax.lax.axis_index(axis)
    start = i * B
    sa_ext = _haloed(res_local["sa"], W, axis, nshards)
    da_ext = _haloed(res_local["da"], W, axis, nshards)

    def local_cols(s):
        cols = s[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
        colc = jnp.clip(cols, 0, nr - 1) - start + W
        return jnp.clip(colc, 0, B + 2 * W - 1)

    idx = ops_pipeline._select_ordered(
        res_local["emit"], res_local["e"], res_local["L"], B, M, big=nr)
    s = jnp.take(res_local["s"], idx)
    e = jnp.take(res_local["e"], idx)
    L = jnp.take(res_local["L"], idx)
    colc = local_cols(s)
    out = {
        "count": res_local["emit"].sum(dtype=jnp.int32)[None],
        "s": s, "e": e, "L": L,
        "w_sa": jnp.take(sa_ext, colc),
        "w_da": jnp.take(da_ext, colc).astype(
            ops_pipeline._da_dtype(num_docs)),
    }
    if mem_mode:
        pv_ext = _haloed(res_local["prev_same"], W, axis, nshards)
        out["w_prev"] = jnp.take(pv_ext, colc)
    if need_ctx:
        # rows past the real candidate count carry garbage; the host
        # slices every per-shard block by cand_count before use
        cidx = ops_pipeline._select_ordered(
            res_local["cand"], res_local["e"], res_local["L"], B, M, big=nr)
        cs = jnp.take(res_local["s"], cidx)
        ce = jnp.take(res_local["e"], cidx)
        ccolc = local_cols(cs)
        cols = cs[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
        valid = cols < ce[:, None]
        wda = jnp.take(da_ext, ccolc)
        is0 = valid & (wda == 0)
        has0 = is0.any(axis=1)
        first0 = jnp.argmax(is0, axis=1).astype(jnp.int32)
        sa0_col = jnp.clip(jnp.clip(cs + first0, 0, nr - 1) - start + W,
                           0, B + 2 * W - 1)
        out.update({
            "cand_count": res_local["cand"].sum(dtype=jnp.int32)[None],
            "c_e": ce,
            "c_L": jnp.take(res_local["L"], cidx),
            "c_has0": has0,
            "c_sa0": jnp.take(sa_ext, sa0_col),
            "c_prev": jnp.take(res_local["prev_ctx"], cidx),
            "c_next": jnp.take(res_local["next_ctx"], cidx),
        })
    return out


def compile_seq_pfp_step(mesh, axis: str, nr: int, nd: int, w: int,
                         num_docs: int, lvl_cap: int, max_doc_freq: int,
                         size_cap: int, need_ctx: bool, M: int,
                         mem_mode: bool):
    """jit the sharded expansion step (stages A-D). The dict/parse side
    tables arrive replicated; all O(nr) arrays live sharded over `axis`."""
    nshards = int(mesh.shape[axis])
    assert nshards & (nshards - 1) == 0, "seq axis must be a power of two"
    assert nr % nshards == 0, "row bucket must divide the shard count"
    B = nr // nshards
    M = min(M, B)  # a shard can't hold more boundaries than rows
    W = size_cap
    assert W <= B, "shard blocks must cover one interval width"
    row_sh = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    spec1 = P(axis)
    field_names = ("emit", "cand", "s", "e", "L", "sa", "da",
                   "prev_ctx", "next_ctx", "prev_same")

    def step(parse, d_starts, cumcnt, m, total_rows, n_text, isaP,
             grp_of_pos, d, slt_table, grp_cross, doc_ends,
             min_match_len, num_distinct, max_total_freq):
        grp_tab = ops_pfp._grp_tab(d, grp_of_pos, grp_cross, nd)
        ops = ops_pfp._expand_operands(
            parse, d_starts, cumcnt, m, total_rows, n_text, isaP,
            grp_tab, doc_ends, nr, nd, w, num_docs, lvl_cap)
        ops = tuple(jax.lax.with_sharding_constraint(a, row_sh)
                    for a in ops)
        sorted_ops = jax.shard_map(
            lambda *a: _bitonic_block_sort(a, axis=axis, nshards=nshards,
                                           num_keys=2),
            mesh=mesh, in_specs=(spec1,) * len(ops),
            out_specs=(spec1,) * len(ops))(*ops)
        res, counts = ops_pfp._analyze_sorted(
            sorted_ops, slt_table, nr, nd, w, num_docs, lvl_cap,
            min_match_len, num_distinct, max_total_freq, max_doc_freq,
            size_cap=size_cap, need_ctx=need_ctx)
        local = {k: jax.lax.with_sharding_constraint(res[k], row_sh)
                 for k in field_names}
        windows = jax.shard_map(
            functools.partial(_local_compact, nr=nr, B=B, W=W, M=M,
                              num_docs=num_docs, axis=axis,
                              nshards=nshards, mem_mode=mem_mode,
                              need_ctx=need_ctx),
            mesh=mesh, in_specs=({k: spec1 for k in field_names},),
            out_specs=spec1)(local)
        return counts, windows

    return jax.jit(step, out_shardings=(rep, None))


# per-shard match window capacity of the first pass when M is not given
FIRST_M = 4096


def find_matches_seq_sharded(rb, opts, mesh, axis: str = "seq",
                             pfp_w: int = 10, pfp_mod: int = 100,
                             M: int | None = None,
                             parse_prefix: str | None = None,
                             wide: bool | None = None,
                             shard_dict: bool | None = None,
                             force_gspmd: bool = False):
    """Drop-in engine.find_matches over a seq-sharded mesh (PFP backend),
    byte-identical output to the single-device engine. parse_prefix
    resumes from PREFIX.dict/.parse (-p) — the natural pairing: checkpoint
    the parse once, scan sharded.

    Routing: the DEFAULT formulation is the block-sharded shard_map scan
    (parallel/widepfp.py — explicit per-shard carries, linear total work
    at every scale; it also covers row spaces past 2^31, and composes
    with the distributed dict index). Since round 4 the block scan covers
    EVERY supported size cap (<= 4096: caps <= 128 use the fused windowed
    stencils, larger caps the probe-guarded sparse-table PSV/NSV walks —
    ops/intervals.py — whose touch set fits the size_cap + 1 halo). The
    older GSPMD formulation of stages A/C (below) is retained ONLY as a
    test oracle / explicit opt-in (force_gspmd, MUMEMTO_SEQ_GSPMD=1, or
    the PhrasePackOverflow fallback): GSPMD lowers the O(n) cumulative
    fills with full-window halos — work QUADRATIC in the row count
    (measured: 12 s / 53 s / 545 s at 0.16 / 0.32 / 0.64 Mchar on the
    CPU mesh vs 2 / 4 / 10 s for the block scan — the hazard is in the
    partitioner, not the backend).

    wide: force the uint32-coordinate block path (None = auto: always
    unless force_gspmd; the MUMEMTO_WIDE_ROWS=1 env override is kept for
    tests).

    shard_dict: distribute the dict-side index over the mesh too
    (parallel/sharddict.py) instead of replicating it — same output
    (its tables come back all_gathered, so it composes with both row
    formulations). None = the MUMEMTO_SHARD_DICT=1 env override.

    force_gspmd: pin the GSPMD formulation (tests; also
    MUMEMTO_SEQ_GSPMD=1).

    M: per-shard match window capacity (a compile static). None sizes it
    from the run: a first pass at FIRST_M, and if a shard found more
    matches, one more pass at the capacity it needs. An explicit M that
    overflows raises WindowCapacityError."""
    import os

    from mumemto_tpu import engine
    from mumemto_tpu.parallel.partition import WindowCapacityError

    if M is None:
        kw = dict(axis=axis, pfp_w=pfp_w, pfp_mod=pfp_mod,
                  parse_prefix=parse_prefix, wide=wide,
                  shard_dict=shard_dict, force_gspmd=force_gspmd)
        try:
            return find_matches_seq_sharded(rb, opts, mesh, M=FIRST_M, **kw)
        except WindowCapacityError as e:
            return find_matches_seq_sharded(
                rb, opts, mesh, M=ops_pfp.bucket(e.needed, lo=FIRST_M), **kw)

    size_cap = engine.interval_size_cap(opts, rb.num_docs)
    if size_cap is None or size_cap > 4096:
        raise ValueError("seq-sharded scan requires a bounded interval "
                         "size cap (finite f/F or MUM mode)")
    force_gspmd = force_gspmd or os.environ.get("MUMEMTO_SEQ_GSPMD") == "1"
    if parse_prefix:
        pfp = ops_pfp.pfp_from_parse_files(parse_prefix, w=pfp_w)
    else:
        pfp = ops_pfp.build_pfp(rb.text, w=pfp_w, mod=pfp_mod)
    if shard_dict is None:
        shard_dict = os.environ.get("MUMEMTO_SHARD_DICT") == "1"
    n_rows = int((pfp.phrase_ln[pfp.parse].astype(np.int64)
                  - pfp.w).sum())
    past_31 = ops_pfp.bucket(n_rows) >= 2**31
    if past_31 and (force_gspmd or wide is False):
        # the GSPMD formulation's row coordinates are int32 and would
        # wrap silently (cumcnt/cumC .astype(int32) in _host_prep)
        raise ValueError("row spaces past 2^31 need the block (wide) "
                         "scan; drop wide=False / force_gspmd")
    wide_explicit = wide is True
    if wide is None:
        wide = (past_31 or os.environ.get("MUMEMTO_WIDE_ROWS") == "1"
                or not force_gspmd)
    if wide:
        from mumemto_tpu.parallel import widepfp
        try:
            return widepfp.find_matches_wide(rb, opts, mesh, axis=axis,
                                             M=M, pfp=pfp,
                                             shard_dict=shard_dict)
        except widepfp.PhrasePackOverflow:
            if past_31 or wide_explicit:
                # past 2^31 no int32 path exists; and an EXPLICITLY
                # requested wide=True must not silently degrade to the
                # int32 GSPMD formulation
                raise
            pass  # fall through: GSPMD's unpacked operand tier covers it
    prep = ops_pfp.pfp_scan_prepare(
        pfp, rb.doc_ends, rb.num_docs,
        dict_mesh=(mesh, axis) if shard_dict else None)
    nshards = int(mesh.shape[axis])
    M = min(M, prep["nr"] // nshards)
    step = compile_seq_pfp_step(
        mesh, axis, prep["nr"], prep["nd"], pfp.w, rb.num_docs,
        prep["lvl_cap"], opts.max_doc_freq, size_cap, opts.merge, M,
        mem_mode=not opts.mum_mode)
    counts, windows = step(
        prep["parse"], prep["d_starts"], prep["cumcnt"], prep["m"],
        prep["total_rows"], prep["n_text"], prep["isaP"],
        prep["grp_of_pos"], prep["d"], prep["slt_table"],
        prep["grp_cross"], prep["doc_ends"],
        jnp.int32(opts.min_match_len), jnp.int32(opts.num_distinct),
        jnp.int32(opts.max_total_freq))
    return _assemble_results(rb, opts, counts, windows, nshards, M)


def _assemble_results(rb, opts, counts, windows, nshards: int, M: int):
    """Host-side merge of per-shard windows into MatchResults, reusing the
    single-device emitter code (engine._emit_mums/_emit_mems/
    _merge_thresholds)."""
    from mumemto_tpu import engine

    n_emit, n_cand, n_runs = (int(x) for x in np.asarray(counts))
    win = {k: np.asarray(v) for k, v in windows.items()}
    per_shard = win["count"]
    _check_capacity(per_shard, M, "seq-sharded scan")

    def rows(key, counts):
        """Concatenate the real (count-limited) rows of every shard."""
        a = win[key].reshape((nshards, M) + win[key].shape[1:])
        return np.concatenate(
            [a[i, :int(counts[i])] for i in range(nshards)])

    def shard_rows(key):
        return rows(key, per_shard)

    results = engine.MatchResults(opts=opts, num_docs=rb.num_docs)
    results.bwt_runs = n_runs
    results.text_length = int(rb.text.size) if rb.text is not None else \
        int(sum(rb.seq_lengths))
    doc_offsets, doc_lens = engine._doc_metadata(rb, opts)

    s = shard_rows("s")
    e = shard_rows("e")
    L = shard_rows("L")
    w_sa = shard_rows("w_sa")
    w_da = shard_rows("w_da").astype(np.int32)
    order = np.lexsort((-L, e))
    s, e, L, w_sa, w_da = s[order], e[order], L[order], w_sa[order], \
        w_da[order]
    W = w_sa.shape[1] if w_sa.ndim == 2 else 1
    valid = (s[:, None] + np.arange(W)) < e[:, None]
    if opts.mum_mode:
        engine._emit_mums(results, s, e, L, w_sa, w_da, valid, opts,
                          doc_offsets, doc_lens, rb.num_docs)
    else:
        keep = np.ones(s.size, dtype=bool)
        if opts.max_doc_freq != 1 and s.size:
            w_prev = shard_rows("w_prev")[order]
            unique = (valid & (w_prev < s[:, None])).sum(axis=1)
            keep = unique >= opts.num_distinct
        engine._emit_mems(results, s[keep], e[keep], L[keep],
                          w_sa[keep], w_da[keep], valid[keep], opts,
                          doc_offsets, doc_lens)
    if opts.merge:
        cand_per = win["cand_count"]
        _check_capacity(cand_per, M, "seq-sharded cand windows")

        def cand_rows(key):
            return rows(key, cand_per)

        ce, cL = cand_rows("c_e"), cand_rows("c_L")
        corder = np.lexsort((-cL, ce))
        engine._merge_thresholds(
            results, cand_rows("c_has0")[corder],
            cand_rows("c_sa0")[corder], cand_rows("c_prev")[corder],
            cand_rows("c_next")[corder], doc_offsets, doc_lens)
    return results
