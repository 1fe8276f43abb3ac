"""Multi-device scale-out: the MumemtoM partition scheme as a device mesh.

The reference's only scale-out mechanism is partition-merge ("MumemtoM",
README.md:124-142): run the finder independently per collection partition,
emit per-anchor-position threshold metadata, then merge candidate sets. Here
that becomes a sharded JAX program over a Mesh with axes

  'part' — collection partitions (the reference's per-host runs)
  'seq'  — sequence/SA-row sharding inside one partition

Each partition's index construction + interval scan runs data-parallel under
vmap over the 'part'-sharded batch; reductions across partitions (match
counts, merged anchor thresholds) become XLA collectives inserted by GSPMD.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from mumemto_tpu.ops import suffix as ops_suffix
from mumemto_tpu.ops import intervals as ops_intervals


def make_mesh(n_devices: int | None = None, devices=None):
    """1D/2D mesh over available devices: ('part',) or ('part', 'seq')."""
    devices = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n >= 4 and n % 2 == 0:
        shape, axes = (n // 2, 2), ("part", "seq")
    else:
        shape, axes = (n,), ("part",)
    dev_array = np.asarray(devices).reshape(shape)
    return jax.sharding.Mesh(dev_array, axes)


def _partition_scan(text, doc_ends, num_docs: int, min_match_len, num_distinct):
    """Single-partition pipeline: index construction + MUM interval scan.

    Returns (match_count, longest_match_len, per-position emit mask).
    """
    n = text.shape[0]
    sa, hist, num_lvl = ops_suffix._suffix_array_impl(text, n)
    lcp = ops_suffix._lcp_impl(sa, hist, num_lvl, n)
    bwt = jnp.take(text, (sa + (n - 1)) % n)
    da = jnp.minimum(jnp.searchsorted(doc_ends, sa, side="right"),
                     num_docs).astype(jnp.int32)
    res = ops_intervals.analyze_intervals(
        lcp, da, bwt, n, min_match_len, num_distinct,
        jnp.int32(0), 1)
    emit = res["emit"]
    count = emit.sum(dtype=jnp.int32)
    longest = jnp.max(jnp.where(emit, res["L"], 0))
    return count, longest, emit


def partitioned_step(texts, doc_ends, num_docs: int,
                     min_match_len=20, num_distinct=2):
    """One full data-parallel step over partition-sharded inputs.

    texts: (num_partitions, n) uint8, sharded over 'part'
    doc_ends: (num_partitions, num_docs) int32 end positions per partition

    Returns (total_matches across all partitions, per-partition counts,
    per-partition longest match) — the cross-partition reduction lowers to
    an all-reduce over the 'part' axis.
    """
    counts, longest, _ = jax.vmap(
        lambda t, d: _partition_scan(t, d, num_docs,
                                     jnp.int32(min_match_len),
                                     jnp.int32(num_distinct)))(texts, doc_ends)
    total = counts.sum()
    return total, counts, longest


def compile_partitioned_step(mesh, texts_shape, num_docs: int):
    """jit the partitioned step with explicit shardings over the mesh."""
    spec_in = P("part", "seq") if "seq" in mesh.axis_names else P("part")
    sharding_in = NamedSharding(mesh, spec_in)
    sharding_doc = NamedSharding(mesh, P("part"))
    out_shard = (NamedSharding(mesh, P()),
                 NamedSharding(mesh, P("part")),
                 NamedSharding(mesh, P("part")))
    fn = jax.jit(
        functools.partial(partitioned_step, num_docs=num_docs),
        in_shardings=(sharding_in, sharding_doc),
        out_shardings=out_shard)
    return fn


def _partition_scan_matches(text, doc_ends, num_docs: int, min_match_len,
                            num_distinct, M: int):
    """Per-partition scan returning the compacted match windows
    (ops/pipeline.compact_windows_mum shape contract)."""
    from mumemto_tpu.ops import pipeline as ops_pipeline

    n = text.shape[0]
    sa, hist, num_lvl = ops_suffix._suffix_array_impl(text, n,
                                                      packed_init=True)
    lcp = ops_suffix._lcp_impl(sa, hist, num_lvl, n)
    bwt = jnp.take(text, (sa + (n - 1)) % n)
    da = jnp.minimum(jnp.searchsorted(doc_ends, sa, side="right"),
                     num_docs).astype(jnp.int32)
    # MUM mode (f=1): F clamps to N*f (pfp_mum.hpp:194-196) and the
    # interval size is bounded by the doc count
    res = ops_intervals.analyze_intervals(
        lcp, da, bwt, n, min_match_len, num_distinct,
        jnp.int32(num_docs), 1,
        size_cap=1 << max(int(num_docs).bit_length(), 2))
    res["sa"] = sa
    res["da"] = da
    count = res["emit"].sum(dtype=jnp.int32)
    s, e, L, w_sa, w_da = ops_pipeline.compact_windows_mum(
        res, n, M, num_docs, num_docs)
    return count, s, e, L, w_sa, w_da


class WindowCapacityError(RuntimeError):
    """A compiled fixed-capacity match buffer (M) overflowed; `needed` is
    the capacity that would have held the worst shard."""

    def __init__(self, msg: str, needed: int):
        super().__init__(msg)
        self.needed = needed


def _check_capacity(emit_counts, M: int, what: str):
    """No silent caps: _select_ordered pads/truncates to M entries, so any
    emit count > M would silently drop matches. Verify from the (tiny)
    counts readback and fail loudly with the needed capacity."""
    c = np.atleast_1d(np.asarray(emit_counts))
    worst = int(c.max()) if c.size else 0
    if worst > M:
        raise WindowCapacityError(
            f"{what}: {worst} matches exceed the compiled window capacity "
            f"M={M}; recompile with M >= {worst}", worst)


def compile_sharded_scan(mesh, n: int, num_docs: int,
                         min_match_len: int = 20,
                         num_distinct: int | None = None, M: int = 4096):
    """Sequence-parallel scan of ONE collection: the padded text is sharded
    over the mesh's LAST axis ('seq' when present, else the only axis) and
    the whole index+interval program runs under GSPMD — XLA inserts the
    collectives (the distributed sort is the heavy step). Returns compacted
    MUM windows, identical to the single-device result.

    This is the long-context analog of the reference's partition scheme:
    instead of splitting the COLLECTION across processes, the SA-row space
    of one collection is split across chips.

    Demonstration-scale only (dryrun + tests): under GSPMD the cumulative
    rank fills inside the doubling rounds lower with full-window halos —
    work quadratic in n (the hazard measured in
    seqpfp.find_matches_seq_sharded). Production sharded scans go through
    the PFP block formulation (parallel/widepfp.py) instead."""
    from mumemto_tpu.ops import pipeline as ops_pipeline

    if num_distinct is None:
        num_distinct = num_docs
    axis = mesh.axis_names[-1]
    text_sh = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    def step(text, doc_ends):
        res, counts = ops_pipeline.scan_collection(
            text, doc_ends, n, num_docs,
            jnp.int32(min_match_len), jnp.int32(num_distinct),
            jnp.int32(num_docs), 1,
            size_cap=1 << max(int(num_docs).bit_length(), 2),
            need_ctx=False)
        s, e, L, w_sa, w_da = ops_pipeline.compact_windows_mum(
            res, n, M, num_docs, num_docs)
        return counts, s, e, L, w_sa, w_da

    jitted = jax.jit(step, in_shardings=(text_sh, rep),
                     out_shardings=(rep,) * 6)

    def checked(text, doc_ends):
        out = jitted(text, doc_ends)
        _check_capacity(out[0][0], M, "sharded scan")
        return out

    return checked


def compile_partitioned_matches(mesh, num_docs: int, M: int = 4096,
                                min_match_len: int = 20,
                                num_distinct: int | None = None):
    """jit a partition-parallel step that returns REAL compacted matches
    per partition: (counts[P], s/e/L [P, M], w_sa/w_da [P, M, num_docs]),
    everything sharded over 'part'. The host then applies the writer
    transforms per partition (engine._emit_mums) and the MumemtoM merge."""
    if num_distinct is None:
        num_distinct = num_docs
    spec_in = P("part", "seq") if "seq" in mesh.axis_names else P("part")

    def step(texts, doc_ends):
        return jax.vmap(
            lambda t, de: _partition_scan_matches(
                t, de, num_docs, jnp.int32(min_match_len),
                jnp.int32(num_distinct), M))(texts, doc_ends)

    part = NamedSharding(mesh, P("part"))
    jitted = jax.jit(step,
                     in_shardings=(NamedSharding(mesh, spec_in), part),
                     out_shardings=(part,) * 6)

    def checked(texts, doc_ends):
        out = jitted(texts, doc_ends)
        _check_capacity(out[0], M, "partitioned match scan")
        return out

    return checked
