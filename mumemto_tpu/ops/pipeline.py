"""Fused device pipeline: text -> index -> interval scan -> compacted matches.

Two jitted phases to keep host<->device traffic tiny (device may sit behind
a slow transport):

  scan_collection : one fused program building SA/LCP/BWT/DA and running the
                    interval analysis; returns the device-resident result
                    dict plus scalar counts (the only host readback).
  compact_*       : gather the selected intervals' fields and their SA-row
                    windows into fixed-size (bucketed) arrays on device, so
                    the host only ever receives O(matches) data, never O(n).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from mumemto_tpu.ops import intervals as ops_intervals
from mumemto_tpu.ops import suffix as ops_suffix


@functools.partial(jax.jit, static_argnames=("n", "num_docs", "max_doc_freq",
                                              "size_cap", "need_ctx",
                                              "alpha_thresholds",
                                              "lcp_thresholds"))
def scan_collection(text, doc_ends, n: int, num_docs: int,
                    min_match_len, num_distinct, max_total_freq,
                    max_doc_freq: int, size_cap: int | None = None,
                    need_ctx: bool = True, alpha_thresholds=None,
                    lcp_thresholds=None):
    """Direct (-g) backend. alpha_thresholds/lcp_thresholds: optional
    static alphabet split points enabling the 8-char SA seed (<= 8
    distinct bytes) and the packed 7-char LCP bottom (<= 16) — the same
    levers the PFP dict stage uses (ops/pfp.pfp_scan_prepare). With the
    8-letter seed the LCP also takes the PLCP / irreducible-LCP path
    (~4 O(n) random passes instead of ~2 per doubling level); the
    uncapped history ends with an all-distinct rank row, so the values
    are exact on every real row, and the zero-pad class is pinned to one
    canonical value by canonicalize_pad_lcp in both implementations
    (doc_ends[-1] is the first pad position — pads never reach the
    emitters, but the canonical values keep .lcp checkpoint bytes
    implementation-independent)."""
    sa, hist, num_lvl = ops_suffix._suffix_array_impl(
        text, n, packed_init=True, alpha_thresholds=alpha_thresholds)
    if alpha_thresholds is not None:
        # deep_cap n//4: unlike the PFP dictionary (mostly unique
        # content, ~2-3% deep), the full repetitive text has long
        # run-boundary lcps, so a larger share of the ~r irreducible
        # rows saturates the 9-char probe; past n//4 the lax.cond falls
        # back to the classic full descent (same values)
        lcp, _isa = ops_suffix._lcp_plcp_impl(
            sa, hist, text, n, hist.shape[0], alpha_thresholds,
            deep_cap=max(n // 4, 1024), num_lvl=num_lvl)
    else:
        lcp = ops_suffix._lcp_impl(sa, hist, num_lvl, n, text=text,
                                   bottom_thresholds=lcp_thresholds)
    lcp = ops_suffix.canonicalize_pad_lcp(
        lcp, sa, doc_ends[num_docs - 1] + 1, n)
    bwt = jnp.take(text, (sa + (n - 1)) % n)
    da = jnp.minimum(
        jnp.searchsorted(doc_ends, sa, side="right"), num_docs
    ).astype(jnp.int32)
    res = ops_intervals.analyze_intervals(
        lcp, da, bwt, n, min_match_len, num_distinct, max_total_freq,
        max_doc_freq, size_cap=size_cap, need_ctx=need_ctx)
    res["sa"] = sa
    res["da"] = da
    res["lcp"] = lcp
    res["bwt"] = bwt
    # BWT run count over real rows (the reference's n/r repetitiveness
    # stat, pfp_mum.cpp:148-150); pad rows (da == num_docs) excluded
    real = da < num_docs
    change = (bwt[1:] != bwt[:-1]) & real[1:] & real[:-1]
    nruns = change.sum(dtype=jnp.int32) + 1
    counts = jnp.stack([res["emit"].sum(dtype=jnp.int32),
                        res["cand"].sum(dtype=jnp.int32), nruns])
    return res, counts


def _select_ordered(mask, e, lcp, n: int, M: int, big: int | None = None):
    """Indices of mask=True in reference pop order (e asc, L desc), padded
    with n to M entries. Two-stage: compact the sparse mask rows with
    nonzero (a cumsum+scatter — no O(n) sort), then pop-order the M
    survivors with an M-sized sort. `big` must exceed every real e value
    (defaults to n; pass the global row bucket when e holds GLOBAL row
    ids over a local block, as the seq-sharded compaction does)."""
    if big is None:
        big = n
    idx = jnp.nonzero(mask, size=M, fill_value=n)[0].astype(jnp.int32)
    idxc = jnp.minimum(idx, n - 1)
    real = idx < n
    key_e = jnp.where(real, jnp.take(e, idxc), jnp.int32(big + 1))
    key_l = jnp.where(real, -jnp.take(lcp, idxc), 0)
    _, _, ordered = jax.lax.sort((key_e, key_l, idxc), num_keys=2)
    return ordered


def _da_dtype(num_docs: int):
    """Readback dtype for doc-id windows: int16 only when every doc id
    INCLUDING the num_docs pad sentinel fits (the window width W is NOT a
    bound on the id range — in MEM mode W is the interval size)."""
    return jnp.int16 if num_docs < 32767 else jnp.int32


@functools.partial(jax.jit, static_argnames=("n", "M", "W", "num_docs"))
def compact_windows_mum(res, n: int, M: int, W: int, num_docs: int):
    """MUM-mode compaction: only the fields the host writer consumes, in
    compact dtypes — the device->host link is ~10 MB/s, so the readback
    payload is (4 + 4 + 2) bytes per window cell instead of 17."""
    idx = _select_ordered(res["emit"], res["e"], res["L"], n, M)
    s = jnp.take(res["s"], idx)
    e = jnp.take(res["e"], idx)
    L = jnp.take(res["L"], idx)
    cols = s[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
    colc = jnp.clip(cols, 0, n - 1)
    w_sa = jnp.take(res["sa"], colc)
    w_da = jnp.take(res["da"], colc).astype(_da_dtype(num_docs))
    return s, e, L, w_sa, w_da


@functools.partial(jax.jit, static_argnames=("n", "M", "W", "num_docs"))
def compact_windows_mem(res, n: int, M: int, W: int, num_docs: int):
    """MEM-mode compaction: fields the host emitter consumes, compact
    dtypes (w_da sized by num_docs; prev-same-doc pointers needed for the
    deferred distinct-doc check)."""
    idx = _select_ordered(res["emit"], res["e"], res["L"], n, M)
    s = jnp.take(res["s"], idx)
    e = jnp.take(res["e"], idx)
    L = jnp.take(res["L"], idx)
    cols = s[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
    colc = jnp.clip(cols, 0, n - 1)
    w_sa = jnp.take(res["sa"], colc)
    w_da = jnp.take(res["da"], colc).astype(_da_dtype(num_docs))
    w_prev = jnp.take(res["prev_same"], colc)
    return s, e, L, w_sa, w_da, w_prev


@functools.partial(jax.jit, static_argnames=("n", "M"))
def compact_fields(res, n: int, M: int):
    """Emitted intervals' (s, e, L) in pop order (no windows)."""
    idx = _select_ordered(res["emit"], res["e"], res["L"], n, M)
    s = jnp.take(res["s"], idx)
    e = jnp.take(res["e"], idx)
    L = jnp.take(res["L"], idx)
    # pad slots alias row n-1 after the nonzero rewrite, so derive
    # validity positionally: the pop order packs real rows first
    real = jnp.arange(M) < res["emit"].sum(dtype=jnp.int32)
    return idx, s, e, L, real


@functools.partial(jax.jit, static_argnames=("n", "M", "W"))
def compact_cand_thresh(res, n: int, M: int, W: int):
    """Per-candidate merge-threshold inputs in pop order: the first doc-0
    row's SA value within the window, next_best = min(max(prev,next),cap)
    computed host-side from contexts."""
    idx = _select_ordered(res["cand"], res["e"], res["L"], n, M)
    s = jnp.take(res["s"], idx)
    e = jnp.take(res["e"], idx)
    real = jnp.arange(M) < res["cand"].sum(dtype=jnp.int32)
    cols = s[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
    valid = (cols < e[:, None]) & real[:, None]
    colc = jnp.clip(cols, 0, n - 1)
    w_da = jnp.take(res["da"], colc)
    is0 = valid & (w_da == 0)
    has0 = is0.any(axis=1)
    first0 = jnp.argmax(is0, axis=1)
    w_sa_first0 = jnp.take(
        res["sa"],
        jnp.clip(s + first0.astype(jnp.int32), 0, n - 1))
    prev_ctx = jnp.take(res["prev_ctx"], idx)
    next_ctx = jnp.take(res["next_ctx"], idx)
    return has0 & real, w_sa_first0, prev_ctx, next_ctx


@jax.jit
def _pack_u8(*arrs):
    parts = []
    for a in arrs:
        flat = a.reshape(-1)
        if flat.dtype != jnp.uint8:
            flat = jax.lax.bitcast_convert_type(flat, jnp.uint8)
        parts.append(flat.reshape(-1))
    return jnp.concatenate(parts)


def fetch_packed(*arrs):
    """ONE device->host transfer for several device arrays.

    Naive np.asarray per array costs one synchronous round-trip each, and
    the compaction readbacks are 5-11 small arrays, so they are bound by
    round trips, not bytes. This bitcasts every array to a flat uint8
    payload on device, concatenates, transfers ONCE, and re-views the
    segments on host (bool arrays round-trip as uint8 and are re-viewed
    as bool).

    Returns a list of np.ndarrays matching the inputs' dtypes/shapes."""
    import numpy as np
    metas = []
    conv = []
    for a in arrs:
        dt = np.dtype(a.dtype)
        if dt == np.bool_:
            a = a.astype(jnp.uint8)
        metas.append((dt, a.shape))
        conv.append(a)
    flat = np.asarray(_pack_u8(*conv))
    out = []
    off = 0
    for dt, sh in metas:
        nb = int(dt.itemsize * int(np.prod(sh, dtype=np.int64)))
        seg = flat[off:off + nb]
        if dt == np.bool_:
            out.append(seg.view(np.uint8).astype(np.bool_).reshape(sh))
        else:
            # 1D uint8 slices may start misaligned for wider dtypes;
            # frombuffer over a private copy keeps the view legal
            out.append(np.frombuffer(seg.tobytes(), dtype=dt).reshape(sh))
        off += nb
    return out


def bucket(m: int, lo: int = 256) -> int:
    """0.75/1.0-of-power-of-two bucket for compaction sizes (tighter than
    pure powers of two: the padding rows are readback waste)."""
    m = max(m, 1)
    p = 1 << (m - 1).bit_length()
    if p // 2 + p // 4 >= m:
        p = p // 2 + p // 4
    return max(lo, p)
