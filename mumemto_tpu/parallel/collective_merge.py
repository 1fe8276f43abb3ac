"""Collective (device-side) MumemtoM anchor merge.

The reference's anchor merge is a sequential per-host left-fold over
partition files (src/merge_candidates.cpp:211-219; fold core :106-157).
SURVEY §2.3 names the accelerator-native formulation: all_gather the
per-partition anchor metadata (MUM bitvector, lengths, thresholds) across
the mesh — over the network across hosts, over NVLink within one — then
run the merge scan as a
vectorized zip over anchor positions on device. This module implements
exactly that.

Key reduction (proved by induction over the fold): the fold's future
behavior depends ONLY on the dense per-anchor-position state

    bv[p]      a merged MUM starts at anchor position p
    len_at[p]  its length (0 if none)
    nb[p]      merged next-best threshold

because the fold's searchsorted/delta arithmetic reads only the ANCHOR
column of the offsets, and anchor starts/trims are position-local. The
non-anchor offset columns are path-independent given the final (p, L):
'+' columns accumulate left-trims summing to p - original_start, '-'
columns accumulate right-trims summing to (len_k - delta_k) - L. So the
device fold carries three dense arrays per partition, and the host
recomposes full offset/strand matrices afterwards from the ORIGINAL
partitions — byte-identical to analysis/merge.anchor_merge (pinned by
tests/test_collective_merge.py and __graft_entry__.dryrun_multichip).

The fold itself is elementwise over anchor positions plus two
forward-fill gathers per step — O(P * n_anchor) device work, with ONE
all_gather as the only communication.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from mumemto_tpu.analysis import merge as host_merge

MIN_MERGE_LEN = host_merge.MIN_MERGE_LEN


def _fold_pair(state, part):
    """One anchor-merge fold on dense device arrays
    (merge_candidates.cpp:106-157 as a vectorized zip over positions)."""
    bv1, nb1, len1 = state
    bv2, nb2, len2 = part
    n = bv1.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)

    new_nb = jnp.where((nb1 > 0) & (nb2 > 0), jnp.maximum(nb1, nb2), 0)
    check = (bv1 | bv2) & (nb1 > 0) & (nb2 > 0)

    def side(bv, len_at):
        # current MUM at p = last start <= p (the searchsorted-right - 1)
        cur = jax.lax.cummax(jnp.where(bv, idx, -1))
        delta = idx - cur
        cur_len = jnp.take(len_at, jnp.maximum(cur, 0))
        covered = (cur >= 0) & (delta <= cur_len)
        return covered, cur_len - delta

    cov1, s1 = side(bv1, len1)
    cov2, s2 = side(bv2, len2)
    new_len = jnp.minimum(s1, s2)
    emit = (check & cov1 & cov2 & (new_len > new_nb)
            & (new_len >= MIN_MERGE_LEN))
    return (emit, new_nb, jnp.where(emit, new_len, 0))


@functools.partial(jax.jit, static_argnames=("n_parts",))
def _fold_all(bv_all, nb_all, len_all, n_parts: int):
    """Left-fold partitions 0..n_parts-1 (stacked (P, n_anchor) arrays).

    Also returns the intermediate state bitvectors (one per fold): the
    host needs them to trace each final MUM's emit-position CHAIN back
    through the folds — with overlapping anchor MUMs, the originating
    MUM in partition k is its cover at the fold-k emit position, which
    can differ from its cover at the final position."""
    state = (bv_all[0], nb_all[0], len_all[0])
    inter_bv = []
    for k in range(1, n_parts):
        state = _fold_pair(state, (bv_all[k], nb_all[k], len_all[k]))
        inter_bv.append(state[0])
    return state + (jnp.stack(inter_bv) if inter_bv
                    else jnp.zeros((0,) + bv_all.shape[1:], bool),)


def compile_collective_merge(mesh, axis: str, n_anchor: int, n_parts: int):
    """jit the collective fold: each device holds ONE partition's dense
    anchor arrays; one all_gather over `axis` (DCN across hosts) makes
    every device hold all partitions, then the fold replicates. Output is
    the final (bv, nb, len_at), replicated."""
    assert int(mesh.shape[axis]) == n_parts

    def body(bv_loc, nb_loc, len_loc):
        bv_all = jax.lax.all_gather(bv_loc[0], axis)
        nb_all = jax.lax.all_gather(nb_loc[0], axis)
        len_all = jax.lax.all_gather(len_loc[0], axis)
        return _fold_all(bv_all, nb_all, len_all, n_parts)

    spec = P(axis)
    # outputs ARE replicated (every device folds the same all_gathered
    # stack) but the static replication checker can't see through the
    # elementwise fold — disable the varying-manual-axes check
    fn = jax.shard_map(body, mesh=mesh,
                       in_specs=(spec, spec, spec),
                       out_specs=(P(), P(), P(), P()),
                       check_vma=False)
    rep = NamedSharding(mesh, P())
    return jax.jit(fn, out_shardings=(rep, rep, rep, rep))


def _dense_arrays(parts, n_anchor: int):
    """Per-partition dense (bv, nb, len_at) stacks from parse_candidate
    tuples. len_at's last-write-wins matches the host's
    searchsorted-right - 1 pick among equal starts."""
    n_parts = len(parts)
    bv_all = np.zeros((n_parts, n_anchor), dtype=bool)
    nb_all = np.zeros((n_parts, n_anchor), dtype=np.int32)
    len_all = np.zeros((n_parts, n_anchor), dtype=np.int32)
    for k, (lengths, starts, _strands, bv, nb) in enumerate(parts):
        if nb.size != n_anchor:
            raise ValueError("anchor length mismatch across partitions")
        # the device fold runs in int32 while the host fold it must match
        # byte-for-byte runs in int64 — refuse (rather than silently wrap)
        # thresholds/lengths past int32, like the widepfp guards do
        if nb.size and (int(np.max(nb)) >= 2**31
                        or (lengths.size and int(np.max(lengths)) >= 2**31)):
            raise ValueError(
                f"partition {k}: anchor thresholds/lengths >= 2^31 exceed "
                "the collective fold's int32 operands — use the host fold "
                "(merge without --collective)")
        bv_all[k] = bv
        nb_all[k] = nb
        len_all[k, starts[:, 0]] = lengths
    return bv_all, nb_all, len_all


def _recompose(parts, inter_bv, pos, lengths):
    """Full offset/strand matrices for merged MUMs at anchor positions
    `pos` with final `lengths`, from the ORIGINAL partitions.

    The originating MUM of partition j is its cover at the fold-j emit
    position i_j, traced right-to-left through the intermediate state
    bitvectors: i_{P-1} = pos; i_{j-1} = state_{j-1}-cover(i_j). Offsets
    are then path-independent (trims telescope): '+' columns shift by
    pos - start, '-' columns by (len - (pos - start)) - L."""
    n_parts = len(parts)
    m = [None] * n_parts
    i = pos.copy()
    for j in range(n_parts - 1, 0, -1):
        sj = parts[j][1][:, 0]
        m[j] = np.searchsorted(sj, i, side="right") - 1
        # state_{j-1}: after fold j-1 (inter_bv[j-2]) or partition 0's bv
        state_pos = np.flatnonzero(inter_bv[j - 2]) if j >= 2 else \
            np.flatnonzero(parts[0][3])
        i = state_pos[np.searchsorted(state_pos, i, side="right") - 1] \
            if i.size else i
    m[0] = np.searchsorted(parts[0][1][:, 0], i, side="right") - 1

    out_starts = []
    out_strands = []
    for k, (lk, sk, tk, _bv, _nb) in enumerate(parts):
        mk = m[k]
        delta = pos - sk[mk, 0]
        trim_minus = (lk[mk] - delta) - lengths
        off = sk[mk] + np.where(tk[mk], delta[:, None],
                                trim_minus[:, None])
        cols = slice(None) if k == 0 else slice(1, None)
        out_starts.append(off[:, cols])
        out_strands.append(tk[mk][:, cols])
    return (np.concatenate(out_starts, axis=1),
            np.concatenate(out_strands, axis=1))


def collective_anchor_merge(mum_files, output: str, mesh=None,
                            axis: str = "part", verbose: bool = False):
    """Drop-in analysis/merge.anchor_merge with the fold on device.

    mesh: a Mesh whose `axis` has exactly len(mum_files) devices; None
    builds one over the first len(mum_files) local devices, or — when
    fewer are addressable (a 1-chip host) — runs the same fold program
    on device 0 over the host-stacked arrays (no all_gather)."""
    import os
    import sys

    from mumemto_tpu import formats
    from mumemto_tpu.analysis.mumdata import MUMdata

    parts = [host_merge.parse_candidate(p) for p in mum_files]
    n_anchor = parts[0][4].size
    n_parts = len(parts)
    single_device = False
    if mesh is None:
        # local devices only: on a multi-host deployment this merge runs
        # in ONE process (dcn.py's rank 0) — a mesh over jax.devices()
        # would include other processes' non-addressable devices and the
        # single-process shard_map launch over it fails
        devs = jax.local_devices()
        if len(devs) < n_parts:
            # fewer devices than partitions (e.g. a 1-chip host): run the
            # SAME _fold_all program on device 0 over the host-stacked
            # arrays — no all_gather, byte-identical output (the
            # collective form only changes where the stack comes from)
            single_device = True
        else:
            mesh = jax.sharding.Mesh(
                np.asarray(devs[:n_parts]).reshape(n_parts), (axis,))
    if verbose:
        print(f"collective anchor merge: {n_parts} partitions x "
              f"{n_anchor} anchor positions"
              + (" (single-device fold: fewer devices than partitions)"
                 if single_device else ""), file=sys.stderr)

    bv_all, nb_all, len_all = _dense_arrays(parts, n_anchor)
    if single_device:
        bv_f, nb_f, len_f, inter_bv = _fold_all(
            jnp.asarray(bv_all), jnp.asarray(nb_all), jnp.asarray(len_all),
            n_parts)
    else:
        fn = compile_collective_merge(mesh, axis, n_anchor, n_parts)
        bv_f, nb_f, len_f, inter_bv = fn(
            jnp.asarray(bv_all), jnp.asarray(nb_all), jnp.asarray(len_all))
    bv_f = np.asarray(bv_f)
    nb_f = np.asarray(nb_f).astype(np.int64)
    len_f = np.asarray(len_f)
    inter_bv = np.asarray(inter_bv)

    pos = np.flatnonzero(bv_f)
    lengths = len_f[pos].astype(np.int64)
    starts, strands = _recompose(parts, inter_bv, pos, lengths)

    out_path = output
    if not out_path.endswith((".mums", ".bumbl")):
        out_path += ".mums"
    base = out_path[:-6] if out_path.endswith(".bumbl") else out_path[:-5]
    md = MUMdata.from_arrays(lengths.astype(np.uint32), starts, strands)
    if out_path.endswith(".bumbl"):
        md.write_bums(out_path)
    else:
        md.write_mums(out_path)
    formats.write_thresh(base + ".athresh", nb_f)
    return out_path
