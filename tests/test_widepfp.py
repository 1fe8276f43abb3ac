"""Wide-coordinate (uint32) seq-sharded scan: byte-equal to the engine,
and exact at synthetic row bases beyond 2^31.

Two layers of evidence, neither needing 2 G-row allocations:
  * forced-wide end-to-end runs == single-device engine bytes across
    shard counts and modes (the full u32 pipeline on small inputs);
  * the offset-shift unit test: the per-shard operand builder fed the
    SAME metadata translated by 2^31 + delta rows must reproduce the
    base-0 operands exactly, with ssa shifted — pinning the modular-u32
    carry/fill/searchsorted arithmetic in the >2^31 regime.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mumemto_tpu import engine, options, refbuilder
from mumemto_tpu.ops import pfp as ops_pfp
from mumemto_tpu.parallel import seqpfp, widepfp
from tests.conftest import mutated_collection, rand_seq


def _mesh(nshards):
    devs = np.asarray(jax.devices()[:nshards]).reshape(nshards)
    return jax.sharding.Mesh(devs, ("seq",))


def _compare(rb, opts, nshards, M=4096):
    want = engine.find_matches(rb, opts, backend="pfp").output_bytes()
    got = widepfp.find_matches_wide(rb, opts, _mesh(nshards),
                                    M=M).output_bytes()
    assert want == got
    return want


@pytest.mark.parametrize("nshards", [1, 2, 4, 8])
def test_wide_shard_sweep(rng, nshards):
    docs = mutated_collection(rng, 4, base_len=900)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, quiet=True)
    assert _compare(rb, opts, nshards)


def test_wide_partial_mums(rng):
    docs = mutated_collection(rng, 5, base_len=700)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, num_distinct_docs=-1, quiet=True)
    assert _compare(rb, opts, 4)


def test_wide_mems(rng):
    rep = rand_seq(rng, 60)
    docs = mutated_collection(rng, 4, base_len=500, insert_rep=rep)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, rare_freq=2, quiet=True)
    assert _compare(rb, opts, 4)


def test_wide_merge_metadata(rng):
    docs = mutated_collection(rng, 3, base_len=800)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, merge=True, quiet=True)
    single = engine.find_matches(rb, opts, backend="pfp")
    sharded = widepfp.find_matches_wide(rb, opts, _mesh(4))
    assert single.output_bytes() == sharded.output_bytes()
    assert (single.candidate_thresh == sharded.candidate_thresh).all()
    dl0 = int(engine._doc_metadata(rb, opts)[1][0])
    fo, ro = engine.thresh_arrays(single, dl0)
    fs, rs = engine.thresh_arrays(sharded, dl0)
    assert (fo == fs).all()
    assert (ro == rs).all()


def test_wide_env_routing(rng, monkeypatch):
    """MUMEMTO_WIDE_ROWS=1 routes find_matches_seq_sharded through the
    wide path (auto-routing also fires at row buckets >= 2^31)."""
    monkeypatch.setenv("MUMEMTO_WIDE_ROWS", "1")
    docs = mutated_collection(rng, 3, base_len=600)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, quiet=True)
    want = engine.find_matches(rb, opts, backend="pfp").output_bytes()
    got = seqpfp.find_matches_seq_sharded(
        rb, opts, _mesh(2)).output_bytes()
    assert want == got


def _prep_u32(rb, opts):
    pfp = ops_pfp.build_pfp(rb.text, w=10, mod=100)
    return pfp, ops_pfp.pfp_scan_prepare(pfp, rb.doc_ends, rb.num_docs,
                                         row_dtype=np.uint32)


def test_block_operands_past_2_31(rng):
    """The offset-shift trick: translate the whole row space by
    DELTA = 2^31 + 12345 via a synthetic occurrence 0 spanning [0, DELTA),
    then build operands for the block at base + DELTA. key1/key2/sufbwt/da
    must equal the untranslated block's and ssa must equal old + DELTA —
    i.e. the u32 fills, carries and searchsorted are exact past 2^31."""
    docs = mutated_collection(rng, 3, base_len=400)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, quiet=True)
    pfp, prep = _prep_u32(rb, opts)
    B = 512
    DELTA = np.uint32(2**31 + 12345)
    nd, w = prep["nd"], prep["w"]
    num_docs = rb.num_docs

    cumcnt = np.asarray(prep["cumcnt"])
    mp1 = cumcnt.shape[0]
    # translated metadata: occurrence 0 becomes a phantom covering
    # [0, DELTA); every real occurrence and doc boundary shifts up
    cum2 = np.zeros(mp1 + 1, np.uint32)
    cum2[1:] = cumcnt + DELTA
    parse2 = np.concatenate([[1], np.asarray(prep["parse"])]).astype(np.int32)
    k2 = np.asarray(prep["isaP"])
    # the builder reads isaP[j+1] per occurrence j; prepend a slot so the
    # phantom occurrence 0 maps onto old occurrence 0's successor chain
    isaP2 = np.concatenate([[0], k2]).astype(np.int32)
    de2 = (np.asarray(prep["doc_ends"]) + DELTA).astype(np.uint32)

    from mumemto_tpu.ops import pfp as ops_pfp
    grp_tab = ops_pfp._grp_tab(prep["d"], prep["grp_of_pos"],
                               prep["grp_cross"], nd)
    lvl_cap = prep["lvl_cap"]
    pack_cross = 2 * lvl_cap + 7 <= 31
    assert pack_cross  # test shape must exercise the packed default

    def build(base, parse, cumcnt_, m, total_rows, n_text, isaP_, de):
        f = jax.jit(widepfp._block_operands,
                    static_argnames=("B", "nd", "w", "num_docs",
                                     "lvl_cap", "pack_cross"))
        return f(jnp.uint32(base), jnp.asarray(parse),
                 jnp.asarray(d_starts), jnp.asarray(cumcnt_),
                 jnp.int32(m), jnp.uint32(total_rows),
                 jnp.uint32(n_text), jnp.asarray(isaP_),
                 grp_tab, jnp.asarray(de),
                 B=B, nd=nd, w=w, num_docs=num_docs,
                 lvl_cap=lvl_cap, pack_cross=pack_cross)

    d_starts = np.asarray(prep["d_starts"])
    m = int(prep["m"])
    total_rows = int(np.asarray(prep["total_rows"]))
    n_text = int(np.asarray(prep["n_text"]))

    for base in (0, 137, B, total_rows - B // 2):
        ref = build(np.uint32(base), np.asarray(prep["parse"]), cumcnt,
                    m, total_rows, n_text, k2, np.asarray(prep["doc_ends"]))
        shifted = build(np.uint32(base) + DELTA, parse2, cum2, m + 1,
                        np.uint32(total_rows) + DELTA,
                        np.uint32(n_text) + DELTA, isaP2, de2)
        k1a, k2a, ssa_a, sb_a, da_a = (np.asarray(x) for x in ref)
        k1b, k2b, ssa_b, sb_b, da_b = (np.asarray(x) for x in shifted)
        # rows that are real in BOTH runs must agree exactly
        real = (np.arange(B) + base) < total_rows
        assert (k1a == k1b).all(), f"key1 mismatch at base={base}"
        assert (k2a[real] == k2b[real]).all()
        assert (sb_a[real] == sb_b[real]).all()
        assert (da_a[real] == da_b[real]).all()
        got = ssa_b[real].astype(np.int64) - int(DELTA)
        assert (got == ssa_a[real].astype(np.int64)).all()
        assert (ssa_b[real] > 2**31).all()  # genuinely past int32


def test_wide_midsize_boundary_stress(rng):
    """~160 Kb collection over 8 shards in wide mode: long matches span
    shard boundaries; byte-equal to single-device."""
    docs = mutated_collection(rng, 4, base_len=20000, n_mut=30)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, quiet=True)
    _compare(rb, opts, 8, M=8192)
