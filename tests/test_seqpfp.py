"""Seq-sharded PFP scan == single-device engine, byte for byte.

Shard-count sweep (1/2/4/8), partial-MUM, MEM mode, and merge metadata —
the cross-shard hazards live at block boundaries (SURVEY.md §7.3 #4), so
every config uses inputs large enough that matches span shard boundaries.
"""

import numpy as np
import pytest

import jax

from mumemto_tpu import engine, options, refbuilder
from mumemto_tpu.parallel import seqpfp
from tests.conftest import mutated_collection, rand_seq


def _mesh(nshards):
    devs = np.asarray(jax.devices()[:nshards]).reshape(nshards)
    return jax.sharding.Mesh(devs, ("seq",))


def _compare(rb, opts, nshards, M=4096):
    want = engine.find_matches(rb, opts, backend="pfp").output_bytes()
    got = seqpfp.find_matches_seq_sharded(
        rb, opts, _mesh(nshards), M=M).output_bytes()
    assert want == got
    return want


@pytest.mark.parametrize("nshards", [1, 2, 4, 8])
def test_seqpfp_shard_sweep(rng, nshards):
    docs = mutated_collection(rng, 4, base_len=900)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, quiet=True)
    assert _compare(rb, opts, nshards)


def test_seqpfp_partial_mums(rng):
    docs = mutated_collection(rng, 5, base_len=700)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, num_distinct_docs=-1, quiet=True)
    assert _compare(rb, opts, 4)


def test_seqpfp_mems(rng):
    rep = rand_seq(rng, 60)
    docs = mutated_collection(rng, 4, base_len=500, insert_rep=rep)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, rare_freq=2, quiet=True)
    assert _compare(rb, opts, 4)


def test_seqpfp_merge_metadata(rng):
    docs = mutated_collection(rng, 3, base_len=800)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, merge=True, quiet=True)
    single = engine.find_matches(rb, opts, backend="pfp")
    sharded = seqpfp.find_matches_seq_sharded(rb, opts, _mesh(4))
    assert single.output_bytes() == sharded.output_bytes()
    assert (single.candidate_thresh == sharded.candidate_thresh).all()
    dl0 = int(engine._doc_metadata(rb, opts)[1][0])
    fo, ro = engine.thresh_arrays(single, dl0)
    fs, rs = engine.thresh_arrays(sharded, dl0)
    assert (fo == fs).all()
    assert (ro == rs).all()


def test_seqpfp_capacity_overflow(rng):
    from mumemto_tpu.parallel.partition import WindowCapacityError
    docs = mutated_collection(rng, 3, base_len=900)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, quiet=True)
    with pytest.raises(WindowCapacityError):
        seqpfp.find_matches_seq_sharded(rb, opts, _mesh(2), M=4)


def test_seqpfp_capacity_sized_from_run(rng, monkeypatch):
    """Without an explicit M, a shard that overflows the first pass's
    window capacity is rerun at the capacity it needs: same bytes."""
    from mumemto_tpu.parallel.partition import WindowCapacityError
    docs = mutated_collection(rng, 3, base_len=900)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, quiet=True)
    monkeypatch.setattr(seqpfp, "FIRST_M", 1)
    with pytest.raises(WindowCapacityError):  # the first pass overflows
        seqpfp.find_matches_seq_sharded(rb, opts, _mesh(2), M=1)
    want = engine.find_matches(rb, opts, backend="pfp").output_bytes()
    got = seqpfp.find_matches_seq_sharded(rb, opts, _mesh(2))
    assert got.output_bytes() == want


def test_cli_seq_shards(rng, tmp_path):
    """--seq-shards N through the full CLI surface == single-device run."""
    from mumemto_tpu import cli
    docs = mutated_collection(rng, 3, base_len=600)
    paths = []
    for i, d in enumerate(docs):
        p = tmp_path / f"c{i}.fa"
        p.write_text(f">c{i}\n{d[0]}\n")
        paths.append(str(p))
    assert cli.main(paths + ["-o", str(tmp_path / "single")]) == 0
    assert cli.main(paths + ["-o", str(tmp_path / "sharded"),
                             "--seq-shards", "4"]) == 0
    assert (tmp_path / "single.mums").read_bytes() == \
        (tmp_path / "sharded.mums").read_bytes()


def test_seqpfp_midsize_boundary_stress(rng):
    """~160 Kb collection over 8 shards: thousands of rows per block, long
    matches guaranteed to span shard boundaries (the SURVEY §7.3 #4 hazard
    class), byte-equal to single-device."""
    docs = mutated_collection(rng, 4, base_len=20000, n_mut=30)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, quiet=True)
    _compare(rb, opts, 8, M=8192)


@pytest.mark.slow
def test_seqpfp_chr_scale_boundary_stress(rng):
    """~2 Mchar (1 Mbp fwd + revcomp) over 8 shards:
    realistic per-shard block sizes (~260 K rows), thousands of matches
    spanning shard boundaries, byte-equal to single-device. Runs on the
    default block-sharded scan — the GSPMD formulation is quadratic in
    the row count and is pinned separately at small size
    (test_seqpfp_gspmd_formulation, test_sharddict)."""
    n_docs, base_len = 4, 250_000
    docs = _snp_collection(rng, n_docs, base_len)
    rb = refbuilder.build_from_sequences(docs)
    assert rb.text.size >= 8 * base_len
    opts = options.normalize(rb.num_docs, quiet=True)
    res = engine.find_matches(rb, opts, backend="pfp")
    assert res.num_matches >= 1000, res.num_matches
    want = res.output_bytes()
    got = seqpfp.find_matches_seq_sharded(
        rb, opts, _mesh(8), M=8192).output_bytes()
    assert want == got


def _snp_collection(rng, n_docs, base_len, rate=400):
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    base = rng.integers(0, 4, base_len, dtype=np.int8)
    docs = []
    for _ in range(n_docs):
        s = base.copy()
        pos = rng.integers(0, base_len, max(8, base_len // rate))
        s[pos] = (s[pos] + rng.integers(1, 4, pos.size)) % 4
        docs.append([bytes(acgt[s])])
    return docs


def test_seqpfp_gspmd_formulation(rng):
    """The retained GSPMD formulation (size caps > 128 / sharded dict):
    byte-equal to both the single-device engine and the default block
    scan."""
    docs = _snp_collection(rng, 4, 4000)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, quiet=True)
    want = engine.find_matches(rb, opts, backend="pfp").output_bytes()
    got_g = seqpfp.find_matches_seq_sharded(
        rb, opts, _mesh(4), force_gspmd=True).output_bytes()
    got_b = seqpfp.find_matches_seq_sharded(rb, opts, _mesh(4)).output_bytes()
    assert want == got_g
    assert want == got_b


@pytest.mark.slow
def test_seqpfp_sharddict_midsize(rng):
    """Distributed dict index composed with BOTH row formulations
    (block default; GSPMD pinned) at midsize, byte-equal to
    single-device."""
    docs = _snp_collection(rng, 4, 20_000)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, quiet=True)
    want = engine.find_matches(rb, opts, backend="pfp").output_bytes()
    got = seqpfp.find_matches_seq_sharded(
        rb, opts, _mesh(8), M=8192, shard_dict=True).output_bytes()
    assert want == got
    got_g = seqpfp.find_matches_seq_sharded(
        rb, opts, _mesh(8), M=8192, shard_dict=True,
        force_gspmd=True).output_bytes()
    assert want == got_g


def test_seqpfp_cap256_many_docs(rng):
    """A >128-doc MUM-mode
    collection (size cap 256) runs on the DEFAULT block scan — the
    probe-guarded sparse-table walks inside the halo — byte-equal to the
    single-device engine AND to the trusted oracle (the single-device
    non-windowed analyzer changed too: guarded walks + width rejection +
    walk-based leftmost dedup). The reference's envelope is 65535 docs
    (pfp_mum.hpp:35-36); the old routing fell off to the quadratic GSPMD
    formulation past 128 docs."""
    from mumemto_tpu.oracle import naive
    docs = _conserved_collection(rng, 130)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, quiet=True)
    assert engine.interval_size_cap(opts, rb.num_docs) == 256
    want = naive.oracle_output(rb, opts)
    single = engine.find_matches(rb, opts, backend="pfp")
    assert single.num_matches > 0
    assert single.output_bytes() == want
    got = seqpfp.find_matches_seq_sharded(
        rb, opts, _mesh(4)).output_bytes()
    assert got == want


def _conserved_collection(rng, n_docs, n_cores=3, core_len=45,
                          unique_len=40):
    """n_docs docs sharing n_cores conserved cores (each occurring once
    per doc, in order) separated by per-doc unique sequence — strict
    multi-MUMs exist at ANY doc count, unlike uniform SNP collections
    where >~100 docs mutate every window somewhere."""
    cores = [rand_seq(rng, core_len) for _ in range(n_cores)]
    docs = []
    for _ in range(n_docs):
        parts = []
        for c in cores:
            parts.append(rand_seq(rng, unique_len))
            parts.append(c)
        parts.append(rand_seq(rng, unique_len))
        docs.append(["".join(parts)])
    return docs


def test_seqpfp_cap256_partial_many_docs(rng):
    """Partial multi-MUMs (-k -1) over >128 docs on the block scan."""
    docs = _conserved_collection(rng, 140)
    # knock a piece of core 1 (positions [40, 85) of every doc) out of one
    # doc so a (N-1)-doc partial MUM exists
    docs[7][0] = docs[7][0].replace(docs[0][0][45:70], "")
    assert len(docs[7][0]) < len(docs[0][0])
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, num_distinct_docs=-1, quiet=True)
    assert engine.interval_size_cap(opts, rb.num_docs) == 256
    single = engine.find_matches(rb, opts, backend="pfp")
    assert single.num_matches > 0
    assert _compare(rb, opts, 4) == single.output_bytes()


def test_seqpfp_cap1024_mem_mode(rng):
    """Size cap 1024 (unlimited
    per-doc frequency, F = 1000) through the block scan, byte-equal to
    single-device, the oracle, and the retained GSPMD test oracle."""
    from mumemto_tpu.oracle import naive
    rep = rand_seq(rng, 50)
    docs = mutated_collection(rng, 4, base_len=400, insert_rep=rep)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, rare_freq=0, max_mem_freq=1000,
                             quiet=True)
    assert engine.interval_size_cap(opts, rb.num_docs) == 1024
    want = naive.oracle_output(rb, opts)
    single = engine.find_matches(rb, opts, backend="pfp").output_bytes()
    assert single == want
    got = seqpfp.find_matches_seq_sharded(
        rb, opts, _mesh(2)).output_bytes()
    assert got == want
    got_g = seqpfp.find_matches_seq_sharded(
        rb, opts, _mesh(2), force_gspmd=True).output_bytes()
    assert got_g == want


def test_seqpfp_cap256_merge_metadata(rng):
    """Merge thresholds (prev/next ctx via the guarded-walk gathers) at
    cap 256 — merge requires strict-MUM mode, so >128 docs — on the block
    scan == single-device."""
    docs = _conserved_collection(rng, 130)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, merge=True, quiet=True)
    assert engine.interval_size_cap(opts, rb.num_docs) == 256
    single = engine.find_matches(rb, opts, backend="pfp")
    assert single.num_matches > 0
    sharded = seqpfp.find_matches_seq_sharded(rb, opts, _mesh(2))
    assert single.output_bytes() == sharded.output_bytes()
    assert (single.candidate_thresh == sharded.candidate_thresh).all()


def test_cli_seq_shards_parse_resume(rng, tmp_path):
    """-P checkpoint, then -p resume SHARDED == single-device resume."""
    from mumemto_tpu import cli
    docs = mutated_collection(rng, 3, base_len=600)
    paths = []
    for i, d in enumerate(docs):
        p = tmp_path / f"r{i}.fa"
        p.write_text(f">r{i}\n{d[0]}\n")
        paths.append(str(p))
    ck = str(tmp_path / "ck")
    assert cli.main(paths + ["-o", ck, "-P"]) == 0
    assert cli.main(["-p", ck, "-o", str(tmp_path / "single")]) == 0
    assert cli.main(["-p", ck, "-o", str(tmp_path / "sharded"),
                     "--seq-shards", "4"]) == 0
    assert (tmp_path / "single.mums").read_bytes() == \
        (tmp_path / "sharded.mums").read_bytes()


def test_library_seq_shards(rng):
    """library.mum(seq_shards=N) == single-device library result."""
    from mumemto_tpu import library
    docs = mutated_collection(rng, 3, base_len=500)
    single = library.mum(docs)
    sharded = library.mum(docs, seq_shards=4)
    assert len(single) == len(sharded)
    for i in range(len(single)):
        L1, o1, s1 = single.match_at(i)
        L2, o2, s2 = sharded.match_at(i)
        assert L1 == L2 and (o1 == o2).all() and (s1 == s2).all()
    with pytest.raises(ValueError):
        library.mum(docs, seq_shards=3)
