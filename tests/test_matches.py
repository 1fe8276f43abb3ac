"""Golden equivalence: JAX engine output == trusted oracle, byte for byte."""

import numpy as np
import pytest

from mumemto_tpu import engine, options, refbuilder
from mumemto_tpu.oracle import naive
from tests.conftest import mutated_collection, rand_seq


def _assert_equal(rb, opts):
    want = naive.oracle_output(rb, opts)
    got = engine.find_matches(rb, opts).output_bytes()
    assert want == got, (
        f"engine/oracle mismatch\nwant[:300]={want[:300]!r}\ngot[:300]={got[:300]!r}")
    return want


@pytest.mark.parametrize("use_revcomp", [True, False])
@pytest.mark.parametrize("k", [0, -1, 2])
def test_mums_match_oracle(rng, use_revcomp, k):
    docs = mutated_collection(rng, int(rng.integers(2, 5)))
    rb = refbuilder.build_from_sequences(docs, use_revcomp=use_revcomp)
    opts = options.normalize(rb.num_docs, num_distinct_docs=k,
                             use_revcomp=use_revcomp, quiet=True)
    out = _assert_equal(rb, opts)
    assert out  # matches exist by construction


@pytest.mark.parametrize("k,f,F", [(0, 2, 0), (0, 3, 0), (2, 2, 0),
                                   (0, 0, 0), (0, 2, -1)])
def test_mems_match_oracle(rng, k, f, F):
    rep = rand_seq(rng, 60)
    docs = mutated_collection(rng, 3, base_len=150, insert_rep=rep)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, num_distinct_docs=k, rare_freq=f,
                             max_mem_freq=F, quiet=True)
    _assert_equal(rb, opts)


def test_mum_properties(rng):
    """Oracle-free property check: exact occurrence, per-doc uniqueness,
    and one-character maximality on BOTH sides of every reported MUM
    (mumemto_tpu/properties.py; breaks the oracle-circularity of the
    byte-equality tests)."""
    from mumemto_tpu import properties

    docs = mutated_collection(rng, 3)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, quiet=True)
    res = engine.find_matches(rb, opts)
    assert res.num_matches > 0
    assert properties.check_mum_properties(res, rb) == res.num_matches


def test_partial_mum_properties(rng):
    """Partial MUMs (-k -1): absent docs must have ZERO occurrences of the
    match substring; present docs exactly one; maximality both sides."""
    from mumemto_tpu import properties

    docs = mutated_collection(rng, 4, base_len=400, n_mut=12)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, num_distinct_docs=-1, quiet=True)
    res = engine.find_matches(rb, opts)
    assert res.num_matches > 0
    assert properties.check_mum_properties(res, rb) == res.num_matches


def test_mem_properties(rng):
    """MEM-mode property check: exact occurrence, occurrence-set
    completeness, k/f/F conditions, maximality both sides."""
    from mumemto_tpu import properties

    rep = rand_seq(rng, 60)
    docs = mutated_collection(rng, 3, base_len=150, insert_rep=rep)
    rb = refbuilder.build_from_sequences(docs)
    for k, f, F in [(0, 3, 0), (2, 2, 0), (0, 2, 5)]:
        opts = options.normalize(rb.num_docs, num_distinct_docs=k,
                                 rare_freq=f, max_mem_freq=F, quiet=True)
        res = engine.find_matches(rb, opts)
        assert res.mem_records, (k, f, F)
        assert properties.check_mem_properties(res, rb) == len(res.mem_records)


def test_merge_threshold_metadata(rng):
    docs = mutated_collection(rng, 3)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, merge=True, quiet=True)
    f_o = naive.run_finder(rb, opts)
    r_e = engine.find_matches(rb, opts)
    assert (np.asarray(f_o.candidate_thresh) == r_e.candidate_thresh).all()
    fo, ro = f_o.thresh_arrays()
    dl0 = rb.seq_lengths[0] // 2
    fe, re_ = engine.thresh_arrays(r_e, dl0)
    assert (fo == fe).all()
    assert (ro == re_).all()


def test_write_outputs_files(rng, tmp_path):
    docs = mutated_collection(rng, 3)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, quiet=True)
    res = engine.find_matches(rb, opts)
    engine.write_outputs(res, rb, str(tmp_path / "out"))
    want = naive.oracle_output(rb, opts)
    assert (tmp_path / "out.mums").read_bytes() == want

    # binary mode
    opts_b = options.normalize(rb.num_docs, binary=True, quiet=True)
    res_b = engine.find_matches(rb, opts_b)
    engine.write_outputs(res_b, rb, str(tmp_path / "outb"))
    from mumemto_tpu import formats
    L, S, T, _, flags = formats.parse_bumbl(str(tmp_path / "outb.bumbl"))
    assert (L == res.lengths).all()
    assert (S == res.offsets).all()
    assert (T == (res.strands > 0)).all()
    assert not (flags & formats.FLAG_PARTIAL)


def test_library_api(rng):
    import mumemto_tpu
    docs = mutated_collection(rng, 3)
    r = mumemto_tpu.mum([list(d) for d in docs])
    assert r.num_docs() == 3
    assert len(r) > 0
    L, off, st = r[0]
    assert off.shape == (3,) and st.dtype == bool
    with pytest.raises(IndexError):
        r.match_at(len(r))
    with pytest.raises(ValueError):
        mumemto_tpu.mem([list(d) for d in docs], max_doc_freq=1)
    rep = rand_seq(rng, 60)
    docs2 = mutated_collection(rng, 2, base_len=120, insert_rep=rep)
    r2 = mumemto_tpu.mem([list(d) for d in docs2], max_doc_freq=3)
    assert len(r2) > 0
    L, pos, ids, st = r2[0]
    assert len(pos) == len(ids) == len(st)


def test_ambiguous_bases_match_oracle(rng):
    """N (and other IUPAC) bases are ordinary characters in the reference
    (gsacak compares raw bytes; N complements to N) — N==N can extend
    matches. Engine must agree with the oracle byte-for-byte."""
    base = list(rand_seq(rng, 300))
    for _ in range(12):
        base[int(rng.integers(0, len(base)))] = "N"
    base = "".join(base)
    docs = []
    for _ in range(3):
        s = list(base)
        for _ in range(4):
            s[int(rng.integers(0, len(s)))] = rng.choice(list("ACGTN"))
        docs.append(["".join(s)])
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, quiet=True)
    want = naive.oracle_output(rb, opts)
    got = engine.find_matches(rb, opts).output_bytes()
    assert want == got
    assert want


def test_large_cap_walk_analyzer_oracle(rng):
    """Interval size caps past the seq-shard limit (here F=5000 -> cap
    8192, a 13-level guarded walk) still run single-device — the
    reference's envelope is 65535 docs / unbounded F (pfp_mum.hpp:35-36).
    Byte-equal to the oracle, matches guaranteed by a planted repeat."""
    rep = rand_seq(rng, 60)
    docs = mutated_collection(rng, 3, base_len=2000, insert_rep=rep)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, rare_freq=0, max_mem_freq=5000,
                             quiet=True)
    assert engine.interval_size_cap(opts, rb.num_docs) == 8192
    # the cap must be SMALLER than the padded row space, else the
    # analyzer legitimately takes the uncapped full-table path
    assert rb.text.size > 8192
    out = _assert_equal(rb, opts)
    assert out
