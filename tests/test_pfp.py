"""PFP backend golden equivalence: identical bytes to the trusted oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from mumemto_tpu import engine, options, refbuilder
from mumemto_tpu.oracle import naive
from mumemto_tpu.ops import pfp as ops_pfp
from tests.conftest import mutated_collection, rand_seq


def _check(rb, opts):
    want = naive.oracle_output(rb, opts)
    got = engine.find_matches(rb, opts, backend="pfp").output_bytes()
    assert want == got
    return want


@pytest.mark.parametrize("use_revcomp", [True, False])
@pytest.mark.parametrize("k", [0, -1])
def test_pfp_mums(rng, use_revcomp, k):
    docs = mutated_collection(rng, int(rng.integers(2, 5)), base_len=400)
    rb = refbuilder.build_from_sequences(docs, use_revcomp=use_revcomp)
    opts = options.normalize(rb.num_docs, num_distinct_docs=k,
                             use_revcomp=use_revcomp, quiet=True)
    assert _check(rb, opts)


@pytest.mark.parametrize("k,f,F", [(0, 2, 0), (0, 0, 0)])
def test_pfp_mems(rng, k, f, F):
    rep = rand_seq(rng, 60)
    docs = mutated_collection(rng, 3, base_len=200, insert_rep=rep)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, num_distinct_docs=k, rare_freq=f,
                             max_mem_freq=F, quiet=True)
    _check(rb, opts)


def test_pfp_edge_cases(rng):
    cases = [
        # tandem repeats: deep nesting + big same-suffix groups
        [[rand_seq(rng, 25) * 12 + "ACGT"], ["TTGG" + rand_seq(rng, 25) * 9]],
        # homopolymer run: giant phrase (few hash breaks)
        [["A" * 300 + rand_seq(rng, 50)], [rand_seq(rng, 40) + "A" * 280]],
        # tiny identical docs
        [["ACGTACGTACGTACGTACGTACGTA"], ["ACGTACGTACGTACGTACGTACGTA"]],
    ]
    for docs in cases:
        rb = refbuilder.build_from_sequences(docs)
        _check(rb, options.normalize(rb.num_docs, quiet=True))


def test_pfp_merge_metadata(rng):
    docs = mutated_collection(rng, 3, base_len=300)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, merge=True, quiet=True)
    f_o = naive.run_finder(rb, opts)
    r_e = engine.find_matches(rb, opts, backend="pfp")
    assert (np.asarray(f_o.candidate_thresh) == r_e.candidate_thresh).all()
    fo, ro = f_o.thresh_arrays()
    dl0 = rb.seq_lengths[0] // 2
    fe, re_ = engine.thresh_arrays(r_e, dl0)
    assert (fo == fe).all() and (ro == re_).all()


def test_parse_files_roundtrip(rng, tmp_path):
    docs = mutated_collection(rng, 2, base_len=300)
    rb = refbuilder.build_from_sequences(docs)
    prefix = str(tmp_path / "p")
    ops_pfp.write_parse_files(rb, prefix)
    body, starts, lens, parse = ops_pfp.read_parse_files(prefix)
    pfp = ops_pfp.build_pfp(rb.text)
    assert parse.size == pfp.m
    assert (parse == pfp.parse).all()
    assert lens.size == pfp.num_phrases
    # reconstruct the text from parse + dict (overlap w): phrase j contributes
    # its chars minus the w-overlap with the next, validating the PFP invariant
    w = pfp.w
    rebuilt = []
    for j, pid in enumerate(parse):
        s, l = starts[pid - 1], lens[pid - 1]
        chunk = body[s:s + l]
        rebuilt.append(chunk[:-w] if j < parse.size - 1 else chunk)
    rebuilt = np.concatenate(rebuilt)
    # strip the leading artificial Dollar and trailing w Dollars
    assert (rebuilt[1:1 + rb.text.size] == rb.text).all()
    assert rebuilt[0] == ops_pfp.DOLLAR_PFP
    assert (rebuilt[1 + rb.text.size:] == ops_pfp.DOLLAR_PFP).all()


# ---------------------------------------------------------------------------
# Reference parser golden fixture (KR hash byte-compatibility)
# ---------------------------------------------------------------------------

def _reference_parser(text: np.ndarray, w: int, p: int):
    """Independent test-only transcription of the reference pfparser
    (newscan.hpp: KR_window:84-115, process_string:310-325,
    save_update_word:265-306, finish_parse:357-400): returns the .dict
    byte stream and the .parse u32 rank list a reference run would write.
    Phrase ranks are by content (probing only perturbs internal hash keys,
    never the written ranks)."""
    prime = 1999999973
    asize_pot = pow(256, w - 1, prime)
    window = [0] * w
    h = 0
    tot = 0
    word = bytes([ops_pfp.DOLLAR_PFP])
    phrases = []          # parse order, as bytes
    for c in text.tolist():
        k = tot % w
        tot += 1
        h = (h + prime - (window[k] * asize_pot) % prime) % prime
        h = (256 * h + c) % prime
        window[k] = c
        word += bytes([c])
        if h % p == 0 and len(word) > w:
            phrases.append(word)
            word = word[-w:]
    word += bytes([ops_pfp.DOLLAR_PFP]) * w
    phrases.append(word)
    uniq = sorted(set(phrases))
    rank = {ph: i + 1 for i, ph in enumerate(uniq)}
    dict_bytes = b"".join(ph + bytes([ops_pfp.SEP]) for ph in uniq) \
        + bytes([ops_pfp.TERM])
    parse = np.array([rank[ph] for ph in phrases], dtype="<u4")
    return dict_bytes, parse


@pytest.mark.parametrize("w,mod", [(10, 100), (4, 11)])
def test_parse_files_reference_bytes(rng, tmp_path, w, mod):
    docs = mutated_collection(rng, 2, base_len=600)
    rb = refbuilder.build_from_sequences(docs)
    prefix = str(tmp_path / "ref")
    ops_pfp.write_parse_files(rb, prefix, w=w, mod=mod)
    want_dict, want_parse = _reference_parser(rb.text, w, mod)
    with open(prefix + ".dict", "rb") as f:
        assert f.read() == want_dict
    got_parse = np.fromfile(prefix + ".parse", dtype="<u4")
    assert (got_parse == want_parse).all()
    # and the resume path reconstructs the identical PFP
    pfp = ops_pfp.pfp_from_parse_files(prefix, w=w)
    direct = ops_pfp.build_pfp(rb.text, w=w, mod=mod)
    assert pfp.n_text == direct.n_text
    assert (pfp.parse == direct.parse).all()
    assert (pfp.phrase_ln == direct.phrase_ln).all()


@pytest.mark.parametrize("mode", ["cross_packed", "cross_operand",
                                  "unpacked"])
def test_pfp_operand_packing_modes(rng, monkeypatch, mode):
    """The three expansion operand modes are byte-equal: cross packed into
    sufbwt (default while 2*lvl_cap+7 <= 31), cross as its own 5th sort
    operand (big maxlen), and the fully unpacked 7-operand sort (bit
    budgets exhausted, e.g. huge row spaces). Force each branch and
    require byte-equality (at test scale the fallbacks are otherwise
    never exercised). Distinct base_len per mode keeps the shape buckets
    apart so the jit cache cannot serve a stale trace."""
    base_len = {"cross_operand": 500, "unpacked": 520,
                "cross_packed": 540}[mode]
    docs = mutated_collection(rng, 3, base_len=base_len)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, quiet=True)
    want = naive.oracle_output(rb, opts)
    real = ops_pfp._pack_da_mode

    def forced(nr, nd, num_docs, suf_bits):
        bits = real(nr, nd, num_docs, suf_bits)[2]
        if mode == "cross_packed":
            assert 2 * suf_bits + 7 <= 31  # the forced pack must be legal
            return (True, True, bits)
        return (False, mode == "cross_operand", bits)

    monkeypatch.setattr(ops_pfp, "_pack_da_mode", forced)
    got = engine.find_matches(rb, opts, backend="pfp").output_bytes()
    assert want == got


@pytest.mark.parametrize("n", [64, 100, 256])
def test_rmq_query_every_range(rng, n):
    """The two-window range minimum equals numpy's min over every
    (lo, hi) pair, including lengths that are exact powers of two."""
    vals = rng.integers(0, 1000, n).astype(np.int32)
    table = ops_pfp._rmq_prepare(jnp.asarray(vals))
    lo, hi = np.triu_indices(n)
    got = np.asarray(ops_pfp._rmq_query(
        table, jnp.asarray(lo, jnp.int32), jnp.asarray(hi, jnp.int32)))
    want = np.concatenate([np.minimum.accumulate(vals[i:])
                           for i in range(n)])
    np.testing.assert_array_equal(got, want)
