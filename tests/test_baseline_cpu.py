"""The measured CPU baseline binary (native/baseline_cpu) agrees with the
trusted oracle on counts and an order-independent occurrence checksum.

This pins the vs_baseline denominator to a *correct* single-core C++
implementation of the same pipeline (SA-IS + Kasai + interval stack)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from mumemto_tpu import options, refbuilder
from mumemto_tpu.oracle import naive
from tests.conftest import mutated_collection, rand_seq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN = os.path.join(ROOT, "native", "baseline_cpu")

M64 = (1 << 64) - 1


def _build():
    sys.path.insert(0, os.path.join(ROOT, "native"))
    import build_baseline
    return build_baseline.build(quiet=True)


pytestmark = pytest.mark.skipif(not _build(), reason="g++ unavailable")


def _mix(x: int) -> int:
    x &= M64
    x ^= x >> 33
    x = (x * 0xFF51AFD7ED558CCD) & M64
    x ^= x >> 33
    return x


def _run_binary(rb, opts, reps: int = 1, tmp_path=None):
    text_f = tmp_path / "text.bin"
    len_f = tmp_path / "lens.txt"
    text_f.write_bytes(bytes(rb.text))
    len_f.write_text("".join(f"{l}\n" for l in rb.seq_lengths))
    out = subprocess.run(
        [BIN, str(text_f), str(len_f), str(opts.min_match_len),
         str(opts.num_distinct), str(opts.max_doc_freq),
         str(opts.max_total_freq), str(int(opts.no_max_freq)),
         str(int(opts.use_revcomp)), str(reps)],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


def _oracle_summary(rb, opts):
    """(matches, sum_len, occ_hash) computed from the oracle finder with the
    binary's checksum formula."""
    o = options.MatchOptions(**{**opts.__dict__, "binary": opts.mum_mode})
    finder = naive.run_finder(rb, o)
    matches = 0
    sum_len = 0
    occ_hash = 0
    if o.mum_mode:
        for length, offs, strands in zip(finder.bum_lengths,
                                         finder.bum_starts,
                                         finder.bum_strands):
            matches += 1
            sum_len += length
            for d, (pos, plus) in enumerate(zip(offs, strands)):
                if pos == -1:
                    continue  # absent slot
                occ_hash = (occ_hash + _mix(
                    (pos * 131 + d * 7 + (0 if plus else 3) + length))) & M64
    else:
        for line in finder.out_lines:
            length_s, pos_s, doc_s, strand_s = line.decode().split("\t")
            length = int(length_s)
            matches += 1
            sum_len += length
            for pos, d, st in zip(pos_s.split(","), doc_s.split(","),
                                  strand_s.strip().split(",")):
                occ_hash = (occ_hash + _mix(
                    (int(pos) * 131 + int(d) * 7
                     + (3 if st == "-" else 0) + length))) & M64
    return matches, sum_len, occ_hash


def _assert_equal(rb, opts, tmp_path):
    got = _run_binary(rb, opts, tmp_path=tmp_path)
    want = _oracle_summary(rb, opts)
    assert (got["matches"], got["sum_len"], got["occ_hash"]) == want


@pytest.mark.parametrize("use_revcomp", [True, False])
@pytest.mark.parametrize("k", [0, -1, 2])
def test_baseline_mums_match_oracle(rng, tmp_path, use_revcomp, k):
    docs = mutated_collection(rng, int(rng.integers(3, 6)))
    rb = refbuilder.build_from_sequences(docs, use_revcomp=use_revcomp)
    opts = options.normalize(rb.num_docs, num_distinct_docs=k,
                             use_revcomp=use_revcomp, quiet=True)
    _assert_equal(rb, opts, tmp_path)


@pytest.mark.parametrize("k,f,F", [(0, 2, 0), (0, 3, 0), (2, 2, 0),
                                   (0, 0, 0), (0, 2, -1)])
def test_baseline_mems_match_oracle(rng, tmp_path, k, f, F):
    rep = rand_seq(rng, 60)
    docs = mutated_collection(rng, 3, base_len=150, insert_rep=rep)
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, num_distinct_docs=k, rare_freq=f,
                             max_mem_freq=F, quiet=True)
    _assert_equal(rb, opts, tmp_path)


def test_baseline_deep_recursion(rng, tmp_path):
    """A larger, highly repetitive collection forces SA-IS into multiple
    recursion levels; equality with the oracle validates the from-scratch
    construction end to end."""
    base = rand_seq(rng, 256)
    docs = []
    for _ in range(4):
        reps = [base] * 12
        # sprinkle point mutations so MUMs exist but periodicity is deep
        s = np.frombuffer(("".join(reps)).encode(), dtype=np.uint8).copy()
        pos = rng.integers(0, s.size, 24)
        s[pos] = np.frombuffer(b"ACGT", dtype=np.uint8)[
            rng.integers(0, 4, 24)]
        docs.append(s.tobytes().decode())
    rb = refbuilder.build_from_sequences(docs)
    opts = options.normalize(rb.num_docs, quiet=True)
    _assert_equal(rb, opts, tmp_path)
