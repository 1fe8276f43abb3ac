"""Mid-scale correctness evidence.

The byte-equality suite runs at <= ~16 Kb; this test runs ~1 Mbp of
synthetic pangenome (2 Mchar text with revcomp) through BOTH backends —
the default PFP expansion pipeline and the direct full-text doubling —
and requires byte-identical .mums output, then property-verifies a sample
of the matches against the raw text (exactness, per-doc uniqueness,
both-side maximality; oracle-free).

At this size the engine exercises the real production code paths: large
shape buckets, the packed (`nd < 2^24`) expansion sort operands, the
windowed gather-free PSV/NSV, and multi-level dict SA/LCP depths.
"""

import numpy as np
import pytest

from mumemto_tpu import engine, options, properties, refbuilder


@pytest.mark.slow
def test_midscale_pfp_equals_direct_and_properties():
    rng = np.random.default_rng(42)
    n_docs, base_len = 4, 250_000
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    base = rng.integers(0, 4, base_len, dtype=np.int8)
    docs = []
    for d in range(n_docs):
        s = base.copy()
        pos = rng.integers(0, base_len, max(1, base_len // 1000))
        s[pos] = (s[pos] + rng.integers(1, 4, pos.size)) % 4
        docs.append([bytes(acgt[s])])
    rb = refbuilder.build_from_sequences(docs)
    assert rb.text.size >= 2_000_000

    opts = options.normalize(rb.num_docs, quiet=True)
    res_pfp = engine.find_matches(rb, opts, backend="pfp")
    res_dir = engine.find_matches(rb, opts, backend="direct")
    assert res_pfp.num_matches > 0
    assert res_pfp.output_bytes() == res_dir.output_bytes()
    # n/r stat: the backends count runs over slightly different row sets
    # (PFP rows start at the first text suffix; the direct SA keeps the
    # terminator row), so allow a boundary-row difference
    assert abs(res_pfp.bwt_runs - res_dir.bwt_runs) <= 2

    checked = properties.check_mum_properties(res_pfp, rb, max_checked=200)
    assert checked > 0
