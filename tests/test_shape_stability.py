"""Different inputs in the same shape buckets must NOT trigger recompiles.

A cold compile of the fused scan is the most expensive step of a run; any
data-dependent static (raw lengths, phrase counts, ...) leaking into a jit signature silently
recompiles the pipeline per dataset. This guards the contract with NO
whitelist: the test first verifies (on host metadata) that the two
collections share every legitimate adaptive static — shape buckets and the
phrase-length depth cap — and then requires zero recompiles of any
program, including the expensive SA/LCP ones.
"""

import logging

import numpy as np

from mumemto_tpu import engine, options, refbuilder
from mumemto_tpu.ops import pfp as ops_pfp
from tests.conftest import mutated_collection


def _build(seed):
    docs = mutated_collection(np.random.default_rng(seed), 3, base_len=400)
    return refbuilder.build_from_sequences(docs)


def _static_signature(rb):
    """The legitimate data-adaptive jit statics of the PFP pipeline,
    recomputed from host metadata exactly as pfp_scan derives them."""
    pfp = ops_pfp.build_pfp(rb.text)
    maxlen = int(pfp.phrase_ln.max()) if pfp.phrase_ln.size > 1 else 1
    n_rows = int((pfp.phrase_ln[pfp.parse] - pfp.w).sum())
    alpha = tuple(sorted(set(pfp.alpha) | {0, 1, 2}))
    return (
        ops_pfp.bucket(int(pfp.ext.shape[0])),          # ne
        ops_pfp.bucket(pfp.d_len + 4),                   # nd
        ops_pfp.bucket(pfp.m + 1, lo=64),                # mp
        ops_pfp.bucket(pfp.num_phrases + 1, lo=64),      # npz bucket
        ops_pfp.bucket(n_rows),                          # nr
        (maxlen + 2).bit_length(),                       # lvl_cap
        alpha if len(alpha) <= 8 else None,              # seed thresholds
    )


def test_no_recompile_same_buckets(rng, caplog):
    import jax

    # find two collections that agree on EVERY legitimate adaptive static
    seeds = [101, 202, 303, 404, 505, 606]
    sigs = {}
    pair = None
    for s in seeds:
        sig = _static_signature(_build(s))
        if sig in sigs:
            pair = (sigs[sig], s)
            break
        sigs[sig] = s
    assert pair, f"no two seeds share statics: {sigs}"
    s1, s2 = pair

    def run(seed):
        rb = _build(seed)
        opts = options.normalize(rb.num_docs, quiet=True)
        return engine.find_matches(rb, opts).output_bytes()

    # warm all programs on the first collection
    assert run(s1)

    jax.config.update("jax_log_compiles", True)
    try:
        with caplog.at_level(logging.WARNING, logger="jax._src.dispatch"):
            assert run(s2)  # different data, identical statics
    finally:
        jax.config.update("jax_log_compiles", False)
    compiled = [r.getMessage() for r in caplog.records
                if "Finished XLA compilation" in r.getMessage()]
    assert not compiled, f"unexpected recompiles: {compiled}"
