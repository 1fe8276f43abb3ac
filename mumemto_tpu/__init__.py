"""mumemto_tpu — an accelerator-native pangenome exact-matching engine.

Finds multi-MUMs and multi-MEMs (maximal unique/exact matches with k/f/F
occurrence filters) across collections of genome sequences, with outputs
byte-compatible with vikshiv/mumemto v1.4.0 (.mums/.mems/.bumbl/.lengths and
merge metadata), re-designed for an accelerator: the suffix-array / LCP
construction and the LCP-interval match scan are expressed as JAX/XLA array
programs, run on an NVIDIA GPU, instead of the reference's sequential C++
streaming pipeline.

Public API (mirrors mumemto_library/mumemto_api.hpp:43-57):
    mum(sequences, min_match_len=20, use_revcomp=True, num_distinct=0)
    mem(sequences, min_match_len=20, use_revcomp=True, num_distinct=0,
        max_total_freq=0, max_doc_freq=2)
"""

__version__ = "1.4.0"  # tracks reference PFPMUM_VERSION (include/pfp_mum.hpp:33)

def __getattr__(name):
    # lazy: avoid importing jax for format-only / oracle-only use
    if name in ("mum", "mem", "MumResult", "MemResult"):
        from mumemto_tpu import library
        return getattr(library, name)
    raise AttributeError(name)
