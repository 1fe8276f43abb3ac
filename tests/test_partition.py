"""Mesh-parallel partitioned scan returns the same MUMs as per-partition
single-device engine runs (virtual 8-device CPU mesh)."""

import numpy as np

from mumemto_tpu import engine, options, refbuilder
from mumemto_tpu.parallel import partition
from tests.conftest import mutated_collection


def _partition_inputs(rng, n_part, num_docs, n):
    texts = np.zeros((n_part, n), dtype=np.uint8)
    doc_ends = np.zeros((n_part, num_docs), dtype=np.int32)
    rbs = []
    for p in range(n_part):
        docs = mutated_collection(np.random.default_rng(1000 + p), num_docs,
                                  base_len=300)
        rb = refbuilder.build_from_sequences(docs)
        assert rb.text.size <= n
        texts[p, : rb.text.size] = rb.text
        doc_ends[p] = rb.doc_ends.astype(np.int32)
        rbs.append(rb)
    return texts, doc_ends, rbs


def test_partitioned_matches_equal_engine(rng):
    import jax
    import jax.numpy as jnp

    num_docs, n, M = 3, 4096, 256
    mesh = partition.make_mesh(len(jax.devices()))
    n_part = mesh.shape["part"]
    texts, doc_ends, rbs = _partition_inputs(rng, n_part, num_docs, n)

    fn = partition.compile_partitioned_matches(mesh, num_docs, M=M)
    counts, s, e, L, w_sa, w_da = (np.asarray(x) for x in
                                   fn(jnp.asarray(texts),
                                      jnp.asarray(doc_ends)))

    opts = options.normalize(num_docs, quiet=True)
    for p in range(n_part):
        m = int(counts[p])
        results = engine.MatchResults(opts=opts, num_docs=num_docs)
        doc_offsets, doc_lens = engine._doc_metadata(rbs[p], opts)
        valid = (s[p, :m, None] + np.arange(num_docs)) < e[p, :m, None]
        engine._emit_mums(results, s[p, :m], e[p, :m], L[p, :m],
                          w_sa[p, :m], w_da[p, :m].astype(np.int32), valid,
                          opts, doc_offsets, doc_lens, num_docs)
        want = engine.find_matches(rbs[p], opts, backend="direct")
        assert results.output_bytes() == want.output_bytes(), f"partition {p}"
        # raw emit counts both orientations; the writer's strand
        # canonicalization (mem_finder.hpp:383-391) keeps one of each
        assert len(results.lengths) == want.num_matches


def test_sharded_scan_equals_single_device(rng):
    """Sequence-parallel (text sharded over all devices) == single-device
    scan, byte-for-byte through the writer."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    num_docs, n = 3, 8192
    docs = mutated_collection(np.random.default_rng(7), num_docs,
                              base_len=900)
    rb = refbuilder.build_from_sequences(docs)
    assert rb.text.size <= n
    text = np.zeros(n, dtype=np.uint8)
    text[: rb.text.size] = rb.text
    mesh = Mesh(np.asarray(jax.devices()), ("seq",))

    fn = partition.compile_sharded_scan(mesh, n, num_docs, M=256)
    counts, s, e, L, w_sa, w_da = (np.asarray(x) for x in
                                   fn(jnp.asarray(text),
                                      jnp.asarray(rb.doc_ends,
                                                  dtype=jnp.int32)))
    m = int(counts[0])
    opts = options.normalize(num_docs, quiet=True)
    results = engine.MatchResults(opts=opts, num_docs=num_docs)
    doc_offsets, doc_lens = engine._doc_metadata(rb, opts)
    valid = (s[:m, None] + np.arange(num_docs)) < e[:m, None]
    engine._emit_mums(results, s[:m], e[:m], L[:m], w_sa[:m],
                      w_da[:m].astype(np.int32), valid, opts,
                      doc_offsets, doc_lens, num_docs)
    want = engine.find_matches(rb, opts, backend="direct")
    assert results.output_bytes() == want.output_bytes()
    assert len(results.lengths) == want.num_matches


def test_window_capacity_overflow_raises(rng):
    """The fixed-M compiled paths must fail loudly, never silently drop
    matches, when the emit count exceeds M."""
    import jax
    import jax.numpy as jnp
    import pytest
    from jax.sharding import Mesh

    num_docs, n = 3, 8192
    docs = mutated_collection(np.random.default_rng(7), num_docs,
                              base_len=900)
    rb = refbuilder.build_from_sequences(docs)
    text = np.zeros(n, dtype=np.uint8)
    text[: rb.text.size] = rb.text
    mesh = Mesh(np.asarray(jax.devices()), ("seq",))

    # M=256 fits (previous test); M=4 must overflow for this input
    fn = partition.compile_sharded_scan(mesh, n, num_docs, M=4)
    with pytest.raises(partition.WindowCapacityError, match="M=4"):
        fn(jnp.asarray(text), jnp.asarray(rb.doc_ends, dtype=jnp.int32))

    pmesh = partition.make_mesh(len(jax.devices()))
    texts, doc_ends, _ = _partition_inputs(rng, pmesh.shape["part"],
                                           num_docs, 4096)
    fn2 = partition.compile_partitioned_matches(pmesh, num_docs, M=4)
    with pytest.raises(partition.WindowCapacityError, match="M=4"):
        fn2(jnp.asarray(texts), jnp.asarray(doc_ends))
