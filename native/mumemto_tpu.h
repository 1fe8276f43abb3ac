/* mumemto_tpu C ABI — in-memory multi-MUM / multi-MEM finding.
 *
 * Native equivalent of the reference's libmumemto C interface
 * (mumemto_library/mumemto.h:33-94): documents in, match views out, with a
 * thread-local last-error string. The engine itself is the JAX (GPU)
 * pipeline, hosted in an embedded CPython interpreter; this header is plain
 * C and has no Python or JAX types in its surface.
 *
 * Usage:
 *   mumemto_tpu_doc docs[2] = {{seqs0, 1}, {seqs1, 1}};
 *   mumemto_tpu_result* r = mumemto_tpu_mum(docs, 2, 20, 1, 0);
 *   if (!r) fprintf(stderr, "%s\n", mumemto_tpu_last_error());
 *   for (size_t i = 0; i < mumemto_tpu_num_matches(r); ++i) {
 *     uint32_t len = mumemto_tpu_match_length(r, i);
 *     const int64_t* off = mumemto_tpu_match_offsets(r, i);   // -1 = absent
 *     const uint8_t* strand = mumemto_tpu_match_strands(r, i); // 1 = '+'
 *   }
 *   mumemto_tpu_free(r);
 *
 * Link: -lmumemto_tpu (and ensure libpython3.x is resolvable).
 *
 * Runtime model / cost notes:
 *  - The first call initializes the embedded interpreter AND the JAX
 *    backend: expect seconds (warm compile cache) to minutes (cold cache,
 *    new shapes) of one-time latency. Subsequent calls in the same process
 *    reuse the live backend and run at engine speed.
 *  - The interpreter stays resident for the process lifetime; there is no
 *    teardown API (CPython cannot be safely re-initialized).
 *  - Calls are serialized on the embedded interpreter's GIL: concurrent
 *    callers are safe but run one at a time.
 */

#ifndef MUMEMTO_TPU_H_
#define MUMEMTO_TPU_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct mumemto_tpu_doc {
  const char* const* seqs; /* one or more NUL-terminated records */
  size_t num_seqs;
} mumemto_tpu_doc;

typedef struct mumemto_tpu_result mumemto_tpu_result; /* opaque */

/* Optional: where the mumemto_tpu Python package lives (defaults to the
 * MUMEMTO_TPU_PYROOT env var, else the interpreter's default sys.path).
 * Must be called before the first mum/mem call to take effect. */
void mumemto_tpu_set_module_path(const char* path);

/* Multi-MUMs: per-document frequency exactly 1.
 * num_distinct: minimum distinct documents (0 = all). Returns NULL on
 * error (see mumemto_tpu_last_error). */
mumemto_tpu_result* mumemto_tpu_mum(const mumemto_tpu_doc* docs,
                                    size_t num_docs, uint32_t min_match_len,
                                    int use_revcomp, int64_t num_distinct);

/* Multi-MEMs: per-document frequency up to max_doc_freq (> 1 required;
 * 0 = unlimited), total frequency up to max_total_freq (0 = unlimited). */
mumemto_tpu_result* mumemto_tpu_mem(const mumemto_tpu_doc* docs,
                                    size_t num_docs, uint32_t min_match_len,
                                    int use_revcomp, int64_t num_distinct,
                                    int64_t max_total_freq,
                                    int64_t max_doc_freq);

size_t mumemto_tpu_num_matches(const mumemto_tpu_result* r);
size_t mumemto_tpu_num_docs(const mumemto_tpu_result* r);
uint32_t mumemto_tpu_match_length(const mumemto_tpu_result* r, size_t i);

/* MUM accessors (mum results only): arrays of num_docs entries. */
const int64_t* mumemto_tpu_match_offsets(const mumemto_tpu_result* r,
                                         size_t i);
const uint8_t* mumemto_tpu_match_strands(const mumemto_tpu_result* r,
                                         size_t i);

/* MEM accessors (mem results only): per-occurrence arrays. */
size_t mumemto_tpu_match_num_occ(const mumemto_tpu_result* r, size_t i);
const int64_t* mumemto_tpu_match_positions(const mumemto_tpu_result* r,
                                           size_t i);
const uint32_t* mumemto_tpu_match_seq_ids(const mumemto_tpu_result* r,
                                          size_t i);
const uint8_t* mumemto_tpu_match_occ_strands(const mumemto_tpu_result* r,
                                             size_t i);

void mumemto_tpu_free(mumemto_tpu_result* r);

/* Thread-local message for the last failed call in this thread. */
const char* mumemto_tpu_last_error(void);

#ifdef __cplusplus
}
#endif

#endif /* MUMEMTO_TPU_H_ */
