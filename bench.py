"""Benchmark: pangenome multi-MUM throughput (Mbp/s) on one chip.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Runs only on a GPU: with no GPU present it exits non-zero and prints no
number.

Baseline: the reference C++ cannot be compiled offline (its thirdparty deps
are FetchContent'd), so vs_baseline divides by a MEASURED single-core C++
implementation of the same pipeline run on the same host at bench time:
native/baseline_cpu (from-scratch SA-IS + Kasai + LCP-interval stack,
compiled with the reference's own -O3 -march=native flags; oracle-verified
in tests/test_baseline_cpu.py). Its match count must agree with the engine's
— a live cross-validation on the real bench input. If the binary cannot be
built or run, or MUMEMTO_BENCH_CPU=0 skips it, vs_baseline is omitted.

Workload: synthetic pangenome of N_DOCS mutated copies of a base genome
(0.1% SNP divergence, the human-haplotype regime of the reference's
headline runs), revcomp on, strict multi-MUMs — the shape of BASELINE
configs 1/5 scaled to MUMEMTO_BENCH_MBP megabases. Overrides:
MUMEMTO_BENCH_{MBP,DOCS,REPS,SNP,W,MOD}; MUMEMTO_TPU_PROFILE=1 prints
per-stage device timings.
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))

import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def emit(value: float, baseline: float | None, **extra):
    line = {
        "metric": "pangenome multi-MUM throughput (SA+LCP+scan, 1 chip)",
        "value": round(value, 3),
        "unit": "Mbp/s",
    }
    if baseline is not None:
        line["vs_baseline"] = round(value / baseline, 3)
    print(json.dumps({**line, **extra}), flush=True)


def run_cpu_baseline(text, seq_lengths, opts, mbp, reps=3):
    """Run the single-core C++ baseline on the identical input.

    Returns (mbp_per_s, matches), or None (with the reason logged) if the
    binary cannot be built or run."""
    import subprocess
    import tempfile
    root = _os.path.dirname(_os.path.abspath(__file__))
    _sys.path.insert(0, _os.path.join(root, "native"))
    import build_baseline
    if not build_baseline.build():
        log("[bench] native/baseline_cpu could not be built")
        return None
    if text.size + 2 > 2**31 - 1:
        log("[bench] text too long for the int32 baseline binary")
        return None
    try:
        with tempfile.TemporaryDirectory() as td:
            tf = _os.path.join(td, "text.bin")
            lf = _os.path.join(td, "lens.txt")
            with open(tf, "wb") as f:
                f.write(text.tobytes())
            with open(lf, "w") as f:
                f.write("".join(f"{l}\n" for l in seq_lengths))
            out = subprocess.run(
                [_os.path.join(root, "native", "baseline_cpu"), tf, lf,
                 str(opts.min_match_len), str(opts.num_distinct),
                 str(opts.max_doc_freq), str(opts.max_total_freq),
                 str(int(opts.no_max_freq)), str(int(opts.use_revcomp)),
                 str(reps)],
                capture_output=True, text=True, timeout=3600)
        if out.returncode != 0:
            log(f"[bench] cpu baseline failed: {out.stderr[:200]}")
            return None
        r = json.loads(out.stdout)
        log(f"[bench] cpu baseline (single-core C++ SA-IS+Kasai+scan): "
            f"{r['t_total']:.2f}s = {mbp / r['t_total']:.3f} Mbp/s, "
            f"{r['matches']} matches "
            f"(sa {r['t_sa']:.2f} lcp {r['t_lcp']:.2f} scan {r['t_scan']:.2f})")
        return mbp / r["t_total"], r["matches"]
    except Exception as e:  # noqa: BLE001 — baseline is best-effort
        log(f"[bench] cpu baseline error: {e}")
        return None


def synth_collection(total_mbp: float, n_docs: int, seed: int = 0,
                     snp_rate: float | None = None):
    """n_docs mutated copies of one base sequence, ~total_mbp Mbp total
    (pre-revcomp). Default divergence 0.1% — the reference's headline
    workloads are human pangenome haplotypes (chr19 x20, README.md,
    BASELINE.json config 5), whose pairwise SNP divergence is ~0.1%."""
    if snp_rate is None:
        snp_rate = float(os.environ.get("MUMEMTO_BENCH_SNP", 0.001))
    rng = np.random.default_rng(seed)
    base_len = int(total_mbp * 1e6 / n_docs)
    base = rng.integers(0, 4, base_len, dtype=np.int8)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    docs = []
    for d in range(n_docs):
        s = base.copy()
        n_mut = max(1, int(base_len * snp_rate))
        pos = rng.integers(0, base_len, n_mut)
        s[pos] = (s[pos] + rng.integers(1, 4, n_mut)) % 4
        docs.append(acgt[s])
    return docs


def main():
    from mumemto_tpu import engine, options
    from mumemto_tpu.refbuilder import RefBuilder, revcomp

    total_mbp = float(os.environ.get("MUMEMTO_BENCH_MBP", 8))
    n_docs = int(os.environ.get("MUMEMTO_BENCH_DOCS", 8))
    reps = int(os.environ.get("MUMEMTO_BENCH_REPS", 5))  # best-of
    # PFP window/modulus: internal representation knobs — the output is
    # provably parse-independent (tested), so the bench may tune them
    pfp_w = int(os.environ.get("MUMEMTO_BENCH_W", 10))
    pfp_mod = int(os.environ.get("MUMEMTO_BENCH_MOD", 100))

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"[bench] no GPU (JAX found {dev.platform}); "
                         f"refusing to time a device run")
    log(f"[bench] device: {dev.platform} {dev.device_kind} "
        f"x{len(jax.devices())}")
    log(f"[bench] generating {total_mbp} Mbp synthetic pangenome, {n_docs} docs")
    docs = synth_collection(total_mbp, n_docs)
    pieces = []
    seq_lengths = []
    dollar = np.frombuffer(b"$", dtype=np.uint8)
    for fwd in docs:
        pieces += [fwd, dollar, revcomp(fwd), dollar]
        seq_lengths.append(2 * (fwd.size + 1))
    text = np.concatenate(pieces)
    rb = RefBuilder(text=text, seq_lengths=seq_lengths, num_docs=n_docs,
                    use_revcomp=True, input_files=[], multifasta_names=[],
                    multifasta_lengths=[])
    opts = options.normalize(n_docs, quiet=True)
    mbp = total_mbp  # input megabases (fwd strand, the reference's unit)

    log(f"[bench] text size {text.size/1e6:.1f} M chars (incl. revcomp)")
    t0 = time.time()
    res = engine.find_matches(rb, opts, pfp_w=pfp_w, pfp_mod=pfp_mod,
                              show_progress=False)
    warm = time.time() - t0
    log(f"[bench] warmup (incl. compile): {warm:.2f}s, {res.num_matches} MUMs")

    if os.environ.get("MUMEMTO_BENCH_VERIFY"):
        # oracle-free property pass over the bench output: exact occurrence,
        # per-doc uniqueness, both-side maximality (mumemto_tpu/properties)
        from mumemto_tpu import properties
        cap = int(os.environ.get("MUMEMTO_BENCH_VERIFY_MAX", 0)) or None
        t0 = time.time()
        checked = properties.check_mum_properties(res, rb, max_checked=cap)
        log(f"[bench] property verify: {checked}/{res.num_matches} MUMs OK "
            f"({time.time() - t0:.1f}s)")

    baseline_mbp_s = None
    if os.environ.get("MUMEMTO_BENCH_CPU", "1") != "0":
        cpu = run_cpu_baseline(text, seq_lengths, opts, mbp)
        if cpu is None:
            log("[bench] no live cpu baseline: vs_baseline omitted")
        else:
            baseline_mbp_s, cpu_matches = cpu
            if cpu_matches != res.num_matches:
                log(f"[bench] WARNING: cpu-baseline match count {cpu_matches} "
                    f"!= engine {res.num_matches}")
            else:
                log(f"[bench] cross-check OK: engine and cpu baseline both "
                    f"report {cpu_matches} matches")

    times = []
    for r in range(reps):
        t0 = time.time()
        res = engine.find_matches(rb, opts, pfp_w=pfp_w, pfp_mod=pfp_mod,
                                  show_progress=False)
        times.append(time.time() - t0)
        log(f"[bench] rep {r}: {times[-1]:.3f}s")
    best = min(times)
    emit(mbp / best, baseline_mbp_s)


if __name__ == "__main__":
    main()
