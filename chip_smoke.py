"""End-to-end smoke test of the engine on NVIDIA GPUs.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --multi-gpu   # four GPUs: the multi-device paths only

One-GPU phases, in order (each prints one result line; any failure exits
non-zero):

  device   the JAX devices are GPUs (no CPU fallback), nvidia-smi's name and
           power limit, and the native host extension loaded (the phrase
           sort must not fall back to CPython)
  small    byte equality with oracle/naive.py through cli.main on synthetic
           FASTAs (gzipped, lowercase, multi-record): strict MUMs, -k -1,
           -f 3 -F 20, -M, and the direct backend (-g)
  full     8 genomes of a 4 Mbp base at 0.1% SNP divergence (32 Mbp input,
           64 M chars with revcomp) through cli.main: cold and warm wall
           time, peak device memory, the device time of the break mask and
           of the fused scan, match count equal to native/baseline_cpu,
           property check on a sample, two warm runs byte-identical
  mesh     the multi-device code paths on a 1-GPU mesh, each byte-compared
           with the single-device engine: forced-wide block scan, sharded
           dict index, wide MEM mode, collective anchor merge vs host fold

--multi-gpu phases (4 GPUs): --seq-shards 4 through cli.main on the full-size
collection vs the single-GPU output, and the collective anchor merge over a
4-device ('part',) mesh vs the host fold.

The last stdout line is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

FULL_MBP = 32.0      # input megabases (forward strand)
FULL_DOCS = 8        # genomes: a 4 Mbp base, bacterial scale
FULL_SNP = 0.001     # pairwise divergence of the copies
PROPERTY_SAMPLE = 200
MULTI_GPUS = 4
MIN_CARD_PEAK = 1 << 20  # bytes a card must have held in the sharded scan


def report(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def run_cli(argv) -> tuple[int, str]:
    """cli.main in-process; returns (rc, its stderr), echoing the stderr."""
    from mumemto_tpu import cli
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        rc = cli.main(list(argv))
    err = buf.getvalue()
    sys.stderr.write(err)
    if "device OOM" in err or "partitioned fallback" in err:
        raise RuntimeError("the CLI fell back to MumemtoM partitions after "
                           "a device OOM: the union scan did not run")
    return rc, err


def peak_bytes(device) -> int:
    return device.memory_stats()["peak_bytes_in_use"]


def read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------

def phase_device(want: int):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devs[0].platform} devices")
    if len(devs) < want:
        raise SystemExit(f"need {want} GPUs, JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    from mumemto_tpu import native
    loaded = native.get_native() is not None
    for line in smi.stdout.strip().splitlines():
        print(f"nvidia-smi: {line.strip()}", flush=True)
    report("device", platform=devs[0].platform,
           kind=repr(devs[0].device_kind), count=len(devs),
           native_extension=loaded)
    if not loaded:
        raise RuntimeError("the native host extension did not build/load; "
                           "the phrase sort would run in CPython")
    return devs


# ---------------------------------------------------------------------------
# small-size oracle byte equality
# ---------------------------------------------------------------------------

def _mutate(core: str, seed: int, n: int) -> str:
    import numpy as np
    s = list(core)
    r = np.random.default_rng(seed)
    for _ in range(n):
        s[int(r.integers(0, len(s)))] = str(r.choice(list("ACGT")))
    return "".join(s)


def write_small_collection(td: str, core_len: int = 2000) -> list:
    """Three genomes: one lowercase, one gzipped, one with two records."""
    import numpy as np
    core = "".join(np.random.default_rng(7).choice(list("ACGT"), core_len))
    g1, g2, g3 = (_mutate(core, k, core_len // 100) for k in (1, 2, 3))
    paths = [os.path.join(td, n) for n in ("g1.fa", "g2.fa.gz", "g3.fa")]
    with open(paths[0], "w") as f:
        f.write(f">c1\n{g1.lower()}\n")
    with gzip.open(paths[1], "wt") as f:
        f.write(f">c2\n{g2}\n")
    half = core_len // 2
    with open(paths[2], "w") as f:
        f.write(f">c3a\n{g3[:half]}\n>c3b\n{g3[half:]}\n")
    return paths


SMALL_CASES = (
    # (label, CLI flags, options.normalize kwargs, output extension)
    ("strict", [], {}, ".mums"),
    ("k-1", ["-k", "-1"], {"num_distinct_docs": -1}, ".mums"),
    ("f3F20", ["-f", "3", "-F", "20"],
     {"rare_freq": 3, "max_mem_freq": 20}, ".mems"),
    ("M", ["-M"], {"merge": True}, ".mums"),
    ("g", ["-g"], {}, ".mums"),
)


def phase_small(td: str) -> None:
    from mumemto_tpu import options, refbuilder
    from mumemto_tpu.oracle import naive
    paths = write_small_collection(td)
    rb = refbuilder.build_from_files(paths)
    t0 = time.time()
    sizes = {}
    for label, flags, kw, ext in SMALL_CASES:
        out = os.path.join(td, f"small_{label}")
        rc, _ = run_cli(paths + ["-o", out] + flags)
        if rc != 0:
            raise RuntimeError(f"small {label}: cli rc={rc}")
        want = naive.oracle_output(
            rb, options.normalize(rb.num_docs, quiet=True, **kw))
        got = read(out + ext)
        if not want or got != want:
            raise AssertionError(f"small {label}: output differs from the "
                                 f"oracle ({len(got)} vs {len(want)} bytes)")
        sizes[label] = len(got)
    report("small", cases=",".join(sizes), bytes=sizes,
           oracle_equal=True, wall_s=round(time.time() - t0, 1))


# ---------------------------------------------------------------------------
# full size
# ---------------------------------------------------------------------------

def write_full_collection(td: str) -> list:
    import bench
    docs = bench.synth_collection(FULL_MBP, FULL_DOCS, seed=0,
                                  snp_rate=FULL_SNP)
    paths = []
    for i, d in enumerate(docs):
        p = os.path.join(td, f"genome{i}.fa")
        with open(p, "wb") as f:
            f.write(f">genome{i}\n".encode())
            f.write(d.tobytes())
            f.write(b"\n")
        paths.append(p)
    return paths


def device_busy_seconds(run, reps: int = 1) -> float:
    """Device-busy seconds per call of `run()`: the union of the intervals
    of all events on the GPU planes of a jax.profiler trace of `reps`
    calls (the window holds nothing else, so every kernel is run's)."""
    import glob

    import jax
    from jax.profiler import ProfileData
    with tempfile.TemporaryDirectory() as tdir:
        with jax.profiler.trace(tdir):
            for _ in range(reps):
                run()
        files = glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                          recursive=True)
        if not files:
            raise RuntimeError("the profiler wrote no trace")
        prof = ProfileData.from_file(files[0])
        spans = sorted(
            (ev.start_ns, ev.start_ns + ev.duration_ns)
            for plane in prof.planes if plane.name.startswith("/device:GPU")
            for line in plane.lines for ev in line.events)
    if not spans:
        raise RuntimeError("the trace holds no GPU events")
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy * 1e-9 / reps


def phase_full(td: str) -> None:
    import jax
    import jax.numpy as jnp
    import bench
    from mumemto_tpu import engine, options, properties, refbuilder
    from mumemto_tpu.ops import pfp as ops_pfp

    paths = write_full_collection(td)
    out = [os.path.join(td, f"full{i}") for i in range(3)]
    t0 = time.time()
    rc, _ = run_cli(paths + ["-o", out[0]])
    cold = time.time() - t0
    if rc != 0:
        raise RuntimeError(f"full: cli rc={rc}")
    warm = []
    for o in out[1:]:
        t0 = time.time()
        rc, _ = run_cli(paths + ["-o", o])
        warm.append(time.time() - t0)
        if rc != 0:
            raise RuntimeError(f"full: warm cli rc={rc}")
    # the fused single program ran (not the split per-stage path)
    if ops_pfp._full_scan._cache_size() == 0:
        raise RuntimeError("full: the fused _full_scan program never ran")
    got = [read(o + ".mums") for o in out]
    if not (got[0] == got[1] == got[2]):
        raise AssertionError("full: repeated runs gave different .mums")
    n_matches = got[0].count(b"\n")
    peak = peak_bytes(jax.devices()[0])

    rb = refbuilder.build_from_files(paths)
    opts = options.normalize(rb.num_docs, quiet=True)
    res = engine.find_matches(rb, opts, show_progress=False)
    if res.output_bytes() != got[0]:
        raise AssertionError("full: engine.find_matches != cli .mums")
    checked = properties.check_mum_properties(res, rb,
                                              max_checked=PROPERTY_SAMPLE)

    cpu = bench.run_cpu_baseline(rb.text, rb.seq_lengths, opts, FULL_MBP,
                                 reps=1)
    if cpu is None:
        raise RuntimeError("full: native/baseline_cpu could not run")
    cpu_mbp_s, cpu_matches = cpu
    if cpu_matches != n_matches:
        raise AssertionError(f"full: baseline_cpu found {cpu_matches} "
                             f"matches, the engine {n_matches}")

    # device times at this size: the KR break mask, and the scan (the
    # fused _full_scan program plus its small input uploads)
    pfp = ops_pfp.build_pfp(rb.text)
    ne = int(pfp.ext.shape[0])
    n_text = jnp.int32(pfp.n_text)
    t_mask = device_busy_seconds(lambda: jax.block_until_ready(
        ops_pfp._break_mask(pfp.ext, n_text, 10, 100, ne)), reps=5)
    size_cap = engine.interval_size_cap(opts, rb.num_docs)
    t_scan = device_busy_seconds(lambda: jax.block_until_ready(
        ops_pfp.pfp_scan(pfp, rb.doc_ends, rb.num_docs,
                         jnp.int32(opts.min_match_len),
                         jnp.int32(opts.num_distinct),
                         jnp.int32(opts.max_total_freq), opts.max_doc_freq,
                         size_cap=size_cap, need_ctx=opts.merge)), reps=3)
    report("full", mbp=FULL_MBP, chars=int(rb.text.size), docs=rb.num_docs,
           matches=n_matches, baseline_cpu_matches=cpu_matches,
           baseline_cpu_mbp_s=round(cpu_mbp_s, 3),
           cold_wall_s=round(cold, 2),
           warm_wall_s=",".join(f"{w:.3f}" for w in warm),
           peak_bytes_in_use=peak,
           break_mask_device_ms=round(t_mask * 1e3, 3),
           scan_device_ms=round(t_scan * 1e3, 3),
           properties_checked=checked, deterministic=True,
           fused_scan=True, union_scan=True)


# ---------------------------------------------------------------------------
# multi-device code paths (1-GPU mesh) and the collective merge
# ---------------------------------------------------------------------------

def mesh_collection():
    """Six genomes of a 120 kbp base at 0.1% divergence."""
    import numpy as np
    from mumemto_tpu import refbuilder
    n_docs, base_len = 6, 120_000
    rng = np.random.default_rng(0)
    base = rng.integers(0, 4, base_len, dtype=np.int8)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    docs = []
    for _ in range(n_docs):
        s = base.copy()
        pos = rng.integers(0, base_len, max(1, base_len // 1000))
        s[pos] = (s[pos] + rng.integers(1, 4, pos.size)) % 4
        docs.append([bytes(acgt[s])])
    return refbuilder.build_from_sequences(docs)


def collective_vs_host(td: str, n_parts: int, mesh=None) -> int:
    """MumemtoM: n_parts partitions sharing an anchor genome, merged by the
    host fold and by the collective fold; returns the merged byte count."""
    import numpy as np
    from mumemto_tpu.parallel import collective_merge
    base = "".join(np.random.default_rng(3).choice(list("ACGT"), 4000))
    paths = []
    for i in range(2 * n_parts + 1):
        p = os.path.join(td, f"part_g{i}.fa")
        with open(p, "w") as f:
            f.write(f">g{i}\n{_mutate(base, i, 8)}\n")
        paths.append(p)
    mums = []
    for k in range(n_parts):
        pfx = os.path.join(td, f"part{n_parts}_{k}")
        rc, _ = run_cli([paths[0]] + paths[1 + 2 * k:3 + 2 * k]
                        + ["-o", pfx, "-M", "-n"])
        if rc != 0:
            raise RuntimeError(f"partition {k}: cli rc={rc}")
        mums.append(pfx + ".mums")
    host_out = os.path.join(td, f"host{n_parts}.mums")
    dev_out = os.path.join(td, f"dev{n_parts}.mums")
    rc, _ = run_cli(["merge"] + mums + ["-o", host_out])
    if rc != 0:
        raise RuntimeError(f"host merge rc={rc}")
    collective_merge.collective_anchor_merge(mums, dev_out, mesh=mesh)
    want, got = read(host_out), read(dev_out)
    if not want or got != want:
        raise AssertionError("collective merge != host fold")
    return len(got)


def phase_mesh(td: str) -> None:
    import jax
    import numpy as np
    from mumemto_tpu import engine, options
    from mumemto_tpu.parallel import widepfp
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("seq",))
    rb = mesh_collection()
    opts = options.normalize(rb.num_docs, quiet=True)
    mopts = options.normalize(rb.num_docs, rare_freq=3, quiet=True)
    t0 = time.time()
    want = engine.find_matches(rb, opts, show_progress=False).output_bytes()
    want_mem = engine.find_matches(rb, mopts,
                                   show_progress=False).output_bytes()
    if not want or not want_mem:
        raise AssertionError("mesh: the single-device engine found nothing")
    checks = {
        "wide": lambda: widepfp.find_matches_wide(rb, opts, mesh),
        "sharddict": lambda: widepfp.find_matches_wide(
            rb, opts, mesh, shard_dict=True),
        "wide_mem": lambda: widepfp.find_matches_wide(rb, mopts, mesh),
    }
    for name, fn in checks.items():
        ref = want_mem if name == "wide_mem" else want
        if fn().output_bytes() != ref:
            raise AssertionError(f"mesh {name} != single-device bytes")
    # two partitions on one device: the same fold program, run on device 0
    merged = collective_vs_host(td, 2)
    report("mesh", checks="wide,sharddict,wide_mem,collective_merge",
           byte_equal=True, merged_bytes=merged,
           wall_s=round(time.time() - t0, 1))


def phase_multi(td: str) -> None:
    import jax
    import numpy as np
    n = MULTI_GPUS
    devs = jax.devices()[:n]
    paths = write_full_collection(td)
    single, sharded = (os.path.join(td, s) for s in ("single", "sharded"))
    t0 = time.time()
    rc, _ = run_cli(paths + ["-o", sharded, "--seq-shards", str(n)])
    t_sharded = time.time() - t0
    if rc != 0:
        raise RuntimeError(f"--seq-shards {n}: cli rc={rc}")
    # every card must have held part of the sharded scan (device 0 also
    # runs the single-device comparison below, so it is read now)
    peaks = [peak_bytes(d) for d in devs]
    if min(peaks) < MIN_CARD_PEAK:
        raise AssertionError(f"the sharded scan left a card idle: peak "
                             f"bytes per card {peaks}")
    t0 = time.time()
    rc, _ = run_cli(paths + ["-o", single])
    t_single = time.time() - t0
    if rc != 0:
        raise RuntimeError(f"single-device cli rc={rc}")
    want, got = read(single + ".mums"), read(sharded + ".mums")
    if not want or got != want:
        raise AssertionError(f"--seq-shards {n} != single-device .mums")
    report("seq_shards", shards=n, mbp=FULL_MBP, matches=want.count(b"\n"),
           byte_equal=True, peak_bytes_per_card=peaks,
           sharded_wall_s=round(t_sharded, 2),
           single_wall_s=round(t_single, 2))
    mesh = jax.sharding.Mesh(np.asarray(devs), ("part",))
    merged = collective_vs_host(td, n, mesh=mesh)
    report("collective_merge", partitions=n,
           mesh_devices=[d.id for d in devs], byte_equal=True,
           merged_bytes=merged)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help=f"run only the {MULTI_GPUS}-GPU paths "
                         "(seq-sharded scan, collective merge)")
    args = ap.parse_args(argv)
    # the fused single-program scan is what users run; a progress bar or
    # the profiling env var would switch pfp_scan to its split path
    os.environ["MUMEMTO_TPU_PROGRESS"] = "0"
    os.environ.pop("MUMEMTO_TPU_PROFILE", None)
    devs = phase_device(MULTI_GPUS if args.multi_gpu else 1)
    with tempfile.TemporaryDirectory() as td:
        if args.multi_gpu:
            phase_multi(td)
        else:
            phase_small(td)
            phase_full(td)
            phase_mesh(td)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
