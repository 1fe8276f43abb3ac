"""Collective (device) anchor merge == host anchor merge, byte for byte.

The collective formulation all_gathers per-partition dense anchor arrays
over a 'part' mesh axis and folds on device (SURVEY §2.3 row
2); the host path is analysis/merge.anchor_merge. Includes an
overlapping-MUM chain case (the emit-position trace through intermediate
states, where a naive final-position cover would mispick the originating
MUM)."""

import numpy as np
import pytest

import jax

from mumemto_tpu import cli
from mumemto_tpu.analysis import merge as host_merge
from mumemto_tpu.parallel import collective_merge
from tests.conftest import rand_seq
from tests.test_merge import _genomes, _write_fastas, _run_build


def _mesh(n):
    devs = np.asarray(jax.devices()[:n]).reshape(n)
    return jax.sharding.Mesh(devs, ("part",))


def _compare(tmp_path, mum_files, n_parts):
    host_out = str(tmp_path / "host.mums")
    coll_out = str(tmp_path / "coll.mums")
    host_merge.anchor_merge(mum_files, host_out)
    collective_merge.collective_anchor_merge(mum_files, coll_out,
                                             mesh=_mesh(n_parts))
    assert (tmp_path / "host.mums").read_bytes() == \
        (tmp_path / "coll.mums").read_bytes()
    assert (tmp_path / "host.athresh").read_bytes() == \
        (tmp_path / "coll.athresh").read_bytes()


def test_collective_merge_two_way(rng, tmp_path):
    genomes = _genomes(rng, 5)
    paths = _write_fastas(tmp_path, genomes, [f"g{i}" for i in range(5)])
    p1 = str(tmp_path / "p1")
    p2 = str(tmp_path / "p2")
    _run_build([paths[0], paths[1], paths[2]], p1, ["-M", "-n"])
    _run_build([paths[0], paths[3], paths[4]], p2, ["-M", "-n"])
    _compare(tmp_path, [p1 + ".mums", p2 + ".mums"], 2)


def test_collective_merge_four_way(rng, tmp_path):
    genomes = _genomes(rng, 9, base_len=600, n_mut=14)
    paths = _write_fastas(tmp_path, genomes, [f"h{i}" for i in range(9)])
    parts = []
    for k in range(4):
        pk = str(tmp_path / f"q{k}")
        members = [paths[0]] + paths[1 + 2 * k: 3 + 2 * k]
        _run_build(members, pk, ["-M", "-n"])
        parts.append(pk + ".mums")
    _compare(tmp_path, parts, 4)


def test_collective_merge_single_device_fallback(rng, tmp_path,
                                                 monkeypatch):
    """mesh=None with fewer addressable devices than partitions runs the
    SAME fold program on device 0 (no all_gather) — the 1-chip-host path
    of `merge --collective`. Byte-equal to the host fold."""
    genomes = _genomes(rng, 5)
    paths = _write_fastas(tmp_path, genomes, [f"s{i}" for i in range(5)])
    p1 = str(tmp_path / "p1")
    p2 = str(tmp_path / "p2")
    _run_build([paths[0], paths[1], paths[2]], p1, ["-M", "-n"])
    _run_build([paths[0], paths[3], paths[4]], p2, ["-M", "-n"])
    mum_files = [p1 + ".mums", p2 + ".mums"]
    monkeypatch.setattr(jax, "local_devices", lambda: jax.devices()[:1])
    host_out = str(tmp_path / "host.mums")
    coll_out = str(tmp_path / "coll.mums")
    host_merge.anchor_merge(mum_files, host_out)
    collective_merge.collective_anchor_merge(mum_files, coll_out, mesh=None)
    assert (tmp_path / "host.mums").read_bytes() == \
        (tmp_path / "coll.mums").read_bytes()
    assert (tmp_path / "host.athresh").read_bytes() == \
        (tmp_path / "coll.athresh").read_bytes()


def test_collective_merge_overlapping_anchor_mums(rng, tmp_path):
    """Partitions built from tandem-structured genomes so anchor MUMs
    overlap in coordinates — exercises the emit-chain trace."""
    core = rand_seq(rng, 120)
    base = core + core[: 60] + rand_seq(rng, 200)
    genomes = []
    for i in range(5):
        s = list(base)
        for _ in range(3 + i):
            j = int(rng.integers(0, len(s)))
            s[j] = rng.choice(list("ACGT"))
        genomes.append(rand_seq(rng, 25) + "".join(s) + rand_seq(rng, 25))
    paths = _write_fastas(tmp_path, genomes, [f"t{i}" for i in range(5)])
    p1 = str(tmp_path / "p1")
    p2 = str(tmp_path / "p2")
    _run_build([paths[0], paths[1], paths[2]], p1, ["-M", "-n"])
    _run_build([paths[0], paths[3], paths[4]], p2, ["-M", "-n"])
    _compare(tmp_path, [p1 + ".mums", p2 + ".mums"], 2)
