"""Multi-host DCN orchestration (parallel/dcn.py): a REAL 2-process
jax.distributed run (Gloo-backed CPU collectives, separate OS processes,
coordinator handshake, device barrier) must produce byte-identical merged
output to the single-process mumemtom.run_partitioned flow — host-fold
and collective (device-fold) merge variants.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from mumemto_tpu.parallel import mumemtom
from tests.conftest import mutated_collection

WORKER = r"""
import sys
sys.path.insert(0, sys.argv[6])
import os
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
from mumemto_tpu.parallel import dcn
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
out_prefix, filelist = sys.argv[4], sys.argv[5]
collective = sys.argv[7] == "1"
dcn.initialize(f"127.0.0.1:{port}", nproc, pid)
files = open(filelist).read().split()
dcn.run_partitioned_dcn(files, out_prefix, anchor=True,
                        collective=collective)
print("WORKER_OK", pid)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_collection(rng, tmp_path, n=5):
    docs = mutated_collection(rng, n, base_len=500)
    paths = []
    for i, d in enumerate(docs):
        p = tmp_path / f"g{i}.fa"
        p.write_text(f">g{i}\n{d[0]}\n")
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("collective", [False, True])
def test_dcn_two_process_equals_single(rng, tmp_path, collective):
    paths = _write_collection(rng, tmp_path)
    filelist = tmp_path / "files.txt"
    filelist.write_text("\n".join(paths))
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)

    # single-process reference on the identical deterministic partitions
    single_prefix = str(tmp_path / "single")
    parts = mumemtom.auto_partition(paths, 2, anchor=True)
    assert len(parts) == 2
    mumemtom.run_partitioned(parts, single_prefix, anchor=True)

    dcn_prefix = str(tmp_path / "dcn")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}

    def run_pair():
        port = _free_port()
        procs = [
            subprocess.Popen(
                [sys.executable, str(worker), str(pid), "2", str(port),
                 dcn_prefix, str(filelist), os.path.dirname(
                     os.path.dirname(os.path.abspath(__file__))),
                 "1" if collective else "0"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=env)
            for pid in (0, 1)
        ]
        outs = [p.communicate(timeout=600)[0] for p in procs]
        return procs, outs

    procs, outs = run_pair()
    if any(p.returncode != 0 for p in procs):
        # Gloo's connect/KV-store waits are hard-capped at ~30 s; on an
        # oversubscribed CI host (this suite runs 4 xdist workers on as
        # little as ONE core) a peer can miss that window — and the
        # resulting error text varies (DEADLINE_EXCEEDED / timed out /
        # connection refused from the half-initialized peer), so retry on
        # ANY first-attempt failure with a fresh port. A genuine logic
        # failure reproduces here, and the byte-equality check below is
        # the real correctness assertion either way.
        procs, outs = run_pair()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
        assert "WORKER_OK" in out, out[-2000:]

    # each partition must have been produced by a DIFFERENT process —
    # placement is by index mod process count
    with open(str(tmp_path / "single") + ".mums", "rb") as f:
        want = f.read()
    with open(dcn_prefix + ".mums", "rb") as f:
        got = f.read()
    assert want == got


@pytest.mark.parametrize("env,want", [("", None), ("2", [2]),
                                      ("0,1", [0, 1])])
def test_initialize_pins_local_cards(monkeypatch, env, want):
    """One process per card: MUMEMTO_LOCAL_DEVICE_IDS reaches
    jax.distributed.initialize as local_device_ids."""
    import jax

    from mumemto_tpu.parallel import dcn
    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    monkeypatch.setenv("MUMEMTO_LOCAL_DEVICE_IDS", env)
    dcn.initialize("localhost:1234", 4, 1)
    assert seen["local_device_ids"] == want
    assert (seen["coordinator_address"], seen["num_processes"],
            seen["process_id"]) == ("localhost:1234", 4, 1)
