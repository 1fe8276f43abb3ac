"""C ABI (libmumemto_tpu.so) end-to-end: a plain C consumer must get the
same MUMs as the Python library API."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def capi_exe(tmp_path_factory):
    if shutil.which("gcc") is None:
        pytest.skip("no C compiler")
    r = subprocess.run([sys.executable,
                        os.path.join(ROOT, "native", "build_capi.py")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        pytest.skip(f"C ABI library build failed: {r.stderr}")
    exe = str(tmp_path_factory.mktemp("capi") / "test_capi")
    r = subprocess.run([
        "gcc", "-O2", "-o", exe,
        os.path.join(ROOT, "native", "test_capi.c"),
        "-I" + os.path.join(ROOT, "native"),
        "-L" + os.path.join(ROOT, "native"),
        "-Wl,-rpath," + os.path.join(ROOT, "native"),
        "-lmumemto_tpu",
    ], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return exe


def test_c_consumer_matches_python_library(capi_exe, rng):
    base = "".join(rng.choice(list("ACGT"), 500))
    docs = []
    for _ in range(3):
        s = list(base)
        for _ in range(4):
            s[int(rng.integers(0, len(s)))] = str(rng.choice(list("ACGT")))
        docs.append("".join(s))

    env = dict(os.environ)
    env["MUMEMTO_TPU_PYROOT"] = ROOT
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([capi_exe], input="\n".join(docs) + "\n",
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr

    from mumemto_tpu import library
    want = library.mum([[d] for d in docs])
    got = [l.split("\t") for l in r.stdout.splitlines()]
    assert len(got) == want.num_matches()
    for i, (ln, offs, strands) in enumerate(got):
        L, o, s = want.match_at(i)
        assert int(ln) == L
        assert [int(x) for x in offs.split(",")] == list(o)
        assert strands == "".join("+" if x else "-" for x in s)
