"""The GPU entry points refuse to run without a GPU: no result line, no
stored number, a non-zero exit."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_on_cpu(script, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", MUMEMTO_BENCH_MBP="0.01",
               MUMEMTO_BENCH_DOCS="2")
    return subprocess.run([sys.executable, os.path.join(ROOT, script),
                           *args], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=300)


@pytest.mark.parametrize("args", [(), ("--multi-gpu",)])
def test_chip_smoke_refuses_cpu(args):
    r = _run_on_cpu("chip_smoke.py", *args)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_bench_refuses_cpu():
    r = _run_on_cpu("bench.py")
    assert r.returncode != 0
    assert '"value"' not in r.stdout
    assert "no GPU" in r.stderr


def test_bench_omits_ratio_without_baseline(capsys):
    sys.path.insert(0, ROOT)
    import bench
    bench.emit(2.0, None)
    line = json.loads(capsys.readouterr().out)
    assert line["value"] == 2.0 and "vs_baseline" not in line
    bench.emit(2.0, 4.0)
    assert json.loads(capsys.readouterr().out)["vs_baseline"] == 0.5
