"""Process-wide JAX configuration: persistent compilation cache.

Index construction compiles one program per text bucket size; caching them
on disk makes repeat runs and the test suite fast. Opt out with
MUMEMTO_TPU_NO_CACHE=1.

Where the cache lives (cache_dir below):
  * JAX_COMPILATION_CACHE_DIR, when set, exactly as given;
  * otherwise the fixed, git-ignored directory `.jax_cache/` at the root of
    the checkout. CPU-forced processes (tests, fuzz drivers, dry runs) use a
    host-fingerprinted subdirectory of it: XLA:CPU persists AOT machine code
    keyed without the exact CPU feature set, so an entry written on one VM
    type can be loaded on another that lacks an ISA extension (the loader
    warns of SIGILL; libgcc segfaults were seen under heavy CPU fuzzing).
"""

import hashlib
import os

_done = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(ROOT, ".jax_cache")


def _host_fingerprint() -> str:
    """Short stable id of this host's CPU feature set."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.sha1(line.encode()).hexdigest()[:12]
    except OSError:
        pass
    import platform
    return hashlib.sha1(platform.processor().encode()).hexdigest()[:12]


def cache_dir(cpu_forced: bool) -> str:
    """The compilation cache directory for this process."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if cpu_forced:
        return os.path.join(DEFAULT_DIR, f"cpu_{_host_fingerprint()}")
    return DEFAULT_DIR


def ensure_cache():
    global _done
    if _done or os.environ.get("MUMEMTO_TPU_NO_CACHE"):
        return
    _done = True
    import jax

    # CPU-forced processes set jax_platforms to exactly "cpu"
    path = cache_dir(str(jax.config.jax_platforms or "").strip() == "cpu")
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
