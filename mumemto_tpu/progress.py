"""Progress reporting: the reference's ANSI bar + tqdm surface.

The reference draws an in-place progress bar from its SA-row stream
(pfp_lcp_mum.hpp:54-63, printProgress) and uses tqdm throughout the Python
tools (mumemto/utils.py). An array engine has no row loop to hook — the
natural granularity is the pipeline PHASE, so the bar advances through
weighted stages (parse, dict SA/LCP, expansion sort, interval scan, emit)
as each device program completes.

Enabled when stderr is a tty, forced on/off with MUMEMTO_TPU_PROGRESS=1/0;
library calls keep it off (the mumemto_set_progress_enabled analog,
pfp_lcp_mum.hpp:46-52). When off (the default for piped/driver runs) the
hook is a no-op and adds NO device syncs to the dispatch path.
"""

from __future__ import annotations

import os
import sys
import time

# stage -> cumulative fraction of the bar (rough stage weights; names
# MUST match the phase() emissions in ops/pfp (build_pfp +
# pfp_scan_prepare split path) and engine — tests/test_progress.py
# guards the mapping)
_STAGES = (
    ("ext_upload", 0.05),
    ("breaks", 0.09),
    ("phrase_sort", 0.12),
    ("build_pfp", 0.16),
    ("dict_index", 0.66),
    ("parse_side", 0.72),
    ("expand_analyze", 0.93),
    ("scan_dispatch", 0.94),
    ("counts_sync", 0.95),
    ("arrays_out", 0.96),
    ("compact_readback", 0.99),
    ("emit_mums", 1.0),
    ("emit_mems", 1.0),
)

_active: "PhaseBar | None" = None


def enabled() -> bool:
    env = os.environ.get("MUMEMTO_TPU_PROGRESS")
    if env is not None:
        return env not in ("", "0")
    return sys.stderr.isatty()


class PhaseBar:
    """printProgress-style in-place bar (pfp_lcp_mum.hpp:54-63), advanced
    by pipeline phase completions."""

    WIDTH = 40

    def __init__(self, label: str = "mumemto"):
        self.label = label
        self.t0 = time.time()
        self.frac = 0.0
        self._draw()

    def _draw(self):
        filled = int(self.frac * self.WIDTH)
        bar = "#" * filled + "-" * (self.WIDTH - filled)
        sys.stderr.write(
            f"\r[{self.label}] |{bar}| {self.frac * 100:5.1f}% "
            f"({time.time() - self.t0:.1f}s)")
        sys.stderr.flush()

    def advance(self, stage: str):
        for name, frac in _STAGES:
            if stage == name:
                self.frac = max(self.frac, frac)
                self._draw()
                return

    def close(self):
        self.frac = 1.0
        self._draw()
        sys.stderr.write("\n")
        sys.stderr.flush()


def activate(label: str = "mumemto") -> "PhaseBar | None":
    """Install a bar as the pipeline-wide hook (no-op when not enabled)."""
    global _active
    if not enabled():
        return None
    _active = PhaseBar(label)
    return _active


def deactivate():
    global _active
    if _active is not None:
        _active.close()
    _active = None


def active() -> "PhaseBar | None":
    return _active


def iter_with_progress(iterable, total: int | None = None,
                       desc: str = "", every: int = 1):
    """tqdm-equivalent for host loops (chunked file readers, per-MUM
    emitters): in-place counter on stderr when enabled, plain passthrough
    otherwise."""
    if not enabled():
        yield from iterable
        return
    t0 = time.time()
    for i, item in enumerate(iterable):
        if i % every == 0:
            tot = f"/{total}" if total else ""
            sys.stderr.write(f"\r[{desc}] {i + 1}{tot} "
                             f"({time.time() - t0:.1f}s)")
            sys.stderr.flush()
        yield item
    sys.stderr.write("\n")
    sys.stderr.flush()
