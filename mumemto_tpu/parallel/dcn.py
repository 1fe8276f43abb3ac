"""Multi-host (DCN) placement of MumemtoM partitions.

The reference's scale-out unit is the partition: run mumemto with merge
metadata once per collection partition — one host each, no communication
— then merge the partition MUM sets (README.md:124-142; fold core
src/merge_candidates.cpp:106-157,211-219). SURVEY §2.3 maps this to
accelerator clusters: partitions data-parallel across hosts over the data
center network (DCN), with the merge as the only collective step.
parallel/mumemtom.py runs that flow inside one process; this module adds
the cross-host placement layer: every process runs the SAME command,
`jax.distributed` wires the processes into one system, partition
assignment is a deterministic function of the process index, a global
device barrier replaces ad-hoc file polling, and process 0 merges — either
the host fold (analysis/merge.py) or the collective device fold
(parallel/collective_merge.py) over this host's local mesh.

Assumptions (stated, reference-shared): partition outputs land on a
filesystem process 0 can read — on a cluster that is the job's shared
scratch; the reference's own merge step reads all partition files on one
node the same way.

Tested with real separate processes (Gloo-backed CPU collectives) in
tests/test_dcn.py: 2-process run == single-process run_partitioned, byte
for byte.
"""

from __future__ import annotations

import os

from mumemto_tpu.parallel import mumemtom


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids: list[int] | None = None,
               heartbeat_timeout_seconds: int = 300,
               shutdown_timeout_seconds: int = 1200) -> None:
    """Wire this process into the multi-host system.

    Arguments default to the MUMEMTO_COORDINATOR / MUMEMTO_NUM_PROCESSES /
    MUMEMTO_PROCESS_ID / MUMEMTO_LOCAL_DEVICE_IDS environment variables.
    Without a coordinator, jax.distributed's own cluster detection (SLURM,
    Open MPI, ...) must supply them. Call once per process, before first
    device use.

    One process per card: a JAX process reserves most of the memory of
    every GPU it can see, so when several processes share a host each must
    be limited to its own card(s) — local_device_ids (e.g.
    MUMEMTO_LOCAL_DEVICE_IDS=2 for the host's third process; a comma list
    for several cards), or equivalently CUDA_VISIBLE_DEVICES per process.

    The timeout defaults are generous on purpose: partition scans are
    minutes-long batch work, not steady training steps, so a process may
    legitimately go quiet (device compile, host I/O) far longer than the
    jax defaults (100 s heartbeat / 300 s shutdown barrier) tolerate —
    measured: a loaded CI host blew the 300 s shutdown barrier."""
    import jax

    coordinator = coordinator or os.environ.get("MUMEMTO_COORDINATOR")
    if num_processes is None and "MUMEMTO_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["MUMEMTO_NUM_PROCESSES"])
    if process_id is None and "MUMEMTO_PROCESS_ID" in os.environ:
        process_id = int(os.environ["MUMEMTO_PROCESS_ID"])
    if local_device_ids is None and os.environ.get("MUMEMTO_LOCAL_DEVICE_IDS"):
        local_device_ids = [
            int(x) for x in os.environ["MUMEMTO_LOCAL_DEVICE_IDS"].split(",")]
    jax.distributed.initialize(
        coordinator_address=coordinator, num_processes=num_processes,
        process_id=process_id, local_device_ids=local_device_ids,
        heartbeat_timeout_seconds=heartbeat_timeout_seconds,
        shutdown_timeout_seconds=shutdown_timeout_seconds)


def barrier(name: str) -> None:
    """Block until every process reaches this point (one tiny allreduce
    over the global device set — DCN traffic only)."""
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def run_partitioned_dcn(files, output_prefix: str, *,
                        anchor: bool = True,
                        num_partitions: int | None = None,
                        min_match_len: int = 20,
                        use_revcomp: bool = True,
                        collective: bool = False,
                        verbose: bool = False) -> str:
    """SPMD MumemtoM: every host calls this with identical arguments.

    Partitioning is deterministic (mumemtom.auto_partition), so each
    process derives the same partition list and claims indices
    process_index, process_index + P, ... — no coordination needed until
    the post-scan barrier. Process 0 then merges (host fold, or the
    collective device fold over its local mesh with collective=True) and
    every process returns the merged path after a final barrier.

    jax.distributed must be initialized first (see initialize())."""
    import jax

    pid = jax.process_index()
    nproc = jax.process_count()
    parts = mumemtom.auto_partition(
        list(files), num_partitions or nproc, anchor=anchor)

    part_mums = []
    for i, pfiles in enumerate(parts):
        pfx = f"{output_prefix}_part{i}"
        part_mums.append(pfx + ".mums")
        if i % nproc == pid:
            mumemtom.scan_partition(pfiles, pfx, anchor=anchor,
                                    min_match_len=min_match_len,
                                    use_revcomp=use_revcomp,
                                    verbose=verbose)

    barrier("mumemto_dcn_partitions_done")

    merged = output_prefix + ".mums"
    merge_err = None
    if pid == 0:
        try:
            mumemtom.merge_partition_outputs(part_mums, output_prefix,
                                             collective=collective)
        except Exception as e:  # noqa: BLE001 — broadcast before raising
            merge_err = e
    # broadcast the merge outcome (the allgather doubles as the final
    # barrier) so a rank-0 failure raises EVERYWHERE instead of stranding
    # the other ranks until the shutdown timeout buries the real error
    import numpy as np
    from jax.experimental import multihost_utils

    ok = np.asarray(multihost_utils.process_allgather(
        np.asarray([merge_err is None], bool))).reshape(-1)
    if merge_err is not None:
        raise merge_err
    if not ok.all():
        raise RuntimeError("merge failed on process 0 — see its log")
    return merged
