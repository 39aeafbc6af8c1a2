"""The multi-process runtime: one mesh over the shards of several
processes, merged by `torch.distributed` collectives.

The counterpart of the reference package's `parallel/distributed.py`,
which wraps `jax.distributed` and builds one global mesh over every
device of every process, so the same `shard_map` programs merge across
the process boundary. Here each process joins a `torch.distributed`
process group (`initialize`), contributes its local devices to one mesh
that every rank builds identically (`global_mesh`: rank 0's shards
first, as `jax.devices()` orders processes), and drives only its own
shards; the merges of `parallel.mesh` turn into collectives over the
group (all-gathers reduced in shard order, so the bits equal a
one-process mesh of the same size).

Usage, on each process (the same program):

    from geomesa_tpu_torch.parallel.distributed import initialize, global_mesh
    initialize("tcp://host0:29511", num_processes=2, process_id=RANK)
    mesh = global_mesh()                 # each rank's own cards, rank order
    ds.set_mesh(mesh)                    # each rank uploads its shards
    grid = density_sharded(mesh, ...)    # the psum crosses processes

The contract, as in the reference: every process issues the same
collectives in the same order, so every rank runs the same queries (the
same requests, in the same order, in the same windows when serving).
Host data feeding follows the reference's: every process reads the
whole superbatch on the host (a shared filesystem) and uploads only its
shards' rows; `process_partitions` is the per-process partition split
for writers. Shared-storage writes (store metadata, the device-cache
and warm-up manifests, sketch sidecars, sentinel baselines) are gated on
`is_coordinator`; per-process debug artifacts (flight dumps,
`geomesa.profile.dir` traces) take `process_suffix`.
"""

from __future__ import annotations

import datetime
import hashlib
import logging
import os
from typing import Optional, Sequence

import torch

from geomesa_tpu_torch.parallel.mesh import Mesh

log = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 120.0

_backend: Optional[str] = None


def _dist():
    """`torch.distributed` when this build has it, else None."""
    try:
        import torch.distributed as dist
    except ImportError:  # pragma: no cover - builds without distributed
        return None
    return dist if dist.is_available() else None


def _running() -> bool:
    dist = _dist()
    return dist is not None and dist.is_initialized()


def _init_method(coordinator: str) -> str:
    if "://" in coordinator:
        return coordinator
    return f"tcp://{coordinator}"


def host_layout(process_id: int, num_processes: int) -> tuple:
    """(this rank's index among the ranks of its host, the number of
    ranks on its host): `LOCAL_RANK` / `LOCAL_WORLD_SIZE` where the
    launcher sets them (torchrun does), else every rank is on this host."""
    local_n = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    local_r = int(os.environ.get("LOCAL_RANK", int(process_id) % local_n))
    return local_r, local_n


def rank_cards(local_rank: int, local_n: int, cards: int) -> list:
    """The indices of a rank's cards among its host's `cards`: an equal
    slice when every rank of the host has a card of its own, else the one
    card it shares (`local_rank % cards`); none without cards."""
    if cards <= 0:
        return []
    if cards >= local_n:
        per = cards // local_n
        return list(range(local_rank * per, (local_rank + 1) * per))
    return [local_rank % cards]


def _cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def default_backend(process_id: int, num_processes: int) -> str:
    """"nccl" when every rank on this host has a card of its own, else
    "gloo" (the CPU, or ranks that share a card: NCCL does not put two
    ranks of one communicator on one card)."""
    cards = _cards()
    return "nccl" if cards and cards >= host_layout(
        process_id, num_processes)[1] else "gloo"


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """`torch.distributed.init_process_group` with the reference's
    environment fallback (GEOMESA_TPU_COORDINATOR / _NUM_PROCESSES /
    _PROCESS_ID). `coordinator` is `host:port`, `tcp://host:port` or a
    `file://` path. The backend is `backend` when given, else "nccl" when
    every rank of this host has a card of its own and "gloo" otherwise
    (the CPU, or ranks that share a card; `default_backend`); the choice
    is logged and returned (`backend()`). Under NCCL this rank's first
    card (`rank_devices`) becomes its current device, the one its
    communicator is bound to. The group's `timeout_s` is finite, so a
    mismatched collective raises instead of hanging."""
    global _backend
    dist = _dist()
    if dist is None:
        raise RuntimeError("torch.distributed is not available in this build")
    coordinator = coordinator or os.environ.get("GEOMESA_TPU_COORDINATOR")
    if num_processes is None and "GEOMESA_TPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["GEOMESA_TPU_NUM_PROCESSES"])
    if process_id is None and "GEOMESA_TPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["GEOMESA_TPU_PROCESS_ID"])
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize needs the coordinator, the number of processes and "
            "this process's id (arguments or GEOMESA_TPU_COORDINATOR / "
            "GEOMESA_TPU_NUM_PROCESSES / GEOMESA_TPU_PROCESS_ID)")
    if backend is None:
        backend = default_backend(process_id, num_processes)
    if backend == "nccl":
        torch.cuda.set_device(rank_cards(*host_layout(process_id, num_processes),
                                         _cards())[0])
    dist.init_process_group(
        backend=backend, init_method=_init_method(coordinator),
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    _backend = backend
    log.info("process %d of %d joined over %s (%s)", int(process_id),
             int(num_processes), backend, coordinator)
    return backend


def backend() -> Optional[str]:
    """The process group's backend ("nccl" or "gloo"), None before
    `initialize`."""
    if not _running():
        return None
    return _backend or str(_dist().get_backend())


def shutdown() -> None:
    """Leave the process group (a no-op when none is running)."""
    global _backend
    if _running():
        _dist().destroy_process_group()
    _backend = None


def process_index() -> int:
    return int(_dist().get_rank()) if _running() else 0


def process_count() -> int:
    return int(_dist().get_world_size()) if _running() else 1


def is_coordinator() -> bool:
    """True on rank 0, and in every single-process run (no process group:
    one check).

    This is the gate for shared-storage side effects: store metadata,
    device-cache manifests, sketch sidecars, warm-up manifests, sentinel
    baselines. Exactly
    one process may perform them, or N processes race identical (or
    worse, divergent) writes into one file. Per-partition data writes
    stay per-process by design (`process_partitions`) and are waived,
    not gated."""
    return not _running() or _dist().get_rank() == 0


def process_suffix() -> str:
    """'' in a single-process run, '.p<rank>' in a process group:
    appended to per-process debug artifacts (flight dumps) whose value is
    per process, so processes never collide on shared storage yet
    nothing is lost."""
    if _running() and _dist().get_world_size() > 1:
        return f".p{_dist().get_rank()}"
    return ""


def runtime_fingerprint() -> int:
    """A 31-bit digest of what shapes every program here: the torch and
    CUDA versions, the `geomesa.coord.dtype` default and the kernel
    sources' build digests (`engine.kernels.build.library_path`; nothing
    is built). Two processes with different fingerprints would run
    different programs against one mesh: mismatched collectives."""
    from geomesa_tpu_torch.engine.kernels import build
    from geomesa_tpu_torch.utils.config import SystemProperties

    parts = [torch.__version__, str(torch.version.cuda),
             str(SystemProperties.COORD_DTYPE.get())]
    parts += [build.library_path(n).name for n in build.sources()]
    digest = hashlib.sha256("|".join(parts).encode("utf-8")).digest()
    return int.from_bytes(digest[:4], "big") & 0x7FFFFFFF


def assert_uniform_runtime() -> None:
    """Collectively verify that every process runs the same program-
    shaping configuration before any kernel dispatches: a MIN and a MAX
    of each rank's `runtime_fingerprint()` over the group (int64) must
    agree. Raises RuntimeError on a spread (the worker should die loudly
    now, not deadlock at the first real merge). A no-op on one process.
    Call it right after `initialize()` (`parallel.launch` does)."""
    from geomesa_tpu_torch.parallel.mesh import reduce_int

    if not _running():
        return
    fp = runtime_fingerprint()
    lo, hi = reduce_int(fp, "min"), reduce_int(fp, "max")
    if lo != hi:
        raise RuntimeError(
            f"divergent runtime configuration across processes: "
            f"fingerprint spread [{lo}, {hi}], local {fp} (process "
            f"{process_index()}/{process_count()}). Check geomesa.coord.dtype, "
            f"the torch and CUDA versions and the kernel sources on every "
            f"host: divergent programs deadlock at the first collective.")


def rank_devices() -> list:
    """This rank's cards: every card without a process group, else its
    slice of its host's cards (`rank_cards`), so no two ranks put shards
    on each other's cards."""
    local_r, local_n = (host_layout(process_index(), process_count())
                        if _running() else (0, 1))
    return [torch.device("cuda", i) for i in rank_cards(local_r, local_n, _cards())]


def global_mesh(local: Optional[Sequence] = None) -> Mesh:
    """One 1-D mesh over every rank's shards. Each rank contributes its
    local device list (`local`, which may repeat a device, such as
    `["cuda:0"] * 2`; by default `rank_devices()`), the lists are
    all-gathered, and every rank builds the identical mesh: shards in
    rank order, each owned by the rank that contributed it. Without a
    process group it is a one-process mesh over `local`."""
    devs = [str(torch.device(d)) for d in (local if local is not None
                                           else rank_devices())]
    if not devs:
        from geomesa_tpu_torch.errors import CudaUnavailableError

        raise CudaUnavailableError(
            "no CUDA device for a global mesh; pass the local devices "
            "explicitly (e.g. ['cpu'] * 2) to run one on the CPU")
    if not _running():
        return Mesh(devs)
    dist = _dist()
    got: list = [None] * dist.get_world_size()
    dist.all_gather_object(got, devs)
    devices, owners = [], []
    for r, mine in enumerate(got):
        devices += mine
        owners += [r] * len(mine)
    # another rank's "cuda:1" names a card of its own host: the devices
    # are kept as names, and only this rank's are ever touched
    return Mesh(devices, owners=owners, rank=dist.get_rank())


def process_partitions(partitions, process_id: Optional[int] = None,
                       num_processes: Optional[int] = None):
    """Deterministic partition -> process assignment for process-local
    feeding: process i takes sorted(partitions)[i::P]. The same list on
    every process gives disjoint, exhaustive coverage."""
    pid = process_id if process_id is not None else process_index()
    n = num_processes if num_processes is not None else process_count()
    return sorted(partitions)[pid::n]
