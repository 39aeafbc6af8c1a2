"""Meshes of devices, row-sharded arrays and the merges over them.

The counterpart of the reference package's `parallel/mesh.py`. The
reference places arrays with `NamedSharding(mesh, P("shard"))` and
merges inside `shard_map` with `all_gather` and `psum`; under
`jax.distributed` the same programs merge across processes. The port
makes the merges explicit:

- `Mesh` is an ordered tuple of `torch.device`s over the one axis
  `SHARD_AXIS`, and the rank of the process that owns each shard
  (`owners`); `devices.shape` is `(D,)`, so the `mesh_shape` strings
  equal the reference's, and two meshes over the same devices and owners
  are equal. The device list may repeat a device: four shards on `cpu`,
  or four on `cuda:0`, run every per-shard launch and every merge on one
  device. A mesh built by one process (`default_mesh`) owns every
  shard; `parallel.distributed.global_mesh` builds one whose shards
  belong to the ranks of a `torch.distributed` process group
  (`spans_processes`), each rank driving its own shards (`local`).
- A row-sharded array is `Sharded`: D shards of equal length, shard i
  holding rows [i*S, (i+1)*S) on `devices[i]`. A process holds only its
  own shards; the others' entries are None. `shards_of` cuts a whole
  tensor into this process's shards (views where a shard's device is the
  tensor's own); `shard_batch_host` uploads a host batch's rows shard by
  shard, each straight from the host to its device as its own allocation
  (the reference's `NamedSharding` placement), so no device ever holds
  more than its shard, even where the mesh repeats a device.
- Per-shard work loops over `my_shards(mesh)`, one shard after
  another with no host sync between them, each under its shard's device
  (`on_shard`), so on several cards the launches overlap.
- The merges take one partial a local shard and give every process the
  whole result on its lead device (`lead`, its first shard's), as the
  reference's replicated `P()` outputs: `merge_topk` is the all-gather +
  re-top-k of the sharded kNN programs, `psum` adds the shards' partial
  results in shard order, `any_of` ORs flags, `pmax` and `host_sum`
  reduce host integers. On a mesh that spans processes they are
  collectives over the default process group: `psum` and `merge_topk`
  all-gather the partials and reduce them in shard order (not
  `all_reduce`, whose order is the backend's), so the bits equal a
  one-process mesh of the same D.
  Under gloo the partials cross through pinned host memory; under NCCL
  they stay on the card.
- Anything that must see a whole sharded column calls `gather`, which
  counts itself under `mesh.gathers` with the column's name and, where
  another process holds shards, raises `RemoteShardError`.

Every process of a process mesh must issue the same collectives in the
same order: each decision that leads to a collective is taken from a
merged value, never from a local one.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from geomesa_tpu_torch.core.columnar import DictColumn, FeatureBatch, GeometryColumn
from geomesa_tpu_torch.engine.device import (
    VALID, DeviceBatch, _indexed, to_device, to_device_parts)
from geomesa_tpu_torch.errors import CudaUnavailableError, RemoteShardError
from geomesa_tpu_torch.utils.metrics import metrics

SHARD_AXIS = "shard"

# per-feature keys whose leading axis is NOT the batch axis (the CSR and
# edge tables of extended geometries): they stay replicated
_REPLICATED_SUFFIXES = ("__verts", "__rings", "__featr", "__vfeat", "__ex1",
                        "__ey1", "__ex2", "__ey2", "__efeat")


class Mesh:
    """An ordered 1-D mesh of devices (axis `SHARD_AXIS`). Equality is by
    value: the same devices, owners and axis names in the same order.

    `owners[i]` is the rank (in the default process group) of the
    process that drives shard i, and `rank` this process's; without
    owners every shard is this process's."""

    def __init__(self, devices: Sequence, axis_names=(SHARD_AXIS,),
                 owners: Optional[Sequence[int]] = None, rank: int = 0):
        devs = [_indexed(torch.device(d)) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty(len(devs), dtype=object)
        for i, d in enumerate(devs):
            self.devices[i] = d
        self.axis_names = tuple(axis_names)
        self.owners = (tuple(int(o) for o in owners) if owners is not None
                       else (int(rank),) * len(devs))
        if len(self.owners) != len(devs):
            raise ValueError(f"{len(self.owners)} owners for {len(devs)} shards")
        self.rank = int(rank)
        self.local = tuple(i for i, o in enumerate(self.owners) if o == self.rank)
        if not self.local:
            raise ValueError(f"rank {self.rank} owns no shard of the mesh")
        # each shard's position among its owner's shards (the all-gather
        # layout of `exchange`)
        seen: dict = {}
        self._pos = []
        for o in self.owners:
            self._pos.append(seen.get(o, 0))
            seen[o] = seen.get(o, 0) + 1
        self._per_rank = max(seen.values())
        self.ranks = tuple(sorted(seen))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> tuple:
        return tuple(self.devices.tolist())

    @property
    def lead(self) -> torch.device:
        """The device this process's merges run on and results come back
        to: its first shard's."""
        return self.devices[self.local[0]]

    @property
    def spans_devices(self) -> bool:
        """True when this process's shards live on more than one device
        (copies between devices happen); False for a mesh that repeats
        one device."""
        return len({self.devices[i] for i in self.local}) > 1

    @property
    def spans_processes(self) -> bool:
        """True when other processes own shards: the merges are then
        collectives over the process group."""
        return len(self.ranks) > 1

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.device_list == other.device_list
                and self.axis_names == other.axis_names
                and self.owners == other.owners and self.rank == other.rank)

    def __hash__(self) -> int:
        return hash((self.device_list, self.axis_names, self.owners, self.rank))

    def __repr__(self) -> str:
        tail = f", owners={list(self.owners)}" if self.spans_processes else ""
        return f"Mesh({[str(d) for d in self.device_list]}, {self.axis_names}{tail})"


def my_shards(mesh: Mesh):
    """(shard index, device) of every shard this process drives, in
    shard order."""
    return [(i, mesh.devices[i]) for i in mesh.local]


def local_devices() -> List[torch.device]:
    """Every card of this process (none when CUDA is absent)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def default_mesh(devices=None) -> Mesh:
    """A mesh over `devices` (a list that may repeat a device, such as
    `["cpu"] * 4`), or over every card when None."""
    if devices is None:
        devices = local_devices()
        if not devices:
            raise CudaUnavailableError(
                "no CUDA device for a default mesh; pass the devices "
                "explicitly (e.g. ['cpu'] * 4) to run a mesh on the CPU")
    return Mesh(devices)


def serve_mesh(spec="auto", devices=None) -> Optional[Mesh]:
    """Resolve a `ServeConfig.mesh` spec to a serving mesh, or None for
    the single-device path (the reference's rules):

      None / "off" / 1 -> None;
      "auto"           -> every card when more than one exists, else None;
      N (int or str)   -> the first N devices (ValueError if fewer);
      a Mesh           -> passed through.

    `devices` replaces the local cards as the pool (a test's CPU list)."""
    if spec is None or isinstance(spec, Mesh):
        return spec
    if isinstance(spec, str):
        s = spec.strip().lower()
        if s in ("off", "none", "", "1"):
            return None
        if s == "auto":
            devs = list(devices) if devices is not None else local_devices()
            return default_mesh(devs) if len(devs) > 1 else None
        try:
            spec = int(s)
        except ValueError:
            raise ValueError(
                f"mesh spec must be auto|N|off, got {spec!r}") from None
    if spec <= 1:
        return None
    devs = list(devices) if devices is not None else local_devices()
    if len(devs) < spec:
        raise ValueError(
            f"mesh={spec} requested but only {len(devs)} device(s) available")
    return default_mesh(devs[:spec])


class Sharded:
    """A row-sharded array: `shards[i]` holds rows [i*S, (i+1)*S) on
    `mesh.devices[i]`, every shard S rows long. On a mesh that spans
    processes only this process's shards are held (`mesh.local`); the
    others' entries are None. `shape`, `len` and `shard_rows` are the
    whole array's."""

    __slots__ = ("mesh", "shards")

    def __init__(self, mesh: Mesh, shards: Sequence[Optional[torch.Tensor]]):
        shards = list(shards)
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size}")
        if any(shards[i] is None for i in mesh.local):
            raise ValueError("a local shard is missing")
        held = [s for s in shards if s is not None]
        if len({int(s.shape[0]) for s in held}) != 1:
            raise ValueError("shards of unequal length")
        self.mesh = mesh
        self.shards = shards

    @classmethod
    def from_local(cls, mesh: Mesh, parts: Sequence[torch.Tensor]) -> "Sharded":
        """A `Sharded` of this process's shards (one a local shard, in
        shard order)."""
        out: list = [None] * mesh.size
        for i, p in zip(mesh.local, parts):
            out[i] = p
        return cls(mesh, out)

    @property
    def local_shards(self) -> List[torch.Tensor]:
        """This process's shards, in shard order."""
        return [self.shards[i] for i in self.mesh.local]

    @property
    def shard_rows(self) -> int:
        return int(self.shards[self.mesh.local[0]].shape[0])

    @property
    def shape(self) -> tuple:
        first = self.shards[self.mesh.local[0]]
        return (self.shard_rows * len(self.shards),) + tuple(first.shape[1:])

    def __len__(self) -> int:
        return self.shape[0]

    def full(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The whole array on `device` (the lead device by default);
        `RemoteShardError` where another process holds shards."""
        if self.mesh.spans_processes:
            raise RemoteShardError(
                f"the whole of a {self.shape} array sharded over {self.mesh} "
                "is asked for, but other processes hold its shards")
        device = self.mesh.lead if device is None else device
        return torch.cat([s.to(device) for s in self.shards])

    def map(self, fn) -> "Sharded":
        """`fn(shard)` on every local shard, under its device: a `Sharded`
        of the results (row-aligned maps only)."""
        out: list = [None] * self.mesh.size
        for i, dev in my_shards(self.mesh):
            with on_shard(dev):
                out[i] = fn(self.shards[i])
        return Sharded(self.mesh, out)


def gather(arr, name: str) -> torch.Tensor:
    """The whole of a sharded column on the lead device, for a caller
    that must see every row at once; counted under `mesh.gathers` (and
    per column, `mesh.gathers{column=...}`). A whole tensor passes
    through uncounted. On a mesh that spans processes the gather is
    counted, then refused with `RemoteShardError`: a whole column is
    never assembled from other processes' shards."""
    if not isinstance(arr, Sharded):
        return arr
    metrics.counter("mesh.gathers")
    metrics.counter("mesh.gathers", column=name)
    return arr.full()


@contextlib.contextmanager
def on_shard(device: torch.device):
    """Make `device` current for a shard's launches (its kernels, their
    temporaries and the current stream are that card's); a no-op off
    CUDA."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            yield
    else:
        yield


def replicated(mesh: Mesh, x: torch.Tensor) -> tuple:
    """`x` on every local shard's device, one entry per shard (the same
    tensor where the device is x's own, so a repeated device copies
    nothing; None for another process's shard)."""
    return tuple(x.to(d) if o == mesh.rank else None
                 for d, o in zip(mesh.device_list, mesh.owners))


def shard_view(arr, shard: int, shard_rows: int,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Rows [shard*S, (shard+1)*S) of a row-sharded or whole array on
    `device`: the shard itself when `arr` is `Sharded` with that shard
    size and device, a view when a whole tensor already lies on `device`,
    a copy otherwise. The shard-affinity route runs one device's kernel
    on this; staged query pairs (a whole array, shard 0 of its own
    length) resolve to the owning device's copy."""
    if isinstance(arr, Sharded):
        if arr.shard_rows == shard_rows and arr.shards[shard] is not None:
            out = arr.shards[shard]
            return out if device is None else out.to(device)
        arr = gather(arr, "shard_view")  # another layout: counted
    lo = shard * shard_rows
    out = arr[lo:lo + shard_rows]
    return out if device is None else out.to(device)


def shards_of(mesh: Mesh, arr) -> List[torch.Tensor]:
    """The per-shard tensors of `arr` (a `Sharded` over `mesh`, or a whole
    tensor whose length divides by the mesh size): one entry a shard,
    None for another process's."""
    if isinstance(arr, Sharded):
        if arr.mesh != mesh:
            raise ValueError(f"array sharded over {arr.mesh}, not {mesh}")
        return list(arr.shards)
    n = int(arr.shape[0])
    d = mesh.size
    if n % d:
        raise ValueError(f"length {n} does not divide into {d} shards; pad first")
    s = n // d
    out: list = [None] * d
    for i, dev in my_shards(mesh):
        out[i] = shard_view(arr, i, s, dev)
    return out


def shard_device_batch(dev: DeviceBatch, mesh: Mesh) -> dict:
    """Shard the feature-axis tensors of a device batch over the mesh
    (`Sharded`); the CSR and edge tables stay replicated (a tuple, one
    entry per shard). The batch length must divide by the mesh size (pad
    first; the validity mask keeps padding inert)."""
    n = int(dev[VALID].shape[0])
    d = mesh.size
    if n % d:
        raise ValueError(
            f"batch length {n} not divisible by mesh size {d}; pad_to first")
    out = {}
    for k, v in dev.items():
        if v.ndim >= 1 and v.shape[0] == n and not k.endswith(_REPLICATED_SUFFIXES):
            out[k] = Sharded(mesh, shards_of(mesh, v))
        else:
            out[k] = replicated(mesh, v)
    return out


def host_rows(batch: FeatureBatch, lo: int, hi: int) -> FeatureBatch:
    """Rows [lo, hi) of a batch: slices (views) of its array, dictionary
    and point columns, a gather for anything else."""
    if not all(isinstance(c, (np.ndarray, DictColumn))
               or (isinstance(c, GeometryColumn) and c.is_point)
               for c in batch.columns.values()):
        return batch.select(np.arange(lo, hi))
    cols = {}
    for name, col in batch.columns.items():
        if isinstance(col, np.ndarray):
            cols[name] = col[lo:hi]
        elif isinstance(col, DictColumn):
            cols[name] = DictColumn(col.codes[lo:hi], col.vocab)
        else:
            cols[name] = GeometryColumn(col.kind, col.x[lo:hi], col.y[lo:hi])
    fids = batch.fids.take(np.arange(lo, hi)) if batch.fids is not None else None
    valid = batch.valid[lo:hi] if batch.valid is not None else None
    return FeatureBatch(batch.sft, cols, fids, valid)


def _flat(batch: FeatureBatch) -> bool:
    """Every row-axis column is one value a row (no CSR tables)."""
    return all(not isinstance(c, GeometryColumn) or c.is_point
               for c in batch.columns.values())


def upload_rows(batch: FeatureBatch, bounds, devices,
                coord_dtype: torch.dtype = torch.float32) -> List[DeviceBatch]:
    """Rows [lo, hi) of a flat host batch for each (lo, hi) of `bounds`,
    on the matching device of `devices`: from the host straight to that
    device (pinned memory, non_blocking on a card), each tensor its own
    allocation, all in one transfer (`engine.device.to_device_parts`)."""
    return to_device_parts([host_rows(batch, lo, hi) for lo, hi in bounds],
                           devices, coord_dtype)


def assemble(mesh: Mesh, parts: Sequence[DeviceBatch]) -> dict:
    """Per-shard device batches (one a local shard, in shard order, same
    keys) as one dict of `Sharded` columns."""
    return {k: Sharded.from_local(mesh, [p[k] for p in parts]) for k in parts[0]}


def shard_batch_host(batch: FeatureBatch, mesh: Mesh,
                     coord_dtype: torch.dtype = torch.float32) -> dict:
    """Host FeatureBatch -> padded, sharded device batch. A flat batch
    (points, no CSR tables) uploads each shard's rows from the host
    straight to its device (`upload_rows`); a batch with CSR tables
    uploads to the lead device once and is cut there
    (`shard_device_batch`: the tables stay replicated)."""
    d = mesh.size
    n = len(batch)
    padded = batch.pad_to(((n + d - 1) // d) * d) if n % d else batch
    if padded.valid is None:
        padded = padded.pad_to(len(padded))  # force a validity mask
    if not _flat(padded):
        return shard_device_batch(to_device(padded, mesh.lead, coord_dtype),
                                  mesh)
    s = len(padded) // d
    return assemble(mesh, upload_rows(
        padded, [(i * s, (i + 1) * s) for i in mesh.local],
        [mesh.devices[i] for i in mesh.local], coord_dtype))


def shard_dicts(mesh: Mesh, dev: dict) -> List[dict]:
    """A sharded device batch (`Sharded` columns, replicated tuples) as
    one plain device batch a shard: shard i's rows and its copy of every
    replicated table, all on `mesh.devices[i]` (None for another
    process's shard)."""
    out: list = [None] * mesh.size
    for i in mesh.local:
        out[i] = {k: (v.shards[i] if isinstance(v, Sharded) else v[i])
                  for k, v in dev.items()}
    return out


# -- the merges ----------------------------------------------------------------


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    """`t` as a collective of the group's backend takes it: under NCCL
    on this rank's current card (the one its communicator is bound to),
    else in host memory (a card's tensor copied to pinned memory; gloo's
    support for CUDA tensors is not relied on). Bool crosses as uint8."""
    import torch.distributed as dist

    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if str(dist.get_backend()) == "nccl":
        return t.to(torch.device("cuda", torch.cuda.current_device())).contiguous()
    if t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host
    return t.contiguous()


def exchange(mesh: Mesh, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every shard's partial, in shard order, on the lead device. `parts`
    holds this process's: one a local shard, in shard order, of one
    shape and dtype across the mesh. On a mesh that spans processes each
    rank all-gathers the others' (padded to the most shards a rank
    owns), so every rank ends with the same list."""
    lead = mesh.lead
    if len(parts) != len(mesh.local):
        raise ValueError(f"{len(parts)} partials for {len(mesh.local)} local shards")
    if not mesh.spans_processes:
        return [p.to(lead) for p in parts]
    import torch.distributed as dist

    dtype = parts[0].dtype
    stacked = _to_wire(torch.stack([p.to(lead) for p in parts]))
    short = mesh._per_rank - stacked.shape[0]
    if short:
        stacked = torch.cat([stacked, stacked.new_zeros(
            (short,) + tuple(stacked.shape[1:]))])
    got = [torch.empty_like(stacked) for _ in mesh.ranks]
    dist.all_gather(got, stacked)
    where = {r: j for j, r in enumerate(mesh.ranks)}
    out = []
    for o, pos in zip(mesh.owners, mesh._pos):
        out.append(got[where[o]][pos].to(lead).to(dtype))
    return out


def reduce_int(value: int, op: str) -> int:
    """`op` ("min", "max" or "sum") of a host integer over every process
    of the default group, as int64: on the card under NCCL, in host
    memory otherwise."""
    import torch.distributed as dist

    t = torch.tensor([int(value)], dtype=torch.int64)
    if str(dist.get_backend()) == "nccl":
        t = t.cuda()  # this rank's current card
    dist.all_reduce(t, op={"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX,
                           "sum": dist.ReduceOp.SUM}[op])
    return int(t.item())


def pmax(mesh: Mesh, value: int) -> int:
    """The MAX of an integer over every process of the mesh (the value
    itself on a one-process mesh)."""
    return reduce_int(value, "max") if mesh.spans_processes else int(value)


def host_sum(mesh: Mesh, value: int) -> int:
    """The sum of a host integer over every process of the mesh (each
    process's value: the sum over its local shards)."""
    return reduce_int(value, "sum") if mesh.spans_processes else int(value)


def _bits64(t: torch.Tensor) -> torch.Tensor:
    """The bits of a 4- or 8-byte tensor as int64 (4-byte values widened
    from their int32 view), so tensors of different dtypes can cross in
    one collective; `_from_bits64` gives them back unchanged."""
    if t.element_size() == 4:
        return t.view(torch.int32).to(torch.int64)
    return t.view(torch.int64)


def _from_bits64(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if torch.empty((), dtype=dtype).element_size() == 4:
        return t.to(torch.int32).view(dtype)
    return t.contiguous().view(dtype)


def merge_topk(mesh: Mesh, fds: Sequence[torch.Tensor],
               gis: Sequence[torch.Tensor], k: int,
               device: Optional[torch.device] = None):
    """The all-gather merge of per-shard top-ks: every shard's [Q, k]
    (distances, global indices) goes to the lead device (`exchange`; one
    pair a local shard), the pool is [Q, D*k] in the reference's order
    (for each query shard 0's k, then shard 1's, ...), and one stable
    re-top-k keeps the k smallest, ties toward the lower pool position as
    the reference's `top_k` breaks them. Returns (dists [Q, k], indices
    [Q, k]) on the lead device (or on `device`)."""
    from geomesa_tpu_torch.engine.knn import _topk_smallest

    lead = mesh.lead if device is None else device
    if mesh.spans_processes:
        # one all-gather: each shard's distances' bits beside its indices
        kd = int(fds[0].shape[-1])
        both = exchange(mesh, [torch.cat([_bits64(f.to(g.device)), _bits64(g)], -1)
                               for f, g in zip(fds, gis)])
        all_d = torch.stack([_from_bits64(p[..., :kd], fds[0].dtype).to(lead)
                             for p in both])
        all_i = torch.stack([_from_bits64(p[..., kd:], gis[0].dtype).to(lead)
                             for p in both])
    else:
        all_d = torch.stack([f.to(lead) for f in exchange(mesh, fds)])  # [D, Q, k]
        all_i = torch.stack([g.to(lead) for g in exchange(mesh, gis)])
    q = all_d.shape[1]
    pool_d = all_d.permute(1, 0, 2).reshape(q, -1)
    pool_i = all_i.permute(1, 0, 2).reshape(q, -1)
    md, mi = _topk_smallest(pool_d, k)
    return md, torch.take_along_dim(pool_i, mi, dim=1)


def psum(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of the shards' partial results (one a local shard) on the
    lead device, added in shard order (a fixed order: the same inputs
    give the same bits, on one process or several)."""
    vals = exchange(mesh, parts)
    out = vals[0]
    for p in vals[1:]:
        out = out + p
    return out


def any_of(mesh: Mesh, flags: Sequence[torch.Tensor]) -> torch.Tensor:
    """The OR of per-shard device flags (one a local shard), on the lead
    device; a MAX over the processes of a mesh that spans them."""
    local = torch.stack([f.to(mesh.lead).reshape(()) for f in flags]).any()
    if not mesh.spans_processes:
        return local
    return torch.tensor(bool(pmax(mesh, int(local.item()))), device=mesh.lead)
