"""Meshes of devices, row-sharded arrays and the two merges over them.

The counterpart of the reference package's `parallel/mesh.py`. The
reference is single-controller SPMD: one process holds a
`jax.sharding.Mesh`, places arrays with `NamedSharding(mesh,
P("shard"))` and merges inside `shard_map` with `all_gather` and `psum`.
The port keeps the single-controller shape without a process group:

- `Mesh` is an ordered tuple of `torch.device`s over the one axis
  `SHARD_AXIS`; `devices.shape` is `(D,)`, so the `mesh_shape` strings
  equal the reference's, and two meshes over the same devices are equal.
  The device list may repeat a device: four shards on `cpu`, or four on
  `cuda:0`, run every per-shard launch and every merge on one device.
- A row-sharded array is `Sharded`: D tensors of equal length, shard i
  holding rows [i*S, (i+1)*S) on `devices[i]`. `shards_of` cuts a whole
  tensor into shards (views where a shard's device is the tensor's own);
  `shard_batch_host` uploads a host batch's rows shard by shard, each
  straight from the host to its device as its own allocation (the
  reference's `NamedSharding` placement), so no device ever holds more
  than its shard, even where the mesh repeats a device.
- The merges are explicit and run in shard order on the lead device
  (`devices[0]`): `merge_topk` is the all-gather + re-top-k of the
  sharded kNN programs, `psum` adds the shards' partial results.
  Anything that must see a whole sharded column calls `gather`, which
  counts itself under `mesh.gathers` with the column's name.

Per-shard work is launched one shard after another with no host sync
between them, each under its shard's device (`on_shard`), so on several
cards the launches overlap. `torch.distributed` is not used: one process
drives every shard.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from geomesa_tpu_torch.core.columnar import DictColumn, FeatureBatch, GeometryColumn
from geomesa_tpu_torch.engine.device import (
    VALID, DeviceBatch, _indexed, to_device, to_device_parts)
from geomesa_tpu_torch.errors import CudaUnavailableError
from geomesa_tpu_torch.utils.metrics import metrics

SHARD_AXIS = "shard"

# per-feature keys whose leading axis is NOT the batch axis (the CSR and
# edge tables of extended geometries): they stay replicated
_REPLICATED_SUFFIXES = ("__verts", "__rings", "__featr", "__vfeat", "__ex1",
                        "__ey1", "__ex2", "__ey2", "__efeat")


class Mesh:
    """An ordered 1-D mesh of devices (axis `SHARD_AXIS`). Equality is by
    value: the same devices in the same order."""

    def __init__(self, devices: Sequence, axis_names=(SHARD_AXIS,)):
        devs = [_indexed(torch.device(d)) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty(len(devs), dtype=object)
        for i, d in enumerate(devs):
            self.devices[i] = d
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> tuple:
        return tuple(self.devices.tolist())

    @property
    def lead(self) -> torch.device:
        """The device the merges run on and results come back to."""
        return self.devices[0]

    @property
    def spans_devices(self) -> bool:
        """True when shards live on more than one device (copies between
        devices happen); False for a mesh that repeats one device."""
        return len(set(self.device_list)) > 1

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.device_list == other.device_list
                and self.axis_names == other.axis_names)

    def __hash__(self) -> int:
        return hash((self.device_list, self.axis_names))

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.device_list]}, {self.axis_names})"


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
    `mesh.devices[i]`, every shard S rows long."""

    __slots__ = ("mesh", "shards")

    def __init__(self, mesh: Mesh, shards: Sequence[torch.Tensor]):
        shards = list(shards)
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size}")
        if len({int(s.shape[0]) for s in shards}) != 1:
            raise ValueError("shards of unequal length")
        self.mesh = mesh
        self.shards = shards

    @property
    def shard_rows(self) -> int:
        return int(self.shards[0].shape[0])

    @property
    def shape(self) -> tuple:
        return (self.shard_rows * len(self.shards),) + tuple(self.shards[0].shape[1:])

    def __len__(self) -> int:
        return self.shape[0]

    def full(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The whole array on `device` (the lead device by default)."""
        device = self.mesh.lead if device is None else device
        return torch.cat([s.to(device) for s in self.shards])

    def map(self, fn) -> "Sharded":
        """`fn(shard)` on every shard, under its device: a `Sharded` of
        the results (row-aligned maps only)."""
        out = []
        for s, dev in zip(self.shards, self.mesh.device_list):
            with on_shard(dev):
                out.append(fn(s))
        return Sharded(self.mesh, out)


def gather(arr, name: str) -> torch.Tensor:
    """The whole of a sharded column on the lead device, for a caller
    that must see every row at once; counted under `mesh.gathers` (and
    per column, `mesh.gathers{column=...}`). A whole tensor passes
    through uncounted."""
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
    """`x` on every shard's device, one entry per shard (the same tensor
    where the device is x's own, so a repeated device copies nothing)."""
    return tuple(x.to(d) for d in mesh.device_list)


def shard_view(arr, shard: int, shard_rows: int,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Rows [shard*S, (shard+1)*S) of a row-sharded or whole array on
    `device`: the shard itself when `arr` is `Sharded` with that shard
    size and device, a view when a whole tensor already lies on `device`,
    a copy otherwise. The shard-affinity route runs one device's kernel
    on this; staged query pairs (a whole array, shard 0 of its own
    length) resolve to the owning device's copy."""
    if isinstance(arr, Sharded):
        if arr.shard_rows == shard_rows:
            out = arr.shards[shard]
            return out if device is None else out.to(device)
        arr = gather(arr, "shard_view")  # another layout: counted
    lo = shard * shard_rows
    out = arr[lo:lo + shard_rows]
    return out if device is None else out.to(device)


def shards_of(mesh: Mesh, arr) -> List[torch.Tensor]:
    """The per-shard tensors of `arr` (a `Sharded` over `mesh`, or a whole
    tensor whose length divides by the mesh size)."""
    if isinstance(arr, Sharded):
        if arr.mesh != mesh:
            raise ValueError(f"array sharded over {arr.mesh}, not {mesh}")
        return list(arr.shards)
    n = int(arr.shape[0])
    d = mesh.size
    if n % d:
        raise ValueError(f"length {n} does not divide into {d} shards; pad first")
    s = n // d
    return [shard_view(arr, i, s, dev) for i, dev in enumerate(mesh.device_list)]


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
    """Per-shard device batches (one a shard, same keys) as one dict of
    `Sharded` columns."""
    return {k: Sharded(mesh, [p[k] for p in parts]) for k in parts[0]}


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
        padded, [(i * s, (i + 1) * s) for i in range(d)], mesh.device_list,
        coord_dtype))


def shard_dicts(mesh: Mesh, dev: dict) -> List[dict]:
    """A sharded device batch (`Sharded` columns, replicated tuples) as
    one plain device batch a shard: shard i's rows and its copy of every
    replicated table, all on `mesh.devices[i]`."""
    out = []
    for i in range(mesh.size):
        out.append({k: (v.shards[i] if isinstance(v, Sharded) else v[i])
                    for k, v in dev.items()})
    return out


# -- the merges ----------------------------------------------------------------


def merge_topk(mesh: Mesh, fds: Sequence[torch.Tensor],
               gis: Sequence[torch.Tensor], k: int,
               device: Optional[torch.device] = None):
    """The all-gather merge of per-shard top-ks: every shard's [Q, k]
    (distances, global indices) goes to the lead device, the pool is
    [Q, D*k] in the reference's order (for each query shard 0's k, then
    shard 1's, ...), and one stable re-top-k keeps the k smallest, ties
    toward the lower pool position as the reference's `top_k` breaks
    them. Returns (dists [Q, k], indices [Q, k]) on the lead device (or
    on `device`)."""
    from geomesa_tpu_torch.engine.knn import _topk_smallest

    lead = mesh.lead if device is None else device
    all_d = torch.stack([f.to(lead) for f in fds])   # [D, Q, k]
    all_i = torch.stack([g.to(lead) for g in gis])
    q = all_d.shape[1]
    pool_d = all_d.permute(1, 0, 2).reshape(q, -1)
    pool_i = all_i.permute(1, 0, 2).reshape(q, -1)
    md, mi = _topk_smallest(pool_d, k)
    return md, torch.take_along_dim(pool_i, mi, dim=1)


def psum(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of the shards' partial results on the lead device, added
    in shard order (a fixed order: the same inputs give the same bits)."""
    lead = mesh.lead
    out = parts[0].to(lead)
    for p in parts[1:]:
        out = out + p.to(lead)
    return out


def any_of(mesh: Mesh, flags: Sequence[torch.Tensor]) -> torch.Tensor:
    """The OR of per-shard device flags, on the lead device."""
    return torch.stack([f.to(mesh.lead).reshape(()) for f in flags]).any()
