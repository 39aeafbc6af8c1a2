"""BIN record encoding: minimal binary results for dot-map rendering.

The counterpart of the reference package's `engine/bin.py` (upstream
BinAggregatingScan): 16-byte records (track id:int32, dtg seconds:int32,
lat:float32, lon:float32), plus 8 bytes (label:int64) in the labelled
variant. The layout is little-endian, as the reference documents (the
JVM upstream writes big-endian); `decode_bin` is the matching reader.

The device packs the lanes as an [N, 4] (or [N, 6]) int32 tensor, the
floats as their bit patterns, fetched once and serialized on the host
with `.tobytes()`: byte-identical to the reference's records.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def bin_pack(track_code: torch.Tensor, dtg_ms: torch.Tensor, lat: torch.Tensor,
             lon: torch.Tensor, label: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """[N, 4] int32 (16-byte records) or [N, 6] with a label (24 bytes:
    the label as two little-endian int32 lanes, low word first). dtg is
    floor-divided to seconds (a date before 1970 rounds down)."""
    lanes = [
        track_code.to(torch.int32),
        torch.div(dtg_ms.to(torch.int64), 1000, rounding_mode="floor").to(torch.int32),
        lat.to(torch.float32).contiguous().view(torch.int32),
        lon.to(torch.float32).contiguous().view(torch.int32),
    ]
    if label is not None:
        l64 = label.to(torch.int64)
        lanes.append((l64 & 0xFFFFFFFF).to(torch.int32))
        lanes.append((l64 >> 32).to(torch.int32))
    return torch.stack(lanes, dim=1)


def encode_bin(packed, select: Optional[np.ndarray] = None) -> bytes:
    """Host: [N, 4|6] int32 -> the 16/24-byte-per-record LE buffer."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    arr = np.asarray(packed, dtype="<i4")
    if select is not None:
        arr = arr[select]
    return arr.tobytes()


def decode_bin(buf: bytes, labeled: bool = False) -> np.ndarray:
    """bytes -> structured array (track, dtg_s, lat, lon[, label])."""
    lanes = 6 if labeled else 4
    raw = np.frombuffer(buf, dtype="<i4").reshape(-1, lanes)
    fields = [("track", "<i4"), ("dtg_s", "<i4"), ("lat", "<f4"), ("lon", "<f4")]
    if labeled:
        fields.append(("label", "<i8"))
    out = np.empty(len(raw), dtype=fields)
    out["track"] = raw[:, 0]
    out["dtg_s"] = raw[:, 1]
    out["lat"] = raw[:, 2].view("<f4")
    out["lon"] = raw[:, 3].view("<f4")
    if labeled:
        out["label"] = ((raw[:, 4].astype(np.int64) & 0xFFFFFFFF)
                        | (raw[:, 5].astype(np.int64) << 32))
    return out
