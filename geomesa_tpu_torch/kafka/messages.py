"""GeoMessage types + versioned binary wire format.

Parity: geomesa-kafka GeoMessage / GeoMessageSerializer [upstream,
unverified]: three message kinds on one topic per feature type —
Change (upsert one feature), Delete (by feature id), Clear (drop all) —
with a versioned, self-describing-enough binary encoding.

The reference's encoding is Kryo-based; here it is a typed struct packing
driven by the SFT (the schema is known on both ends, exactly as upstream):

    [u8 version=1][u8 kind]                       kind: 1=Change 2=Delete 3=Clear
    fid: [u16 len][utf8]                          (Change/Delete)
    Change payload, per attribute in SFT order:
      null byte (0/1), then if non-null:
        String/UUID: [u32 len][utf8]
        Integer: i32   Long/Date/Timestamp: i64   Double: f64  Float: f32
        Boolean: u8    Bytes: [u32 len][raw]
        Point geometry: f64 x, f64 y
        other geometry: [u32 len][WKT utf8]

A copy of the reference package's `kafka/messages.py`: the bytes are the
reference's, byte for byte.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Union

from geomesa_tpu_torch.core.sft import SimpleFeatureType
from geomesa_tpu_torch.core.wkt import Geometry, parse_wkt, point, to_wkt

VERSION = 1
_KIND_CHANGE, _KIND_DELETE, _KIND_CLEAR = 1, 2, 3


@dataclasses.dataclass
class Change:
    fid: str
    attributes: Dict[str, object]  # attr name -> python value


@dataclasses.dataclass
class Delete:
    fid: str


@dataclasses.dataclass
class Clear:
    pass


GeoMessage = Union[Change, Delete, Clear]


class GeoMessageSerializer:
    def __init__(self, sft: SimpleFeatureType):
        self.sft = sft

    # -- encode ------------------------------------------------------------

    def serialize(self, msg: GeoMessage) -> bytes:
        out = bytearray()
        if isinstance(msg, Clear):
            out += struct.pack("<BB", VERSION, _KIND_CLEAR)
            return bytes(out)
        if isinstance(msg, Delete):
            out += struct.pack("<BB", VERSION, _KIND_DELETE)
            self._put_str16(out, msg.fid)
            return bytes(out)
        out += struct.pack("<BB", VERSION, _KIND_CHANGE)
        self._put_str16(out, msg.fid)
        for a in self.sft.attributes:
            v = msg.attributes.get(a.name)
            if v is None:
                out.append(0)
                continue
            out.append(1)
            if a.is_geometry:
                g = self._as_geometry(v)
                if g.is_point:
                    out.append(1)
                    out += struct.pack("<dd", *g.point)
                else:
                    out.append(0)
                    self._put_str32(out, to_wkt(g))
            elif a.type in ("String", "UUID"):
                self._put_str32(out, str(v))
            elif a.type == "Integer":
                out += struct.pack("<i", int(v))
            elif a.type in ("Long", "Date", "Timestamp"):
                out += struct.pack("<q", int(v))
            elif a.type == "Double":
                out += struct.pack("<d", float(v))
            elif a.type == "Float":
                out += struct.pack("<f", float(v))
            elif a.type == "Boolean":
                out.append(1 if v else 0)
            elif a.type == "Bytes":
                b = bytes(v)
                out += struct.pack("<I", len(b))
                out += b
            else:
                raise NotImplementedError(f"wire format for {a.type!r}")
        return bytes(out)

    # -- decode ------------------------------------------------------------

    def deserialize(self, data: bytes) -> GeoMessage:
        version, kind = struct.unpack_from("<BB", data, 0)
        if version != VERSION:
            raise ValueError(f"unsupported GeoMessage version {version}")
        off = 2
        if kind == _KIND_CLEAR:
            return Clear()
        fid, off = self._get_str16(data, off)
        if kind == _KIND_DELETE:
            return Delete(fid)
        attrs: Dict[str, object] = {}
        for a in self.sft.attributes:
            present = data[off]
            off += 1
            if not present:
                attrs[a.name] = None
                continue
            if a.is_geometry:
                is_point = data[off]
                off += 1
                if is_point:
                    x, y = struct.unpack_from("<dd", data, off)
                    off += 16
                    attrs[a.name] = point(x, y)
                else:
                    wkt, off = self._get_str32(data, off)
                    attrs[a.name] = parse_wkt(wkt)
            elif a.type in ("String", "UUID"):
                attrs[a.name], off = self._get_str32(data, off)
            elif a.type == "Integer":
                (attrs[a.name],) = struct.unpack_from("<i", data, off)
                off += 4
            elif a.type in ("Long", "Date", "Timestamp"):
                (attrs[a.name],) = struct.unpack_from("<q", data, off)
                off += 8
            elif a.type == "Double":
                (attrs[a.name],) = struct.unpack_from("<d", data, off)
                off += 8
            elif a.type == "Float":
                (attrs[a.name],) = struct.unpack_from("<f", data, off)
                off += 4
            elif a.type == "Boolean":
                attrs[a.name] = bool(data[off])
                off += 1
            elif a.type == "Bytes":
                (n,) = struct.unpack_from("<I", data, off)
                off += 4
                attrs[a.name] = data[off : off + n]
                off += n
            else:
                raise NotImplementedError(f"wire format for {a.type!r}")
        return Change(fid, attrs)

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _as_geometry(v) -> Geometry:
        if isinstance(v, Geometry):
            return v
        if isinstance(v, str):
            return parse_wkt(v)
        if isinstance(v, (tuple, list)) and len(v) == 2:
            return point(float(v[0]), float(v[1]))
        raise TypeError(f"not a geometry: {v!r}")

    @staticmethod
    def _put_str16(out: bytearray, s: str) -> None:
        b = s.encode("utf-8")
        out += struct.pack("<H", len(b))
        out += b

    @staticmethod
    def _get_str16(data: bytes, off: int):
        (n,) = struct.unpack_from("<H", data, off)
        off += 2
        return data[off : off + n].decode("utf-8"), off + n

    @staticmethod
    def _put_str32(out: bytearray, s: str) -> None:
        b = s.encode("utf-8")
        out += struct.pack("<I", len(b))
        out += b

    @staticmethod
    def _get_str32(data: bytes, off: int):
        (n,) = struct.unpack_from("<I", data, off)
        off += 4
        return data[off : off + n].decode("utf-8"), off + n
