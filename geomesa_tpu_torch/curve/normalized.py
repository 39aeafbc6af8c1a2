"""Dimension normalization: continuous coordinates <-> integer grid cells.

Parity: org.locationtech.geomesa.curve.NormalizedDimension (geomesa-z3)
[upstream, unverified]. A dimension with `bits` precision maps [min, max] onto
[0, 2**bits - 1]; denormalization returns the *center* of the cell, matching
upstream semantics (SemiNormalizedDimension uses cell centers so that
round-tripping stays within half a cell width).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class NormalizedDimension:
    min: float
    max: float
    bits: int

    @property
    def precision(self) -> int:
        return 1 << self.bits

    @property
    def max_index(self) -> int:
        return self.precision - 1

    @property
    def extent(self) -> float:
        return self.max - self.min

    def normalize(self, value):
        """Map coordinate(s) to integer cell index, clipped to the valid range.

        Accepts scalars or arrays; returns int64.
        """
        v = np.asarray(value, dtype=np.float64)
        scaled = np.floor((v - self.min) / self.extent * self.precision)
        return np.clip(scaled, 0, self.max_index).astype(np.int64)

    def denormalize(self, index):
        """Map integer cell index(es) back to the cell-center coordinate."""
        i = np.asarray(index, dtype=np.float64)
        return self.min + (i + 0.5) * (self.extent / self.precision)


def NormalizedLon(bits: int) -> NormalizedDimension:
    return NormalizedDimension(-180.0, 180.0, bits)


def NormalizedLat(bits: int) -> NormalizedDimension:
    return NormalizedDimension(-90.0, 90.0, bits)


def NormalizedTime(max_seconds: float, bits: int) -> NormalizedDimension:
    return NormalizedDimension(0.0, float(max_seconds), bits)
