"""Shared padding policy (a copy of the reference package's
`utils/padding.py`): power-of-two buckets keep the set of shapes a
path meets small."""


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p
