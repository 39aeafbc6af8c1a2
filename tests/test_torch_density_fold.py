"""The fold of the cell-dictionary kernel's rows into the raster grid, in
the port against the reference package's `_fold_counts`, on the same
seeded inputs.

The port routes a -1 pad in dictionary slot j to a sink of its own,
width*height + j, where the reference sends every pad to one sink: the
real cells of the grid are the same. Unit-weight counts are small
integers, exact in f32 in any order (tolerance 0); weighted rows agree to
f32 summation-order noise (rtol=1e-6: a cell sums a few rows).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geomesa_tpu.engine import density_zsparse as ref
from geomesa_tpu_torch.engine import density_zsparse as port


def rows(seed, s, capd, width, height, fill=(0.0, 1.0), weighted=False):
    """s sorted dictionaries of distinct cells with -1 pads at the end (a
    row's share of real slots drawn from `fill`), and their count rows
    (zeros in the pads, as the kernel writes them)."""
    rng = np.random.default_rng(seed)
    dicts = np.full((s, capd), -1, np.int32)
    counts = np.zeros((s, capd), np.float32)
    for r in range(s):
        k = int(round(rng.uniform(*fill) * capd))
        dicts[r, :k] = np.sort(rng.choice(width * height, k, replace=False))
        counts[r, :k] = (rng.uniform(0, 5, k) if weighted
                         else rng.integers(1, 40, k))
    return counts, dicts


CASES = {
    "pads": dict(fill=(0.2, 1.0)),
    "all_pads": dict(fill=(0.0, 0.0)),
    "some_rows_all_pads": dict(fill=(0.0, 0.6)),
    "weighted": dict(fill=(0.1, 0.9), weighted=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("capd,width,height", [(8, 16, 16), (64, 40, 24),
                                               (256, 64, 64)])
def test_fold_matches_reference(case, capd, width, height):
    spec = CASES[case]
    counts, dicts = rows(capd + width, 96, capd, width, height, **spec)
    exp = np.asarray(ref._fold_counts(jnp.asarray(counts), jnp.asarray(dicts),
                                      width=width, height=height))
    got = port._fold_counts(torch.from_numpy(counts), torch.from_numpy(dicts),
                            width, height).numpy()
    assert got.shape == exp.shape == (height, width) and got.dtype == np.float32
    if spec.get("weighted"):
        np.testing.assert_allclose(got, exp, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, exp)
    if case == "all_pads":
        assert not got.any()


@pytest.mark.parametrize("capd", [8, 256, 512])
def test_no_sink_takes_more_than_one_add_per_tile(capd):
    width, height = 48, 32
    _, dicts = rows(capd, 200, capd, width, height, fill=(0.0, 1.0))
    idx, size = port._fold_index(torch.from_numpy(dicts), width, height)
    idx = idx.numpy()
    cells = width * height
    assert size == cells + capd and idx.min() >= 0 and idx.max() < size
    # real cells keep their own index; every pad goes past them
    np.testing.assert_array_equal(idx[dicts >= 0], dicts[dicts >= 0])
    assert (idx[dicts < 0] >= cells).all()
    for r in range(len(idx)):  # per tile: each sink at most once
        sinks = idx[r][idx[r] >= cells]
        assert len(np.unique(sinks)) == len(sinks)
    # over all tiles, a sink takes at most one add per tile
    hits = np.bincount(idx[idx >= cells] - cells, minlength=capd)
    assert hits.max() <= len(idx) and (dicts < 0).sum() == hits.sum()
