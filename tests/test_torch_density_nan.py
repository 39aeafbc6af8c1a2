"""Density grids over rows with a NaN coordinate, in the port against the
reference on one shared catalog (written by the reference), on the cached
route (device cache on) and the scan route (cache off), through the
cell-dictionary kernel (its plain version here) and through the scatter.

The reference casts `floor((x - xmin) / dx)` to int32 before its bounds
check, and XLA converts NaN to 0: a matching row with a NaN x lands in
column 0 of its row, one with a NaN y in row 0 of its column, one with
both in cell (0, 0). The port bins them the same way (`bin_cells` and the
kernel), so unit-weight grids are bit-identical, those rows included.

The store: 4,000 rows over the NYC envelope in Z2 order, two monthly
partitions, 8 of the rows with a NaN coordinate (x only, y only, both),
a time-only filter that admits every row, and a 512x512 grid. Finite
points sit at least a tenth of a cell from every cell edge (the two
packages' binning divides differently only at an edge: ROADMAP Queue C).
"""

import numpy as np
import pytest

from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.plan import DataStore as RDataStore
from geomesa_tpu.plan.hints import QueryHints as RHints
from geomesa_tpu.plan.query import Query as RQuery
from geomesa_tpu.store.partition import DateTimeScheme as RScheme
from geomesa_tpu_torch.plan import DataStore as PDataStore
from geomesa_tpu_torch.plan.hints import QueryHints as PHints
from geomesa_tpu_torch.plan.query import Query as PQuery

from test_torch_density import _morton

SPEC = "fare:Double,dtg:Date,*geom:Point"
ENV = (-74.3, 40.5, -73.7, 41.0)
W = H = 512
N = 4000
JAN, MAR = 1_451_606_400_000, 1_456_790_400_000
CQL = "dtg > 2015-12-31T00:00:00Z AND dtg < 2016-03-02T00:00:00Z"
# rows given a NaN coordinate: (row, x NaN, y NaN)
NAN_ROWS = [(17, True, False), (400, True, False), (2999, True, False),
            (5, False, True), (1234, False, True), (3998, False, True),
            (777, True, True), (2500, True, True)]


def _cell_points(rng, n, lo, d, cells):
    """f32 coordinates between a tenth and nine tenths of a random cell."""
    c = rng.integers(0, cells, n)
    return (lo + (c + rng.uniform(0.1, 0.9, n)) * d).astype(np.float32)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_density_nan"))
    rng = np.random.default_rng(23)
    x = _cell_points(rng, N, ENV[0], (ENV[2] - ENV[0]) / W, W).astype(np.float64)
    y = _cell_points(rng, N, ENV[1], (ENV[3] - ENV[1]) / H, H).astype(np.float64)
    o = np.argsort(_morton(x, y), kind="stable")
    x, y = x[o], y[o]
    for i, nx, ny in NAN_ROWS:
        if nx:
            x[i] = np.nan
        if ny:
            y[i] = np.nan
    t = rng.integers(JAN, MAR, N)
    fare = rng.uniform(0, 5, N)
    ref_ds = RDataStore(root, use_device_cache=True)
    src = ref_ds.create_schema(RSFT.from_spec("taxi", SPEC),
                               scheme=RScheme("yyyy/MM", "dtg"))
    src.write(RFB.from_pydict(src.sft, {"fare": fare, "dtg": t,
                                        "geom": np.stack([x, y], 1)}))
    return dict(
        x=x, y=y,
        ref={"cached": ref_ds.get_feature_source("taxi"),
             "scan": RDataStore(root).get_feature_source("taxi")},
        port={"cached": PDataStore(root, use_device_cache=True, device="cpu")
              .get_feature_source("taxi"),
              "scan": PDataStore(root, device="cpu").get_feature_source("taxi")})


def _queries(zsparse):
    kw = dict(density_bbox=ENV, density_width=W, density_height=H,
              density_zsparse=zsparse)
    return RQuery("taxi", CQL, hints=RHints(**kw)), PQuery("taxi", CQL, hints=PHints(**kw))


def _numpy_grid(x, y):
    """The reference's binning in NumPy: f32 division, NaN cast to 0."""
    f32 = np.float32
    xmin, ymin = f32(ENV[0]), f32(ENV[1])
    dx, dy = f32((ENV[2] - ENV[0]) / W), f32((ENV[3] - ENV[1]) / H)
    with np.errstate(invalid="ignore"):
        col = np.floor((x.astype(f32) - xmin) / dx)
        row = np.floor((y.astype(f32) - ymin) / dy)
    col, row = np.nan_to_num(col, nan=0.0), np.nan_to_num(row, nan=0.0)
    return np.bincount((row * W + col).astype(np.int64),
                       minlength=W * H).reshape(H, W).astype(np.float32)


@pytest.mark.parametrize("zsparse", [True, False], ids=["dictionary", "scatter"])
@pytest.mark.parametrize("route", ["cached", "scan"])
def test_nan_rows_bin_as_the_reference(stores, route, zsparse):
    rq, pq = _queries(zsparse)
    r = stores["ref"][route].get_features(rq)
    p = stores["port"][route].get_features(pq)
    assert p.kind == r.kind == "density"
    assert p.count == r.count == N
    np.testing.assert_array_equal(p.grid, r.grid)
    assert float(p.grid.sum()) == N  # the NaN rows are in the grid
    np.testing.assert_array_equal(p.grid, _numpy_grid(stores["x"], stores["y"]))
    # each NaN row sits in row 0 or column 0 at its finite coordinate
    for i, nx, ny in NAN_ROWS:
        col = 0 if nx else int(np.floor((np.float32(stores["x"][i]) - np.float32(ENV[0]))
                                        / np.float32((ENV[2] - ENV[0]) / W)))
        row = 0 if ny else int(np.floor((np.float32(stores["y"][i]) - np.float32(ENV[1]))
                                        / np.float32((ENV[3] - ENV[1]) / H)))
        assert p.grid[row, col] >= 1
