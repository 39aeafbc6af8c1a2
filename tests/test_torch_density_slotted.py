"""`density_grid_slotted` (the envelope as a device [4] f32 tensor)
against the port's `density_grid` and the reference's slotted grid, as
the reference's tests/test_ringloop.py::TestDensitySlotParity holds its
own: bit-identical wherever the envelope's cell sizes round-trip f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomesa_tpu.engine.density import density_grid_slotted as ref_slotted
from geomesa_tpu_torch.engine.density import density_grid, density_grid_slotted

CASES = [((-180.0, -90.0, 180.0, 90.0), 64, 32),
         ((-170.0, -80.0, 170.0, 80.0), 17, 9),
         ((0.0, 0.0, 64.0, 32.0), 512, 256)]


@pytest.mark.parametrize("bbox, width, height", CASES)
def test_slotted_equals_static_and_reference(bbox, width, height):
    rng = np.random.default_rng(9)
    n = 4096
    x = rng.uniform(-175, 175, n).astype(np.float32)
    y = rng.uniform(-85, 85, n).astype(np.float32)
    x[:3], y[3:6] = np.nan, np.nan  # NaN bins to index 0 on every path
    w = rng.uniform(0, 2, n).astype(np.float32)
    m = rng.random(n) > 0.25
    t = {k: torch.from_numpy(v) for k, v in
         dict(x=x, y=y, w=w, m=m, ones=np.ones(n, np.float32)).items()}
    slot = torch.tensor(bbox, dtype=torch.float32)
    got = density_grid_slotted(t["x"], t["y"], t["ones"], t["m"], slot,
                               width, height).numpy()
    want = np.asarray(ref_slotted(jnp.asarray(x), jnp.asarray(y),
                                  jnp.ones(n, jnp.float32), jnp.asarray(m),
                                  jnp.asarray(np.asarray(bbox, np.float32)),
                                  width, height))
    np.testing.assert_array_equal(got, want)
    xmin, ymin, xmax, ymax = bbox
    if (np.float32((xmax - xmin) / width) == np.float32(xmax - xmin)
            / np.float32(width)
            and np.float32((ymax - ymin) / height) == np.float32(ymax - ymin)
            / np.float32(height)):
        static = density_grid(t["x"], t["y"], t["ones"], t["m"], bbox, width,
                              height).numpy()
        np.testing.assert_array_equal(got, static)
    weighted = density_grid_slotted(t["x"], t["y"], t["w"], t["m"], slot,
                                    width, height).numpy()
    np.testing.assert_allclose(weighted, np.asarray(ref_slotted(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), jnp.asarray(m),
        jnp.asarray(np.asarray(bbox, np.float32)), width, height)),
        rtol=1e-5, atol=1e-4)
