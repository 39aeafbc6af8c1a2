"""Device engine of the port: tensors on one torch.device, the kNN scan,
density grids, point-in-polygon, the polygon-layer spatial join
(`pip_sparse`), and their CUDA kernels (`kernels/`)."""

from geomesa_tpu_torch.engine.pip_sparse import (
    LayerPrep, PairList, layer_prep_key, load_layer_prep, pip_layer,
    pip_layer_assign, pip_layer_grouped, pip_layer_join, pip_layer_sharded,
    pip_layer_sparse, prepare_layer, prepare_layer_async, prepare_layer_cached, save_layer_prep,
    upload_edges, upload_points)

__all__ = [
    "LayerPrep", "PairList", "layer_prep_key", "load_layer_prep", "pip_layer",
    "pip_layer_assign", "pip_layer_grouped", "pip_layer_join",
    "pip_layer_sharded", "pip_layer_sparse", "prepare_layer", "prepare_layer_async",
    "prepare_layer_cached", "save_layer_prep", "upload_edges", "upload_points",
]
