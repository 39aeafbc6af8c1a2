"""Device engine of the port: tensors on one torch.device, the kNN scan,
density grids, point-in-polygon, and their CUDA kernels (`kernels/`)."""
