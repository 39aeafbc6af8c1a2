"""Device engine of the port: tensors on one torch.device, the kNN scan
and its CUDA kernels (`kernels/`)."""
