"""Hand-written CUDA kernels (`*.cu`) and their build (`build.py`)."""
