"""CUDA kernels: build, bind and wrappers."""
