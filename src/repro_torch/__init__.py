"""PyTorch + CUDA port of the AxLLM serving stack (see ``repro`` for the
JAX reference). Importing this package imports neither JAX nor ``repro``;
CUDA kernels are built from ``csrc/`` at their first launch."""
