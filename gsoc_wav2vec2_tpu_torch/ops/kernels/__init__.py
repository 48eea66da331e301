"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  A wrapper runs the plain version for a CPU tensor and launches the
CUDA kernel (or raises) for a CUDA tensor."""
