"""Hand-written Hopper (sm_90a) CUDA kernels of the port, each beside its
plain PyTorch version (`_build` compiles `csrc/*.cu` at first use)."""
