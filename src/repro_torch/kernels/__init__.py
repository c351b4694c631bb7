"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
torch version. A wrapper launches its kernel for CUDA tensors and uses
the plain version only for tensors that lie on the CPU."""
