"""Model kernels: the CUDA flash-attention kernel with its plain version,
the plain attention oracle and the attention dispatch."""
