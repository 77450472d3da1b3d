"""Model kernels: the CUDA flash-attention, SSD-scan and RG-LRU kernels
with their plain versions, the plain oracles and the dispatch (`ops`)."""
