"""Hand-written Hopper kernels, their plain PyTorch versions, and the
entry points that dispatch between them by device."""
