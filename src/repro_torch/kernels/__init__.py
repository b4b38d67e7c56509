"""Hand-written Hopper kernels, their plain PyTorch versions, and the
dispatcher that picks between them by device."""
