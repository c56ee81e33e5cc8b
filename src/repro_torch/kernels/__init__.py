"""Hand-written Hopper kernels, their plain PyTorch versions, and the
dispatch that picks between them by the tensor's device (see ops.py)."""
