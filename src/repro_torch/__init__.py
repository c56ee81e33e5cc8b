"""PyTorch/CUDA port of the OXBNN reproduction (the JAX package ``repro``
is the reference).  The hand-written Hopper kernels live in ``csrc/``
and are built at first use; every entry point runs on the card unless
the caller asks for the CPU.  See README.md and ROADMAP.md."""
