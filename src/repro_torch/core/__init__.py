"""OXBNN core, on PyTorch tensors (bit words are int32, see packing.py).

Modules:
  binarize     Eq. (1) quantizers + the straight-through estimator
  packing      {0,1} <-> packed int32 words
  xnor         XNOR-bitcount VDPs (Eq. 2)
  conv         binarized conv2d (im2col -> XNOR GEMM, Fig. 1 lowering)
  oxg          Optical XNOR Gate behavioral model (Fig. 3)
  pca          Photo-Charge Accumulator model (Fig. 4, Table II capacities)
  mapping      XPC mapping schedules (Fig. 5): OXBNN vs prior work (numpy)
  scalability  Eqs. (3)-(5) -> Table II reproduction (numpy)
"""
