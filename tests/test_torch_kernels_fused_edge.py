"""The plain fused BNN GEMM against the JAX package's Pallas kernel
(tests/test_torch_kernels_fused.py): every third case of the grid from
the third."""
import pytest
import torch

from test_torch_kernels_fused import FUSED_CASES, check_fused

torch.set_num_threads(1)


@pytest.mark.parametrize("m,s,n", FUSED_CASES[2::3])
def test_fused_bnn_plain_matches_pallas_and_ref(m, s, n):
    check_fused(m, s, n)
