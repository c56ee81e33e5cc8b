"""The plain fused BNN GEMM against the JAX package's Pallas kernel
(``interpret=True``) and its oracle, in all four epilogues, bit-exact:
every third case of the grid from the first (moved from
tests/test_torch_kernels.py for time; the other two thirds:
tests/test_torch_kernels_fused_wide.py and
tests/test_torch_kernels_fused_edge.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_bnn as jfb, ref as jref
from repro_torch.kernels import fused_bnn as fb, ref

torch.set_num_threads(1)

MODES = ("bitcount", "dot", "dot_scaled", "binary_act")


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a).view(np.int32))


# (M, S, N): every combination of M in {1, 3, 130}, S in {33, 100, 768},
# N in {5, 64}; then the rows around the kernel's CUDA-core and
# tensor-core paths (M = 2, 33) at S one bit either side of a 32-word
# K tile (4095, 4097)
FUSED_CASES = [(m, s, n) for m in (1, 3, 130) for s in (33, 100, 768)
               for n in (5, 64)] + [(2, 4095, 5), (2, 4097, 64),
                                    (33, 4095, 64), (33, 4097, 5)]


def check_fused(m, s, n):
    rng = np.random.default_rng(1000 * m + 10 * s + n)
    x = rng.standard_normal((m, s)).astype(np.float32)
    x[0, :3] = 0.0                                  # >= threshold on zeros
    w = rng.standard_normal((n, s)).astype(np.float32)
    alpha = (rng.random(n) + 0.5).astype(np.float32)
    wp_j = jref.binarize_pack_ref(jnp.asarray(w))
    ip_j = jref.binarize_pack_ref(jnp.asarray(x))
    wp_t = _i32(wp_j)
    for mode in MODES:
        got = fb.fused_bnn_matmul_torch(torch.from_numpy(x), wp_t, s,
                                        mode=mode,
                                        alpha=torch.from_numpy(alpha))
        pallas = np.asarray(jfb.fused_bnn_matmul(
            jnp.asarray(x), wp_j, s, mode=mode, alpha=jnp.asarray(alpha),
            interpret=True))
        oracle = np.asarray(jref.xnor_popcount_matmul_ref(
            ip_j, wp_j, s, mode=mode, alpha=jnp.asarray(alpha)))
        assert got.numpy().dtype == pallas.dtype == oracle.dtype, mode
        np.testing.assert_array_equal(got.numpy(), pallas, err_msg=mode)
        np.testing.assert_array_equal(got.numpy(), oracle, err_msg=mode)
        # the CPU wrapper takes the plain version (same bits)
        np.testing.assert_array_equal(
            fb.fused_bnn_matmul(torch.from_numpy(x), wp_t, s, mode=mode,
                                alpha=torch.from_numpy(alpha)).numpy(),
            pallas)
    # the port's own packed oracle agrees with the JAX one
    np.testing.assert_array_equal(
        ref.xnor_popcount_matmul_ref(_i32(ip_j), wp_t, s, "dot").numpy(),
        np.asarray(jref.xnor_popcount_matmul_ref(ip_j, wp_j, s, "dot")))




@pytest.mark.parametrize("m,s,n", FUSED_CASES[0::3])
def test_fused_bnn_plain_matches_pallas_and_ref(m, s, n):
    check_fused(m, s, n)
