"""Training of mamba2 (the SSD mixer over the whole sequence, no FFN), against the JAX package on the reduced configs
from JAX's weights, at the config's own precision and at
``bnn_train``: ``loss_fn`` (cross entropy, aux, their sum) and every
leaf's gradient within 1e-5 of the leaf's largest element; then one
port train step with 2 microbatches moves every parameter."""
import pytest
import torch

from _torch_train import check_family_grads, check_family_train_step

torch.set_num_threads(1)


@pytest.mark.parametrize("precision", [None, "bnn_train"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b"])
def test_family_loss_grads_and_step(arch, precision):
    tcfg, params, batch = check_family_grads(arch, precision)
    check_family_train_step(tcfg, params, batch)
