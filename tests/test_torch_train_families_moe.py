"""Training of the MoE families, mixtral (sliding window, MoE) and
deepseek-v2-lite (MLA, MoE with shared experts, a leading dense layer),
whose aux load-balance term is carried up the stack, against the JAX package on the reduced configs
from JAX's weights, at the config's own precision and at
``bnn_train``: ``loss_fn`` (cross entropy, aux, their sum) and every
leaf's gradient within 1e-5 of the leaf's largest element; then one
port train step with 2 microbatches moves every parameter."""
import pytest
import torch

from _torch_train import check_family_grads, check_family_train_step

torch.set_num_threads(1)


@pytest.mark.parametrize("precision", [None, "bnn_train"])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-16b"])
def test_family_loss_grads_and_step(arch, precision):
    tcfg, params, batch = check_family_grads(arch, precision)
    check_family_train_step(tcfg, params, batch)
