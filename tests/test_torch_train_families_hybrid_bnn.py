"""Training of the reduced jamba hybrid (SSD and GQA layers, MoE every
other layer: the aux term) at ``bnn_train``, against the JAX
package from JAX's weights: ``loss_fn`` (cross entropy, aux, their sum)
and every leaf's gradient within FAMILY_GRAD_REL of the leaf's largest
element (FAMILY_GRAD_REL_LEAF on the SSD decay leaves, A_log: the
reference's own rounding spread there); then one port train step with 2 microbatches moves every
parameter.  Its own precision is in test_torch_train_families_hybrid.py
(one JAX compile a file)."""
import torch

from _torch_train import check_family_grads, check_family_train_step

torch.set_num_threads(1)


def test_family_loss_grads_and_step():
    tcfg, params, batch = check_family_grads("jamba-1.5-large-398b", "bnn_train")
    check_family_train_step(tcfg, params, batch)
