"""Training over several ranks, the jamba hybrid: the reduced
jamba-1.5-large (one period of 8: SSD layers, a GQA layer, MoE every
second layer, dense FFNs between) at "bnn_train", one ``launch.train``
step over a (2, 2) mesh of gloo ranks under the FSDP train rules,
against the JAX package's ``build_train_step`` on the same mesh (4
forced host devices, a subprocess started beside the ranks): every
leaf's placement; the loss, cross entropy, MoE aux loss, every gradient
(A_log within ``FAMILY_GRAD_REL_LEAF``'s bound, the one-rank family
test's) and the gradient norm at step 0; the step's metrics and the
params after it."""
import pytest
import torch

import _torch_ranks_train as H
from _torch_ranks import spawn
from _torch_train import FAMILY_GRAD_REL_LEAF

torch.set_num_threads(1)

ARCH = "jamba-1.5-large-398b"
JOB = dict(key=ARCH, arch=ARCH, shape=[2, 2], precision="bnn_train",
           microbatches=[1], steps=1, batch=H.B, seq=H.T_SEQ, lr=H.LR,
           chunk=H.CHUNK)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_run = H.JaxTrainRun(tmp_path_factory.mktemp("ranks_train_hyb"), [JOB])
    ranks = spawn(H.train_worker, 4, [JOB],
                  {(ARCH, "bnn_train"): H.jax_params(ARCH)})
    return ranks, jax_run.result()


def test_jamba_trains_over_ranks_as_jax(runs):
    ranks, want = runs
    H.check_job(ranks, want[ARCH], JOB, FAMILY_GRAD_REL_LEAF[ARCH])
    assert ranks[0][ARCH]["aux"] > 0
