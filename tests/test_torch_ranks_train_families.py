"""Training over several ranks, the MoE, MLA and SSM families: reduced
mixtral-8x7b (expert-parallel MoE, the sliding window, one kv head
gathered whole), deepseek-v2-lite (MLA on a rank's heads with its up
projections gathered whole, routed and shared experts, a leading dense
layer) and mamba2-1.3b (the SSD on a rank's heads, the conv and the
gated norm gathered whole) at "bnn_train", one ``launch.train`` step
over a (2, 2) mesh of gloo ranks under the FSDP train rules, against
the JAX package's ``build_train_step`` on the same mesh (4 forced host
devices, a subprocess started beside the ranks): every leaf's
placement; the loss, cross entropy and MoE aux loss (JAX's: every
dispatch group's mean over the whole batch), every gradient (none zero
where JAX's is not) and the gradient norm at step 0; the step's
metrics and the params after it, within the one-rank training tests'
bounds.  Also a MoE layer whose experts do not divide the model axis
(reduced mixtral with 6 experts over (1, 4): each expert's ``mlp`` cut,
the down projection's STE products summed over the ranks, then alpha
of the whole K) trains as the port's one rank."""
import numpy as np
import pytest
import torch

import _torch_ranks_train as H
from _torch_ranks import jobs_worker, spawn
from _torch_train import FAMILY_GRAD_REL_LEAF, assert_leaves_close
from repro_torch import tree as T
from repro_torch.launch import steps
from repro_torch.models import transformer as M

torch.set_num_threads(1)

ARCHS = ("mixtral-8x7b", "deepseek-v2-lite-16b", "mamba2-1.3b")
JOBS = [dict(key=a, arch=a, shape=[2, 2], precision="bnn_train",
             microbatches=[1], steps=1, batch=H.B, seq=H.T_SEQ, lr=H.LR,
             chunk=H.CHUNK) for a in ARCHS]


# 6 experts on a 4-way model axis: the decode and train rules drop
# "experts" and cut each expert's "mlp" instead
SIX = H.port_cfg("mixtral-8x7b").replace(n_experts=6)


def six_params():
    return M.init(torch.Generator().manual_seed(3), SIX)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_run = H.JaxTrainRun(tmp_path_factory.mktemp("ranks_train_fam"), JOBS)
    params = {(a, "bnn_train"): H.jax_params(a) for a in ARCHS}
    ranks = spawn(jobs_worker, 4, [(H.train_worker, (JOBS, params)),
                                   (H.grads_worker, (SIX, six_params(),
                                                     (1, 4)))])
    return [r[0] for r in ranks], jax_run.result(), [r[1] for r in ranks]


@pytest.mark.parametrize("arch", ARCHS)
def test_family_trains_over_ranks_as_jax(runs, arch):
    ranks, want, _ = runs
    job = next(j for j in JOBS if j["arch"] == arch)
    H.check_job(ranks, want[arch], job, FAMILY_GRAD_REL_LEAF.get(arch))
    if "mamba" not in arch:
        assert ranks[0][arch]["aux"] > 0      # the aux term is carried up


def test_experts_cut_by_mlp_train_as_one_rank(runs):
    _, _, six = runs
    loss, met, grads = steps.value_and_grad(six_params(), SIX,
                                            H.batch(SIX, 0),
                                            loss_chunk=H.CHUNK, remat=True)
    norm = float(torch.sqrt(sum(torch.sum(torch.square(g))
                                for g in T.leaves(grads))))
    for rank in six:
        # each expert's hidden over "model", its K (embed) over "data"
        assert rank["down"] == (None, "model", "data")
        np.testing.assert_allclose(rank["loss"], float(loss),
                                   rtol=H.LOSS_REL)
        np.testing.assert_allclose(rank["aux"], float(met["aux"]),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(rank["grad_norm"], norm, rtol=H.NORM_REL)
        assert_leaves_close(rank["grads"], grads, H.GRAD_REL, "six experts")
