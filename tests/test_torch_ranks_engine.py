"""The engine over several ranks against the JAX package: 8 requests
on the reduced bnn-lm-100m at "bnn" (JAX's weights), served greedy and
sampled by one ``Engine`` a rank over a (2, 2) and a (1, 4) mesh of a
4-rank ``gloo`` world (every rank the same scheduler over the same
requests), with ``check_ranks`` comparing the ranks' tokens at every
step.  Each rank's tokens equal one JAX ``Engine``'s and the port's
one-rank engine's; the decode batches reach 4 rows (split over
``data`` on the (2, 2) mesh) and the pool is short enough to preempt
(swap: each rank's kv-head slice of the blocks goes to the host and
back)."""
import jax
import numpy as np
import pytest
import torch

import _torch_ranks as H
from repro.serving import Engine as JEngine, EngineConfig as JEngineConfig
from repro_torch.interop import params_from_numpy

torch.set_num_threads(1)

SHAPES = [(2, 2), (1, 4)]
LENS = [5, 9, 3, 7, 12, 4, 8, 6]
MAX_NEW = 8
# 12 blocks of 4 tokens under 4 decode rows of up to 20 tokens each:
# 3 preemptions, 2 of them swaps
EKW = dict(num_blocks=13)


@pytest.fixture(scope="module")
def prompts(bnn_cfg):
    return H.prompts(bnn_cfg.vocab, LENS, seed=11)


@pytest.fixture(scope="module")
def params(bnn_params):
    return params_from_numpy(jax.tree.map(np.asarray, bnn_params),
                             H.port_cfg())


@pytest.fixture(scope="module")
def jax_tokens(bnn_cfg, bnn_params, prompts):
    """One JAX Engine (the XLA paths), greedy then sampled."""
    eng = JEngine(bnn_params, bnn_cfg, JEngineConfig(
        **{**H.EKW, **EKW}, attn_impl="xla", bnn_impl="xla"))
    out = []
    for samp in (None, H.sampling("jax")):
        rids = [eng.submit(p, MAX_NEW, **({"sampling": samp(i)} if samp
                                          else {}))
                for i, p in enumerate(prompts)]
        got = eng.run()
        out.append([got[r].tolist() for r in rids])
    return out


@pytest.fixture(scope="module")
def one_rank(params, prompts):
    return [H.serve(params, H.port_cfg(), prompts, MAX_NEW, sampled=s, **EKW)
            for s in (False, True)]


@pytest.fixture(scope="module")
def ranks(params, prompts):
    return H.spawn(H.engine_worker, 4, SHAPES, params, prompts, MAX_NEW, EKW)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "1x4"])
def test_engine_over_ranks_gives_jax_tokens(ranks, jax_tokens, one_rank,
                                            shape, sampled):
    want = jax_tokens[sampled]
    assert one_rank[sampled][0] == want
    for rank in ranks:
        run = rank[shape][sampled]
        assert run["tokens"] == want
        assert run["max_concurrent"] == H.EKW["max_batch"]
        assert run["preemptions"] == one_rank[sampled][1]["preemptions"]


def test_the_schedule_preempts(one_rank):
    """The pool cannot hold 4 decode rows to their ends."""
    assert one_rank[0][1]["preemptions"] > 0
