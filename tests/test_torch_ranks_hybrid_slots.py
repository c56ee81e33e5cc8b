"""The jamba hybrid's slots and weights over several ranks: the reduced
jamba-1.5-large at "bnn" on JAX's weights over (1, 2), (2, 2) and
(1, 4) meshes of ``gloo`` ranks (a world of 2 and one of 4), under the
JAX engine's defaults: the joint prefix match hits (blocks and slot
snapshots), and a preempted request's slot goes to the host and comes
back bit-equal on every rank, the data ranks' pools (blocks and slots)
staying equal after every step, with one rank's tokens (its slot
machinery is held to the JAX engine's in
tests/test_torch_hybrid_snapshots.py).  ``launch/mesh.init_on_ranks``
(each expert stack placed as drawn) gives ``init``'s seeded weights.
tests/test_torch_ranks_hybrid.py holds the forward and the engine to
JAX."""
import pytest
import torch

import _torch_ranks as H
from test_torch_ranks_hybrid import ARCH, IDS, MAX_NEW, SHAPES

torch.set_num_threads(1)

SLOT_EKW = dict(max_batch=2)         # 2 decode rows
PREEMPT_AFTER = 5


@pytest.fixture(scope="module")
def models():
    return H.jax_models(ARCH)


@pytest.fixture(scope="module")
def ranks(models):
    """Per world size, each rank's results: the slot runs, then
    ``init_on_ranks`` over the world's first mesh."""
    params, slots = models[2], H.shared_prompts(models[0].vocab)
    out = {}
    for size, shapes in ((2, [(1, 2)]), (4, [(2, 2), (1, 4)])):
        out[size] = H.spawn(H.jobs_worker, size, [
            (H.slots_worker, (ARCH, shapes, params, slots, MAX_NEW,
                              PREEMPT_AFTER, SLOT_EKW)),
            (H.init_worker, (ARCH, shapes[0]))])
    return out


def _ranks(ranks, shape, job):
    return [r[job] for r in ranks[shape[0] * shape[1]]]


@pytest.fixture(scope="module")
def slot_refs(models):
    """The port's one rank's (tokens, counts) of ``drive_slots``, greedy
    then sampled."""
    return H.drive_slots_port(H.port_cfg(arch=ARCH), models[2],
                              H.shared_prompts(models[0].vocab), MAX_NEW,
                              PREEMPT_AFTER, SLOT_EKW)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_snapshots_hit_and_swapped_slots_return_bit_equal(ranks, slot_refs,
                                                          shape):
    H.check_slots(_ranks(ranks, shape, 0), shape, slot_refs)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_init_on_ranks_draws_the_seeded_weights(ranks, shape):
    """``init_on_ranks`` places the seeded weights by the decode rules:
    gathered whole, they are ``init``'s."""
    from repro_torch import tree as T
    from repro_torch.models import transformer as M
    cfg = H.port_cfg(arch=ARCH)
    want = M.trainable(M.init(torch.Generator().manual_seed(0), cfg), cfg)
    specs = H.port_placements(ARCH, want, shape)
    for rank in _ranks(ranks, shape, 1):
        assert rank["specs"] == specs
        assert all(torch.equal(a, b) for a, b in zip(
            T.leaves(rank["params"]), T.leaves(want), strict=True))
