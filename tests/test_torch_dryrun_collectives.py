"""The dry-run's collective record and step memory
(``launch/collectives.py``, ``launch/dryrun.run_cell``):
``collectives.analyze`` against the JAX package's
``analyze_collectives`` on its HLO example; a training step's record against chip_smoke.py's exact
prediction of what a rank of (i) issues (which
tests/test_torch_ranks_train_phase.py holds against real ranks); the
trip-count scaling of the collectives and the temp bytes against the
whole step at reduced depth; a train step's temp bytes falling where
``model`` cuts the vocab (the loss on a rank's vocab slice); and the
attention's one-tile stand-in on ``meta`` against the chunked call."""
import collections
import sys
from pathlib import Path

import pytest
import torch

from repro.launch.hlo_analysis import analyze_collectives
from repro_torch import configs
from repro_torch.configs.base import ShapeCell, reduced
from repro_torch.dist import sharding as S
from repro_torch.launch import analytic, collectives as coll, dryrun
from repro_torch.launch.mesh import fake_world
from repro_torch.layers import attention as A

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS                                     # noqa: E402

HLO = """
HloModule test

%body.1 (p: (s32[], f32[4])) -> (s32[], f32[4]) {
  %p = (s32[], f32[4]) parameter(0)
  %ar = f32[4]{0} all-reduce(%gte), replica_groups={}, to_apply=%add.1
  ROOT %t = (s32[], f32[4]) tuple(%c, %ar)
}

%cond.1 (p: (s32[], f32[4])) -> pred[] {
  %p = (s32[], f32[4]) parameter(0)
  %limit = s32[] constant(7)
  ROOT %lt = pred[] compare(%gte, %limit), direction=LT
}

ENTRY %main (a: f32[4]) -> f32[4] {
  %a = f32[4] parameter(0)
  %w = (s32[], f32[4]) while(%init), condition=%cond.1, body=%body.1, backend_config={"known_trip_count":{"n":"7"}}
  %ar2 = f32[8]{0} all-gather(%a), dimensions={0}
  ROOT %out = f32[4] get-tuple-element(%w), index=1
}
"""


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def test_record_of_the_hlo_example_is_jaxs():
    """tests/test_analytic.py's HLO: an f32[4] all-reduce in a loop of 7
    (16 bytes sent, 7 trips), an f32[8] all-gather of two ranks' f32[4]
    (16 bytes sent, its result 32) once."""
    entries = [("all_reduce", 2, 1, 16, 7), ("all_gather", 2, 1, 16, 1)]
    assert coll.analyze(entries) == analyze_collectives(HLO)
    assert coll.sent_totals(entries) == {
        "all_reduce": 7, "all_reduce_bytes": 112, "all_gather": 1,
        "all_gather_bytes": 16}


@pytest.mark.parametrize("layers", [12, CS.RANKS_TRAIN_LAYERS])
def test_train_record_is_the_ranks_prediction(layers):
    """bnn-lm-100m at [ranks] (i)'s sizes and float32 over (2, 2): every
    kind's calls and sent bytes are ``train_step_collectives``'."""
    sizes = CS.RANKS_TRAIN
    cell = ShapeCell("ranks_train", sizes["seq_len"], sizes["global_batch"],
                     "train")
    with fake_world(4):
        rec = dryrun.run_cell("bnn-lm-100m", cell, False, mesh=_mesh((2, 2)),
                              microbatches=sizes["microbatches"],
                              overrides={"n_layers": layers},
                              dtype=torch.float32)
    cfg = configs.get_config("bnn-lm-100m").replace(n_layers=layers)
    assert rec["sent"] == CS.train_step_collectives(cfg, sizes, (2, 2))
    jax = rec["collectives"]
    assert jax["total_bytes_executed"] == sum(
        jax[k]["bytes_executed"] for k in coll.KINDS) > 0
    assert rec["roofline"]["collective_s"] == \
        jax["total_bytes_executed"] / analytic.LINK_BW
    assert rec["first_call"]["sent"] == {}      # training caches nothing


def _whole(cfg, cell, mesh, rules):
    """The whole step at ``cfg``'s depth, two microbatches: sent totals,
    JAX's result bytes by kind, and its memory."""
    run = dryrun.step_run(cfg, cell, mesh, rules, 2, torch.float32)
    sent, result = collections.Counter(), collections.Counter()
    for kind, group, nbytes, _tags in run["events"]:
        sent[kind] += 1
        sent[kind + "_bytes"] += nbytes
        result[coll.JAX_KIND[kind]] += coll.result_bytes(kind, group, nbytes)
    return dict(sent), dict(result), {k: run[k] for k in
                                      ("temp", "output", "alias")}


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mixtral-8x7b",
                                  "deepseek-v2-lite-16b", "mamba2-1.3b"])
def test_scaled_train_step_is_the_whole_step(arch):
    """A dense, an MoE, an MLA and an SSM config at reduced width and
    four periods of layers, their train step over (2, 2) with two
    microbatches: the record scaled from runs at two and three periods
    (one and two where the leading dense layer makes a period's run two
    layers deep) has the whole step's calls, sent and result bytes, and
    temp, output and alias bytes."""
    base = reduced(configs.get_config(arch))
    cfg = base.replace(n_layers=base.first_dense + 4 * base.scan_period)
    cell = ShapeCell("t", 32, 8, "train")
    rules = S.rules_train(False, fsdp=True)
    with fake_world(4):
        mesh = _mesh((2, 2))
        rec = dryrun.step_record(cfg, cell, mesh, rules, 2, torch.float32)
        sent, result, mem = _whole(cfg, cell, mesh, rules)
    assert rec["sent"] == sent
    assert {k: rec["collectives"][k]["bytes_executed"]
            for k in coll.KINDS if k in result} == result
    assert rec["memory"] == mem and mem["temp"] > 0


def test_train_step_temp_falls_with_the_vocab_cut():
    """The reduced bnn-lm-100m's train step over (2, 2) (two microbatches
    of 2 rows a rank by 64) at a vocab of 8192, which ``model`` cuts, and
    of 8191, which it does not: where the vocab is cut a chunk's logits
    and their gradient are (rows, chunk, V/2) and the head is never
    gathered whole, so the step's temp bytes are under half the
    whole-vocab step's (a chunk's logits set the peak: 4.2 MB whole at
    float32).  The cut step's record has no reduce-scatter over the
    whole head (the whole head's gradient, V x d floats)."""
    base = reduced(configs.get_config("bnn-lm-100m"))
    cell = ShapeCell("t", 64, 8, "train")
    rules = S.rules_train(False, fsdp=True)
    runs = {}
    with fake_world(4):
        mesh = _mesh((2, 2))
        for v in (8192, 8191):
            runs[v] = dryrun.step_run(base.replace(vocab=v), cell, mesh,
                                      rules, 2, torch.float32)
    assert 0 < runs[8192]["temp"] < runs[8191]["temp"] / 2
    whole_head = 8191 * base.d_model * 4
    rs = [nbytes for kind, _g, nbytes, _t in runs[8191]["events"]
          if kind == "reduce_scatter"]
    assert whole_head in rs
    assert all(n < 8192 * base.d_model * 4 for kind, _g, n, _t in
               runs[8192]["events"] if kind == "reduce_scatter")


@pytest.mark.parametrize("t,window", [(16, None), (16, 8), (1, None)])
def test_one_tile_stand_in_is_the_chunked_call(t, window):
    """On ``meta`` at one (q chunk, kv chunk) tile the stand-in allocates
    what the chunked call does, and returns its shape and dtype; over
    four kv chunks (and four q chunks but at decode) it holds one
    tile's transients, then the output."""
    kw = dict(causal=t > 1, window=window, q_offset=0, kv_len=None,
              k_positions=None, q_chunk=16, kv_chunk=16)
    q = torch.empty((2, t, 4, 8), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 16, 2, 8), dtype=torch.bfloat16, device="meta")
    with coll.LiveBytes() as real:
        want = A._chunked(q, k, k, **kw)
    with coll.LiveBytes() as stand_in:
        got = A.attention(q, k, k, **kw)
    assert real.peak == stand_in.peak > 0
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    tw = 4 * t if t > 1 else t
    q4 = torch.empty((2, tw, 4, 8), dtype=torch.bfloat16, device="meta")
    k4 = torch.empty((2, 64, 2, 8), dtype=torch.bfloat16, device="meta")
    with coll.LiveBytes() as wide:
        out = A.attention(q4, k4, k4, **kw)
    assert out.shape == (2, tw, 4, 8)
    assert wide.peak == max(stand_in.peak, out.numel() * out.element_size())
