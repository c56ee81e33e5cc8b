"""The port's synthetic data stream and checkpoint manager.

``SyntheticLM``'s batches equal the JAX package's bit for bit (3 seeds x
steps x 4 shards, and the assembled global batch).  The checkpoint
round trip of a training-state tree (nested dicts and lists, float32,
bf16 and int32 leaves) bit-equal; rotation keeps the newest ``keep``;
a step directory without COMMITTED (a crash mid-write) is not listed
and restore takes the latest committed one; a changed byte fails the
integrity check; another tree is refused; the async writer snapshots
on the caller's thread (in-place writes after save do not reach the
file) and hands a write error to ``wait``."""
import json
import os

import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro_torch import tree as T
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data import pipeline as pipe

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_synthetic_lm_equals_jax(seed):
    dcfg = dict(vocab=97, seq_len=24, global_batch=8, seed=seed)
    for shard in range(4):
        j = jpipe.SyntheticLM(jpipe.DataConfig(**dcfg), shard, 4)
        t = pipe.SyntheticLM(pipe.DataConfig(**dcfg), shard, 4)
        np.testing.assert_array_equal(t.successors, j.successors)
        for step in (0, 1, 5, 123):
            jb, tb = j.batch(step), t.batch(step)
            assert sorted(tb) == sorted(jb) == ["labels", "tokens"]
            for k in jb:
                assert tb[k].dtype == jb[k].dtype
                np.testing.assert_array_equal(tb[k], jb[k])
    g_j = jpipe.SyntheticLM(jpipe.DataConfig(**dcfg), 0, 4)
    g_t = pipe.SyntheticLM(pipe.DataConfig(**dcfg), 0, 4)
    for k, v in g_j.global_batch_for_test(3).items():
        np.testing.assert_array_equal(g_t.global_batch_for_test(3)[k], v)
    tb = pipe.to_tensors(g_t.batch(2), "cpu")
    assert tb["tokens"].dtype == torch.int64
    with pytest.raises(ValueError):
        pipe.SyntheticLM(pipe.DataConfig(**dcfg), 0, 3)


def _state(seed: int):
    """A (params, optimizer state) tree as training saves it."""
    g = torch.Generator().manual_seed(seed)
    params = {"embed": {"w": torch.randn(16, 8, generator=g)},
              "layers": [{"w": torch.randn(8, 8, generator=g),
                          "b": torch.randn(8, generator=g)}
                         for _ in range(2)]}
    mom = T.map_(lambda p: torch.randn(p.shape, generator=g)
                 .to(torch.bfloat16), params)
    return (params, {"m": mom, "v": T.map_(torch.clone, mom),
                     "step": torch.tensor(seed, dtype=torch.int32)})


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _assert_bit_equal(got, want):
    gl, wl = T.leaves(got), T.leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_checkpoint_round_trip_rotation_bf16(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    states = {s: _state(s) for s in (5, 10, 15)}
    for s, st in states.items():
        mgr.save(s, st)
    assert mgr.all_steps() == [10, 15]             # rotated
    tree, step = mgr.restore(_state(0))
    assert step == 15
    _assert_bit_equal(tree, states[15])
    tree, _ = mgr.restore(_state(0), step=10)
    _assert_bit_equal(tree, states[10])
    with open(tmp_path / "step_0000015" / "manifest.json") as f:
        man = json.load(f)
    assert man["dtypes"].count("torch.bfloat16") == 10      # m and v
    assert man["treedef"] == T.describe(states[15])
    with pytest.raises(IOError):                   # another tree
        mgr.restore({"w": torch.zeros(3)})


@pytest.mark.parametrize("change", ["shape", "dtype"])
def test_checkpoint_restore_refuses_other_leaves(tmp_path, change):
    """A tree of the same structure whose leaf has another shape or
    dtype (another config) is refused at restore, naming the leaf."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1))
    bad = _state(0)
    w = bad[0]["layers"][1]["w"]
    bad[0]["layers"][1]["w"] = (torch.zeros(9, 8) if change == "shape"
                                else w.double())
    assert T.describe(bad) == T.describe(_state(0))
    with pytest.raises(IOError, match="leaf"):
        mgr.restore(bad)


def test_checkpoint_crash_safety_and_integrity(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    # a crash mid-write: the directory is there, COMMITTED is not
    os.remove(tmp_path / "step_0000002" / "COMMITTED")
    os.makedirs(tmp_path / "step_0000003.tmp")
    assert mgr.all_steps() == [1]
    tree, step = mgr.restore(_state(0))
    assert step == 1
    _assert_bit_equal(tree, _state(1))
    # one changed byte in the arrays fails the digest
    npz = tmp_path / "step_0000001" / "arrays.npz"
    data = bytearray(npz.read_bytes())
    data[len(data) // 2] ^= 0xFF
    npz.write_bytes(bytes(data))
    with pytest.raises(IOError, match="integrity"):
        mgr.restore(_state(0))
    empty = CheckpointManager(str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError):
        empty.restore(_state(0))


def test_checkpoint_async_snapshots_on_callers_thread(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=True)
    st = _state(3)
    want = T.map_(torch.clone, st)
    mgr.save(7, st)
    for leaf in T.leaves(st):                      # the optimizer's writes
        leaf.add_(1) if leaf.dtype != torch.int32 else leaf.fill_(99)
    mgr.wait()
    tree, step = mgr.restore(_state(0))
    assert step == 7
    _assert_bit_equal(tree, want)
    # a failed write reaches the caller at wait()
    os.makedirs(tmp_path / "step_0000008")
    (tmp_path / "step_0000008" / "COMMITTED").write_text("ok")
    bad = CheckpointManager(str(tmp_path / "file"), async_write=True)
    (tmp_path / "file" / "step_0000001.tmp").write_text("not a directory")
    bad.save(1, _state(1))
    with pytest.raises(OSError):
        bad.wait()
