"""The port's training launcher on the CPU: ``train(..., device="cpu",
smoke=True)`` lowers the loss as the JAX package's
``test_train_loss_decreases`` asks; resuming at step 10 to 16 equals an
uninterrupted 16-step run (``test_checkpoint_resume_determinism``);
started from JAX's weights, its losses follow JAX's ``train`` on the
same data stream; ``--multi-pod`` and a missing card raise; and
``python -m repro_torch.launch.train --smoke --device cpu --steps 3``
runs."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.launch.train import train as jtrain
from repro.models import transformer as JM
from repro_torch.interop import params_from_numpy
from repro_torch.launch.train import main, train

from _torch_train import cfgs

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def test_train_loss_decreases(tmp_path):
    losses = train("bnn-lm-100m", smoke=True, steps=30, global_batch=8,
                   seq_len=64, lr=2e-3, ckpt_dir=str(tmp_path / "ck"),
                   ckpt_every=10, device="cpu")
    assert len(losses) == 30 and np.isfinite(losses).all()
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.05, (first, last)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == \
        ["step_0000020", "step_0000030"]


def test_checkpoint_resume_determinism(tmp_path):
    """Stop at 10, resume to 16 == uninterrupted 16 (same data stream,
    same params)."""
    kw = dict(smoke=True, global_batch=4, seq_len=32, lr=1e-3,
              schedule_total=16, device="cpu")
    l_a = train("bnn-lm-100m", steps=16, **kw)
    d = str(tmp_path / "ck")
    l_10 = train("bnn-lm-100m", steps=10, ckpt_dir=d, ckpt_every=5, **kw)
    l_b = train("bnn-lm-100m", steps=16, ckpt_dir=d, ckpt_every=100, **kw)
    assert len(l_b) == 6                       # resumed at step 10
    np.testing.assert_allclose(l_a[:10], l_10, rtol=0)
    np.testing.assert_allclose(l_a[-1], l_b[-1], rtol=1e-4)


def test_losses_follow_jax_train():
    """From JAX's init weights, the port's losses on the same stream:
    step 0 within 1e-5 (same weights, same batch); later steps within
    1e-3, since Adam's first step moves each near-zero gradient element
    by about lr either way."""
    kw = dict(smoke=True, steps=4, global_batch=4, seq_len=32, lr=1e-3,
              precision="bnn_train")
    want = jtrain("bnn-lm-100m", **kw)
    jcfg, tcfg = cfgs("bnn-lm-100m", "bnn_train")
    params, _ = JM.init(jax.random.PRNGKey(0), jcfg)
    got = train("bnn-lm-100m", device="cpu", params=params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg), **kw)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_refusals():
    """What the JAX launcher does with --multi-pod: a smoke run trains on
    one device whatever it is asked (the JAX smoke mesh is 1x1); any
    other run needs the 512 ranks of the (2, 16, 16) mesh, and outside
    such a process group raises before it draws a weight; without a
    card ``train`` refuses unless asked for the CPU."""
    losses = train("bnn-lm-100m", smoke=True, multi_pod=True, device="cpu",
                   steps=2, seq_len=16, log_every=10 ** 6)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses == train("bnn-lm-100m", smoke=True, device="cpu", steps=2,
                           seq_len=16, log_every=10 ** 6)
    with pytest.raises(ValueError, match="need a process group of 512"):
        main(["--device", "cpu", "--multi-pod"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train("bnn-lm-100m", smoke=True, steps=1)


def test_cli_runs():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "3", "--seq-len", "32"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"),
             "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    lines = [l for l in res.stdout.splitlines() if l.startswith("[train]")]
    assert len(lines) == 2 and "step=    2" in lines[-1], res.stdout
