"""Port core: import hygiene, BNN packing/XNOR math bit-exact against
the JAX package, and the config copy field-for-field equal.

Inputs are made with numpy from a fixed seed and go through both
packages; packed words compare as the same 32 bits (uint32 in JAX,
int32 in the port)."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.core import packing as jpacking, xnor as jxnor
from repro_torch import configs as tconfigs
from repro_torch.configs.base import reduced as treduced
from repro_torch.core import packing, xnor

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SIZES = (1, 31, 32, 33, 100, 768)


def _words(a) -> np.ndarray:
    """Packed words of either package as uint32."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def test_import_hygiene_no_jax_no_repro():
    """Importing every port module, and what chip_smoke.py and
    chip_ranks_full.py import,
    loads neither jax nor any module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "import chip_ranks_full\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.startswith('jaxlib') or m == 'repro'\n"
        "             or m.startswith('repro.'))\n"
        "print('BAD', bad)\n"
        "print('N', sum(m.startswith('repro_torch') for m in sys.modules))\n"
        "print('SSM', 'repro_torch.layers.mamba2' in sys.modules)\n"
        "print('SERVE', 'repro_torch.launch.serve' in sys.modules)\n"
        "new = ('serving.policy', 'serving.tracing', 'serving.replay',\n"
        "       'serving.frontend', 'launch.trace_view')\n"
        "print('SLICE12', all('repro_torch.' + m in sys.modules\n"
        "                     for m in new))\n"
        "new = ('dist.fault', 'dist.sharding', 'serving.sharded')\n"
        "print('SLICE13', all('repro_torch.' + m in sys.modules\n"
        "                     for m in new))\n"
        "new = ('tree', 'optim.optimizer', 'optim.compress',\n"
        "       'data.pipeline', 'checkpoint.manager', 'launch.steps',\n"
        "       'launch.train')\n"
        "print('SLICE14', all('repro_torch.' + m in sys.modules\n"
        "                     for m in new))\n"
        "new = ('launch.analytic', 'launch.mesh', 'launch.dryrun',\n"
        "       'dist.sharding', 'configs.base')\n"
        "import torch.distributed as dist\n"
        "print('SLICE15', all('repro_torch.' + m in sys.modules\n"
        "                     for m in new), dist.is_initialized())\n"
        "new = ('dist.spmd', 'dist.sharding', 'launch.mesh',\n"
        "       'launch.steps', 'serving.engine')\n"
        "print('SLICE16', all('repro_torch.' + m in sys.modules\n"
        "                     for m in new),\n"
        "      'torch.distributed.tensor' in sys.modules,\n"
        "      dist.is_initialized())\n"
        "new = ('layers.moe', 'layers.mla', 'layers.attn_block',\n"
        "       'layers.ffn', 'kernels.ops', 'models.transformer',\n"
        "       'launch.mesh', 'serving.block_cache')\n"
        "print('SLICE17', all('repro_torch.' + m in sys.modules\n"
        "                     for m in new),\n"
        "      'torch.distributed.tensor' in sys.modules)\n"
        "new = ('dist.spmd', 'dist.sharding', 'launch.steps',\n"
        "       'launch.train', 'launch.mesh', 'optim.optimizer',\n"
        "       'checkpoint.manager', 'tree')\n"
        "print('SLICE19', all('repro_torch.' + m in sys.modules\n"
        "                     for m in new),\n"
        "      'torch.distributed.tensor' in sys.modules,\n"
        "      dist.is_initialized())\n"
        "print('CFGS', sum(m.startswith('repro_torch.configs.')\n"
        "                  for m in sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    n = int(res.stdout.split("N ")[1].split()[0])
    assert n >= 25, res.stdout          # every subpackage was walked
    assert "SSM True" in res.stdout, res.stdout   # the SSD mixer too
    assert "SERVE True" in res.stdout, res.stdout  # and the serve CLI
    # the policies, the trace, its replay and viewer, the front-end
    assert "SLICE12 True" in res.stdout, res.stdout
    # the heartbeat monitor, the shards' devices, the sharded engine
    assert "SLICE13 True" in res.stdout, res.stdout
    # training: the optimizer, compression, data, checkpoints, the CLI
    assert "SLICE14 True" in res.stdout, res.stdout
    # the analytic model, the meshes, the dry-run: no process group is
    # made by importing them
    assert "SLICE15 True False" in res.stdout, res.stdout
    # the forward over several ranks: its DTensor helpers import DTensor
    # only where a mesh is used, and no module makes a process group
    assert "SLICE16 True False False" in res.stdout, res.stdout
    # the MoE and MLA families over several ranks: the expert-parallel
    # MoE, MLA on a rank's heads, the head_dim fallback, the per-layer
    # placement of the weights on the ranks
    assert "SLICE17 True False" in res.stdout, res.stdout
    # training over several ranks: the differentiable collectives, the
    # train placements, the step, AdamW and checkpoints on shards, the
    # launcher's mesh: DTensor only where a mesh is used, no group made
    assert "SLICE19 True False False" in res.stdout, res.stdout
    # every config of the registry (11) and base.py: the jamba hybrid,
    # the dense and the front-end configs too
    assert int(res.stdout.split("CFGS ")[1].split()[0]) == 12, res.stdout


@pytest.mark.parametrize("s", SIZES)
def test_packing_bit_exact(s):
    rng = np.random.default_rng(s)
    bits = rng.integers(0, 2, size=(3, s)).astype(np.uint8)
    x = rng.standard_normal((5, s)).astype(np.float32)
    x[0, : min(s, 4)] = 0.0                      # x >= 0 on exact zeros
    # pack_bits / pack_pm1 along the last axis and along axis 0
    np.testing.assert_array_equal(
        _words(packing.pack_bits(torch.from_numpy(bits))),
        _words(jpacking.pack_bits(jnp.asarray(bits))))
    np.testing.assert_array_equal(
        _words(packing.pack_pm1(torch.from_numpy(x))),
        _words(jpacking.pack_pm1(jnp.asarray(x))))
    np.testing.assert_array_equal(
        _words(packing.pack_pm1(torch.from_numpy(x.T.copy()), axis=0)),
        _words(jpacking.pack_pm1(jnp.asarray(x.T), axis=0)))
    # unpack_bits round trip against the JAX words
    jw = jpacking.pack_bits(jnp.asarray(bits))
    tw = torch.from_numpy(np.array(jw).view(np.int32))
    np.testing.assert_array_equal(packing.unpack_bits(tw, s).numpy(), bits)
    np.testing.assert_array_equal(packing.unpack_bits(tw, s).numpy(),
                                  np.asarray(jpacking.unpack_bits(jw, s)))
    # popcount over words with every bit pattern class, bit 31 included
    words = rng.integers(0, 2 ** 32, size=64, dtype=np.uint64).astype(np.uint32)
    words[:3] = [0, 0xFFFFFFFF, 0x80000000]
    np.testing.assert_array_equal(
        packing.popcount_u32(torch.from_numpy(words.view(np.int32))).numpy(),
        np.asarray(jpacking.popcount_u32(jnp.asarray(words))))


@pytest.mark.parametrize("s", SIZES)
def test_xnor_bit_exact(s):
    rng = np.random.default_rng(100 + s)
    i01 = rng.integers(0, 2, size=(4, s)).astype(np.uint8)
    w01 = rng.integers(0, 2, size=(6, s)).astype(np.uint8)
    ip_j, wp_j = jpacking.pack_bits(jnp.asarray(i01)), \
        jpacking.pack_bits(jnp.asarray(w01))
    ip_t = torch.from_numpy(np.array(ip_j).view(np.int32))
    wp_t = torch.from_numpy(np.array(wp_j).view(np.int32))
    # integer paths: bit-exact
    np.testing.assert_array_equal(
        xnor.xnor_matmul_packed(ip_t, wp_t, s).numpy(),
        np.asarray(jxnor.xnor_matmul_packed(ip_j, wp_j, s)))
    np.testing.assert_array_equal(
        xnor.xnor_bitcount_packed(ip_t[:, None], wp_t[None], s).numpy(),
        np.asarray(jxnor.xnor_bitcount_packed(ip_j[:, None], wp_j[None], s)))
    np.testing.assert_array_equal(
        xnor.xnor_bitcount_01(torch.from_numpy(i01)[:, None],
                              torch.from_numpy(w01)[None]).numpy(),
        np.asarray(jxnor.xnor_bitcount_01(jnp.asarray(i01)[:, None],
                                          jnp.asarray(w01)[None])))
    pm = (2 * i01.astype(np.int32) - 1)
    np.testing.assert_array_equal(
        xnor.dot_pm1(torch.from_numpy(pm), torch.from_numpy(pm)).numpy(),
        np.asarray(jxnor.dot_pm1(jnp.asarray(pm), jnp.asarray(pm))))
    # the float inference GEMM: integer dot exactly, times alpha (f32
    # mean: tolerance 1e-6 relative for the reduction order)
    x = rng.standard_normal((4, s)).astype(np.float32)
    w = rng.standard_normal((s, 7)).astype(np.float32)
    np.testing.assert_allclose(
        xnor.bnn_matmul_infer(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jxnor.bnn_matmul_infer(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        xnor.bnn_matmul_infer(torch.from_numpy(x), torch.from_numpy(w),
                              scale=False).numpy(),
        np.asarray(jxnor.bnn_matmul_infer(jnp.asarray(x), jnp.asarray(w),
                                          scale=False)))


@pytest.mark.parametrize("block_words", [1, 100, 1 << 26])
def test_xnor_matmul_in_row_blocks_bit_exact(block_words, monkeypatch):
    """The plain XNOR GEMM computes in blocks of rows (its int64
    temporaries would not fit beside a full-width model at M = 128):
    one row a block, a few rows, one block, all equal to the JAX
    package's, at leading batch dimensions too."""
    rng = np.random.default_rng(9)
    s = 100
    i01 = rng.integers(0, 2, size=(2, 37, s)).astype(np.uint8)
    w01 = rng.integers(0, 2, size=(5, s)).astype(np.uint8)
    ip_j = jpacking.pack_bits(jnp.asarray(i01))
    wp_j = jpacking.pack_bits(jnp.asarray(w01))
    want = np.asarray(jxnor.xnor_matmul_packed(ip_j, wp_j, s))
    monkeypatch.setattr(xnor, "XNOR_BLOCK_WORDS", block_words)
    ip_t = torch.from_numpy(np.array(ip_j).view(np.int32))
    wp_t = torch.from_numpy(np.array(wp_j).view(np.int32))
    np.testing.assert_array_equal(
        xnor.xnor_matmul_packed(ip_t, wp_t, s).numpy(), want)
    np.testing.assert_array_equal(
        xnor.xnor_matmul_packed(ip_t[0], wp_t, s).numpy(), want[0])


@pytest.mark.parametrize("shrink", [False, True])
def test_arch_config_matches_jax(shrink):
    j = jconfigs.get_config("bnn-lm-100m")
    t = tconfigs.get_config("bnn-lm-100m")
    if shrink:
        j, t = jreduced(j), treduced(t)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")
