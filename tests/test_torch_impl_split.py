"""The paged attention and the BNN GEMMs take their impls separately,
as the JAX engine's ``attn_impl`` and ``bnn_impl`` do.

The reduced bnn-lm-100m engine under ``EngineConfig()``'s defaults
(prefix cache, swap) serves the same traffic with the two mixed pairs
(``attn_impl="torch", bnn_impl="auto"`` and the reverse); each gives
the tokens of the (auto, auto) engine and of the JAX engine with the
matching mixed pair (``"xla"``/``"pallas"``, the Pallas kernels in
interpret mode).  A spy on ``kernels/ops.resolve_impl`` records which
impl each kernel family was handed."""
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.models import transformer as JM
from repro.serving import Engine as JEngine, EngineConfig as JEngineConfig
from repro_torch import configs as tconfigs
from repro_torch.configs.base import reduced as treduced
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.serving import Engine, EngineConfig

torch.set_num_threads(1)

MAX_NEW = 6
# the port's pair -> the JAX engine's pair with the same split
PAIRS = {("torch", "auto"): ("xla", "pallas"),
         ("auto", "torch"): ("pallas", "xla")}
# the ops entry points of each kernel family (the spy's caller names)
ATTENTION = {"paged_attention", "paged_attention_mla"}
BNN = {"bnn_dense", "expert_dense"}


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced(jconfigs.get_config("bnn-lm-100m")).replace(
        precision="bnn")
    tcfg = treduced(tconfigs.get_config("bnn-lm-100m")).replace(
        precision="bnn")
    jp, _ = JM.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 128, n) for n in (5, 19, 11)]
    return jcfg, jp, tcfg, tp, prompts


def _serve(eng, prompts):
    rids = [eng.submit(p, MAX_NEW) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


def _port(models, attn_impl, bnn_impl, monkeypatch=None):
    """The port's tokens, and {kernel family: impls handed to
    resolve_impl} while it served."""
    _jcfg, _jp, tcfg, tp, prompts = models
    seen: dict[str, set] = {}
    if monkeypatch is not None:
        real = ops.resolve_impl

        def spy(impl, t):
            caller = sys._getframe(1).f_code.co_name
            fam = ("attention" if caller in ATTENTION else
                   "bnn" if caller in BNN else caller)
            seen.setdefault(fam, set()).add(impl)
            return real(impl, t)
        monkeypatch.setattr(ops, "resolve_impl", spy)
    eng = Engine(tp, tcfg, EngineConfig(attn_impl=attn_impl,
                                        bnn_impl=bnn_impl), device="cpu")
    return _serve(eng, prompts), seen


@pytest.fixture(scope="module")
def defaults(models):
    return _port(models, "auto", "auto")[0]


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_mixed_pair_tokens_and_dispatch(models, defaults, pair,
                                        monkeypatch):
    attn_impl, bnn_impl = pair
    got, seen = _port(models, attn_impl, bnn_impl, monkeypatch)
    for g, d in zip(got, defaults, strict=True):
        np.testing.assert_array_equal(g, d)
    # each family got its own impl, and only it
    assert seen["attention"] == {attn_impl}, seen
    assert seen["bnn"] == {bnn_impl}, seen
    jcfg, jp, _tcfg, _tp, prompts = models
    j_attn, j_bnn = PAIRS[pair]
    want = _serve(JEngine(jp, jcfg, JEngineConfig(attn_impl=j_attn,
                                                  bnn_impl=j_bnn)), prompts)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_engine_config_takes_the_pairs():
    for attn_impl, bnn_impl in PAIRS:
        ecfg = EngineConfig(attn_impl=attn_impl, bnn_impl=bnn_impl)
        assert (ecfg.attn_impl, ecfg.bnn_impl) == (attn_impl, bnn_impl)
    with pytest.raises(ValueError, match="unknown impl"):
        EngineConfig(attn_impl="xla")
