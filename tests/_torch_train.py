"""Shared helpers of the training tests (tests/test_torch_train_*.py):
JAX trees carried into the port's trainable tree and compared leaf by
leaf."""
import jax
import numpy as np
import torch

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro_torch import configs as tconfigs, tree as T
from repro_torch.configs.base import reduced as treduced
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer as M


def cfgs(arch: str, precision: str | None = None):
    """The reduced config of ``arch`` in both packages, at its own
    precision or ``precision``."""
    j = jreduced(jconfigs.get_config(arch))
    t = treduced(tconfigs.get_config(arch))
    if precision:
        j, t = j.replace(precision=precision), t.replace(precision=precision)
    return j, t


def to_port(tree, tcfg) -> dict:
    """A JAX params-shaped tree (params, gradients, moments) as the
    port's trainable tree (a tied head left out)."""
    return M.trainable(params_from_numpy(jax.tree.map(np.asarray, tree),
                                         tcfg), tcfg)


def np_(t) -> np.ndarray:
    return t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def leaf_paths(tree, prefix: str = "") -> list[str]:
    """Each leaf's path (``/layers/0/attn/A_log``), in walk order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, f"{prefix}/{i}")]
    return [prefix]


def assert_leaves_close(got, want, rel: float, what: str = "",
                        rel_by_name: dict | None = None):
    """Every leaf of ``got`` within ``rel`` x the largest |element| of
    the same leaf of ``want`` (trees of one structure); a leaf whose
    name (the last key of its path) is in ``rel_by_name`` within that
    bound instead."""
    gl, wl = T.leaves(got), T.leaves(want)
    assert len(gl) == len(wl), (len(gl), len(wl))
    for path, g, w in zip(leaf_paths(got), gl, wl):
        g, w = np_(g), np_(w)
        assert g.shape == w.shape, (what, path, g.shape, w.shape)
        bound = (rel_by_name or {}).get(path.rsplit("/", 1)[-1], rel)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= bound * scale, (what, path, w.shape, err, scale)


def batch_np(vocab: int, b: int, t: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, t)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, t)).astype(np.int32)}


def to_torch_batch(batch: dict) -> dict:
    """int arrays -> int64 tensors, float arrays -> float32 tensors."""
    return {k: (torch.from_numpy(np.asarray(v)).long()
                if np.issubdtype(np.asarray(v).dtype, np.integer)
                else torch.from_numpy(np.asarray(v, np.float32)))
            for k, v in batch.items()}


def family_batch(cfg, b: int = 4, t: int = 24, seed: int = 7) -> dict:
    """The JAX tests' family batch shape (tests/test_archs_smoke.py's
    ``_batch``), drawn with numpy: audio frame embeddings, a vlm's patch
    prefix and tokens, or tokens; labels on the token tail."""
    rng = np.random.default_rng(seed)
    batch = {}
    t_lab = t
    if cfg.frontend == "audio":
        batch["embeds"] = (rng.standard_normal((b, t, cfg.d_model)) *
                           0.1).astype(np.float32)
    elif cfg.frontend == "vlm":
        p = cfg.frontend_prefix
        batch["prefix_embeds"] = (rng.standard_normal((b, p, cfg.d_model)) *
                                  0.1).astype(np.float32)
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, t - p)).astype(
            np.int32)
        t_lab = t - p
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    batch["labels"] = rng.integers(0, cfg.vocab, (b, t_lab)).astype(np.int32)
    return batch


FAMILY_GRAD_REL = 1e-5     # each leaf within this x its largest |element|
# jamba's SSD decay leaves (A_log) alone: the JAX package's own jitted
# and op-by-op gradients of the reduced jamba differ by up to 1.3e-5 of
# the leaf's largest element there (layer 0's A_log), so 1e-5 cannot
# tell the port from rounding; every other leaf, dt_bias and D
# included, stays within FAMILY_GRAD_REL
FAMILY_GRAD_REL_LEAF = {"jamba-1.5-large-398b": {"A_log": 5e-5}}
FAMILY_CHUNK = 8           # < the label tail: several chunks, one padded


def check_family_grads(arch: str, precision: str | None):
    """``loss_fn`` (xent, the MoE aux term and their sum) and every
    leaf's gradient of the port against the JAX package on the reduced
    ``arch`` (JAX's weights carried across); returns the port's
    (tcfg, params, batch) for a train step."""
    import jax
    from repro.models import transformer as JM
    from repro_torch.launch import steps

    jcfg, tcfg = cfgs(arch, precision)
    params, _ = JM.init(jax.random.PRNGKey(0), jcfg)
    batch = family_batch(jcfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, jcfg, b, loss_chunk=FAMILY_CHUNK),
        has_aux=True))(params, batch)
    tp = params_from_numpy(jax.tree.map(np.asarray, params), tcfg)
    tb = to_torch_batch(batch)
    loss, m, grads = steps.value_and_grad(tp, tcfg, tb,
                                          loss_chunk=FAMILY_CHUNK,
                                          remat=False)
    np.testing.assert_allclose(float(m["xent"]), float(jm["xent"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    if jcfg.n_experts:
        assert float(m["aux"]) > 0          # the aux term is carried up
    assert ("head" in grads) == (not tcfg.tie_embeddings)
    assert_leaves_close(grads, to_port(jg, tcfg), FAMILY_GRAD_REL, arch,
                        FAMILY_GRAD_REL_LEAF.get(arch))
    return tcfg, tp, tb


def check_family_train_step(tcfg, params, batch):
    """One step with 2 microbatches moves the parameters (the JAX
    package's ``test_arch_train_step``): the loss is finite, the step
    is 1, and every leaf that is not all zeros moved."""
    from repro_torch.launch import steps
    from repro_torch.optim import optimizer as opt

    ocfg = opt.AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    tree = M.trainable(params, tcfg)
    before = T.map_(torch.clone, tree)
    state = opt.init(ocfg, tree)
    _, state, metrics = steps.build_train_step(
        tcfg, ocfg, microbatches=2, loss_chunk=FAMILY_CHUNK)(
        params, state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert int(state["step"]) == 1
    moved = [float((a - b).abs().sum()) for a, b in
             zip(T.leaves(tree), T.leaves(before))]
    assert sum(moved) > 0
    for d, b in zip(moved, T.leaves(before)):
        assert d > 0 or not b.any()
