"""The partitioning plan against the JAX package: logical-axis specs,
their resolution to partition specs, the rule sets, and DTensor
placements.

For every config at published width, the port's param and cache specs
equal the JAX package's after the JAX scanned segments are unstacked
(their leading "layers" axis dropped, one dict per layer, in the walk
``interop.params_from_numpy`` takes); and every leaf's resolved spec
on the 16x16 and 2x16x16 meshes, under the train (FSDP) and decode
rules, equals JAX's ``logical_to_pspec`` over JAX's specs with a
stand-in mesh.  JAX's ``abstract_init`` is ``eval_shape``: nothing is
allocated."""
import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.dist import sharding as JS
from repro.layers.common import logical_to_pspec as j_logical_to_pspec
from repro.models import transformer as JM
from repro_torch import configs as tconfigs
from repro_torch.dist import sharding as S
from repro_torch.launch import mesh as MESH
from repro_torch.layers.common import logical_to_pspec, to_placements
from repro_torch.models import transformer as M
from repro_torch.optim import optimizer as opt_mod

from _torch_partition import (FakeMesh, flat_jax, flat_port, is_axes,
                              unstack_layers)

torch.set_num_threads(1)

ARCHS = list(jconfigs._REGISTRY)        # the 10 assigned + bnn-lm-100m


@pytest.fixture(scope="module")
def trees():
    """arch -> (JAX shapes, JAX specs, port meta params, port specs)."""
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
        jshapes, jspecs = JM.abstract_init(jcfg)
        tparams = M.trainable(M.abstract_init(tcfg), tcfg)
        out[arch] = (jcfg, jshapes, jspecs, tcfg, tparams,
                     M.param_specs(tcfg))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(trees, arch):
    jcfg, jshapes, jspecs, tcfg, tparams, tspecs = trees[arch]
    got = flat_port(tspecs, tparams)
    want = flat_jax(jcfg, jspecs, jshapes)
    assert got == want
    # a tied head has no entry: the leaves count the embedding once
    assert ("head" in tspecs) == (not tcfg.tie_embeddings)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_jax(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    want = unstack_layers({"segments": JM.cache_specs(jcfg)}, jcfg, True)
    got = M.cache_specs(tcfg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == jax.tree.map(tuple, w, is_leaf=is_axes)
    # the caches' leaves line up with the specs' and their ranks
    caches = M.init_cache(tcfg, 2, 64, device="meta")
    for g, c in zip(got, caches, strict=True):
        assert g.keys() == c.keys()
        assert all(len(g[k]) == c[k].ndim for k in g)


RULES = {"train": lambda mp: (S.rules_train(mp, fsdp=True),
                              JS.rules_train(mp, fsdp=True)),
         "decode": lambda mp: (S.rules_decode(mp), JS.rules_decode(mp))}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("kind", sorted(RULES))
def test_resolved_specs_equal_jax(trees, kind, multi_pod):
    trules, jrules = RULES[kind](multi_pod)
    assert trules == jrules
    mesh = FakeMesh(multi_pod)
    for arch in ARCHS:
        jcfg, jshapes, jspecs, tcfg, tparams, tspecs = trees[arch]
        got = S.param_pspecs(mesh, tparams, tspecs, trules)
        flat_got = flat_port(tspecs, tparams)
        want = flat_jax(jcfg, jspecs, jshapes)
        pgot = {}

        def walk(p, path=()):
            if isinstance(p, tuple):
                pgot[path] = p
                return
            items = p.items() if isinstance(p, dict) else enumerate(p)
            for k, v in items:
                walk(v, path + (k,))
        walk(got)
        assert pgot.keys() == want.keys() == flat_got.keys()
        for path, (axes, shape) in want.items():
            jspec = j_logical_to_pspec(axes, jrules, shape, mesh)
            assert pgot[path] == tuple(jspec), (arch, path)
    # the cache specs too (decode rules over the decode cell's caches)
    if kind == "decode":
        for arch in ARCHS:
            tcfg = tconfigs.get_config(arch)
            caches = M.init_cache(tcfg, 128, 32768, torch.bfloat16,
                                  device="meta")
            for s, c in zip(M.cache_specs(tcfg), caches):
                for k in s:
                    assert logical_to_pspec(s[k], trules, c[k].shape,
                                            mesh) == tuple(
                        j_logical_to_pspec(s[k], jrules, c[k].shape, mesh))


def test_logical_to_pspec_dedup_and_divisibility():
    """The JAX suite's two cases (tests/test_infra.py), verbatim."""
    class FakeMesh:
        shape = {"data": 16, "model": 16}

    rules = {"experts": "model", "embed": "data", "mlp": "model"}
    # 8 experts cannot split 16 -> dropped, mlp gets model instead
    spec = logical_to_pspec(("experts", "embed", "mlp"), rules,
                            (8, 4096, 14336), FakeMesh())
    assert tuple(spec) == (None, "data", "model")
    # 64 experts can -> dedup drops the second 'model'
    spec = logical_to_pspec(("experts", "embed", "mlp"), rules,
                            (64, 2048, 1408), FakeMesh())
    assert tuple(spec) == ("model", "data", None)


def test_param_shardings_tree():
    """The JAX suite's tree case: the placements tree mirrors the
    params' (the trainable tree) on a 1x1 mesh."""
    cfg = tconfigs.reduced(tconfigs.get_config("mixtral-8x7b"))
    shapes = M.trainable(M.abstract_init(cfg), cfg)
    specs = M.param_specs(cfg)
    with MESH.smoke_mesh("cpu") as mesh:
        shards = S.param_shardings(mesh, shapes, specs,
                                   S.rules_train(False))
        assert len(S.map_specs(lambda a, s: a, specs, shapes)) == \
            len(shards)
        leaves = []
        S.map_specs(lambda a, s, p: leaves.append((s, p)), specs, shapes,
                    shards)
        assert leaves and all(len(p) == mesh.ndim for _s, p in leaves)
    assert not torch.distributed.is_initialized()


def test_to_placements_two_mesh_dims_on_one_tensor_dim():
    """("pod", "data") on one dim shards it on both mesh dims; local
    shapes under a fake 512-rank group are JAX's shard shapes."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    rules = S.rules_train(True, fsdp=True)
    with MESH.fake_world(512):
        mesh = MESH.make_production_mesh(multi_pod=True)
        spec = logical_to_pspec(("embed", "mlp"), rules, (4096, 14336),
                                mesh)
        assert spec == (("pod", "data"), "model")
        pl = to_placements(spec, mesh)
        assert pl == [Shard(0), Shard(0), Shard(1)]
        d = distribute_tensor(torch.empty(4096, 14336, device="meta"),
                              mesh, pl, src_data_rank=None)
        assert tuple(d.to_local().shape) == (4096 // 32, 14336 // 16)
        assert to_placements((None, None), mesh) == [Replicate()] * 3
    assert not torch.distributed.is_initialized()


def test_meshes_refuse_the_wrong_world():
    with pytest.raises(ValueError, match="need a process group of 256"):
        MESH.make_production_mesh()
    with MESH.fake_world(256):
        with pytest.raises(ValueError, match="512"):
            MESH.make_production_mesh(multi_pod=True)
        m = MESH.make_production_mesh()
        assert m.mesh_dim_names == ("data", "model") and m.shape == (16, 16)
        with pytest.raises(ValueError, match="need 256 devices"):
            MESH.make_mesh_for(list(range(100)))
        m2 = MESH.make_mesh_for(list(range(256)))
        assert m2.shape == (16, 16)
        with pytest.raises(RuntimeError, match="already initialised"):
            with MESH.fake_world(8):
                pass
    assert not torch.distributed.is_initialized()


def test_batch_and_optimizer_specs():
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import steps
    rules = S.rules_train(True, fsdp=True)
    mesh = FakeMesh(True)
    cfg = tconfigs.get_config("pixtral-12b")
    b = steps.input_specs(cfg, SHAPES["train_4k"])
    assert {k: tuple(v.shape) for k, v in b.items()} == {
        "prefix_embeds": (256, cfg.frontend_prefix, cfg.d_model),
        "tokens": (256, 4096 - cfg.frontend_prefix),
        "labels": (256, 4096 - cfg.frontend_prefix)}
    assert b["prefix_embeds"].dtype == torch.bfloat16
    assert S.batch_pspecs(mesh, b, rules)["tokens"] == (("pod", "data"),
                                                        None)
    d = steps.input_specs(cfg, SHAPES["decode_32k"])
    assert S.batch_pspecs(mesh, d, rules)["length"] == ()
    params = steps.to_dtype_structs(
        M.trainable(M.abstract_init(cfg), cfg))
    st = opt_mod.abstract_state(opt_mod.AdamWConfig(
        moment_dtype=torch.bfloat16), params)
    assert st["m"]["embed"]["w"].dtype == torch.bfloat16
    assert st["step"].dtype == torch.int32
    assert opt_mod.state_specs(M.param_specs(cfg))["step"] == ()
    audio = tconfigs.get_config("musicgen-large")
    assert set(steps.input_specs(audio, SHAPES["prefill_32k"])) == {
        "embeds"}
