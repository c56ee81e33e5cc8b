"""The SSM family over several ranks against the JAX package: the
reduced mamba2 (the Mamba-2 SSD mixer over recurrent slots, no FFN) at
"bnn" on JAX's weights, placed by the decode rules over meshes of
``gloo`` ranks (a world of 2 and one of 4).

Every leaf's placement equals JAX's ``PartitionSpec`` over (1, 2),
(2, 2) and (1, 4): ``in_proj`` and the conv by columns over ``model``
(z | x B C | dt and x | B | C cut across), the norm's scale and
``out_proj``'s rows over ``model``, A_log, D and dt_bias replicated;
the slot pools hold ``h`` by heads and the conv tail whole.
``logits_fn`` and the prefill step are within TOL of JAX's under the
same ``Mesh`` (a subprocess with 4 forced host devices), with its
greedy tokens, and bit-equal to the port's one rank; the legacy decode
gives JAX's one device's tokens.  The engine over each mesh gives one
JAX ``Engine``'s tokens, greedy and sampled.  Under the JAX engine's
defaults the slot snapshots hit and a preempted request's slot goes to
the host and comes back bit-equal on every rank, the data ranks' pools
staying equal after every step, with JAX's and one rank's tokens.
Speculative decoding over (1, 2) gives one rank's tokens on mamba2's
periodic trace (verify steps, a partial acceptance and repairs) and on
bnn-lm-100m; so do the serve CLI's paged and legacy runs."""
import numpy as np
import pytest
import torch

import _torch_ranks as H

torch.set_num_threads(1)

ARCH = "mamba2-1.3b"
TOL = dict(rtol=1e-4, atol=1e-4)     # float32 logits, port vs XLA
B, T, NEW = 4, 12, 6
SHAPES = [(1, 2), (2, 2), (1, 4)]
IDS = ["1x2", "2x2", "1x4"]
LENS = [5, 9, 3, 7, 12, 4, 8, 6]
MAX_NEW = 8
EKW = dict(num_slots=4)              # 3 slots under 4 decode rows
# H.shared_prompts' runs: 2 decode rows, the victim preempted after
# 5 steps
SLOT_EKW = dict(max_batch=2)
PREEMPT_AFTER = 5
# test_torch_spec.py's engine, mamba2's trace as test_torch_spec_families
SPEC_EKW = dict(block_size=4, num_blocks=33, max_batch=4, prefill_chunk=4,
                max_model_len=40)


@pytest.fixture(scope="module")
def models():
    return H.jax_models(ARCH)


@pytest.fixture(scope="module")
def tokens(models):
    return np.random.default_rng(3).integers(0, models[0].vocab, (B, T)) \
        .astype(np.int32)


@pytest.fixture(scope="module")
def prompts(models):
    return H.prompts(models[0].vocab, LENS, seed=12)


def ssm_trace() -> list[np.ndarray]:
    """tests/test_torch_spec_families.py's periodic prompts."""
    rng = np.random.default_rng(6)
    return [np.tile(rng.integers(0, 128, 3), 5)[:12] for _ in range(2)]


def bnn_trace() -> list[np.ndarray]:
    rng = np.random.default_rng(8)
    return [np.tile(rng.integers(0, 128, 3), 4) for _ in range(3)]


@pytest.fixture(scope="module")
def bnn_params():
    from repro_torch.models import transformer as M
    return M.init(torch.Generator().manual_seed(0), H.port_cfg())


@pytest.fixture(scope="module")
def spec_cases(models, bnn_params):
    return {"mamba2": (ARCH, models[2], ssm_trace(), 16, SPEC_EKW),
            "bnn": (H.ARCH, bnn_params, bnn_trace(), 12,
                    dict(SPEC_EKW, max_model_len=32))}


@pytest.fixture(scope="module")
def jax_mesh_started(tokens, tmp_path_factory):
    return H.JaxMeshRun(ARCH, tokens, tmp_path_factory.mktemp("jax_mesh"),
                        SHAPES)


@pytest.fixture(scope="module")
def jax_mesh(jax_mesh_started, ranks):
    """JAX's mesh runs (started before the ranks, run beside them)."""
    return jax_mesh_started.result()


@pytest.fixture(scope="module")
def jax_one(models, tokens):
    jcfg, jp, _ = models
    return H.jax_one_device(ARCH, jcfg, jp, tokens, NEW)


@pytest.fixture(scope="module")
def one_rank(models, tokens):
    from repro_torch.models import transformer as M
    lg = M.logits_fn(models[2], H.port_cfg(arch=ARCH),
                     torch.from_numpy(tokens.astype(np.int64)))
    return {1: lg, 2: lg}


@pytest.fixture(scope="module")
def ranks(jax_mesh_started, models, tokens, prompts, spec_cases):
    """Per world size, each rank's results: the family runs, the slot
    runs (and over (1, 2) the speculative runs and the serve CLI's)."""
    params, slots = models[2], H.shared_prompts(models[0].vocab)
    out = {}
    for size, shapes in ((2, [(1, 2)]), (4, [(2, 2), (1, 4)])):
        jobs = [(H.family_worker, (ARCH, shapes, params, tokens, NEW,
                                   prompts, MAX_NEW, EKW)),
                (H.slots_worker, (ARCH, shapes, params, slots, MAX_NEW,
                                  PREEMPT_AFTER, SLOT_EKW))]
        if size == 2:
            jobs += [(H.spec_worker, ((1, 2), spec_cases)),
                     (H.forward_worker, ([(1, 2)], params, tokens, NEW, ARCH,
                                         True))]
        out[size] = H.spawn(H.jobs_worker, size, jobs)
    return out


def _ranks(ranks, shape, job):
    return [r[job] for r in ranks[shape[0] * shape[1]]]


@pytest.fixture(scope="module")
def engines(models, prompts):
    """(JAX's tokens, the port's one-rank (tokens, stats)), greedy then
    sampled."""
    jcfg, jp, params = models
    return (H.jax_engine_tokens(jcfg, jp, prompts, MAX_NEW, EKW),
            [H.serve(params, H.port_cfg(arch=ARCH), prompts, MAX_NEW,
                     sampled=s, **EKW) for s in (False, True)])


@pytest.fixture(scope="module")
def slot_refs(models):
    """(JAX's tokens, the port's one rank's (tokens, counts)) of
    ``drive_slots``, greedy then sampled."""
    jcfg, jp, params = models
    slots = H.shared_prompts(jcfg.vocab)
    return (H.drive_slots_jax(jcfg, jp, slots, MAX_NEW, PREEMPT_AFTER,
                              SLOT_EKW),
            H.drive_slots_port(H.port_cfg(arch=ARCH), params, slots, MAX_NEW,
                               PREEMPT_AFTER, SLOT_EKW))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_placements_equal_jax(models, jax_mesh, shape):
    from repro_torch.launch import mesh as MESH
    from repro_torch.models import transformer as M
    got = H.port_placements(ARCH, models[2], shape)
    assert got == jax_mesh[shape]["params"]
    at = "layers/0/attn/"
    assert got[at + "in_proj/w"] == (None, "model")
    assert got[at + "conv_w"] == (None, "model")
    assert got[at + "conv_b"] == ("model",)
    assert got[at + "norm/scale"] == ("model",)
    assert got[at + "out_proj/w"] == ("model", None)
    assert got[at + "A_log"] == got[at + "D"] == got[at + "dt_bias"] == \
        (None,)
    cfg = H.port_cfg(arch=ARCH)
    with MESH.fake_world(shape[0] * shape[1]):
        pools = M.init_paged_state(cfg, 8, 4, 5, mesh=H.mesh(shape))
        assert all({k: H.port_spec(v) for k, v in p.items()} ==
                   {"h": (None, "model", None, None), "conv": (None,) * 3}
                   for p in pools)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_logits_and_steps_match_jax_mesh(ranks, jax_mesh, jax_one, one_rank,
                                         shape):
    H.check_family(_ranks(ranks, shape, 0), shape, jax_mesh=jax_mesh,
                   jax_one=jax_one, one_rank=one_rank, tol=TOL)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_engine_over_ranks_gives_jax_tokens(ranks, engines, shape, sampled):
    jax_tokens, one = engines
    want = jax_tokens[sampled]
    assert one[sampled][0] == want
    for rank in _ranks(ranks, shape, 0):
        run = rank["engine"][shape][sampled]
        assert run["tokens"] == want
        assert run["preemptions"] == one[sampled][1]["preemptions"]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_snapshots_hit_and_swapped_slots_return_bit_equal(ranks, slot_refs,
                                                          shape):
    jax_tokens, one = slot_refs
    H.check_slots(_ranks(ranks, shape, 1), shape, one, jax_tokens)


@pytest.mark.parametrize("case", ["mamba2", "bnn"])
def test_spec_over_ranks_gives_one_rank_tokens(ranks, spec_cases, case):
    from repro_torch.serving import Engine, EngineConfig
    arch, params, ps, gen, ekw = spec_cases[case]
    cfg = H.port_cfg(arch=arch)
    runs = {}
    for k in (0, 3):
        eng = Engine(params, cfg, EngineConfig(**ekw, spec_k=k), device="cpu")
        rids = [eng.submit(p, gen) for p in ps]
        got = eng.run()
        runs[k] = ([got[r].tolist() for r in rids], eng.stats())
    assert runs[3][0] == runs[0][0]
    sp = runs[3][1]["speculative"]
    assert sp["spec_steps"] > 0 and sp["draft_tokens"] > 0
    if case == "mamba2":
        assert 0 < sp["accepted_tokens"] < sp["draft_tokens"]
        assert sp["repairs"] >= 1
    for rank in _ranks(ranks, (1, 2), 2):
        assert rank[case]["tokens"] == runs[3][0]
        assert rank[case]["speculative"] == sp


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_cached_bytes_as_reckoned(ranks, shape):
    """What every rank caches at first use beside its slices (the whole
    LM head, each SSM layer's whole conv weight, conv bias and norm
    scale) is what ``rank_weight_bytes`` reckons."""
    from repro_torch.launch.mesh import rank_weight_bytes
    want = rank_weight_bytes(H.port_cfg(arch=ARCH), shape)["cached"]
    assert want > 0
    assert [r["forward"][shape]["cached_bytes"]
            for r in _ranks(ranks, shape, 0)] == \
        [want] * shape[0] * shape[1]


def test_serve_cli_over_a_mesh_equals_one_device(ranks, jax_one, models,
                                                 tokens):
    """The serve CLI's paged and legacy runs over (1, 2) give one
    device's tokens (JAX's legacy decode's)."""
    from repro_torch.launch import serve as SV
    want = SV.serve(ARCH, smoke=True, precision="bnn", gen=NEW, device="cpu",
                    params=models[2], prompts=tokens, verbose=False)
    np.testing.assert_array_equal(want, jax_one["decode"])
    for rank in _ranks(ranks, (1, 2), 3):
        for engine in ("paged", "legacy"):
            np.testing.assert_array_equal(rank[(1, 2)]["serve"][engine], want)
