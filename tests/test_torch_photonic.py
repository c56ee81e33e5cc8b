"""Port photonic model on the CPU: the OXG and PCA device models on
tensors against the JAX package's, and the numpy layers above them —
XPC mapping, Table II scalability, the accelerator configs, the
transaction-level simulator, the serving cost model and the engine's
``stats()["photonic"]`` section — against the JAX package's numbers.

All comparisons are exact: the device models run the same float32
operations, the numpy layers the same arithmetic.  The one tolerance is
the engine's float stats (ENGINE_RTOL), which pass through the same
formulas but over counters the two engines accumulate separately."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.core import mapping as jmapping, oxg as joxg, pca as jpca
from repro.core import scalability as jscal
from repro.models import transformer as JM
from repro.photonic import accelerators as jacc, simulator as jsim
from repro.photonic import workloads as jwl
from repro.serving import Engine as JEngine, EngineConfig as JEngineConfig
from repro.serving import cost_model as jcm
from repro_torch import configs as tconfigs
from repro_torch.configs.base import reduced as treduced
from repro_torch.core import mapping, oxg, pca, scalability
from repro_torch.interop import params_from_numpy
from repro_torch.photonic import accelerators as acc, simulator as sim
from repro_torch.photonic import workloads as wl
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving import cost_model as cm

torch.set_num_threads(1)

ENGINE_RTOL = 1e-9


def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------- OXG


def test_oxg_truth_table_transient_and_lorentzian_match_jax():
    for i in (0, 1):
        for w in (0, 1):
            assert int(oxg.oxg_xnor(i, w)) == (1 if i == w else 0)
            _same(oxg.oxg_xnor(i, w), joxg.oxg_xnor(i, w))
            _same(oxg.oxg_transmission(i, w), joxg.oxg_transmission(i, w))
    rng = np.random.default_rng(1)
    i_s = rng.integers(0, 2, 64)
    w_s = rng.integers(0, 2, 64)
    trace = oxg.transient(torch.from_numpy(i_s), torch.from_numpy(w_s))
    _same(trace, joxg.transient(jnp.asarray(i_s), jnp.asarray(w_s)))
    assert ((_np(trace) > oxg.OXGParams().threshold) == (i_s == w_s)).all()
    detune = np.linspace(-1.0, 1.0, 41).astype(np.float32)
    p = oxg.OXGParams(fwhm_nm=0.5, extinction=0.05)
    jp = joxg.OXGParams(fwhm_nm=0.5, extinction=0.05)
    _same(oxg.through_transmission(torch.from_numpy(detune), p),
          joxg.through_transmission(jnp.asarray(detune), jp))


# ------------------------------------------------------------------- PCA


def test_pca_tables_and_capacity_match_jax():
    assert pca.TABLE_II == jpca.TABLE_II
    assert pca._K_FIT == jpca._K_FIT
    for dr in (3, 5, 10, 15, 20, 30, 40, 50, 64):
        for use_table in (True, False):
            got = pca.pca_for_datarate(dr, use_table)
            want = jpca.pca_for_datarate(dr, use_table)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.dv == want.dv
            for n in (1, 19, 53):
                assert pca.alpha_capacity(got, n) == \
                    jpca.alpha_capacity(want, n)
    for dr, (p_pd, _n, _g, _a) in pca.TABLE_II.items():
        assert pca.gamma_from_model(dr, p_pd) == \
            jpca.gamma_from_model(dr, p_pd)


@pytest.mark.parametrize("gamma", [100, 8503])
def test_pca_charge_model_matches_jax(gamma):
    p, jp = pca.PCAParams(gamma=gamma), jpca.PCAParams(gamma=gamma)
    rng = np.random.default_rng(gamma)
    v = (rng.random(200) * 5.2).astype(np.float32)
    v[:3] = (0.0, p.v_range, p.v_range - 0.5 * p.dv)   # edges
    ones = rng.integers(0, 2 * gamma, 200).astype(np.int32)
    zmax = rng.integers(1, 4608, 200).astype(np.int32)
    vt, ot, zt = map(torch.from_numpy, (v, ones, zmax))
    vj, oj, zj = map(jnp.asarray, (v, ones, zmax))
    _same(pca.accumulate(vt, ot, p), jpca.accumulate(vj, oj, jp))
    _same(pca.saturated(vt, p), jpca.saturated(vj, jp))
    _same(pca.readout_bitcount(vt, p), jpca.readout_bitcount(vj, jp))
    _same(pca.comparator(vt, zt, p), jpca.comparator(vj, zj, jp))
    # scalars, as the mapping executor passes them
    _same(pca.accumulate(np.float32(1.25), np.int32(7), p),
          jpca.accumulate(np.float32(1.25), np.int32(7), jp))
    _same(pca.comparator(pca.accumulate(0.0, np.int32(16), p), 30, p),
          jpca.comparator(jpca.accumulate(jnp.zeros(()), jnp.int32(16), jp),
                          30, jp))


def test_pingpong_pca_matches_jax():
    runs = []
    for mod in (pca, jpca):
        pp = mod.PingPongPCA(mod.PCAParams(gamma=100), discharge_passes=1)
        trace = []
        for phase in ((10, 5), (7,), (60, 60), (3, 3, 3)):
            trace += [pp.step(c) for c in phase]
            trace.append(pp.read_and_swap())
        runs.append((trace, pp.v.tolist(), pp.cooldown.tolist(), pp.active))
        stuck = mod.PingPongPCA(mod.PCAParams(gamma=100), discharge_passes=3)
        stuck.step(4)
        stuck.read_and_swap()
        stuck.step(1)
        with pytest.raises(RuntimeError, match="ping-pong"):
            stuck.read_and_swap()
    assert runs[0] == runs[1]


# ------------------------------------------------------------ mapping


@pytest.mark.parametrize("h,s,m,n,seed", [
    (1, 1, 1, 1, 0), (3, 17, 2, 5, 1), (8, 64, 8, 16, 2), (5, 33, 3, 7, 3),
    (6, 40, 8, 3, 4)])
def test_mapping_equivalence_matches_jax(h, s, m, n, seed):
    rng = np.random.default_rng(seed)
    i_bits = rng.integers(0, 2, (h, s)).astype(np.uint8)
    w_bits = rng.integers(0, 2, (h, s)).astype(np.uint8)
    ref = mapping.reference_bitcounts(i_bits, w_bits)
    np.testing.assert_array_equal(
        ref, jmapping.reference_bitcounts(i_bits, w_bits))
    for got, want in ((mapping.plan_oxbnn(h, s, m, n, alpha=10 ** 6),
                       jmapping.plan_oxbnn(h, s, m, n, alpha=10 ** 6)),
                      (mapping.plan_prior_work(h, s, m, n),
                       jmapping.plan_prior_work(h, s, m, n))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        out = mapping.execute_plan(got, i_bits, w_bits)
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(
            out, jmapping.execute_plan(want, i_bits, w_bits))
    with pytest.raises(ValueError):
        mapping.plan_oxbnn(h=1, s=100, m=1, n=10, alpha=2)


# -------------------------------------------------------- scalability


def test_table2_matches_jax():
    for use_table in (True, False):
        assert scalability.table2(use_table_gamma=use_table) == \
            jscal.table2(use_table_gamma=use_table)
    assert scalability.paper_table2() == jscal.paper_table2()
    for dr in (1, 3, 15, 50, 64):
        assert scalability.pd_sensitivity_dbm(dr) == \
            jscal.pd_sensitivity_dbm(dr)
        assert scalability.max_n(dr) == jscal.max_n(dr)
        assert scalability.n_for_datarate(dr) == jscal.n_for_datarate(dr)
    for n, m in ((1, 1), (19, 19), (53, 53), (16, 4)):
        assert scalability.link_budget_db(n, m, -18.5) == \
            jscal.link_budget_db(n, m, -18.5)
    assert scalability.fsr_limit() == jscal.fsr_limit()


# ---------------------------------------------------------- simulator


def test_workloads_and_accelerators_match_jax():
    assert list(wl.WORKLOADS) == list(jwl.WORKLOADS)
    for name in wl.WORKLOADS:
        got, want = wl.WORKLOADS[name](), jwl.WORKLOADS[name]()
        assert [dataclasses.asdict(x) for x in got] == \
            [dataclasses.asdict(x) for x in want]
        assert [(x.h_out, x.w_out, x.s, x.v, x.macs) for x in got] == \
            [(x.h_out, x.w_out, x.s, x.v, x.macs) for x in want]
    assert wl.max_vector_size() == jwl.max_vector_size()
    for a, ja in zip(acc.ALL, jacc.ALL, strict=True):
        assert dataclasses.asdict(a) == dataclasses.asdict(ja)
        assert (a.tau_s, a.num_xpcs, a.num_tiles, a.alpha,
                a.laser_power_w()) == \
            (ja.tau_s, ja.num_xpcs, ja.num_tiles, ja.alpha,
             ja.laser_power_w())


@pytest.fixture(scope="session")
def fig7_tables():
    return sim.compare(acc.ALL), jsim.compare(jacc.ALL)


@pytest.mark.parametrize("network", list(jwl.WORKLOADS))
def test_simulator_compare_matches_jax(fig7_tables, network):
    """Every accelerator on one network: every field of every
    LayerResult (stages included) and the network totals, exactly."""
    got, want = fig7_tables
    assert list(got) == list(want) == [a.name for a in jacc.ALL]
    for name in want:
        g, w = got[name][network], want[name][network]
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
        assert (g.fps, g.power_w, g.fps_per_w) == \
            (w.fps, w.power_w, w.fps_per_w)
    assert sim.gmean([1.0, 4.0, 16.0]) == jsim.gmean([1.0, 4.0, 16.0])
    knobs = dict(psum_write_width=4, reduce_units_per_xpe=0.5)
    for a, ja in ((acc.LIGHTBULB, jacc.LIGHTBULB), (acc.OXBNN_5,
                                                    jacc.OXBNN_5)):
        assert dataclasses.asdict(sim.simulate(a, network,
                                               sim.SimKnobs(**knobs))) == \
            dataclasses.asdict(jsim.simulate(ja, network,
                                             jsim.SimKnobs(**knobs)))


# --------------------------------------------------------- cost model


def _cfgs(full: bool):
    j = jconfigs.get_config("bnn-lm-100m")
    t = tconfigs.get_config("bnn-lm-100m")
    return (j, t) if full else (jreduced(j), treduced(t))


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("fused", [True, False])
def test_cost_model_reports_match_jax(full, fused):
    jcfg, tcfg = _cfgs(full)
    got = cm.PhotonicCostModel(tcfg, "OXBNN_50", fused_bnn=fused,
                               link_gbps=25.0)
    want = jcm.PhotonicCostModel(jcfg, "OXBNN_50", fused_bnn=fused,
                                 link_gbps=25.0)
    assert [dataclasses.asdict(x) for x in cm.gemm_specs(tcfg)] == \
        [dataclasses.asdict(x) for x in jcm.gemm_specs(jcfg)]
    assert got.report() == want.report()
    for kw in (dict(prefill_tokens=0, decode_tokens=0),
               dict(prefill_tokens=137, decode_tokens=64),
               dict(prefill_tokens=512, decode_tokens=9, skipped_tokens=48,
                    prefill_passes=40, prefill_chunk=16)):
        assert got.serving_report(**kw) == want.serving_report(**kw)
    for kw in (dict(verify_passes=0, verify_tokens=0, committed_tokens=0),
               dict(verify_passes=5, verify_tokens=20, committed_tokens=13)):
        assert got.speculative_report(**kw) == want.speculative_report(**kw)
    for kw in (dict(score_tokens=0, score_passes=0),
               dict(score_tokens=99, score_passes=7)):
        assert got.scoring_report(**kw) == want.scoring_report(**kw)
    assert got.handoff_report(handoffs=3, handoff_bytes=1 << 20) == \
        want.handoff_report(handoffs=3, handoff_bytes=1 << 20)
    assert got.transfer_steps_overlap(1 << 24) == \
        want.transfer_steps_overlap(1 << 24)
    assert (got.step_latency_s(8), got.verify_latency_s(5),
            got.prefill_latency_s(64, 4)) == \
        (want.step_latency_s(8), want.verify_latency_s(5),
         want.prefill_latency_s(64, 4))
    assert dataclasses.asdict(got.token_cost) == \
        dataclasses.asdict(want.token_cost)


# --------------------------------------------------------------- engine


@pytest.fixture(scope="session")
def served_pair():
    """The JAX and the port's engine after the same greedy traffic on the
    reduced bnn-lm-100m (the JAX engine on its XLA paths, the port on
    the plain kernel versions): (JAX stats, port stats, port engine)."""
    jcfg = jreduced(jconfigs.get_config("bnn-lm-100m")).replace(
        precision="bnn")
    tcfg = treduced(tconfigs.get_config("bnn-lm-100m")).replace(
        precision="bnn")
    jp, _ = JM.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg)
    ecfg = dict(block_size=4, num_blocks=33, max_batch=4, prefill_chunk=4,
                max_model_len=32, accelerator="OXBNN_5", link_gbps=40.0)
    je = JEngine(jp, jcfg, JEngineConfig(
        **ecfg, prefix_cache=False, preempt_policy="recompute",
        attn_impl="xla", bnn_impl="xla"))
    te = Engine(tp, tcfg, EngineConfig(**ecfg), device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 128, n) for n in (5, 9, 3)]
    for eng in (je, te):
        for p, n in zip(prompts, (6, 4, 7)):
            eng.submit(p, n)
        eng.step()
        eng.submit(prompts[0][::-1].copy(), 5)        # joins mid-stream
        eng.run()
    return je.stats(), te.stats(), te


def test_engine_photonic_stats_match_jax(served_pair):
    jst, tst, _te = served_pair
    assert (tst["prefill_tokens"], tst["decoded_tokens"]) == \
        (jst["prefill_tokens"], jst["decoded_tokens"])
    got, want = tst["photonic"], jst["photonic"]
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert type(g) is type(w), key
        if isinstance(w, float):
            assert math.isclose(g, w, rel_tol=ENGINE_RTOL), (key, g, w)
        else:
            assert g == w, (key, g, w)
    # the CPU engine runs the plain versions: the unfused pack pass is
    # priced, and the configured accelerator is the one reported
    assert got["fused_bnn"] is False and got["pack_pass_s_per_token"] > 0
    assert got["accelerator"] == "OXBNN_5"


def test_engine_cost_model_follows_config(served_pair):
    _jst, _tst, te = served_pair
    assert te.cost_model.link_gbps == 40.0
    assert te.cost_model.acc.name == "OXBNN_5"
    assert EngineConfig().accelerator == JEngineConfig().accelerator
    assert EngineConfig().link_gbps == JEngineConfig().link_gbps
