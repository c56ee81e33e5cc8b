"""The jamba window that ``chip_smoke.py`` serves at published width
(published layers 2-4), here at reduced width (split from
tests/test_torch_family_hybrid.py, whose helpers it shares): both
engines' tokens and admission records equal, and the smoke's jamba
traffic making both shortages and re-checking on the CPU."""
import jax
import numpy as np
import torch

import _torch_family as F
from repro.models import transformer as JM
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.serving import EngineConfig
from test_torch_family_hybrid import (ARCH, ENGINE, MAX_NEW, S, _prompts,
                                      _watched_pair, _window_cfgs)

torch.set_num_threads(1)


def test_window_served_by_both_engines_with_identical_tokens():
    jcfg, tcfg = _window_cfgs()
    jp, _ = JM.init(jax.random.PRNGKey(1), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg)
    # the period of 3 unstacks as the period of 8 does
    F.check_round_trip(ARCH, jp, tp, (jcfg, tcfg))
    (je, jrun), (te, trun), (jrec, trec) = _watched_pair(
        (jcfg, tcfg), jp, tp, ENGINE, _prompts(), list(MAX_NEW))
    F.check_engine_tokens(((je, jrun), (te, trun)))
    assert trec["attempts"] == jrec["attempts"]
    assert te.stats()["mixer"] == je.stats()["mixer"]


def test_smoke_traffic_makes_both_shortages_and_rechecks_on_the_cpu():
    """The smoke's jamba phase at reduced width on the CPU: its engine
    settings and its traffic's prompt lengths (admission does not depend
    on the weights) make every slot busy at once, an admission wait for
    a slot with blocks free and one find a slot but too few blocks; the
    picked requests re-check through both routes, the replay in the
    engine's own slot and table."""
    _jcfg, tcfg = _window_cfgs()
    prompts = S.jamba_traffic(tcfg.vocab)
    full = [len(p) for p in S.jamba_traffic(get_config(ARCH).vocab)]
    assert [len(p) for p in prompts] == full
    cpu = torch.device("cpu")
    rec = {}
    eng, params, out, launches, st = S.phase_serving(
        cpu, tcfg, EngineConfig(**S.JAMBA_ENGINE), max_new=32, late_after=4,
        prompts=prompts, n_late=4, required=(),
        watch=lambda e: rec.update(S.watch_admissions(e)))
    slots = st["mixer"]["slots"]
    assert slots["peak_used_slots"] == slots["num_slots"] == 5
    slot_waits, released = S.shortages(eng, rec)
    assert slot_waits and released
    rids = S.jamba_rids(eng, out, rec)
    assert len(out[rids[0]]) == max(len(s) for s in out.values())
    # the replay's table is the one the engine gave the request: every
    # position but the last token's
    for rid in rids:
        assert len(rec["held"][rid]) == -(-(len(out[rid]) - 1) // 16)
    S.phase_e2e(cpu, tcfg, params, eng, out, rids=rids, held=rec["held"])
