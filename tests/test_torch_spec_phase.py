"""chip_smoke.py's speculative and slot-snapshot phases at reduced width
on the CPU.

Admission, prefix and snapshot matching, preemption and prompt lookup
depend only on the prompts' lengths and content, so the phases' traffic
at the reduced configs' vocabularies (same lengths, same sharing) makes
on the CPU what their gates need on the card: the [spec] phase (verify
steps, accepted and partly accepted drafts, tokens equal spec_k 0's,
greedy and sampled), the mamba2 defaults pair (two forced preemptions,
a re-adopted snapshot, a host trip restored bit-equal, tokens equal the
control's), the jamba defaults pair (both members skip the same tokens,
both admission shortages), and a family's speculative run against its
phase run (mixtral's ring wraps, mamba2 repairs); the [spec] phase
itself: tests/test_torch_spec_phase_serve.py.  The re-check of a
parting request runs both routes; on the CPU they cannot part, so a
made-up parting is refused.  The sampled-bits check compares the CPU
with itself here."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as S                                      # noqa: E402
from repro_torch.configs import get_config                  # noqa: E402
from repro_torch.configs.base import reduced                # noqa: E402
from repro_torch.models import transformer as M             # noqa: E402
from repro_torch.serving import EngineConfig                # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _model(arch, window=False, **change):
    cfg = reduced(get_config(arch)).replace(precision="bnn", **change)
    if window:
        cfg = S.jamba_window(cfg)
    return cfg, M.init(torch.Generator().manual_seed(0), cfg)


def test_traffic_lengths_do_not_depend_on_the_vocab():
    for f in (lambda v: S.prefix_traffic(v, seed=5),
              S.jamba_prefix_traffic, S.spec_traffic,
              lambda v: S.with_periodic(S.family_traffic(v, seed=1), v, 32)):
        full, small = f(50280), f(128)
        assert [len(p) for p in full] == [len(p) for p in small]
    t = S.prefix_traffic(50280, seed=5)
    assert len(t) == 12 and len({p[:256].tobytes() for p in t}) == 3
    np.testing.assert_array_equal(t[9], t[1])
    np.testing.assert_array_equal(t[11], t[6])
    for p in S.periodic_prompts(32000, 8, seed=21):
        assert 128 <= len(p) <= 512
        from repro_torch.serving.sampling import prompt_lookup_draft
        assert len(prompt_lookup_draft(p, S.SPEC_K, S.SPEC_NGRAM)) > 0


def test_mamba2_defaults_pair_at_reduced_width():
    cfg, params = _model("mamba2-1.3b")
    S.phase_defaults(CPU, "cpu", cfg, params, S.MAMBA2_ENGINE,
                     S.prefix_traffic(cfg.vocab, seed=5), "reduced", False)


def test_jamba_defaults_pair_at_reduced_width():
    cfg, params = _model("jamba-1.5-large-398b", window=True)
    S.phase_defaults(CPU, "cpu", cfg, params, S.JAMBA_ENGINE,
                     S.jamba_prefix_traffic(cfg.vocab), "reduced", True)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-1.3b"])
def test_spec_family_against_its_phase_run(arch):
    """A family's phase run (no prefix cache, recompute) is the control
    of its speculative run on the same traffic; mixtral's ring (window
    32 at reduced width) wraps, mamba2 repairs its slots."""
    cfg, params = _model(arch)
    kw = dict(S.MAMBA2_ENGINE if arch == "mamba2-1.3b" else
              S.MIXTRAL_ENGINE, max_model_len=640)
    prompts = S.with_periodic(S.family_traffic(cfg.vocab, seed=2, n=6,
                                               lens=(16, 300)),
                              cfg.vocab, seed=33)
    _eng, _p, out, _l, _st = S.phase_serving(
        CPU, cfg, EngineConfig(**kw), max_new=32, late_after=4,
        prompts=prompts, n_late=4, required=())
    S.spec_family(CPU, cfg, params, kw, prompts, out, f"[{arch}]", ())


def test_a_parting_without_an_accepted_difference_is_refused():
    cfg, params = _model("bnn-lm-100m")
    prompt = S.periodic_prompts(cfg.vocab, 1, seed=3, lens=(40, 40))[0]
    from repro_torch.launch import serve as SV
    kw = dict(S.SERVE_CALM, max_model_len=128)
    _e, (want,) = SV.run(params, cfg, [prompt], 8, EngineConfig(**kw),
                         device=CPU)
    got = want.copy()
    got[len(prompt) + 3] = (got[len(prompt) + 3] + 1) % cfg.vocab
    with pytest.raises(AssertionError, match="no accepted difference"):
        S.spec_recheck(CPU, cfg, params, prompt, 8, kw, None, got, want,
                       "[test]")


def test_sampled_bits_check_runs():
    S.check_sampled_bits(CPU)
