"""chip_smoke.py's ``[train]`` phase at reduced width on the CPU (the
rehearsal of the card's run): gates (a)-(f) hold, with the CPU standing
in for the card in (a); the training path is deterministic (the resumed
run's and the uninterrupted run's losses are bit-equal) and (f) serves
the trained weights through the engine and re-checks them."""
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as S                                      # noqa: E402
from repro_torch.configs import get_config                  # noqa: E402

torch.set_num_threads(1)


def test_train_phase_sizes():
    cfg = get_config("bnn-lm-100m")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab, cfg.tie_embeddings) == (12, 768, 12, 64, 2048, 32000,
                                                True)
    assert cfg.precision == "bnn_train"
    assert S.TRAIN == dict(seq_len=256, global_batch=8, lr=1e-3, steps=60)
    assert S.TRAIN_RESUME == (10, 16, 5)
    n, lo, hi = S.TRAIN_SERVE_PROMPTS
    assert (n, lo, hi, S.TRAIN_SERVE_NEW) == (8, 64, 256, 32)


def test_train_phase_gates_hold_at_reduced_width(capsys):
    launches = S.phase_train(torch.device("cpu"), "cpu", smoke=True)
    assert set(launches) >= set(S.SERVING_KERNELS)
    out = capsys.readouterr()
    text = out.out + out.err
    assert "the last 6: True" in text            # deterministic resume
    assert "(f) served the trained weights" in text


def test_markov_share():
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(50, 8, 2, seed=3))
    seq = data.batch(0)["tokens"][0]
    assert S.markov_share(data, {0: seq}, {0: 1}) == 1.0
    bad = seq.copy()
    bad[4:] = [v for v in range(50) if v not in data.successors[bad[3]]][0]
    share = S.markov_share(data, {0: bad, 1: seq}, {0: 1, 1: 5})
    want = [bad[i] in data.successors[bad[i - 1]] for i in range(1, 8)] + \
        [True] * 3
    assert 0 < share < 1
    np.testing.assert_allclose(share, np.mean(want))


def test_train_sign_flips_walks_every_projection():
    """(a)'s explanation of a miss: every BNN projection's input is
    recorded in call order (7 a layer), and a run against itself flips
    no sign."""
    from repro_torch.data.pipeline import to_tensors
    from repro_torch.launch.train import train_init
    cfg, sizes, data = S._train_setup(torch.device("cpu"), smoke=True)
    params = train_init(cfg, "cpu")
    batch = to_tensors({k: v[:2] for k, v in data.batch(0).items()}, "cpu")
    seen = S.record_projection_inputs(params, cfg, batch, 64)
    assert len(seen) == 7 * cfg.n_layers
    assert seen[0].shape == (2, 64, cfg.d_model)
    assert S.train_sign_flips(params, params, cfg, batch, batch, 64) == 0
