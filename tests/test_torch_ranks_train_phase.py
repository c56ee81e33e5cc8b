"""chip_smoke.py's ``[ranks]`` (i)-(j) at reduced width on CPU ranks
(the rehearsal of the card's run): the gates hold (step 0 against one
rank, the last step again on one rank from the mesh's checkpoint, the
trained weights served over the mesh = one rank's engine), every BNN
projection input at step 0 is bit-equal to one rank's, and a step's
collectives are exactly ``train_step_collectives``' prediction, which
also gives the card's full-width step at its sizes."""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as S                                      # noqa: E402
from repro_torch.configs import get_config                  # noqa: E402
from repro_torch.configs.base import reduced                # noqa: E402

torch.set_num_threads(1)


def test_ranks_train_phase_sizes_and_prediction():
    assert S.RANKS_TRAIN == dict(seq_len=256, global_batch=8,
                                 microbatches=2, steps=3, lr=1e-3)
    assert S.RANKS_TRAIN_SHAPE == (2, 2) and S.RANKS_TRAIN_LAYERS == 6
    assert S.RANKS_TRAIN_PARAM == dict(rtol=5e-3, atol=1e-4)
    cfg = get_config("bnn-lm-100m")
    # the published depth: 12 layers of 9 FSDP leaves, gathered twice
    # (the recompute) a microbatch, o and down again over "model" for
    # alpha; the loss's head gathered over "data" alone, its chunk's max
    # and pair of sums all-reduced over "model" (forward, recompute,
    # the pair's gradient); the card's (i) at 6
    want = S.train_step_collectives(cfg, S.RANKS_TRAIN, (2, 2))
    assert (want["all_gather"], want["reduce_scatter"],
            want["all_reduce"]) == (534, 222, 361)
    want = S.train_step_collectives(
        cfg.replace(n_layers=S.RANKS_TRAIN_LAYERS), S.RANKS_TRAIN, (2, 2))
    assert (want["all_gather"], want["reduce_scatter"],
            want["all_reduce"]) == (270, 114, 193)


def test_ranks_train_phase_holds_at_reduced_width(capsys):
    launches = S.phase_ranks_train(torch.device("cpu"), "cpu", smoke=True)
    assert set(launches) >= set(S.SERVING_KERNELS)
    text = "".join(capsys.readouterr())
    assert "14 of 14 bit-equal" in text
    assert "STE sign flips 0" in text
    assert "0 parameter elements beyond" in text
    assert "equal True" in text                  # the collectives' prediction
    assert "one rank's engine on the gathered weights: True" in text
    cfg = reduced(get_config("bnn-lm-100m"))
    got = S.train_step_collectives(cfg, S.RANKS_TRAIN_SMOKE, (2, 2))
    assert got["all_gather"] == 94 and got["all_reduce"] == 81
