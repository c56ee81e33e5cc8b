"""``launch.serve`` on given params cut to fewer layers than the
config's: ``serve`` takes their depth (as ``launch.train`` does), so
the paged serve of the cut model equals the legacy loop run with the
cut config."""
import numpy as np
import torch

from repro_torch.launch import serve as S

torch.set_num_threads(1)

ARCH = "bnn-lm-100m"


def test_serve_takes_the_depth_of_given_params():
    cfg, params = S.setup(ARCH, smoke=True, precision="bnn", seed=0,
                          device="cpu")
    assert cfg.n_layers > 1
    params["layers"] = params["layers"][:1]
    cut = cfg.replace(n_layers=1)
    prompts = S.make_prompts(cut, 2, 12, 0)
    paged = S.serve(ARCH, smoke=True, params=params, prompts=prompts, gen=4,
                    precision="bnn", device="cpu", verbose=False)
    legacy, _tps = S.run_legacy(params, cut, prompts, 4, device="cpu")
    assert np.array_equal(np.asarray(paged), np.asarray(legacy))
