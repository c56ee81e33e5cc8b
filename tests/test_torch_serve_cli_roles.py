"""The port's serve CLI with ``--shards 3 --roles 1:2 --trace PREFIX
--replay-photonic`` against the JAX CLI (the comparison of
tests/test_torch_serve_cli_shards.py: tokens and every line but timing
fields equal, the handoff line and one replay report a shard); the
per-shard trace files validate in both packages; ``main`` takes
``--shards``/``--roles`` with ``--device cpu`` and refuses a topology
with no decode shard as JAX's ``parse_roles`` does."""
import pytest

import test_torch_serve_cli_shards as C
from repro.serving import tracing as JT
from repro_torch.launch import serve as S
from repro_torch.serving import tracing as T

CASES = {"1:2": dict(shards=3, roles="1:2", replay_photonic=True)}


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    return C.cli_outputs(CASES, tmp_path_factory.mktemp("cli_roles"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_cli_output_equals_jax_cli(outputs, case):
    C.check_case(outputs, case, CASES[case])


def test_sharded_cli_traces_validate_in_both_packages(outputs):
    prefix = outputs["1:2", "torch"][2]
    for i in range(3):
        path = f"{prefix}.shard{i}.jsonl"
        records = T.read_trace(path)
        T.validate_trace(records)
        JT.validate_trace(JT.read_trace(path))
        assert records[0]["shard"] == i and records[0]["n_shards"] == 3


def test_main_takes_shards_and_roles(capsys):
    toks = S.main(["--smoke", "--precision", "bnn", "--device", "cpu",
                   "--batch", "2", "--gen", "4", "--shards", "3", "--roles",
                   "1:2"])
    assert toks.shape == (2, 20)
    text = capsys.readouterr().out
    assert "[serve] shard 0 (prefill)" in text
    assert "[serve] handoffs=2 " in text
    with pytest.raises(ValueError, match=">= 1 decode"):
        S.main(["--smoke", "--device", "cpu", "--shards", "2", "--roles",
                "2:0"])
    with pytest.raises(ValueError, match="no decode-capable"):
        S.main(["--smoke", "--device", "cpu", "--shards", "2", "--roles",
                "prefill,prefill"])
