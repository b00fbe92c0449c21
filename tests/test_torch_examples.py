"""The port's examples run on the CPU: a small drive to its ATE report, and
blocking against streaming serving, bit-equal."""

import importlib.util
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_synthetic_drive_reports_ate_on_the_cpu(capsys):
    rc = _example("torch_synthetic_drive").main(
        ["--device", "cpu", "--small", "--frames", "4"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "device=cpu frames=4" in out and "ATE  icp=" in out
    assert out.rstrip().endswith("OK")


def test_streaming_server_is_bit_equal_to_blocking_on_the_cpu(capsys):
    rc = _example("torch_streaming_server").main(
        ["--device", "cpu", "--small", "--frames", "5"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "trajectories bit-equal" in out and "streaming" in out
    assert out.rstrip().endswith("OK")


@pytest.mark.parametrize("name", ["torch_synthetic_drive",
                                  "torch_streaming_server"])
def test_examples_default_to_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _example(name).main(["--small", "--frames", "2"])
