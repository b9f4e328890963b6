"""The port's diagnostics (``phones_las_torch/utils/diagnostics.py``) and
the surface of its command lines: the counterpart of
``tests/test_diagnostics.py``, on the CPU."""

import glob
import importlib
import json

import numpy as np
import pytest
import torch

from phones_las_torch.models.las import LASConfig, init_las
from phones_las_torch.utils.diagnostics import annotate, assert_all_finite, enable_nan_checks, profile_trace
from tests.torch_threads import one_thread

one_thread()


def test_assert_all_finite_names_the_leaf():
    params = init_las(LASConfig(), seed=0, device="cpu")
    assert_all_finite(params, name="params")
    assert_all_finite({"a": torch.ones(3), "b": (np.zeros(2), [torch.zeros(1)])})
    with torch.no_grad():
        params.speller.out_b[3] = float("nan")
    with pytest.raises(FloatingPointError, match=r"params\.speller\.out_b"):
        assert_all_finite(params, name="params")
    with pytest.raises(FloatingPointError, match=r"bad\['x'\]\[1\]"):
        assert_all_finite({"x": [torch.ones(2), torch.tensor([1.0, float("inf")])]}, name="bad")


def test_nan_checks_toggle_anomaly_mode():
    try:
        enable_nan_checks(True)
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (torch.sqrt(x) * 0.0).sum().backward()  # 0 · ∞ in the backward
    finally:
        enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()


def test_profile_trace_records_annotations(tmp_path):
    d = str(tmp_path / "prof")
    with profile_trace(d):
        with annotate("test-scope"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    files = glob.glob(d + "/trace_*.json")
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "test-scope" in names and "aten::mm" in names


@pytest.mark.parametrize("mod", ["prepare", "train", "infer", "transcribe", "serve", "export", "lm"])
def test_cli_help(mod, capsys):
    cli = importlib.import_module(f"phones_las_torch.cli.{mod}")
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "usage" in out.lower() and (mod == "lm" or "--device" in out or "speechlike" in out)
