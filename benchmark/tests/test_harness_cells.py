"""``BENCHMARK.json``'s format and limits, and the harness's result line,
refusals and imports."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from benchmark import run as R
from benchmark.tests.tiny import ROOT, load, tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = load("BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    c = R.load_cell(cell)
    assert c.chips == 1
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    assert c.mix["numerics"] in ("parity", "production")
    assert c.limits["logit_gap"] > 0
    assert sorted(R.stem(m["name"]) for m in c.end_to_end) == ["audio_per_s", "call_p90_ms", "setup_s"]
    e2e = {m["name"] for m in c.end_to_end}
    assert len(c.per_layer) == 9
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", R.stem(m["name"]) + ".py"))


def test_configs_are_files_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and _line(c["source"]) and _line(c["why"])
        body = load(c["file"])
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        used = [w for w in BENCH["workloads"] if w["config"] == c["name"]]
        assert used


def test_names_units_and_entries():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names) and len(set(CELLS)) == len(CELLS)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_the_last_line_has_the_keys_and_checks_last():
    res = R.run(tiny_cell(), 2**31 + 11, 0.5, False, device="cpu")
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks" and set(keys) <= {"correct", "attempted", "failed", "metrics", "device",
                                                  "breakdown", "counts", "checks"}
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"audio_per_s.w1024", "call_p90_ms.w1024", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    json.dumps(res)


def test_a_run_with_no_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0], "--seed", "2147483659",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "CUDA card" in p.stderr


def test_a_directory_of_the_benchmark_alone_gives_no_result(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark has no
    program to run."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0], "--seed", "5",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and "{" not in p.stdout


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_yardstick_imports_nothing_of_the_program_or_jax():
    """The reference, the counts, the traffic, the weights, the trace and
    the metrics' readers import neither the port nor JAX."""
    bench = os.path.join(ROOT, "benchmark")
    files = [os.path.join(bench, f) for f in ("reference.py", "counts.py", "traffic.py", "weights.py", "trace.py")]
    files += [os.path.join(bench, "metrics", f) for f in os.listdir(os.path.join(bench, "metrics"))
              if f.endswith(".py")]
    for f in files:
        tops = {m.split(".", 1)[0] for m in _imports(f)}
        assert not tops & {"phones_las_torch", "phones_las_tpu", "jax", "jaxlib", "flax"}, (f, tops)


def test_nothing_the_benchmark_loads_is_jax():
    """Every module a run loads (the harness, the control, the port's
    serving path), compared by its whole top-level name."""
    code = (
        "import sys, importlib, pkgutil, benchmark.run as R, benchmark.control, benchmark.reference\n"
        "import phones_las_torch.api, phones_las_torch.utils.param_io, phones_las_torch.models.las\n"
        "import phones_las_torch.decode.greedy, phones_las_torch.decode.fused_greedy\n"
        "import phones_las_torch.frontend.fused_frontend, phones_las_torch.ops.lstm\n"
        "print(R.forbidden_modules())\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
    assert R.FORBIDDEN == ("jax", "jaxlib", "flax", "phones_las_tpu")


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "phones_las_tpu_like", types.ModuleType("phones_las_tpu_like"))
    monkeypatch.setitem(sys.modules, "jaxtyping_like", types.ModuleType("jaxtyping_like"))
    assert R.forbidden_modules() == [] or set(R.forbidden_modules()) <= set(R.FORBIDDEN)
    assert "phones_las_tpu_like" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "phones_las_tpu.api", types.ModuleType("phones_las_tpu.api"))
    assert "phones_las_tpu" in R.forbidden_modules()


def test_the_trace_reads_stems_busy_time_and_idle_causes():
    from benchmark.trace import Activity, Trace, stem

    assert stem("void (anonymous namespace)::lstm_grid_kernel<4, true>(Args)") == "lstm_grid_kernel"
    assert stem("void at::native::elementwise_kernel<128, 4>(int)") == "elementwise_kernel"
    assert stem("sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32") == (
        "sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32")
    dev = [Activity("void (anonymous namespace)::greedy_kernel(A)", "kernel", 1.0, 3.0),
           Activity("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 2.5, 4.0),
           Activity("void (anonymous namespace)::lstm_fwd_kernel<256>(A)", "kernel", 6.0, 7.0)]
    host = [Activity("bench.window", "user_annotation", 0.0, 10.0),
            Activity("bench.transcribe_batch", "user_annotation", 0.6, 9.0),
            Activity("aten::copy_", "cpu_op", 4.5, 5.5)]
    t = Trace(dev, host, (0.0, 10.0))
    assert t.busy_s == 4.0 and t.window_s == 10.0
    assert t.kernel_seconds(("greedy_",)) == 2.0 and t.kernel_seconds(("lstm_",)) == 1.0
    assert t.device_seconds(exclude=("greedy_", "lstm_")) == 1.5
    assert t.gaps() == [(0.0, 1.0), (4.0, 6.0), (7.0, 10.0)]
    b = t.breakdown()
    assert b["device_ops"][0] == ["greedy_kernel", 2.0]
    assert dict(map(tuple, b["idle_gaps"])) == {
        "bench.window / python": 1.0, "bench.transcribe_batch / aten::copy_": 2.0,
        "bench.transcribe_batch / python": 3.0}
