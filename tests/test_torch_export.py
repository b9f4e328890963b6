"""Serving programs (``phones_las_torch/export.py``) on the CPU: a tiny
workdir trained by the port's CLIs, exported with ``torch.export``, gives
the live ``Transcriber``'s tokens greedy, with beam 2 and with beam 2 + an
n-gram LM; its graph holds the kernels as ``phones_las_torch`` operators
(which pass ``torch.library.opcheck``); a fresh process loads it without
the model code; a program exported for CUDA and the CPU serves on the
CPU; requests beyond every exported shape, devices the export does not
list and JAX export directories are refused."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from phones_las_torch.api import Transcriber
from phones_las_torch.cli import export as export_cli
from phones_las_torch.cli import lm as lm_cli
from phones_las_torch.cli import prepare as prepare_cli
from phones_las_torch.cli import train as train_cli
from phones_las_torch.decode import fused_greedy as FG
from phones_las_torch.export import ExportedTranscriber, export_model
from phones_las_torch.frontend import features as F
from phones_las_torch.frontend import fused_frontend as FF
from phones_las_torch.ops import lstm as L
from tests.torch_threads import one_thread, subprocess_env

one_thread()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = {"phones_las_torch.fused_logmel.default", "phones_las_torch.bidir_recurrence.default",
       "phones_las_torch.greedy_decode_fused.default"}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A 2 × 16 BiLSTM bahdanau model trained 2 steps by the CLIs (the
    reference's ``tests/test_export.py`` fixture, targets capped at 12)."""
    root = tmp_path_factory.mktemp("export")
    data, wd = str(root / "d"), str(root / "w")
    prepare_cli.main(["synthetic", "--out", data, "--n-utts", "10", "--n-phones", "4", "--device", "cpu"])
    train_cli.main([
        "--preset", "timit_phone_las", "--data", data, "--workdir", wd, "--num-steps", "2",
        "--batch-size", "4", "--encoder-layers", "2", "--encoder-units", "16", "--decoder-units", "16",
        "--embedding-dim", "8", "--attention-units", "16", "--max-target-len", "12", "--device", "cpu",
    ])
    return wd


@pytest.fixture(scope="module")
def clips():
    rs = np.random.RandomState(0)
    return [(rs.randn(6000 + 1000 * i) * 2000).astype(np.int16) for i in range(3)]


@pytest.fixture(scope="module")
def greedy_export(workdir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("exp") / "greedy")
    export_cli.main(["--workdir", workdir, "--out", out, "--batch-sizes", "2,4", "--pad-seconds", "1",
                     "--beam-width", "0", "--device", "cpu"])
    return out


def test_export_greedy_roundtrip(workdir, greedy_export, clips):
    with open(os.path.join(greedy_export, "export.json")) as f:
        meta = json.load(f)
    assert (meta["runtime"], meta["device"], meta["platforms"], meta["beam_width"]) == ("torch.export", "cpu", ["cpu"], 0)
    assert (meta["matmul_precision"], meta["prec"]) == ("highest", "highest")
    e = ExportedTranscriber(greedy_export, device="cpu")
    assert e.sample_rate == 16000
    live = Transcriber(workdir, beam_width=0, device="cpu").transcribe_batch(clips)
    assert e.transcribe_batch(clips) == live
    assert e.transcribe(clips[0]) == live[0]  # the b=2 program
    assert isinstance(e.transcribe(clips[0].astype(np.float32)), list)  # PCM-scale floats are quantised
    # requests beyond every exported shape fail loudly
    with pytest.raises(ValueError, match="no exported shape"):
        e.transcribe_batch([clips[0]] * 5)
    with pytest.raises(ValueError, match="no exported shape"):
        e.transcribe(np.zeros(40000, np.int16))


def test_graph_holds_the_kernel_operators(greedy_export):
    """One node per kernel call: the front-end, one BiLSTM launch per
    layer, the greedy decoder; no unrolled recurrence."""
    ep = torch.export.load(os.path.join(greedy_export, "infer_b2_t16000.pt2"))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    ours = sorted(t for t in targets if t.startswith("phones_las_torch."))
    assert set(ours) == OPS and ours.count("phones_las_torch.bidir_recurrence.default") == 2
    assert len(ours) == 4 and len(targets) < 400


@pytest.mark.parametrize("lm", [False, True], ids=["beam2", "beam2_lm"])
def test_export_beam(workdir, clips, tmp_path, lm):
    kw = {"beam_width": 2}
    if lm:
        data = json.load(open(os.path.join(workdir, "config.json")))["data"]
        kw.update(lm=str(tmp_path / "lm.npz"), lm_weight=0.5)
        lm_cli.main(["--data", data, "--out", kw["lm"], "--order", "2"])
    out = str(tmp_path / "exp")
    meta = export_model(workdir, out, batch_sizes=[2], pad_seconds=[1.0], device="cpu", **kw)
    assert meta["beam_width"] == 2
    live = Transcriber(workdir, device="cpu", **kw).transcribe_batch(clips[:2])
    assert ExportedTranscriber(out, device="cpu").transcribe_batch(clips[:2]) == live


def test_fresh_process_loads_without_model_code(workdir, greedy_export, clips):
    code = (
        "import sys, numpy as np\n"
        "from phones_las_torch.export import ExportedTranscriber\n"
        f"clips = [np.asarray(c, np.int16) for c in {[c.tolist() for c in clips[:2]]!r}]\n"
        f"print(ExportedTranscriber({greedy_export!r}, device='cpu').transcribe_batch(clips))\n"
        "loaded = sorted(m for m in sys.modules if m.startswith(('phones_las_torch.models', 'phones_las_torch.api',"
        " 'phones_las_torch.decode.beam', 'phones_las_torch.train', 'jax', 'phones_las_tpu')))\n"
        "assert not loaded, loaded\n"
    )
    env = subprocess_env(PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == str(Transcriber(workdir, beam_width=0, device="cpu").transcribe_batch(clips[:2]))


def test_platforms_and_refusals(workdir, greedy_export, clips, tmp_path, monkeypatch):
    """A program traced on the CPU for ['cuda', 'cpu'] serves on the CPU;
    an export without 'cuda' is refused there, one without 'cpu' here; a
    JAX (StableHLO) export directory is refused with a clear error."""
    out = str(tmp_path / "xp")
    meta = export_cli_main(workdir, out, "--platforms", "cuda,cpu")
    assert meta["platforms"] == ["cuda", "cpu"]
    assert ExportedTranscriber(out, device="cpu").transcribe(clips[1]) == \
        Transcriber(workdir, beam_width=0, device="cpu").transcribe(clips[1])
    with pytest.raises(ValueError, match="not for 'cuda'"):
        ExportedTranscriber(greedy_export, device="cuda")
    with open(os.path.join(out, "export.json")) as f:
        only_cuda = dict(json.load(f), platforms=["cuda"])
    with open(os.path.join(out, "export.json"), "w") as f:
        json.dump(only_cuda, f)
    with pytest.raises(ValueError, match="not for 'cpu'"):
        ExportedTranscriber(out, device="cpu")
    with pytest.raises(ValueError, match="unknown platforms"):
        export_model(workdir, str(tmp_path / "tpu"), batch_sizes=[2], pad_seconds=[1.0],
                     platforms=["tpu"], device="cpu")
    jax_dir = tmp_path / "jax_export"
    jax_dir.mkdir()
    (jax_dir / "export.json").write_text(json.dumps({
        "format": 1, "sample_rate": 16000, "tokens": ["a"], "platforms": None,
        "entries": [{"batch": 2, "pad_samples": 16000, "file": "infer_b2_t16000.shlo"}],
    }))
    with pytest.raises(ValueError, match="StableHLO"):
        ExportedTranscriber(str(jax_dir), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ExportedTranscriber(greedy_export)


def export_cli_main(workdir, out, *extra):
    export_cli.main(["--workdir", workdir, "--out", out, "--batch-sizes", "2", "--pad-seconds", "1",
                     "--beam-width", "0", "--device", "cpu", *extra])
    with open(os.path.join(out, "export.json")) as f:
        return json.load(f)


def _opcheck_args(name):
    g = torch.Generator().manual_seed(0)
    if name == "fused_logmel":
        cfg = F.FrontendConfig()
        return (torch.randn(2, 4000, generator=g) * 1000, FF._cfg_key(cfg), F.frames_for_samples(4000, cfg))
    if name == "bidir_recurrence":
        t, b, u = 6, 3, 8
        mask = torch.ones(t, b)
        mask[4:, 1] = 0.0
        return (torch.randn(t, b, 4 * u, generator=g), torch.randn(t, b, 4 * u, generator=g), mask,
                torch.randn(u, 4 * u, generator=g) * 0.3, torch.randn(u, 4 * u, generator=g) * 0.3, 1.0, "bf16")
    from phones_las_torch.models.speller import SpellerConfig, init_speller

    cfg = SpellerConfig(vocab_size=9, embedding_dim=8, num_layers=2, units=16, memory_dim=12, attention_units=8,
                        attention_layer_size=8)
    params = init_speller(cfg, g)
    mem = torch.randn(3, 5, 12, generator=g)
    mask = torch.ones(3, 5)
    mask[2, 3:] = 0.0
    return mem, mask, FG.flat_weights(params), cfg.bos_id, cfg.eos_id, 7


@pytest.mark.parametrize("name", ["fused_logmel", "bidir_recurrence", "greedy_decode_fused"])
def test_opcheck(name):
    """Each kernel's operator: schema, fake (shape) function against the
    CPU implementation, dispatch through AOT autograd; and its CPU
    implementation is the plain version."""
    args = _opcheck_args(name)
    op = getattr(torch.ops.phones_las_torch, name).default
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result
    got = op(*args)
    if name == "fused_logmel":
        want = FF.fused_logmel_plain(args[0], F.FrontendConfig(), args[2])
    elif name == "bidir_recurrence":
        of, ob, (hf, cf), (hb, cb) = L.bidir_recurrence_plain(*args)
        want = (of, ob, hf, cf, hb, cb)
    else:
        params, widths = FG._unflatten(args[2], args[0], args[3], args[4])
        want = FG.greedy_decode_fused_plain(params, widths, args[0], args[1], args[5])[:1]
        got = (got,)
        assert got[0].dtype == torch.int32 and got[0].shape == (3, 7)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
