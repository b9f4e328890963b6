"""The port's whole slice — artifact → front-end → pyramidal BiLSTM →
greedy decode — on the CPU against the JAX reference, on a small random
model and on the committed checkpoint and eval set; plus the device rule
and the rule that the port imports nothing of JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from phones_las_tpu.decode import greedy_decode as jax_greedy_decode
from phones_las_tpu.models.las import LASConfig as JaxLASConfig
from phones_las_tpu.models.las import encode as jax_encode
from phones_las_tpu.models.las import init_las
from phones_las_tpu.models.listener import ListenerConfig as JaxListenerConfig
from phones_las_tpu.models.speller import SpellerConfig as JaxSpellerConfig
from phones_las_tpu.utils.param_io import load_params_npz

from phones_las_torch.decode.greedy import greedy_decode
from phones_las_torch.models.las import encode
from phones_las_torch.utils.metrics import edit_distance_stats, per_from_stats
from phones_las_torch.utils.param_io import (
    config_from_dict,
    load_artifact,
    named_leaves,
    params_from_numpy,
)
from tests.torch_threads import one_thread, subprocess_env

one_thread()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "phones_las_tpu", "assets", "bench")
CKPT = os.path.join(ASSETS, "ckpt.npz")
EVAL_GREEDY_PER = 0.0319  # the reference's greedy PER on the eval set


def _flat(params):
    return {
        jax.tree_util.keystr(p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }


def test_small_model_slice_matches_jax():
    jcfg = JaxLASConfig(
        listener=JaxListenerConfig(input_dim=120, num_layers=3, units=16),
        speller=JaxSpellerConfig(
            vocab_size=13, embedding_dim=8, num_layers=2, units=16, memory_dim=32,
            attention_units=16, attention_layer_size=16,
        ),
    )
    jp = init_las(jax.random.PRNGKey(0), jcfg)
    rs = np.random.RandomState(0)
    jp = jp._replace(  # non-trivial CMVN stats
        cmvn_mean=jnp.asarray(rs.randn(120) * 0.5, jnp.float32),
        cmvn_std=jnp.asarray(rs.rand(120) + 0.5, jnp.float32),
    )
    lens = np.array([9000, 5000, 7777])
    audio = np.zeros((3, 9000), np.float32)
    for i, n in enumerate(lens):
        audio[i, :n] = rs.randn(n) * 2000
    mem_j, enc_lens_j, mask_j = jax_encode(jp, jcfg, jnp.asarray(audio), jnp.asarray(lens))
    tok_j, len_j, _ = jax_greedy_decode(jp.speller, jcfg.speller, mem_j, mask_j, max_steps=8)

    cfg = config_from_dict(dataclasses.asdict(jcfg))
    params = params_from_numpy(_flat(jp), cfg, device="cpu")
    with torch.no_grad():
        mem, enc_lens, mask = encode(params, cfg, torch.from_numpy(audio), torch.from_numpy(lens))
        tok, ln, _ = greedy_decode(params.speller, cfg.speller, mem, mask, 8)
    np.testing.assert_array_equal(enc_lens.numpy(), np.asarray(enc_lens_j))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    # float32 through the front-end (1e-4 bound) and three recurrent layers
    np.testing.assert_allclose(mem.numpy(), np.asarray(mem_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_j))
    np.testing.assert_array_equal(ln.numpy(), np.asarray(len_j))


@pytest.mark.parametrize("path", [CKPT, os.path.join(REPO, "tests", "goldens", "long_gate.npz")])
def test_artifact_leaves_match_jax_loader(path):
    """The bench checkpoint, and the long-regime golden (monotonic
    attention, CTC head, SpecAugment config, extras)."""
    jparams, jcfg = load_params_npz(path)
    params, cfg, extras = load_artifact(path, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.speller.vocab_size == 26
    with np.load(path) as d:
        assert bool(extras) == ("__extras__" in d.files)
    ref = _flat(jparams)
    got = dict(named_leaves(params))
    assert sorted(got) == sorted(ref)
    for key, leaf in ref.items():
        assert tuple(got[key].shape) == leaf.shape, key
        assert got[key].dtype == torch.float32 and leaf.dtype == np.float32, key
        np.testing.assert_array_equal(got[key].numpy(), leaf)


def test_checkpoint_eval_set_tokens_match_jax_xla():
    data = np.load(os.path.join(ASSETS, "eval_set.npz"), allow_pickle=False)
    cap = int(data["decode_cap"][0])
    jparams, jcfg = load_params_npz(CKPT)

    @jax.jit
    def run(p, audio, lengths):
        memory, _, mask = jax_encode(p, jcfg, audio, lengths, implementation="xla")
        return jax_greedy_decode(p.speller, jcfg.speller, memory, mask, max_steps=cap)[:2]

    ref_tok, _ = (np.asarray(x) for x in run(jparams, data["audio"], data["lengths"]))

    params, cfg, _ = load_artifact(CKPT, device="cpu")
    with torch.no_grad():
        mem, _, mask = encode(params, cfg, torch.from_numpy(data["audio"]), torch.from_numpy(data["lengths"]))
        tok, ln, _ = greedy_decode(params.speller, cfg.speller, mem, mask, cap)
    np.testing.assert_array_equal(tok.numpy(), ref_tok)
    refs = data["refs"]
    per = per_from_stats(*edit_distance_stats(
        tok.numpy(), ln.numpy(), np.where(refs >= 0, refs, 0), (refs >= 0).sum(axis=1)
    ))
    assert round(per, 4) == EVAL_GREEDY_PER


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_artifact(CKPT)
    cfg = config_from_dict(dataclasses.asdict(JaxLASConfig()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({}, cfg)


def test_bad_artifact_leaf_fails_loudly():
    with np.load(CKPT) as d:
        flat = {k: d[k] for k in d.files if not k.startswith("__")}
    _, cfg, _ = load_artifact(CKPT, device="cpu")
    missing = dict(flat)
    del missing[".speller.out_b"]
    with pytest.raises(KeyError, match="out_b"):
        params_from_numpy(missing, cfg, device="cpu")
    bad = dict(flat)
    bad[".listener.layers[1][0].wh"] = bad[".listener.layers[1][0].wh"][:, :8]
    with pytest.raises(ValueError, match="wh"):
        params_from_numpy(bad, cfg, device="cpu")


def test_every_port_test_file_runs_one_thread():
    """Each ``tests/test_torch_*.py`` sets one torch intra-op thread through
    ``tests/torch_threads.py`` after its imports, and starts its
    subprocesses with that module's environment."""
    import ast
    import glob

    files = sorted(glob.glob(os.path.join(REPO, "tests", "test_torch_*.py")))
    assert len(files) >= 24
    for path in files:
        with open(path, encoding="utf-8") as f:
            src = f.read()
        tree = ast.parse(src)
        calls = [n for n in tree.body if isinstance(n, ast.Expr) and isinstance(n.value, ast.Call)
                 and getattr(n.value.func, "id", None) == "one_thread"]
        assert calls, f"{os.path.basename(path)} does not call one_thread() at module level"
        imported = {a.name for n in tree.body if isinstance(n, ast.ImportFrom) and n.module == "tests.torch_threads"
                    for a in n.names}
        assert "one_thread" in imported, os.path.basename(path)
        if "subprocess.run(" in src or "subprocess.Popen(" in src:
            assert "subprocess_env(" in src, f"{os.path.basename(path)} starts processes without subprocess_env"


def test_port_imports_no_jax():
    """Every module of the port (the decode and serving modules, the bench,
    the entry points and the tools included) imports without pulling in
    JAX, the JAX package or the reference's root ``bench`` and
    ``__graft_entry__``, and so does ``chip_smoke.py``, whose imports are
    also read from its source."""
    import ast

    code = (
        "import pkgutil, importlib, sys, phones_las_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(phones_las_torch.__path__, 'phones_las_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'phones_las_tpu', 'bench', '__graft_entry__'))\n"
        "assert not bad, bad\n"
        "need = {'api', 'data.vocab', 'decode.beam', 'decode.ctc', 'decode.lm', 'decode.greedy', 'ops.attention',\n"
        "        'frontend.specaugment', 'frontend.freq_warp', 'frontend.cmvn', 'data.ipa', 'data.pipeline',\n"
        "        'utils.config', 'cli.common', 'train.checkpoint', 'train.state', 'data.records',\n"
        "        'data.audio_io', 'data.native_records', 'data.speechlike', 'data.synthetic', 'data.prep_common',\n"
        "        'data.timit', 'data.librispeech', 'parallel.multihost', 'parallel.mesh', 'export',\n"
        "        'utils.diagnostics',\n"
        "        'cli.serve', 'cli.train', 'cli.infer', 'cli.transcribe', 'cli.prepare', 'cli.lm', 'cli.export',\n"
        "        'data.g2p', 'data.lexicon_en', 'models.g2p_model', 'data.common_voice', 'cli.g2p',\n"
        "        'bench', 'entry', 'tools.make_bench_assets', 'tools.export_artifact', 'tools.decode_stats',\n"
        "        'tools.sample_lm_text', 'tools.longform_eval', 'tools.longform_debug'}\n"
        "missing = {'phones_las_torch.' + n for n in need} - set(names)\n"
        "assert not missing and len(names) >= 20, (missing, names)\n"
    )
    env = subprocess_env(PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not {m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "phones_las_tpu", "bench",
                                                            "__graft_entry__")}, imported
