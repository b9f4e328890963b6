"""Degenerate utterances through the port's data layer and model on the
CPU against the JAX reference (the port of ``tests/test_edge_cases.py``):
a 1-sample row with an empty target, a row shorter than one window, an
over-long target that the planner drops, over-long audio that is
truncated, and the pad row ``drop_remainder=False`` leaves. The batches
are compared field by field, bitwise; the loss and every gradient leaf of
``compute_loss`` on that batch against JAX's, CTC head and grapheme head
off and on."""

import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from phones_las_tpu import api as japi
from phones_las_tpu.data.pipeline import DataSource as JaxDataSource
from phones_las_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from phones_las_tpu.data.records import RecordWriter as JaxRecordWriter
from phones_las_tpu.data.records import Utterance as JaxUtterance
from phones_las_tpu.models import LASConfig as JaxLASConfig
from phones_las_tpu.models import ListenerConfig as JaxListenerConfig
from phones_las_tpu.models import SpellerConfig as JaxSpellerConfig
from phones_las_tpu.models.las import compute_loss as jax_compute_loss
from phones_las_tpu.models.las import init_las as jax_init_las

from phones_las_torch import Transcriber
from phones_las_torch.data import RecordWriter, Utterance
from phones_las_torch.data.native_records import NativeRecordReader
from phones_las_torch.data.pipeline import DataSource, PipelineConfig
from phones_las_torch.models import compute_loss
from phones_las_torch.models.las import trainable_filter
from phones_las_torch.utils.param_io import config_from_dict, named_leaves, params_from_numpy
from tests.torch_threads import one_thread

one_thread()

LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4  # of each leaf's largest magnitude


def _flat(params):
    return {
        jax.tree_util.keystr(p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }


def _edge_utterances(graphemes: bool):
    """The reference test's four utterances; with ``graphemes``, each also
    carries a grapheme target (the first an empty one)."""
    g = (lambda *ids: np.asarray(ids, np.int32)) if graphemes else (lambda *ids: None)
    return [
        ("tiny", np.zeros(1, np.int16), np.zeros(0, np.int32), g()),  # 1 sample, empty target
        ("short", np.ones(100, np.int16) * 500, np.asarray([4], np.int32), g(5, 6)),  # < one window
        ("longt", np.ones(3000, np.int16) * 500, np.asarray([4] * 50, np.int32), g(7)),  # dropped
        ("longa", np.ones(9000, np.int16) * 500, np.asarray([5, 6], np.int32), g(8, 9, 4)),  # truncated
    ]


def _write_both(tmp_path, graphemes: bool):
    """The utterances through both packages' writers: the files are equal."""
    paths = []
    for name, writer, utt in (("port", RecordWriter, Utterance), ("jax", JaxRecordWriter, JaxUtterance)):
        path = str(tmp_path / f"edge_{name}_{int(graphemes)}.plu")
        with writer(path) as w:
            for utt_id, audio, targets, g in _edge_utterances(graphemes):
                w.write(utt(utt_id, audio, targets, g))
        paths.append(path)
    assert filecmp.cmp(*paths, shallow=False)
    return paths[0]


def _pipeline_kw(graphemes: bool):
    return dict(batch_size=4, buckets=(4000,), max_target_len=8, max_grapheme_len=6 if graphemes else 0,
                drop_remainder=False, drop_too_long=False, shuffle=False)


def _edge_batch(tmp_path, graphemes: bool, use_native: str = "never"):
    path = _write_both(tmp_path, graphemes)
    kw = _pipeline_kw(graphemes)
    got = list(DataSource([path], PipelineConfig(**kw), use_native=use_native).epoch(0))
    want = list(JaxDataSource([path], JaxPipelineConfig(**kw), use_native="never").epoch(0))
    return got, want


@pytest.mark.parametrize("use_native", ["never", "auto"])
@pytest.mark.parametrize("graphemes", [False, True])
def test_degenerate_batch_equals_jax_bitwise(tmp_path, use_native, graphemes):
    """One batch: 3 real rows (the over-long target dropped, the over-long
    audio truncated to the bucket) and a pad row, every field equal to the
    reference's in dtype and bits, and the reference test's own checks."""
    got, want = _edge_batch(tmp_path, graphemes, use_native)
    assert len(got) == len(want) == 1
    a, b = got[0], want[0]
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k
    assert a["num_real"] == 3 and "longt" not in a["utt_ids"]
    assert a["audio_lengths"].tolist() == [1, 100, 4000, 0]  # longa truncated; the pad row
    assert a["target_lengths"].tolist() == [1, 2, 3, 0]  # <eos> counted
    assert not a["audio"][3].any() and not a["targets"][3].any()
    if graphemes:
        assert a["grapheme_lengths"].tolist() == [1, 3, 4, 0]


def _tiny_cfg(ctc_weight: float, grapheme: bool):
    """The reference test's widths: 2 × 8 listener, vocab 10."""
    speller = dict(embedding_dim=4, num_layers=1, units=8, memory_dim=16, attention_units=8, attention_layer_size=8)
    return JaxLASConfig(
        listener=JaxListenerConfig(input_dim=120, num_layers=2, units=8),
        speller=JaxSpellerConfig(vocab_size=10, **speller),
        grapheme_speller=JaxSpellerConfig(vocab_size=10, **speller) if grapheme else None,
        multitask_weight=0.5 if grapheme else 0.0,
        ctc_weight=ctc_weight,
    )


@pytest.mark.parametrize("grapheme", [False, True])
@pytest.mark.parametrize("ctc_weight", [0.0, 0.3])
def test_degenerate_batch_loss_and_grads_match_jax(tmp_path, ctc_weight, grapheme):
    """``compute_loss`` and its gradients on the degenerate batch (the pad
    row included) against JAX's under the same parameters: the loss within
    1e-5 relative, each gradient leaf within 2e-4 of its largest
    magnitude, everything finite."""
    got, _ = _edge_batch(tmp_path, grapheme)
    keys = ("audio", "audio_lengths", "targets", "target_lengths") + (
        ("grapheme_targets", "grapheme_lengths") if grapheme else ())
    batch = {k: got[0][k] for k in keys}

    jcfg = _tiny_cfg(ctc_weight, grapheme)
    jparams = jax_init_las(jax.random.PRNGKey(0), jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (ref_loss, ref_aux), ref_grads = jax.value_and_grad(
        lambda p: jax_compute_loss(p, jcfg, jb), has_aux=True)(jparams)

    cfg = config_from_dict(dataclasses.asdict(jcfg))
    params = params_from_numpy(_flat(jparams), cfg, device="cpu")
    mask = trainable_filter(params)
    for key, t in named_leaves(params):
        t.requires_grad_(mask[key])
    loss, aux = compute_loss(params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()

    assert np.isfinite(loss.item()) and np.isfinite(float(ref_loss))
    assert abs(loss.item() - float(ref_loss)) <= LOSS_RTOL * abs(float(ref_loss))
    heads = ["phone_loss"] + (["ctc_loss"] if ctc_weight else []) + (["grapheme_loss"] if grapheme else [])
    for k in heads:
        np.testing.assert_allclose(aux[k].item(), float(ref_aux[k]), rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    ref = _flat(ref_grads)
    checked = 0
    for key, t in named_leaves(params):
        if not t.requires_grad:
            continue
        g, want = t.grad.numpy(), ref[key]
        assert np.isfinite(g).all() and np.isfinite(want).all(), key
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(g - want).max()) <= GRAD_TOL * scale, (key, float(np.abs(g - want).max()), scale)
        checked += 1
    # listener 2 layers × 2 directions × 3; speller: embedding, a cell's 3,
    # attention wq/wk/v, attention layer, out_w/out_b; CTC w/b; the grapheme speller's 10
    assert checked == 12 + 10 + (2 if ctc_weight else 0) + (10 if grapheme else 0)


def test_native_edge_parity(tmp_path):
    """The native C++ fill against the Python fill on a 1-sample row with
    an empty target and a dropped over-long target (a batch of one real
    row and one pad row), both equal to the reference's Python fill."""
    if not NativeRecordReader.available():
        pytest.skip("no C++ compiler")
    path = str(tmp_path / "edge2.plu")
    with RecordWriter(path) as w:
        w.write(Utterance("tiny", np.zeros(1, np.int16), np.zeros(0, np.int32)))
        w.write(Utterance("longt", np.ones(500, np.int16), np.asarray([4] * 50, np.int32)))
    kw = dict(batch_size=2, buckets=(400,), max_target_len=8, drop_remainder=False, drop_too_long=False,
              shuffle=False)
    nb = list(DataSource([path], PipelineConfig(**kw), use_native="auto").epoch(0))
    pb = list(DataSource([path], PipelineConfig(**kw), use_native="never").epoch(0))
    jb = list(JaxDataSource([path], JaxPipelineConfig(**kw), use_native="never").epoch(0))
    assert len(nb) == len(pb) == len(jb) == 1
    for k in ("audio", "audio_lengths", "targets", "target_lengths"):
        np.testing.assert_array_equal(nb[0][k], pb[0][k], err_msg=k)
        np.testing.assert_array_equal(nb[0][k], jb[0][k], err_msg=k)
    assert nb[0]["num_real"] == 1 and nb[0]["audio_lengths"].tolist() == [1, 0]


def test_transcriber_takes_the_rows_the_reference_takes():
    """The long-gate artifact's ``Transcriber`` on rows of 0, 1, 100, 400,
    16000 and 32000 samples, together and the two shortest alone: the
    reference takes every one of them (a 0-sample row is one frame of
    silence), and the port gives its tokens; an empty request raises
    ``ValueError`` in both."""
    asset = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "long_gate.npz")
    rs = np.random.RandomState(11)
    rows = [(rs.randn(n) * 3000).astype(np.int16) for n in (0, 1, 100, 400, 16000, 32000)]
    port = Transcriber.from_artifact(asset, device="cpu")
    ref = japi.Transcriber.from_artifact(asset)
    for batch in (rows, rows[:1], rows[1:2]):
        got, want = port.transcribe_batch(batch), ref.transcribe_batch(batch)
        assert got == want and all(want)
    for t in (port, ref):
        with pytest.raises(ValueError):
            t.transcribe_batch([])
