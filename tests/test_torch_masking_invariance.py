"""Pad-content invariance of the port (the port of
``tests/test_masking_invariance.py``): scribbling over pad audio and pad
targets changes no bit of the loss, the encoder lengths, the encoder
output at valid frames, the greedy tokens or the beam-3 + joint-CTC
tokens and scores, for the standard and the monotonic attention
variants; the clean run equals JAX's."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from phones_las_tpu.decode import beam_decode as jax_beam_decode
from phones_las_tpu.decode import greedy_decode as jax_greedy_decode
from phones_las_tpu.models import LASConfig as JaxLASConfig
from phones_las_tpu.models import ListenerConfig as JaxListenerConfig
from phones_las_tpu.models import SpellerConfig as JaxSpellerConfig
from phones_las_tpu.models import compute_loss as jax_compute_loss
from phones_las_tpu.models import encode as jax_encode
from phones_las_tpu.models import init_las as jax_init_las

from phones_las_torch.decode import beam_decode, greedy_decode
from phones_las_torch.models import compute_loss, encode
from phones_las_torch.models.las import ctc_logp
from phones_las_torch.utils.param_io import config_from_dict, params_from_numpy
from tests.torch_threads import one_thread

one_thread()

V = 10
STEPS = 5
BEAM = 3
ALPHA = 0.7
VARIANTS = ("bahdanau", "luong", "bahdanau_monotonic", "luong_monotonic")


def _flat(params):
    return {
        jax.tree_util.keystr(p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }


def _cfg(variant):
    """The reference test's model with ``variant`` attention and a CTC head
    (the joint beam scores prefixes with it)."""
    return JaxLASConfig(
        listener=JaxListenerConfig(input_dim=120, num_layers=2, units=8),
        speller=JaxSpellerConfig(
            vocab_size=V, embedding_dim=6, num_layers=1, units=8, memory_dim=16,
            attention_units=8, attention_layer_size=8, attention_type=variant,
        ),
        ctc_weight=0.3,
    )


def _inputs():
    """The reference test's batch and its scribbled copy."""
    rs = np.random.RandomState(0)
    b, s, st = 2, 4800, 6
    audio = rs.randn(b, s).astype(np.float32) * 1000
    lens = np.array([4800, 3000], np.int32)
    targets = rs.randint(4, V, (b, st)).astype(np.int32)
    tlens = np.array([st, 4], np.int32)
    audio2 = audio.copy()
    audio2[1, 3000:] = rs.randn(s - 3000) * 30000
    targets2 = targets.copy()
    targets2[1, 4:] = 9
    return (audio, targets), (audio2, targets2), lens, tlens


def _run_port(params, cfg, audio, targets, lens, tlens):
    batch = {"audio": torch.from_numpy(audio), "audio_lengths": torch.from_numpy(lens),
             "targets": torch.from_numpy(targets), "target_lengths": torch.from_numpy(tlens)}
    with torch.no_grad():
        loss, _ = compute_loss(params, cfg, batch)
        mem, el, mask = encode(params, cfg, batch["audio"], batch["audio_lengths"])
        toks, dlens, _ = greedy_decode(params.speller, cfg.speller, mem, mask, STEPS)
        beam = beam_decode(params.speller, cfg.speller, mem, mask, STEPS, beam_width=BEAM,
                           ctc_logp=ctc_logp(params, mem), ctc_alpha=ALPHA)
    return loss.item(), mem.numpy(), el.numpy(), toks.numpy(), dlens.numpy(), beam


@pytest.mark.parametrize("variant", VARIANTS)
def test_pad_content_invariance(variant):
    jcfg = _cfg(variant)
    jparams = jax_init_las(jax.random.PRNGKey(0), jcfg)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    params = params_from_numpy(_flat(jparams), cfg, device="cpu")
    clean, scribbled, lens, tlens = _inputs()

    l1, m1, e1, t1, d1, b1 = _run_port(params, cfg, *clean, lens, tlens)
    l2, m2, e2, t2, d2, b2 = _run_port(params, cfg, *scribbled, lens, tlens)
    assert np.isfinite(l1) and l1 == l2
    np.testing.assert_array_equal(e1, e2)
    for row in range(len(e1)):  # the reference holds the short row within 1e-6; here every bit
        np.testing.assert_array_equal(m1[row, : e1[row]], m2[row, : e1[row]])
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(d1, d2)
    for field in b1._fields:
        got, want = getattr(b2, field), getattr(b1, field)
        assert (got is None) == (want is None), field
        if want is not None:
            assert torch.equal(got, want), field

    # the clean run against JAX, within test_torch_las.py's tolerances
    audio, targets = clean
    jb = {"audio": jnp.asarray(audio), "audio_lengths": jnp.asarray(lens),
          "targets": jnp.asarray(targets), "target_lengths": jnp.asarray(tlens)}
    ref_loss, _ = jax_compute_loss(jparams, jcfg, jb)
    mem_j, el_j, mask_j = jax_encode(jparams, jcfg, jb["audio"], jb["audio_lengths"])
    tok_j, len_j, _ = jax_greedy_decode(jparams.speller, jcfg.speller, mem_j, mask_j, STEPS)
    lp_j = jax.nn.log_softmax(mem_j @ jparams.ctc_w + jparams.ctc_b, axis=-1)
    beam_j = jax_beam_decode(jparams.speller, jcfg.speller, mem_j, mask_j, STEPS, beam_width=BEAM,
                             ctc_logp=lp_j, ctc_alpha=ALPHA)
    assert abs(l1 - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    np.testing.assert_array_equal(e1, np.asarray(el_j))
    np.testing.assert_allclose(m1, np.asarray(mem_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(t1, np.asarray(tok_j))
    np.testing.assert_array_equal(d1, np.asarray(len_j))
    for field in b1._fields:
        got, ref = getattr(b1, field), getattr(beam_j, field)
        if ref is None:
            continue
        g, r = got.numpy(), np.asarray(ref)
        if r.dtype.kind == "f":
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-4, err_msg=field)
        else:
            np.testing.assert_array_equal(g, r, err_msg=field)
