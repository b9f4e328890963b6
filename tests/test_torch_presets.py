"""The reference's five presets at their own widths, on the CPU against JAX:
each bound to a data dir of its published vocabulary size through both
packages' ``resolve_preset``, a seeded init carried into the port by
``params_from_numpy``, two rows of seeded PCM. The loss and its parts
(phone CE, the grapheme term at weight 0.5, the binf sigmoid CE) and
every gradient leaf against ``jax.value_and_grad``; greedy tokens (phone
and grapheme head) and beam-4 tokens against JAX's decoders on the same
encoder output. Then the decoder kernel's shared-memory layout
(``decoder_smem_bytes``, the mirror of ``csrc/greedy.cu::dec_layout``) at
every preset's longest bucket, and the grid layout ``decoder_plan`` takes
where no cluster size fits."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from phones_las_tpu.cli.common import resolve_preset as jax_resolve_preset
from phones_las_tpu.decode import beam_decode as jax_beam_decode
from phones_las_tpu.decode import greedy_decode as jax_greedy_decode
from phones_las_tpu.models.las import compute_loss as jax_compute_loss
from phones_las_tpu.models.las import encode as jax_encode
from phones_las_tpu.models.las import init_las as jax_init_las

from phones_las_torch.cli.common import resolve_preset
from phones_las_torch.data import ipa
from phones_las_torch.data.timit import _GRAPHEMES
from phones_las_torch.data.vocab import Vocab
from phones_las_torch.decode import beam_decode, greedy_decode
from phones_las_torch.decode import fused_greedy as FG
from phones_las_torch.models import las as L
from phones_las_torch.models.speller import SpellerConfig
from phones_las_torch.utils.config import PRESETS
from phones_las_torch.utils.param_io import named_leaves, params_from_numpy
from tests.torch_threads import one_thread

one_thread()

# float32 sums in another order than XLA's, through 2–3 BiLSTM layers of
# 256 units and up to 12 decoder steps
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5  # of each leaf's largest magnitude
# the attention query's gradient is 1e-4 of the other leaves' at a random
# init (the query barely moves the scores), so float32 rounding shows at
# 1.3e-5 of its own largest element: held to tests/test_torch_train.py's bound
QUERY_GRAD_TOL = 1e-4
STEPS = 12  # decode cap
BEAM = 4
VOCAB = {"timit_phone_las": 65, "timit_multitask": 65, "librispeech_char_las": 34, "common_voice_binf": 120,
         "librispeech_offline_infer": 34}


def _tokens(name):
    """A data dir's phone tokens at the preset's published vocabulary (four
    specials added): the 61 TIMIT phones, 116 IPA phones of the inventory
    that ``data/ipa.py`` codes, the LibriSpeech characters and two more."""
    if name.startswith("timit"):
        phones = list(ipa.ARPABET_TO_IPA)
    elif name == "common_voice_binf":
        phones = list(ipa._CONSONANTS) + list(ipa._AFFRICATES) + list(ipa._VOWELS) + list(ipa._DIPHTHONGS)
    else:
        phones = _GRAPHEMES + ["-", "."]
    return phones[: VOCAB[name] - 4]


def _batch(cfg, seed):
    """B = 2 rows of 1.5 and 1 s of seeded PCM, phone targets of 10 and 6
    tokens (<eos> counted), grapheme targets of 12 and 8 for a multitask
    model."""
    rs = np.random.RandomState(seed)
    lens = np.array([24000, 16000], np.int32)
    audio = (rs.randn(2, 24000) * 2000).astype(np.float32)
    audio[1, 16000:] = 0.0
    out = {"audio": audio, "audio_lengths": lens}
    heads = [("targets", "target_lengths", cfg.speller, (10, 6))]
    if cfg.grapheme_speller is not None:
        heads.append(("grapheme_targets", "grapheme_lengths", cfg.grapheme_speller, (12, 8)))
    for key, len_key, sc, t_lens in heads:
        targets = np.zeros((2, max(t_lens)), np.int32)
        for i, t in enumerate(t_lens):
            targets[i, : t - 1] = rs.randint(4, sc.vocab_size, t - 1)
            targets[i, t - 1] = sc.eos_id
        out[key], out[len_key] = targets, np.asarray(t_lens, np.int32)
    return out


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _model_reference(model_key):
    """JAX's side for one model configuration (two presets that differ only
    in their pipeline share it): the init, the loss with its aux terms and
    gradients, the encoder output, greedy tokens of each head, beam tokens."""
    jcfg, codes = model_key[0], model_key[1]
    codes = None if codes is None else np.asarray(codes, np.float32)
    jp = jax_init_las(jax.random.PRNGKey(12), jcfg, binf_codes=codes)
    batch = _batch(jcfg, seed=12)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_compute_loss(p, jcfg, jb, train=False, implementation="xla"), has_aux=True))(jp)
    mem, _, mask = jax.jit(lambda p: jax_encode(p, jcfg, jb["audio"], jb["audio_lengths"]))(jp)
    greedy = {"phone": np.asarray(jax_greedy_decode(jp.speller, jcfg.speller, mem, mask, STEPS)[0])}
    if jcfg.grapheme_speller is not None:
        greedy["grapheme"] = np.asarray(jax_greedy_decode(jp.grapheme_speller, jcfg.grapheme_speller, mem, mask,
                                                          STEPS)[0])
    beam = np.asarray(jax_beam_decode(jp.speller, jcfg.speller, mem, mask, STEPS, beam_width=BEAM).tokens)
    terms = {k: float(aux[k]) for k in ("loss", "phone_loss", "grapheme_loss", "binf_loss") if k in aux}
    return {"flat": _flat(jp), "batch": batch, "terms": terms, "grads": _flat(grads), "mem": np.array(mem),
            "mask": np.array(mask), "greedy": greedy, "beam": beam}


@functools.lru_cache(maxsize=None)
def _preset(name, tmp):
    """Both packages' ``resolve_preset`` over one data dir of the preset's
    vocabulary → (JAX's model config, the port's, binf codes, the JAX
    reference)."""
    import os

    d = os.path.join(tmp, name)
    os.makedirs(d, exist_ok=True)
    Vocab(_tokens(name)).save(os.path.join(d, "vocab.txt"))
    if name == "timit_multitask":
        Vocab(_GRAPHEMES).save(os.path.join(d, "grapheme_vocab.txt"))
    jpreset, *_, jcodes = jax_resolve_preset(name, d, {"dropout": 0.0})
    preset, *_, codes = resolve_preset(name, d, {"dropout": 0.0})
    assert dataclasses.asdict(preset.model) == dataclasses.asdict(jpreset.model)
    assert (codes is None) == (jcodes is None) and (codes is None or np.array_equal(codes, jcodes))
    key = (jpreset.model, None if jcodes is None else tuple(map(tuple, jcodes)))
    return jpreset.model, preset.model, codes, _model_reference(key)


@pytest.fixture(scope="module")
def presets(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("presets"))
    return lambda name: _preset(name, tmp)


def _port_params(ref, cfg, trainable):
    params = params_from_numpy(ref["flat"], cfg, device="cpu")
    mask = L.trainable_filter(params)
    for key, t in named_leaves(params):
        t.requires_grad_(trainable and mask[key])
    return params


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_loss_and_grads_match_jax(name, presets):
    """Every loss term and every trainable gradient leaf at the preset's
    widths against ``jax.value_and_grad`` (train=False: no dropout, no
    sampling), each leaf within 1e-5 of its largest magnitude but the
    attention query's (1e-4)."""
    jcfg, cfg, _, ref = presets(name)
    assert cfg.speller.vocab_size == VOCAB[name]
    params = _port_params(ref, cfg, trainable=True)
    loss, aux = L.compute_loss(params, cfg, {k: torch.from_numpy(v) for k, v in ref["batch"].items()}, train=False)
    loss.backward()
    want = {"loss", "phone_loss"} | ({"grapheme_loss"} if cfg.grapheme_speller else set()) | (
        {"binf_loss"} if cfg.speller.binf_mode != "none" else set())
    assert set(ref["terms"]) == want
    for k, v in ref["terms"].items():
        np.testing.assert_allclose(aux[k].item(), v, rtol=LOSS_RTOL, err_msg=k)
    if cfg.grapheme_speller is not None:
        assert cfg.multitask_weight == 0.5
    checked = 0
    for key, t in named_leaves(params):
        if t.requires_grad:
            g, w = t.grad.numpy(), ref["grads"][key]
            scale = max(float(np.abs(w).max()), 1e-12)
            tol = QUERY_GRAD_TOL if key.endswith(".attention.wq") else GRAD_TOL
            assert float(np.abs(g - w).max()) <= tol * scale, (key, float(np.abs(g - w).max()), scale)
            checked += 1
    # listener layers × 2 directions × (wx, wh, b); a speller's embedding,
    # wx, wh, b a cell, wq/wk/v, attention layer, out_w, out_b; the binf head's 2
    spellers = [cfg.speller] + ([cfg.grapheme_speller] if cfg.grapheme_speller else [])
    binf = 2 if cfg.speller.binf_mode == "head" else 0
    assert checked == 6 * cfg.listener.num_layers + sum(7 + 3 * s.num_layers for s in spellers) + binf


def _greedy_cases():
    cases = [(n, "phone") for n in sorted(PRESETS)]
    return cases + [("timit_multitask", "grapheme")]


@pytest.mark.parametrize("name,head", _greedy_cases())
def test_preset_greedy_tokens_match_jax(name, head, presets):
    """The greedy decode of each head on JAX's encoder output: the loop
    the CPU runs, and the kernel's plain version, each at JAX's tokens."""
    _, cfg, _, ref = presets(name)
    params = _port_params(ref, cfg, trainable=False)
    sp, sc = (params.grapheme_speller, cfg.grapheme_speller) if head == "grapheme" else (params.speller, cfg.speller)
    mem, mask = torch.from_numpy(ref["mem"]), torch.from_numpy(ref["mask"])
    with torch.no_grad():
        tok, _, _ = greedy_decode(sp, sc, mem, mask, STEPS)
        plain, _ = FG.greedy_decode_fused_plain(sp, sc, mem, mask, STEPS)
    np.testing.assert_array_equal(tok.numpy(), ref["greedy"][head])
    np.testing.assert_array_equal(plain.numpy(), ref["greedy"][head])


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_beam_tokens_match_jax(name, presets):
    _, cfg, _, ref = presets(name)
    params = _port_params(ref, cfg, trainable=False)
    with torch.no_grad():
        res = beam_decode(params.speller, cfg.speller, torch.from_numpy(ref["mem"]), torch.from_numpy(ref["mask"]),
                          STEPS, beam_width=BEAM)
    np.testing.assert_array_equal(res.tokens.numpy(), ref["beam"])


# ---- the decoder kernel's shared memory (csrc/greedy.cu::dec_layout)


def _speller(v, n_cells, units=256, emb=128):
    return SpellerConfig(vocab_size=v, embedding_dim=emb, num_layers=n_cells, units=units, memory_dim=2 * units,
                         attention_units=units, attention_layer_size=units)


def _old_layout_bytes(t, cfg, c):
    """The layout before the output projection was sliced over the
    cluster: every block held all of out_w (transposed), the embedding
    table and a logits partial of all V columns."""
    pad4 = lambda n: -(-n // 4) * 4
    e, u, a, al, m, v, n = (cfg.embedding_dim, cfg.units, cfg.attention_units, cfg.attention_layer_size,
                            cfg.memory_dim, cfg.vocab_size, cfg.num_layers)
    floats = (8 * max(e + al + u, 2 * u, u + m) + n * 16 * u + n * 8 * (u // c) + 8 * (al + a + m)
              + max(512 * 32, 8 * max(4 * u // c, a // c, al // c), 2048, m, pad4(16 * 8 * v))
              + v * (al + 4) + pad4(v) + v * e + n * 4 * (u // c) + 2 * pad4(t) + pad4(a) + pad4(8 * v) + 64)
    return 4 * floats


def test_decoder_smem_bytes_at_the_checkpoint():
    """The checkpoint's shape (T_enc = 250, V = 26, two cells, C = 8): the
    old layout gave the 203,312 bytes the card reported before; the new
    one the 166,960 it reports now."""
    cfg = _speller(26, 2)
    assert FG.decoder_plan(64, cfg, 250).cluster == 8
    assert _old_layout_bytes(250, cfg, 8) == 203312
    assert FG.decoder_smem_bytes(64, 250, cfg, 8) == 166960


# (preset's speller, vocabulary, cells, the longest bucket's encoder length)
LONGEST = [("timit_phone_las", 65, 1, 400), ("timit_multitask grapheme head", 32, 1, 400),
           ("librispeech_char_las", 34, 2, 438), ("common_voice_binf", 120, 1, 438),
           ("librispeech_offline_infer", 34, 2, 438)]


@pytest.mark.parametrize("what,v,n_cells,t", LONGEST)
def test_every_preset_fits_the_decoder(what, v, n_cells, t):
    """Each preset's longest bucket fits a block at the cluster size the
    held layout's plan picks (``layout="held"``; the plan itself may take
    the grid layout where the step model says it is faster); the phone
    vocabularies (65, 120) did not fit the old layout at any cluster size
    (fault C6)."""
    cfg = _speller(v, n_cells)
    plan = FG.decoder_plan(256, cfg, t, "held")
    assert plan.cluster == 8
    assert FG.decoder_smem_bytes(256, t, cfg, plan.cluster) <= FG.SMEM_MAX
    assert (_old_layout_bytes(t, cfg, 8) > FG.SMEM_MAX) == (v >= 65)


@pytest.mark.parametrize("v,n_cells,t", [(2881, 2, 438), (2913, 1, 438), (120, 1, 17161), (34, 2, 17005)])
def test_decoder_plan_refuses_what_no_cluster_fits(v, n_cells, t):
    """Past the largest vocabulary (480 with two cells, 640 with one at
    T_enc = 438) and the longest encoder sequence (9064 at V = 120, 7900 at
    V = 34) whose held layout a block holds, no cluster size fits: the plan
    takes the grid layout, which holds nothing that grows with V or T, and
    one less stays held at C = 8. So does every shape past those limits,
    such as these four (once past every cluster layout's limits)."""
    cfg = _speller(v, n_cells)
    assert all(FG.decoder_smem_bytes(8, t, cfg, c) > FG.SMEM_MAX for c in FG.DECODER_CLUSTERS)
    assert FG.decoder_plan(8, cfg, t) == FG.DecoderPlan(1, 8, 1, grid=FG.grid_cuts(8, cfg))
    if t < 1000:
        limit = {2: 480, 1: 640}[n_cells]
        edge = [_speller(limit, n_cells), _speller(limit + 1, n_cells)]
        tt = [t, t]
    else:
        limit = {120: 9064, 34: 7900}[v]
        edge, tt = [cfg, cfg], [limit, limit + 1]
    assert FG.decoder_plan(8, edge[0], tt[0], "held") == FG.DecoderPlan(8, 8, 1)
    assert FG.decoder_plan(8, edge[1], tt[1]).layout == 1
    with pytest.raises(ValueError, match="no held layout"):
        FG.decoder_plan(8, edge[1], tt[1], "held")


def test_decoder_smem_bytes_shrinks_with_the_cluster():
    """The vocabulary, cells and dense stages are sliced over the cluster,
    so a larger cluster never takes more shared memory: the plan's first
    fitting size is the largest that fits."""
    for v, n_cells in ((26, 2), (65, 1), (120, 1), (480, 2)):
        cfg = _speller(v, n_cells)
        sizes = [FG.decoder_smem_bytes(1, 438, cfg, c) for c in FG.DECODER_CLUSTERS]
        assert sizes == sorted(sizes)
