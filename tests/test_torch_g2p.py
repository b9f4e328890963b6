"""The port's G2P against the JAX package's: the rule tables and the
lexicon (equal), the seq2seq model on the bundled weights (encoder within
1e-5, the label-smoothed loss and every gradient leaf within 1e-4 of
``jax.value_and_grad``, tokens equal at beam 4 and greedy on the 70 gold
words, gold PER ≤ 0.05), ``NeuralG2P`` and ``text_to_ipa(model=...)``, the
model file bitwise in both directions with its positional leaf order, and
training: 5 steps from JAX's own init within 1e-5 of every leaf."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from phones_las_tpu.data import g2p as jax_g2p
from phones_las_tpu.data import lexicon_en as jax_lexicon
from phones_las_tpu.models import g2p_model as J

from phones_las_torch.data import g2p, lexicon_en
from phones_las_torch.models import g2p_model as P
from phones_las_torch.utils.metrics import _edit_distance
from tests.test_g2p_coverage import _EN_GOLD
from tests.torch_threads import one_thread

one_thread()

ENCODE_TOL = 1e-5
LOSS_TOL = 1e-4  # the loss, and each gradient leaf's max |d| over its max |g_jax|
TRAIN_TOL = 1e-5  # each leaf after 5 steps, max |d|
ADAM_FLAT = 1e-7  # gradient elements in Adam's eps region (see the training test)
SENTENCES = [
    "Hello, world! The quick brown fox jumps over the lazy dog.",
    "Buenos días, señor; ¿cómo está usted? Ciao bella, perché no.",
    "Schöne Grüße aus München — straße, über, Bäume.",
    "L'été dernier, le garçon a mangé des crêpes à Noël.",
    "Bom dia, coração; não há pão. Goede morgen wereld, ijs.",
    "Dzień dobry, świecie! Günaydın dünya. Доброе утро, мир.",
    "It's 42 degrees in the station's nation-state; knights write psalms.",
]


@pytest.fixture(scope="module")
def bundled():
    """The shipped model in both packages: (JAX params, cfg, vocabs), the
    port's CPU ``NeuralG2P`` and JAX's."""
    jp, jcfg, jvc, jvp = J.load_g2p(P.BUNDLED)
    return {"jax": (jp, jcfg, jvc, jvp), "torch": P.NeuralG2P.bundled(device="cpu"),
            "jax_model": J.NeuralG2P.bundled()}


def _jax_leaves(params):
    return [np.asarray(x) for x in jax.tree.leaves(params)]


def _per(hyp, ref):
    ids = {t: i for i, t in enumerate(dict.fromkeys(list(hyp) + list(ref)))}
    return _edit_distance([ids[t] for t in hyp], [ids[t] for t in ref])


# ---- the rule tables and the lexicon


def test_lexicon_like_jax():
    lex = lexicon_en.expanded_lexicon()
    assert lex == jax_lexicon.expanded_lexicon() and len(lex) > 2000
    assert lexicon_en.lexicon_phone_inventory() == jax_lexicon.lexicon_phone_inventory()
    assert lexicon_en._GOLD_WORDS == jax_lexicon._GOLD_WORDS and not (set(lex) & lexicon_en._GOLD_WORDS)
    assert g2p._EN_LEXICON == jax_g2p._EN_LEXICON
    assert g2p.supported_languages() == jax_g2p.supported_languages()


@pytest.mark.parametrize("breaks", [False, True], ids=["words", "breaks"])
@pytest.mark.parametrize("lang", jax_g2p.supported_languages() + ["xx"])
def test_text_to_ipa_like_jax(lang, breaks):
    """Every language's rules (an unknown code takes English's) on a fixed
    sentence set in several scripts, with and without word breaks."""
    for s in SENTENCES:
        assert g2p.normalize_text(s) == jax_g2p.normalize_text(s)
        assert (g2p.text_to_ipa(s, lang, insert_word_breaks=breaks)
                == jax_g2p.text_to_ipa(s, lang, insert_word_breaks=breaks)), (lang, s)


def test_word_to_ipa_like_jax_on_every_lexicon_word():
    """The English letter-to-sound rules (suffix guards, magic e, regex
    context) on every word of the expanded lexicon and the gold set."""
    words = sorted(set(jax_lexicon.expanded_lexicon()) | set(_EN_GOLD))
    got = [g2p.word_to_ipa(w, g2p._EN_RULES) for w in words]
    want = [jax_g2p.word_to_ipa(w, jax_g2p._EN_RULES) for w in words]
    assert got == want


# ---- the model on the bundled weights


def test_leaf_order_matches_tree_flatten_with_path(bundled):
    """``named_leaves`` is the reference's ``jax.tree.leaves`` order (the
    order of p0 … p16), by path and shape, at the bundled widths and a
    small one."""
    for cfg in (bundled["jax"][1], J.G2PConfig(char_vocab_size=32, phone_vocab_size=12, char_embed_dim=8, units=8)):
        jleaves = jax.tree_util.tree_flatten_with_path(J.init_g2p(jax.random.PRNGKey(0), cfg))[0]
        pcfg = P.G2PConfig(**{f: getattr(cfg, f) for f in ("char_vocab_size", "phone_vocab_size", "char_embed_dim",
                                                            "units", "bos_id", "eos_id")})
        mine = [(k, tuple(t.shape)) for k, t in P.named_leaves(P.G2PParams(pcfg, "cpu"))]
        assert mine == [(jax.tree_util.keystr(k), tuple(x.shape)) for k, x in jleaves]
    assert len(mine) == 17


def test_encode_chars_like_jax(bundled):
    jp, jcfg, jvc, _ = bundled["jax"]
    m = bundled["torch"]
    words = sorted(_EN_GOLD)[:20] + ["a", "supercalifragilisticexpialid"]
    batch = J._pad_batch(jvc, m.vocab_p, [(w, ()) for w in words], 28, 2)
    mem, mask = J.encode_chars(jp, jcfg, jnp.asarray(batch["chars"]), jnp.asarray(batch["char_lengths"]))
    pmem, pmask = P.encode_chars(m.params, m.cfg, torch.from_numpy(batch["chars"]),
                                 torch.from_numpy(batch["char_lengths"]))
    np.testing.assert_array_equal(pmask.numpy() > 0, np.asarray(mask))
    np.testing.assert_allclose(pmem.numpy(), np.asarray(mem), atol=ENCODE_TOL, rtol=0)


def test_loss_and_gradients_like_jax(bundled):
    """The label-smoothed loss and each gradient leaf on a padded batch of
    16 lexicon words against ``jax.value_and_grad``."""
    jp, jcfg, jvc, jvp = bundled["jax"]
    m = bundled["torch"]
    lex = sorted(jax_lexicon.expanded_lexicon().items())
    items = [lex[i] for i in np.random.RandomState(3).randint(0, len(lex), 16)]
    batch = J._pad_batch(jvc, jvp, items, max(len(w) for w, _ in items), max(len(p) for _, p in items) + 1)
    loss, grads = jax.value_and_grad(J.g2p_loss)(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, 0.1)
    params, _, _, _ = P.load_g2p(P.BUNDLED, device="cpu")
    for t in params.parameters():
        t.requires_grad_(True)
    ploss = P.g2p_loss(params, m.cfg, {k: torch.from_numpy(v) for k, v in batch.items()}, 0.1)
    pgrads = torch.autograd.grad(ploss, [t for _, t in P.named_leaves(params)])
    assert abs(float(ploss.detach()) - float(loss)) <= LOSS_TOL * abs(float(loss))
    for (name, _), g, jg in zip(P.named_leaves(params), pgrads, _jax_leaves(grads)):
        scale = max(float(np.abs(jg).max()), 1e-30)
        assert float(np.abs(g.numpy() - jg).max()) <= LOSS_TOL * scale, name


@pytest.fixture(scope="module")
def gold_tokens(bundled):
    """The 70 gold words through both packages' ``predict``, greedy and at
    beam 4: {width: (JAX's, the port's)}."""
    jp, jcfg, jvc, jvp = bundled["jax"]
    m = bundled["torch"]
    words = list(_EN_GOLD)
    return {bw: (J.predict(jp, jcfg, jvc, jvp, words, beam_width=bw),
                 P.predict(m.params, m.cfg, m.vocab_c, m.vocab_p, words, beam_width=bw)) for bw in (1, 4)}


@pytest.mark.parametrize("beam_width", [1, 4], ids=["greedy", "beam4"])
def test_predict_like_jax_on_gold(gold_tokens, beam_width):
    want, got = gold_tokens[beam_width]
    assert got == want


def test_gold_per_through_the_port(bundled):
    """A mirror of ``test_seq2seq_g2p_beats_rules_on_gold``: PER ≤ 0.05 and
    ≥ 80 % of words exact, through ``NeuralG2P.lookup`` (64 × 28 padding)."""
    hyps = bundled["torch"].lookup(list(_EN_GOLD))
    dist = total = exact = 0
    for word, gold in _EN_GOLD.items():
        ref = gold.split()
        dist += _per(hyps[word], ref)
        total += len(ref)
        exact += hyps[word] == ref
    assert dist / total <= 0.05 and exact / len(_EN_GOLD) >= 0.8, (dist, total, exact)
    assert hyps == bundled["jax_model"].lookup(list(_EN_GOLD))


def test_neural_g2p_handles_and_caching(bundled):
    m = bundled["torch"]
    assert m.handles("hello") and not m.handles("42") and not m.handles("") and not m.handles("a" * 29)
    out1 = m.lookup(["hello", "42"])
    assert "hello" in out1 and "42" not in out1
    cached = m._cache["hello"]
    assert m.lookup(["hello"])["hello"] is cached
    assert out1 == bundled["jax_model"].lookup(["hello", "42"])


@pytest.mark.parametrize("text", ["two", "stations", "42", "the stations of 42 xylophones"])
def test_text_to_ipa_with_the_model_like_jax(bundled, text):
    """Lexicon first, the model for alphabetic out-of-lexicon words, the
    rules for what the model cannot handle: the three cases of
    ``test_seq2seq_g2p_integrates_with_text_to_ipa`` and one sentence."""
    got = g2p.text_to_ipa(text, "en", model=bundled["torch"])
    assert got == jax_g2p.text_to_ipa(text, "en", model=bundled["jax_model"])
    if text == "two":
        assert got == list(g2p._EN_LEXICON["two"])
    if text == "42":
        assert got == g2p.text_to_ipa("42", "en")


def test_zero_phone_prediction_falls_back_to_rules():
    class Empty:
        def lookup(self, words):
            return {w: [] for w in words}

    assert g2p.text_to_ipa("blorf", "en", model=Empty()) == g2p.word_to_ipa("blorf", g2p._EN_RULES)


def test_model_file_bitwise_across_packages(bundled, tmp_path):
    """The port's ``save_g2p`` read by JAX's ``load_g2p`` and JAX's file read
    by the port, every leaf bitwise, config and vocabularies equal."""
    m = bundled["torch"]
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    P.save_g2p(ours, m.params, m.cfg, m.vocab_c, m.vocab_p)
    jp, jcfg, jvc, jvp = J.load_g2p(ours)
    assert dataclasses_equal(jcfg, m.cfg) and jvc.tokens == m.vocab_c.tokens and jvp.tokens == m.vocab_p.tokens
    for (name, t), x in zip(P.named_leaves(m.params), _jax_leaves(jp)):
        np.testing.assert_array_equal(t.numpy(), x, err_msg=name)
    bp, bcfg, bvc, bvp = bundled["jax"]
    J.save_g2p(theirs, bp, bcfg, bvc, bvp)
    pp, pcfg, pvc, pvp = P.load_g2p(theirs, device="cpu")
    assert dataclasses_equal(bcfg, pcfg) and pvp.tokens == bvp.tokens
    for (name, t), x in zip(P.named_leaves(pp), _jax_leaves(bp)):
        np.testing.assert_array_equal(t.numpy(), x, err_msg=name)


def dataclasses_equal(a, b) -> bool:
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


def test_load_g2p_fails_loudly(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError, match="no G2P model"):
        P.load_g2p(str(tmp_path / "none.npz"), device="cpu")
    z = dict(np.load(P.BUNDLED))
    z.pop("p16")
    np.savez(tmp_path / "short.npz", **z)
    with pytest.raises(ValueError, match="16 leaves"):
        P.load_g2p(str(tmp_path / "short.npz"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.NeuralG2P.bundled()


# ---- training


def test_train_from_jax_init_like_jax():
    """Five steps of ``_train_from`` from JAX's ``init_g2p(PRNGKey(0))`` at
    U = 32, batch 8, against JAX's ``train_g2p`` (the same batches: the
    same ``RandomState`` draws): every leaf within 1e-5.

    Adam divides by ``sqrt(v) + 1e-8``: where a gradient element lies
    below ``ADAM_FLAT`` in magnitude, a rounding difference of 1e-10 moves
    the update by ~1e-5 (at g = 4.4e-9: lr·eps/(|g|+eps)² ≈ 1.4e5). Those
    elements (the first step's reference gradient below ``ADAM_FLAT``)
    are held to lr a step, the most Adam moves an element; every other
    element to 1e-5."""
    lex = jax_lexicon.expanded_lexicon()
    jp, jcfg, jvc, jvp = J.train_g2p(lex, steps=5, batch_size=8, units=32, dev_fraction=0.0)
    cfg, vc, vp = P.g2p_setup(lex, units=32)
    assert dataclasses_equal(cfg, jcfg) and vp.tokens == jvp.tokens
    j0 = J.init_g2p(jax.random.PRNGKey(0), jcfg)
    items = sorted(lex.items())
    first = J._pad_batch(jvc, jvp, [items[i] for i in np.random.RandomState(0).randint(0, len(items), 8)],
                         max(len(w) for w, _ in items), max(len(p) for _, p in items) + 1)
    g1 = _jax_leaves(jax.grad(J.g2p_loss)(j0, jcfg, {k: jnp.asarray(v) for k, v in first.items()}, 0.1))
    params = P.G2PParams(cfg, "cpu")
    with torch.no_grad():
        for (_, t), x in zip(P.named_leaves(params), _jax_leaves(j0)):
            t.copy_(torch.from_numpy(x.copy()))
    params, losses = P._train_from(params, cfg, vc, vp, lex, steps=5, batch_size=8, learning_rate=2e-3,
                                   label_smoothing=0.1, dev_fraction=0.0, eval_every=150, seed=0)
    assert len(losses) == 5 and all(np.isfinite(losses))
    for (name, t), x, g in zip(P.named_leaves(params), _jax_leaves(jp), g1):
        d = np.abs(t.detach().numpy() - x)
        flat = np.abs(g) < ADAM_FLAT
        assert float(d[~flat].max()) <= TRAIN_TOL, name
        assert float(d.max(initial=0.0)) <= 2e-3 * 5, name


def test_train_g2p_learns_a_toy_mapping():
    words = ["ab", "ba", "aab", "bab", "abb", "aa", "bb", "ab'a"]
    lex = {w: tuple(c for c in w if c != "'") for w in words}
    params, cfg, vc, vp = P.train_g2p(lex, steps=60, batch_size=8, dev_fraction=0.0, label_smoothing=0.0,
                                      device="cpu")
    assert P.predict(params, cfg, vc, vp, ["ab", "ba"], beam_width=1) == [["a", "b"], ["b", "a"]]


def test_train_g2p_keeps_the_best_dev_params(monkeypatch):
    """Early stopping: the params of the best dev PER are returned, not the
    last ones."""
    lex = {w: tuple(w) for w in ["ab", "ba", "aab", "bab", "abb", "aa", "bb", "ba'b", "abab", "baba"]}
    pers = iter([0.5, 0.2, 0.4])
    snaps = []

    def fake_eval(params, *a):
        snaps.append([t.detach().clone() for _, t in P.named_leaves(params)])
        return next(pers)

    monkeypatch.setattr(P, "_eval_per", fake_eval)
    params, _, _, _ = P.train_g2p(lex, steps=3, batch_size=4, units=8, dev_fraction=0.2, eval_every=1,
                                  device="cpu")
    for (name, t), s in zip(P.named_leaves(params), snaps[1]):
        assert torch.equal(t, s), name
