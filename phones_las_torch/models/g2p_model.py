"""Seq2seq grapheme → phoneme model (port of
``phones_las_tpu/models/g2p_model.py``).

A character-level LAS whose audio front-end is a character embedding:
char embedding → a 1-layer BiLSTM listener (no pyramid: words are short)
→ the attention speller over IPA phone tokens. It is the production
encoder and decoder at other widths, so on the card a lookup launches the
BiLSTM kernel (``bidir_recurrence``) and, greedy, the fused decoder
(``greedy_decode_fused``); training launches the residual forward and the
VJP (``recurrence_residual``, ``recurrence_bwd``).

Trained on the bundled expanded lexicon (``data/lexicon_en.py``, about
2.2k word/pronunciation pairs) with dev early stopping; the shipped model
(``phones_las_tpu/assets/g2p_en.npz``, read by path with numpy alone) is
gated on the 70 held-out gold words at PER ≤ 0.05. ``NeuralG2P`` serves
plain alphabetic words; ``data.g2p.text_to_ipa`` keeps the rule tables
for everything else.

The weight file is positional: ``p0 … p16`` in the reference's
``jax.tree.leaves`` order, which ``named_leaves`` writes down (absent
leaves, such as the attention's ``g``, are no leaf). Initialisation draws
from an explicit ``torch.Generator``: its bits cannot match JAX's, so the
training loop ``_train_from`` starts from given params and the tests start
both packages from JAX's init.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from phones_las_torch.data.vocab import Vocab
from phones_las_torch.models.listener import ListenerConfig, ListenerParams, init_listener, listen
from phones_las_torch.models.speller import SpellerConfig, SpellerParams, init_speller, teacher_forced_decode
from phones_las_torch.ops.masking import length_mask
from phones_las_torch.utils.device import DeviceLike, matmul_precision_scope, resolve_device

G2P_CHARS = list("abcdefghijklmnopqrstuvwxyz'-")
BUNDLED = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "phones_las_tpu", "assets", "g2p_en.npz",
)


def char_vocab() -> Vocab:
    return Vocab(G2P_CHARS)


@dataclasses.dataclass(frozen=True)
class G2PConfig:
    char_vocab_size: int
    phone_vocab_size: int
    char_embed_dim: int = 64
    units: int = 128
    bos_id: int = Vocab.sos_id
    eos_id: int = Vocab.eos_id

    @property
    def listener(self) -> ListenerConfig:
        # one layer, no pyramid: every character position stays addressable
        return ListenerConfig(input_dim=self.char_embed_dim, num_layers=1, units=self.units)

    @property
    def speller(self) -> SpellerConfig:
        return SpellerConfig(
            vocab_size=self.phone_vocab_size,
            embedding_dim=self.char_embed_dim,
            num_layers=1,
            units=self.units,
            memory_dim=2 * self.units,
            attention_type="bahdanau",
            attention_units=self.units,
            attention_layer_size=self.units,
            bos_id=self.bos_id,
            eos_id=self.eos_id,
        )


class G2PParams(nn.Module):
    """Char embedding [C, E], listener and speller, the reference's layout."""

    def __init__(self, cfg: G2PConfig, device=None):
        super().__init__()
        self.char_embed = nn.Parameter(
            torch.zeros((cfg.char_vocab_size, cfg.char_embed_dim), device=device), requires_grad=False
        )
        self.listener = ListenerParams(cfg.listener, device)
        self.speller = SpellerParams(cfg.speller, device)


def named_leaves(params: G2PParams) -> Iterator[Tuple[str, torch.Tensor]]:
    """(JAX keystr path, tensor) of every leaf in ``jax.tree.leaves``
    order of the reference's ``G2PParams``: the order of ``p0 … p16``."""
    from phones_las_torch.utils.param_io import _lstm_leaves, _speller_leaves

    yield ".char_embed", params.char_embed
    for l, (pf, pb) in enumerate(params.listener.layers):
        yield from _lstm_leaves(pf, f".listener.layers[{l}][0]")
        yield from _lstm_leaves(pb, f".listener.layers[{l}][1]")
    yield from _speller_leaves(params.speller, ".speller")


def init_g2p(cfg: G2PConfig, generator: torch.Generator, device: DeviceLike = None) -> G2PParams:
    """Random model with the reference's initialisers (char embedding
    N(0, 1/E), then ``init_listener`` and ``init_speller``), drawn on the
    CPU from ``generator`` and placed on ``device`` (None → CUDA)."""
    dev = resolve_device(device)
    p = G2PParams(cfg, dev)
    with torch.no_grad():
        p.char_embed.copy_(
            torch.randn(tuple(p.char_embed.shape), generator=generator) / np.sqrt(cfg.char_embed_dim)
        )
    p.listener = init_listener(cfg.listener, generator, dev)
    p.speller = init_speller(cfg.speller, generator, device=dev)
    return p


def encode_chars(params: G2PParams, cfg: G2PConfig, chars: torch.Tensor, lengths: torch.Tensor):
    """[B, S] char ids → (memory [B, S, 2U], enc_mask [B, S], 1.0 at valid
    positions, as ``models.las.encode`` gives it)."""
    emb = params.char_embed[chars.long()]
    memory, lens = listen(params.listener, cfg.listener, emb, lengths)
    return memory, length_mask(lens, memory.shape[1], memory.dtype)


def g2p_loss(params: G2PParams, cfg: G2PConfig, batch: Dict[str, torch.Tensor],
             label_smoothing: float = 0.0) -> torch.Tensor:
    """Masked cross-entropy of the teacher-forced phone logits, with
    uniform label smoothing (the mask includes the <eos> slot)."""
    memory, mask = encode_chars(params, cfg, batch["chars"], batch["char_lengths"])
    targets, tlens = batch["phones"].long(), batch["phone_lengths"]
    b, l = targets.shape
    sos = torch.full((b, 1), cfg.bos_id, dtype=targets.dtype, device=targets.device)
    dec_in = torch.cat([sos, targets[:, :-1]], dim=1)
    logits, _, _ = teacher_forced_decode(params.speller, cfg.speller, dec_in, memory, mask)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll - label_smoothing * logp.mean(-1)
    tmask = (torch.arange(l, device=targets.device)[None, :] < tlens[:, None].to(targets.device)).float()
    return (nll * tmask).sum() / torch.clamp_min(tmask.sum(), 1.0)


def _pad_batch(vocab_c: Vocab, vocab_p: Vocab, items: Sequence[Tuple[str, Tuple[str, ...]]],
               max_word: int, max_pron: int) -> Dict[str, np.ndarray]:
    b = len(items)
    chars = np.zeros((b, max_word), np.int32)
    clens = np.zeros(b, np.int32)
    phones = np.full((b, max_pron), vocab_p.eos_id, np.int32)
    plens = np.zeros(b, np.int32)
    for i, (word, pron) in enumerate(items):
        c = vocab_c.encode(list(word))[:max_word]
        chars[i, : len(c)] = c
        clens[i] = len(c)
        p = vocab_p.encode(list(pron))[: max_pron - 1]
        phones[i, : len(p)] = p
        plens[i] = len(p) + 1  # learn the <eos> too
    return {"chars": chars, "char_lengths": clens, "phones": phones, "phone_lengths": plens}


def _eval_per(params, cfg, vocab_c, vocab_p, dev_items) -> float:
    from phones_las_torch.utils.metrics import _edit_distance

    hyps = predict(params, cfg, vocab_c, vocab_p, [w for w, _ in dev_items], beam_width=1)
    dist = total = 0
    for (_, ref), hyp in zip(dev_items, hyps):
        dist += _edit_distance(vocab_p.encode(hyp), vocab_p.encode(ref))
        total += len(ref)
    return dist / max(total, 1)


def g2p_setup(lexicon: Dict[str, Tuple[str, ...]], units: int = 128) -> Tuple[G2PConfig, Vocab, Vocab]:
    """The config and vocabularies ``train_g2p`` builds for a lexicon."""
    vocab_c = char_vocab()
    vocab_p = Vocab(sorted({p for pron in lexicon.values() for p in pron}))
    cfg = G2PConfig(char_vocab_size=len(vocab_c), phone_vocab_size=len(vocab_p), units=units)
    return cfg, vocab_c, vocab_p


def train_g2p(
    lexicon: Dict[str, Tuple[str, ...]],
    *,
    steps: int = 1500,
    batch_size: int = 256,
    learning_rate: float = 2e-3,
    label_smoothing: float = 0.1,
    units: int = 128,
    dev_fraction: float = 0.05,
    eval_every: int = 150,
    seed: int = 0,
    log_every: int = 0,
    log: Callable[[str], None] = print,
    device: DeviceLike = None,
) -> Tuple[G2PParams, G2PConfig, Vocab, Vocab]:
    """Train on a word → pronunciation dict on ``device`` (None → CUDA)
    → (params, config, char vocab, phone vocab).

    ``dev_fraction`` of the lexicon is held out; the returned params are
    those of the best dev PER (early stopping: the lexicon memorises in a
    few hundred steps, after which generalisation degrades)."""
    cfg, vocab_c, vocab_p = g2p_setup(lexicon, units)
    params = init_g2p(cfg, torch.Generator().manual_seed(seed), device)
    params, _ = _train_from(
        params, cfg, vocab_c, vocab_p, lexicon, steps=steps, batch_size=batch_size,
        learning_rate=learning_rate, label_smoothing=label_smoothing, dev_fraction=dev_fraction,
        eval_every=eval_every, seed=seed, log_every=log_every, log=log,
    )
    return params, cfg, vocab_c, vocab_p


def _train_from(
    params: G2PParams,
    cfg: G2PConfig,
    vocab_c: Vocab,
    vocab_p: Vocab,
    lexicon: Dict[str, Tuple[str, ...]],
    *,
    steps: int,
    batch_size: int,
    learning_rate: float,
    label_smoothing: float,
    dev_fraction: float,
    eval_every: int,
    seed: int,
    log_every: int = 0,
    log: Callable[[str], None] = print,
) -> Tuple[G2PParams, List[float]]:
    """The training loop of ``train_g2p`` from given ``params`` (trained in
    place, on their device) → (the params to keep, each step's loss).

    Draws as the reference does: ``RandomState(seed)``'s permutation for
    the dev split, then one ``randint(0, n, batch_size)`` a step. The
    optimizer is optax's ``chain(clip_by_global_norm(1.0), adam(lr))``
    written out (``train/state.py``). Every ``eval_every`` steps the greedy
    ``predict`` scores the dev split (on the card: the fused decoder
    kernel) and the best dev PER's params are kept."""
    from phones_las_torch.train.state import Optimizer, TrainConfig, apply_updates

    items = sorted(lexicon.items())
    rng = np.random.RandomState(seed)
    if dev_fraction > 0.0:
        perm = rng.permutation(len(items))
        n_dev = max(int(len(items) * dev_fraction), 1)
        dev_items = [items[i] for i in perm[:n_dev]]
        items = [items[i] for i in perm[n_dev:]]
    else:
        dev_items = []
    max_word = max(len(w) for w, _ in items)
    max_pron = max(len(p) for _, p in items) + 1  # +<eos>

    dev = params.char_embed.device
    leaves = [t for _, t in named_leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    opt = Optimizer(TrainConfig(learning_rate=learning_rate, clip_norm=1.0))
    opt_state = opt.init(leaves)
    n = len(items)
    best_per, best = float("inf"), None
    losses = []
    with matmul_precision_scope("highest"):
        for s in range(steps):
            idx = rng.randint(0, n, batch_size)
            batch = _pad_batch(vocab_c, vocab_p, [items[i] for i in idx], max_word, max_pron)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            with torch.enable_grad():
                loss = g2p_loss(params, cfg, batch, label_smoothing)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)]
            updates, opt_state = opt.update(grads, opt_state)
            apply_updates(leaves, updates)
            losses.append(loss.detach())
            if dev_items and (s + 1) % eval_every == 0:
                per = _eval_per(params, cfg, vocab_c, vocab_p, dev_items)
                if per < best_per:
                    best_per, best = per, [t.detach().clone() for t in leaves]
                if log_every:
                    log(f"g2p step {s + 1}: loss {float(loss.detach()):.4f} dev_per {per:.4f} best {best_per:.4f}")
            elif log_every and (s + 1) % log_every == 0:
                log(f"g2p step {s + 1}: loss {float(loss.detach()):.4f}")
    with torch.no_grad():
        if best is not None:
            for t, b in zip(leaves, best):
                t.copy_(b)
    for t in leaves:
        t.requires_grad_(False)
    return params, [float(x) for x in losses]


def predict(
    params: G2PParams, cfg: G2PConfig, vocab_c: Vocab, vocab_p: Vocab,
    words: Sequence[str], *, beam_width: int = 4, max_steps: int = 24,
    pad_words_to: Optional[int] = None, length_penalty: float = 0.0,
) -> List[List[str]]:
    """Words → IPA token lists on the params' device (beam search; greedy,
    on the card the fused decoder kernel, if the width is ≤ 1).
    ``pad_words_to`` fixes the char axis, as the reference pads it."""
    from phones_las_torch.decode.beam import beam_decode
    from phones_las_torch.decode.greedy import greedy_decode

    b = len(words)
    max_word = pad_words_to or max(max(len(w) for w in words), 2)
    chars = np.zeros((b, max_word), np.int32)
    clens = np.zeros(b, np.int32)
    for i, w in enumerate(words):
        c = vocab_c.encode(list(w))[:max_word]
        chars[i, : len(c)] = c
        clens[i] = len(c)
    dev = params.char_embed.device
    with torch.no_grad(), matmul_precision_scope("highest"):
        memory, mask = encode_chars(params, cfg, torch.from_numpy(chars).to(dev), torch.from_numpy(clens).to(dev))
        if beam_width > 1:
            res = beam_decode(params.speller, cfg.speller, memory, mask, max_steps,
                              beam_width=beam_width, length_penalty=length_penalty)
            tokens, lengths = res.tokens, res.lengths
        else:
            tokens, lengths, _ = greedy_decode(params.speller, cfg.speller, memory, mask, max_steps)
    tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
    return [vocab_p.decode(tokens[i, : lengths[i]]) for i in range(b)]


class NeuralG2P:
    """Trained-model front for ``data.g2p.text_to_ipa``: handles plain
    alphabetic words in fixed-shape cached batches (64 words × 28 chars,
    the padded rows the word "a"); anything with characters outside the
    model's alphabet is left to the rule tables (the caller decides)."""

    _PAD_WORD = 28
    _PAD_BATCH = 64

    def __init__(self, path: str, *, beam_width: int = 4, device: DeviceLike = None):
        self.params, self.cfg, self.vocab_c, self.vocab_p = load_g2p(path, device)
        self.beam_width = beam_width
        self._cache: Dict[str, List[str]] = {}
        self._alpha = set(G2P_CHARS)

    @classmethod
    def bundled(cls, **kw) -> "NeuralG2P":
        """The shipped EN model, ``phones_las_tpu/assets/g2p_en.npz``
        (trained on the expanded lexicon with dev early stopping; gold-set
        PER 0.048 against the rule tables' ≈ 0.06)."""
        return cls(BUNDLED, **kw)

    def handles(self, word: str) -> bool:
        return bool(word) and len(word) <= self._PAD_WORD and all(c in self._alpha for c in word)

    def lookup(self, words: Sequence[str]) -> Dict[str, List[str]]:
        """Transcribe (with caching) the subset of ``words`` the model
        handles → word → IPA tokens."""
        todo = sorted({w for w in words if self.handles(w)} - set(self._cache))
        for i in range(0, len(todo), self._PAD_BATCH):
            chunk = todo[i : i + self._PAD_BATCH]
            padded = chunk + ["a"] * (self._PAD_BATCH - len(chunk))
            outs = predict(self.params, self.cfg, self.vocab_c, self.vocab_p, padded,
                           beam_width=self.beam_width, pad_words_to=self._PAD_WORD)
            for w, o in zip(chunk, outs):
                self._cache[w] = o
        return {w: self._cache[w] for w in words if w in self._cache}


# ---------------------------------------------------------------------------
# npz serialisation (one file: vocabularies, widths and p0 … pN)
# ---------------------------------------------------------------------------


def save_g2p(path: str, params: G2PParams, cfg: G2PConfig, vocab_c: Vocab, vocab_p: Vocab) -> None:
    """Write the reference's format, which its ``load_g2p`` reads."""
    flat = {f"p{i}": t.detach().cpu().numpy() for i, (_, t) in enumerate(named_leaves(params))}
    np.savez(
        path,
        chars="\n".join(vocab_c.tokens),
        phones="\n".join(vocab_p.tokens),
        char_embed_dim=cfg.char_embed_dim,
        units=cfg.units,
        **flat,
    )


def load_g2p(path: str, device: DeviceLike = None) -> Tuple[G2PParams, G2PConfig, Vocab, Vocab]:
    """Read a model file (the reference's or ``save_g2p``'s) with numpy
    alone onto ``device`` (None → CUDA). A missing file, or leaves that are
    missing, extra or misshapen, raise."""
    dev = resolve_device(device)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no G2P model at {path}")
    with np.load(path, allow_pickle=False) as z:
        vocab_c = Vocab(str(z["chars"]).split("\n")[4:])  # specials re-added
        vocab_p = Vocab(str(z["phones"]).split("\n")[4:])
        cfg = G2PConfig(
            char_vocab_size=len(vocab_c), phone_vocab_size=len(vocab_p),
            char_embed_dim=int(z["char_embed_dim"]), units=int(z["units"]),
        )
        flat = {k: z[k] for k in z.files if k.startswith("p") and k[1:].isdigit()}
    params = G2PParams(cfg, dev)
    leaves = list(named_leaves(params))
    if len(flat) != len(leaves):
        raise ValueError(f"{path}: {len(flat)} leaves, the model of its widths has {len(leaves)}")
    from phones_las_torch.utils.param_io import copy_arrays_

    try:
        copy_arrays_([(f"p{i}", t) for i, (_, t) in enumerate(leaves)], flat)
    except (KeyError, ValueError) as e:
        raise ValueError(f"{path}: {e}") from e
    return params.eval(), cfg, vocab_c, vocab_p
