"""Speech-like synthetic corpus: formant-synthesized phones (a copy of
``phones_las_tpu/data/speechlike.py``, so the port imports nothing of the
JAX package; the same seeds give bitwise the same audio and targets).

The tone corpus (``data/synthetic.py``) answers "does training work" but
is spectrally separable, so accuracy features (SpecAugment, LM fusion,
beam search, checkpoint averaging) can only validate as no-ops on it.
This corpus is built to be *discriminative* — hard enough that those
features show measured deltas (round-2 VERDICT item 1):

  * **formant synthesis**: vowels/sonorants are additive harmonic
    synthesis (glottal source at f0, amplitudes shaped by 3 formant
    resonances + spectral tilt); fricatives are FFT-band-shaped noise;
    stops are closure + place-colored burst (+ aspiration when
    voiceless). Neighboring phone classes genuinely overlap in spectrum.
  * **coarticulation**: formant tracks interpolate across segment
    boundaries, and vowel edges bend toward the adjacent consonant's
    locus — consonant identity is partly encoded in the *transitions*,
    exactly the cue structure real speech has.
  * **phonotactics**: phone sequences come from a nonuniform syllable
    grammar (onset–nucleus–coda with Zipfian phone weights and a seeded
    Dirichlet bigram affinity) — an n-gram LM trained on the transcripts
    has real signal, so shallow fusion can help.
  * **speaker variation**: per-utterance f0 (log-uniform 90–240 Hz with
    declination + jitter), vocal-tract length scaling of all formants
    (0.85–1.18), and loudness.
  * **additive noise** at per-utterance SNR drawn from a configurable
    range (default 8–30 dB).

Phones are real IPA symbols, so ``data/ipa.py`` binf features apply and
the binf presets are meaningful here too.

No reference equivalent (SURVEY.md §5 item 3 only asks for a learnable
corpus) — this is evidence infrastructure for the accuracy A/Bs in
docs/ACCURACY.md.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from phones_las_torch.data.records import RecordWriter, Utterance
from phones_las_torch.data.vocab import Vocab

SAMPLE_RATE = 16000
_FRAME_MS = 5  # formant/amplitude track granularity


# ---------------------------------------------------------------------------
# Phone inventory: IPA symbol → synthesis spec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PhoneSpec:
    kind: str  # 'vowel' | 'glide' | 'nasal' | 'fric' | 'stop'
    formants: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # voiced targets
    locus: Tuple[float, float, float] = None  # consonant coarticulation locus
    noise_band: Tuple[float, float] = None  # fricative/burst band (Hz)
    voiced: bool = True
    dur_ms: Tuple[int, int] = (70, 160)
    gain: float = 1.0
    translit: str = ""  # ASCII spelling for grapheme targets


def _v(f1, f2, f3, translit, dur=(70, 170)):
    return PhoneSpec("vowel", (f1, f2, f3), dur_ms=dur, translit=translit)


# Peterson & Barney–style adult-male formant targets.
PHONE_SPECS: Dict[str, PhoneSpec] = {
    "i": _v(270, 2290, 3010, "i"),
    "e": _v(400, 2100, 2700, "e"),
    "ɛ": _v(530, 1840, 2480, "eh"),
    "a": _v(850, 1610, 2500, "a"),
    "ɑ": _v(730, 1090, 2440, "aa"),
    "ɔ": _v(570, 840, 2410, "ao"),
    "o": _v(430, 850, 2450, "o"),
    "u": _v(300, 870, 2240, "u"),
    # glides/liquids: vowel-like, shorter, own targets (ɹ's lowered F3 is
    # its signature cue)
    "j": PhoneSpec("glide", (280, 2200, 2950), dur_ms=(40, 80), translit="y"),
    "w": PhoneSpec("glide", (290, 700, 2200), dur_ms=(40, 80), translit="w"),
    "l": PhoneSpec("glide", (360, 1300, 2700), dur_ms=(50, 90), translit="l"),
    "r": PhoneSpec("glide", (350, 1200, 1600), dur_ms=(50, 90), translit="r"),
    # nasals: low murmur + damped highs, quieter
    "m": PhoneSpec("nasal", (250, 900, 2200), locus=(250, 800, 2200),
                   dur_ms=(50, 100), gain=0.45, translit="m"),
    "n": PhoneSpec("nasal", (250, 1400, 2500), locus=(350, 1800, 2700),
                   dur_ms=(50, 100), gain=0.45, translit="n"),
    # fricatives: band-shaped noise
    "s": PhoneSpec("fric", noise_band=(4200, 7800), voiced=False,
                   locus=(350, 1800, 2700), dur_ms=(60, 120), gain=0.5,
                   translit="s"),
    "ʃ": PhoneSpec("fric", noise_band=(2000, 5500), voiced=False,
                   locus=(300, 1900, 2600), dur_ms=(60, 120), gain=0.55,
                   translit="sh"),
    "f": PhoneSpec("fric", noise_band=(1000, 7800), voiced=False,
                   locus=(250, 1100, 2300), dur_ms=(55, 110), gain=0.25,
                   translit="f"),
    "h": PhoneSpec("fric", noise_band=(400, 2500), voiced=False,
                   locus=None, dur_ms=(40, 90), gain=0.3, translit="h"),
    # stops: closure + place-colored burst (+ aspiration when voiceless)
    "p": PhoneSpec("stop", noise_band=(500, 1500), voiced=False,
                   locus=(250, 800, 2200), dur_ms=(50, 90), translit="p"),
    "t": PhoneSpec("stop", noise_band=(3200, 6500), voiced=False,
                   locus=(350, 1800, 2700), dur_ms=(50, 90), translit="t"),
    "k": PhoneSpec("stop", noise_band=(1400, 3200), voiced=False,
                   locus=(300, 2300, 2400), dur_ms=(50, 90), translit="k"),
    "b": PhoneSpec("stop", noise_band=(400, 1200), voiced=True,
                   locus=(250, 800, 2200), dur_ms=(40, 80), translit="b"),
}

VOWELS = [p for p, s in PHONE_SPECS.items() if s.kind == "vowel"]
GLIDES = [p for p, s in PHONE_SPECS.items() if s.kind == "glide"]
CONSONANTS = [p for p, s in PHONE_SPECS.items()
              if s.kind in ("nasal", "fric", "stop")]


# inter-word silence marker (sentence mode): synthesized as silence,
# blocks coarticulation across the word boundary, never appears as a
# label and is not part of the phone inventory
PAUSE = "_"
_PAUSE_SPEC = PhoneSpec("pause", dur_ms=(60, 180), gain=0.0)


def _spec(phone: str) -> PhoneSpec:
    return _PAUSE_SPEC if phone == PAUSE else PHONE_SPECS[phone]


def speechlike_phone_inventory() -> List[str]:
    return sorted(PHONE_SPECS.keys())


def speechlike_grapheme_inventory() -> List[str]:
    chars = set("|")
    for s in PHONE_SPECS.values():
        chars.update(s.translit)
    return sorted(chars)


# ---------------------------------------------------------------------------
# Phonotactics: nonuniform syllable grammar with a seeded bigram affinity
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Phonotactics:
    """Syllable grammar (onset?)(glide?) nucleus (coda?) with Zipfian
    unigram weights and a Dirichlet consonant→vowel affinity — the
    nonuniform n-gram structure a fusion LM can learn."""

    onset_p: np.ndarray  # [C] P(onset = CONSONANTS[i])
    glide_p: np.ndarray  # [G] P(glide | glide present)
    nucleus_affinity: np.ndarray  # [C+1, V] P(nucleus | onset) (row 0 = none)
    coda_p: np.ndarray  # [C]
    p_onset: float = 0.85
    p_glide: float = 0.18
    p_coda: float = 0.35


def make_phonotactics(seed: int = 1234) -> Phonotactics:
    rng = np.random.RandomState(seed)
    c, g, v = len(CONSONANTS), len(GLIDES), len(VOWELS)

    def zipf(n):
        w = 1.0 / np.arange(1, n + 1) ** 1.1
        w = w[rng.permutation(n)]
        return w / w.sum()

    return Phonotactics(
        onset_p=zipf(c),
        glide_p=zipf(g),
        nucleus_affinity=rng.dirichlet(np.full(v, 0.35), size=c + 1),
        coda_p=zipf(c),
    )


def sample_sentence(
    rng: np.random.RandomState, model: Phonotactics,
    n_syllables_range=(2, 6),
    word_syllables: Optional[Tuple[int, int]] = None,
) -> List[str]:
    """``word_syllables=(lo, hi)`` enables sentence mode: syllables are
    grouped into words of lo–hi syllables with a ``PAUSE`` marker
    between words (long-utterance realism: silent gaps the attention
    alignment must skip)."""
    seq: List[str] = []
    syllables_left_in_word = (
        rng.randint(word_syllables[0], word_syllables[1] + 1)
        if word_syllables else -1
    )
    # inclusive bounds (numpy randint's upper bound is exclusive; the
    # CLI documents --syllables LO HI as a closed range, and LO == HI
    # must mean exactly LO, not a ValueError)
    for _ in range(rng.randint(n_syllables_range[0],
                               n_syllables_range[1] + 1)):
        if word_syllables and syllables_left_in_word == 0:
            seq.append(PAUSE)
            syllables_left_in_word = rng.randint(
                word_syllables[0], word_syllables[1] + 1
            )
        syllables_left_in_word -= 1
        onset_idx = 0
        if rng.rand() < model.p_onset:
            onset_idx = 1 + rng.choice(len(CONSONANTS), p=model.onset_p)
            seq.append(CONSONANTS[onset_idx - 1])
        if rng.rand() < model.p_glide:
            seq.append(GLIDES[rng.choice(len(GLIDES), p=model.glide_p)])
        seq.append(VOWELS[rng.choice(
            len(VOWELS), p=model.nucleus_affinity[onset_idx]
        )])
        if rng.rand() < model.p_coda:
            coda = CONSONANTS[rng.choice(len(CONSONANTS), p=model.coda_p)]
            # h is onset-only in most phonologies; keep codas closed-class
            if coda != "h":
                seq.append(coda)
    return seq


# ---------------------------------------------------------------------------
# Synthesis
# ---------------------------------------------------------------------------


def _formant_env(freqs: np.ndarray, formants: np.ndarray) -> np.ndarray:
    """Spectral envelope at ``freqs`` [.., H] for formant tracks
    ``formants`` [.., 3]: sum of Lorentzian resonances + −6 dB/oct tilt."""
    bw = np.array([90.0, 110.0, 170.0])  # formant bandwidths
    f = freqs[..., None, :]  # [.., 1, H]
    fc = formants[..., :, None]  # [.., 3, 1]
    res = 1.0 / (1.0 + ((f - fc) / (bw[:, None] / 2.0 + 1e-6)) ** 2)
    # weight higher formants down; add a floor so harmonics between
    # formants don't vanish entirely
    w = np.array([1.0, 0.63, 0.35])
    env = (res * w[:, None]).sum(-2) + 0.01
    tilt = 1.0 / (1.0 + (freqs / 3200.0) ** 2)
    return env * tilt


def _frames_to_samples(track: np.ndarray, n: int) -> np.ndarray:
    """Piecewise-linear upsample of a per-frame track [F, ...] → [n, ...]."""
    f = track.shape[0]
    if f == 1:
        return np.broadcast_to(track, (n,) + track.shape[1:]).copy()
    pos = np.linspace(0.0, f - 1.0, n)
    lo = np.minimum(pos.astype(np.int64), f - 2)
    frac = (pos - lo).reshape((n,) + (1,) * (track.ndim - 1))
    return track[lo] * (1.0 - frac) + track[lo + 1] * frac


def _band_noise(rng, n: int, band: Tuple[float, float], sr=SAMPLE_RATE):
    """FFT-shaped noise: flat in ``band`` with raised-cosine 300 Hz skirts."""
    x = rng.randn(n)
    spec = np.fft.rfft(x)
    f = np.fft.rfftfreq(n, 1.0 / sr)
    lo, hi = band
    skirt = 300.0
    g = np.clip((f - (lo - skirt)) / skirt, 0, 1) * np.clip(
        ((hi + skirt) - f) / skirt, 0, 1
    )
    g = 0.5 - 0.5 * np.cos(np.pi * np.clip(g, 0, 1))
    y = np.fft.irfft(spec * g, n)
    peak = np.abs(y).max() + 1e-9
    return y / peak


@dataclasses.dataclass
class _Segment:
    phone: str
    n: int  # samples
    closure: int = 0  # leading closure samples (stops)


def _plan_segments(rng, seq: Sequence[str]) -> List[_Segment]:
    segs = []
    for p in seq:
        spec = _spec(p)
        dur = rng.randint(spec.dur_ms[0], spec.dur_ms[1] + 1) * SAMPLE_RATE // 1000
        closure = 0
        if spec.kind == "stop":
            closure = rng.randint(30, 55) * SAMPLE_RATE // 1000
        segs.append(_Segment(p, int(dur), int(closure)))
    return segs


def synth_speech_utterance(
    rng: np.random.RandomState,
    vocab: Vocab,
    utt_id: str,
    *,
    model: Phonotactics,
    n_syllables_range=(2, 6),
    snr_db_range=(8.0, 30.0),
    amplitude=9000.0,
    grapheme_vocab: Optional[Vocab] = None,
    phones: Optional[Sequence[str]] = None,
    word_syllables: Optional[Tuple[int, int]] = None,
) -> Utterance:
    seq = list(phones) if phones is not None else sample_sentence(
        rng, model, n_syllables_range, word_syllables=word_syllables
    )
    # --- speaker draw
    f0_base = float(np.exp(rng.uniform(np.log(90.0), np.log(240.0))))
    vtln = float(rng.uniform(0.85, 1.18))
    segs = _plan_segments(rng, seq)
    hop = SAMPLE_RATE * _FRAME_MS // 1000
    total = sum(s.n + s.closure for s in segs) + 2 * hop
    n_frames = total // hop + 2
    t_frame = np.arange(n_frames) * (_FRAME_MS / 1000.0)

    # --- per-frame formant track with coarticulation
    # target per frame = the owning segment's formants; vowel/glide edges
    # bend toward the neighbor consonant locus; then smooth.
    track = np.zeros((n_frames, 3))
    voiced_amp = np.zeros(n_frames)
    pos = hop  # leading silence pad
    spans = []  # (start_sample, seg)
    for i, seg in enumerate(segs):
        spans.append((pos, seg))
        pos += seg.closure + seg.n
    for start, seg in spans:
        spec = _spec(seg.phone)
        f_lo = (start + seg.closure) // hop
        f_hi = min((start + seg.closure + seg.n) // hop + 1, n_frames)
        if spec.kind in ("vowel", "glide", "nasal") or (
            spec.kind == "stop" and spec.voiced
        ):
            tgt = np.array(spec.formants if spec.formants[0] else spec.locus)
            track[f_lo:f_hi] = tgt
            voiced_amp[f_lo:f_hi] = spec.gain
        elif spec.locus is not None:
            track[f_lo:f_hi] = spec.locus  # drives neighbors' transitions
    # coarticulation: pull sonorant edges toward neighbor loci over ~35 ms
    trans = max(int(35 / _FRAME_MS), 1)
    for i in range(len(spans)):
        start, seg = spans[i]
        spec = _spec(seg.phone)
        if spec.kind not in ("vowel", "glide"):
            continue
        f_lo = (start + seg.closure) // hop
        f_hi = min((start + seg.closure + seg.n) // hop, n_frames - 1)
        for side, j in ((0, i - 1), (1, i + 1)):
            if not (0 <= j < len(spans)):
                continue
            nb = _spec(spans[j][1].phone)
            locus = nb.locus if nb.locus is not None else (
                nb.formants if nb.kind in ("vowel", "glide") else None
            )
            if locus is None:
                continue
            locus = np.asarray(locus, np.float64)
            w = np.linspace(1.0, 0.0, trans)  # strength at the boundary
            if side == 0:
                sl = slice(f_lo, min(f_lo + trans, f_hi))
            else:
                sl = slice(max(f_hi - trans, f_lo), f_hi)
                w = w[::-1]
            k = sl.stop - sl.start
            if k <= 0:
                continue
            # if the window was clipped, keep the boundary-adjacent end
            wk = w[:k] if side == 0 else w[-k:]
            blend = 0.55 * wk[:, None]
            track[sl] = track[sl] * (1 - blend) + locus[None, :] * blend
    # smooth the track (box filter) and apply vocal-tract scaling
    kernel = np.ones(3) / 3.0
    for d in range(3):
        track[:, d] = np.convolve(track[:, d], kernel, mode="same")
    track *= vtln
    # amplitude ramps at voicing edges (5 ms attack/decay via smoothing)
    voiced_amp = np.convolve(voiced_amp, np.ones(3) / 3.0, mode="same")

    # --- harmonic (voiced) component
    # f0 contour: declination + slow random walk (jitter)
    f0 = f0_base * (1.06 - 0.12 * t_frame / max(t_frame[-1], 0.3))
    f0 *= np.exp(np.cumsum(rng.randn(n_frames)) * 0.002)
    f0_s = _frames_to_samples(f0, total)
    phase = 2.0 * np.pi * np.cumsum(f0_s) / SAMPLE_RATE  # [S]
    n_h = max(int(7600.0 / f0.max()), 1)
    h = np.arange(1, n_h + 1)
    hf = f0[:, None] * h[None, :]  # [F, H] harmonic freqs
    env = _formant_env(hf, track)  # [F, H]
    env = np.where(hf < 7600.0, env, 0.0)
    amp_fr = env * voiced_amp[:, None]  # [F, H]
    amp_s = _frames_to_samples(amp_fr, total)  # [S, H]
    voiced = (amp_s * np.sin(phase[:, None] * h[None, :])).sum(-1)
    # put the harmonic component on the same peak scale as the unit-peak
    # noise components before mixing (relative gains within the voiced
    # track are preserved; clean is re-normalized after the mix)
    voiced = voiced / (np.abs(voiced).max() + 1e-9)

    # --- noise components (fricatives, bursts, aspiration)
    noise = np.zeros(total)
    for idx, (start, seg) in enumerate(spans):
        spec = _spec(seg.phone)
        if spec.kind == "fric":
            seg_n = seg.n
            band = spec.noise_band
            if seg.phone == "h":
                # aspiration colored by the following vowel's formants:
                # reuse its F2 region
                nxt = spans[idx + 1][1].phone if idx + 1 < len(spans) else None
                if nxt and _spec(nxt).kind == "vowel":
                    f2 = _spec(nxt).formants[1] * vtln
                    band = (max(f2 - 600, 300), f2 + 900)
            x = _band_noise(rng, seg_n, band) * spec.gain
            ramp = np.minimum(np.minimum(
                np.arange(seg_n), np.arange(seg_n)[::-1]
            ) / (0.015 * SAMPLE_RATE), 1.0)
            noise[start:start + seg_n] += x * ramp
        elif spec.kind == "stop":
            burst_n = rng.randint(8, 16) * SAMPLE_RATE // 1000
            b0 = start + seg.closure
            burst = _band_noise(rng, burst_n, spec.noise_band)
            burst *= np.exp(-np.arange(burst_n) / (0.004 * SAMPLE_RATE))
            noise[b0:b0 + burst_n] += burst * 0.9
            if not spec.voiced:  # aspiration tail
                asp_n = min(seg.n - burst_n, int(0.03 * SAMPLE_RATE))
                if asp_n > 0:
                    asp = _band_noise(rng, asp_n, (500, 3000)) * 0.25
                    asp *= np.linspace(1.0, 0.0, asp_n)
                    noise[b0 + burst_n:b0 + burst_n + asp_n] += asp
            else:  # voice bar through the closure
                tcl = np.arange(seg.closure)
                noise[start:start + seg.closure] += 0.15 * np.sin(
                    2 * np.pi * f0_base * tcl / SAMPLE_RATE
                )

    clean = voiced + noise
    clean = clean / (np.abs(clean).max() + 1e-9)
    # --- additive noise at a per-utterance SNR
    snr_db = rng.uniform(*snr_db_range)
    sig_p = float((clean ** 2).mean())
    bg = rng.randn(total)
    bg_p = float((bg ** 2).mean())
    bg *= np.sqrt(sig_p / (bg_p * 10.0 ** (snr_db / 10.0)))
    audio = (clean + bg) * amplitude * rng.uniform(0.6, 1.0)
    audio = np.clip(audio, -32000, 32000)

    # PAUSE markers shape the audio only — they are never labels
    label_seq = [p for p in seq if p != PAUSE]
    # ground-truth (start, end) sample span per label token (spans is 1:1
    # with seq; stops sound at start+closure) — for stitching diagnostics
    token_times = np.asarray(
        [
            (start + seg.closure, start + seg.closure + seg.n)
            for (start, seg) in spans
            if seg.phone != PAUSE
        ],
        np.int64,
    )
    targets = np.asarray(vocab.encode(label_seq), np.int32)
    graphemes = None
    if grapheme_vocab is not None:
        chars: List[str] = []
        for j, p in enumerate(label_seq):
            if j:
                chars.append("|")
            chars += list(PHONE_SPECS[p].translit)
        graphemes = np.asarray(grapheme_vocab.encode(chars), np.int32)
    return Utterance(utt_id, audio.astype(np.int16), targets, graphemes,
                     " ".join(label_seq), token_times=token_times)


def write_speechlike_corpus(
    path: str,
    *,
    n_utts: int = 256,
    seed: int = 0,
    phonotactics_seed: int = 1234,
    n_syllables_range: Tuple[int, int] = (2, 6),
    snr_db_range: Tuple[float, float] = (8.0, 30.0),
    graphemes: bool = False,
    word_syllables: Optional[Tuple[int, int]] = None,
) -> Tuple[str, Vocab]:
    """Write a .plu record file; the phonotactic model is derived from
    ``phonotactics_seed`` alone, so train/test splits (different
    ``seed``) share one language."""
    vocab = Vocab(speechlike_phone_inventory())
    gvocab = Vocab(speechlike_grapheme_inventory()) if graphemes else None
    model = make_phonotactics(phonotactics_seed)
    rng = np.random.RandomState(seed)
    with RecordWriter(
        path, meta={"corpus": "speechlike", "sample_rate": SAMPLE_RATE}
    ) as w:
        for i in range(n_utts):
            w.write(synth_speech_utterance(
                rng, vocab, f"spl-{seed}-{i:05d}", model=model,
                n_syllables_range=n_syllables_range,
                snr_db_range=snr_db_range, grapheme_vocab=gvocab,
                word_syllables=word_syllables,
            ))
    return path, vocab
