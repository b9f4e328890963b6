"""Configuration presets (port of ``phones_las_tpu/utils/config.py``):
one per configuration the repo supports, each a model, pipeline and
training configuration plus the decode beam width. ``resolve_preset``
(``cli/common.py``) binds one to a prepared data directory; a training
run stores the preset's name and its overrides in ``config.json``.
"""

from __future__ import annotations

import dataclasses
import json

from phones_las_torch.data.pipeline import PipelineConfig
from phones_las_torch.frontend.features import FrontendConfig
from phones_las_torch.models.las import LASConfig
from phones_las_torch.models.listener import ListenerConfig
from phones_las_torch.models.speller import SpellerConfig
from phones_las_torch.train.state import TrainConfig


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    description: str
    model: LASConfig
    pipeline: PipelineConfig
    train: TrainConfig
    beam_width: int = 0  # 0 → greedy


def _speller(vocab_size: int, **kw) -> SpellerConfig:
    base = dict(
        vocab_size=vocab_size, embedding_dim=128, num_layers=1, units=256,
        memory_dim=512, attention_type="bahdanau", attention_units=256,
        attention_layer_size=256, sampling_probability=0.1,
    )
    base.update(kw)
    return SpellerConfig(**base)


def timit_phone_las(vocab_size: int = 65) -> Preset:
    """configs[0]: TIMIT phone LAS — 40-mel, 2×256 pBLSTM, greedy."""
    return Preset(
        name="timit_phone_las",
        description="TIMIT phone LAS: 40 log-mel+Δ+ΔΔ, 2x256 pBLSTM, "
        "Bahdanau attention decoder, greedy decode",
        model=LASConfig(
            frontend=FrontendConfig(feature_type="logmel", num_mel=40),
            listener=ListenerConfig(input_dim=120, num_layers=2, units=256, dropout=0.2),
            speller=_speller(vocab_size),
        ),
        pipeline=PipelineConfig(
            batch_size=32, buckets=(48000, 80000, 128000), max_target_len=80
        ),
        train=TrainConfig(learning_rate=1e-3, num_steps=20000),
    )


def timit_multitask(vocab_size: int = 65, grapheme_vocab_size: int = 32) -> Preset:
    """configs[1]: joint phone + grapheme heads, shared encoder."""
    base = timit_phone_las(vocab_size)
    return dataclasses.replace(
        base,
        name="timit_multitask",
        description="TIMIT multitask: joint phone + grapheme decoders over "
        "a shared pBLSTM encoder",
        model=dataclasses.replace(
            base.model,
            grapheme_speller=_speller(grapheme_vocab_size),
            multitask_weight=0.5,
        ),
        pipeline=dataclasses.replace(base.pipeline, max_grapheme_len=120),
    )


def librispeech_char_las(vocab_size: int = 34) -> Preset:
    """configs[2]: LibriSpeech-100h char LAS — 3-layer pBLSTM, beam 8."""
    return Preset(
        name="librispeech_char_las",
        description="LibriSpeech-100h char LAS: 3x256 pBLSTM, beam width 8",
        model=LASConfig(
            listener=ListenerConfig(input_dim=120, num_layers=3, units=256, dropout=0.2),
            speller=_speller(vocab_size, num_layers=2),
        ),
        pipeline=PipelineConfig(
            batch_size=32, buckets=(80000, 160000, 280000), max_target_len=300
        ),
        train=TrainConfig(learning_rate=1e-3, num_steps=100000),
        beam_width=8,
    )


def common_voice_binf(vocab_size: int = 120, num_binf: int = 42) -> Preset:
    """configs[3]: multilingual IPA phones + binary-feature output head."""
    return Preset(
        name="common_voice_binf",
        description="Common Voice multilingual IPA LAS with binary "
        "phonological-feature output head",
        model=LASConfig(
            listener=ListenerConfig(input_dim=120, num_layers=3, units=256, dropout=0.2),
            speller=_speller(vocab_size, binf_mode="head", num_binf=num_binf),
            binf_weight=1.0,
        ),
        pipeline=PipelineConfig(
            batch_size=32, buckets=(80000, 160000, 280000), max_target_len=200
        ),
        train=TrainConfig(learning_rate=1e-3, num_steps=100000),
    )


def librispeech_offline_infer(vocab_size: int = 34) -> Preset:
    """configs[4]: LibriSpeech-960h batched offline inference, DP mesh."""
    base = librispeech_char_las(vocab_size)
    return dataclasses.replace(
        base,
        name="librispeech_offline_infer",
        description="LibriSpeech-960h batched offline inference sharded "
        "across a v5e-8 data-parallel mesh",
        pipeline=dataclasses.replace(
            base.pipeline, batch_size=256, shuffle=False, drop_remainder=False
        ),
    )


PRESETS = {
    p.__name__: p
    for p in (
        timit_phone_las,
        timit_multitask,
        librispeech_char_las,
        common_voice_binf,
        librispeech_offline_infer,
    )
}


def get_preset(name: str, **kw) -> Preset:
    return PRESETS[name](**kw)


def dump_preset(preset: Preset, path: str) -> None:
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(preset), f, indent=2, default=str)
