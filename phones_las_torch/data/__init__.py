"""The data layer: vocabularies and phone maps, record files, the native
record reader and audio decoders, the bucketed batch pipeline, and the
corpora and their prep (the port's own copies of the reference's numpy
and C++ modules). The reference's re-exports resolve lazily."""

from phones_las_torch._lazy import lazy_exports

_LAZY = {
    "BINF_FEATURES": "ipa",
    "phone_to_binf": "ipa",
    "binf_matrix": "ipa",
    "ARPABET_TO_IPA": "ipa",
    "TIMIT_FOLD_39": "ipa",
    "fold_timit": "ipa",
    "Vocab": "vocab",
    "RecordWriter": "records",
    "RecordReader": "records",
    "Utterance": "records",
}

__getattr__, __dir__ = lazy_exports(__name__, _LAZY)
