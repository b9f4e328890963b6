"""Audio front-end: framing, power spectrum, log-mel/MFCC, Δ/ΔΔ, CMVN.
The reference's re-exports resolve lazily."""

from phones_las_torch._lazy import lazy_exports

_LAZY = {
    "FrontendConfig": "features",
    "num_frames": "features",
    "frames_for_samples": "features",
    "mel_filterbank": "features",
    "dft_matrices": "features",
    "extract_features": "features",
    "feature_dim": "features",
    "CmvnStats": "cmvn",
    "apply_cmvn": "cmvn",
}

__getattr__, __dir__ = lazy_exports(__name__, _LAZY)
