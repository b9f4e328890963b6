"""Tensor ops of the model: masking, pyramid reduction, LSTM, attention.
The reference's re-exports resolve lazily."""

from phones_las_torch._lazy import lazy_exports

_LAZY = {
    "LSTMParams": "lstm",
    "init_lstm_params": "lstm",
    "lstm_layer": "lstm",
    "bilstm_layer": "lstm",
    "pyramid_reduce": "pyramid",
    "length_mask": "masking",
}

__getattr__, __dir__ = lazy_exports(__name__, _LAZY)
