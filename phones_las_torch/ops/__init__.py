"""Tensor ops of the model: masking, pyramid reduction, LSTM, attention."""
