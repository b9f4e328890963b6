"""Audio front-end: framing, power spectrum, log-mel/MFCC, Δ/ΔΔ, CMVN."""
