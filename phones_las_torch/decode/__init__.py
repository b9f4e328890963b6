"""Decoding: greedy, through the fused CUDA decoder or the speller-step loop."""
