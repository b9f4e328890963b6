"""Decoding: greedy (the fused CUDA decoder or the speller-step loop) and
the vectorised beam search with optional joint CTC and n-gram fusion."""

from phones_las_torch.decode.beam import beam_decode  # noqa: F401
from phones_las_torch.decode.greedy import greedy_decode  # noqa: F401
