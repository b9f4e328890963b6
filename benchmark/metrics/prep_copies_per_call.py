"""Greedy decoder layer (``decode/fused_greedy.py::_launch``): the tensors
the decoder's prep makes anew each call by copying (the speller's weights
cast to float32, padded, cut into the layout's column slices and
concatenated; the mask's cast; the pointer table's copy to the card), a
call: the outermost ``aten::copy_`` and ``aten::cat`` inside the spans
``plt.decode.prep``. Work a cache of the sliced weights would not redo.
0 where the prep copies nothing; nothing where the program opens no
``plt.decode.prep``."""

from benchmark.metrics._spans import outermost_within

COPIES = ("aten::copy_", "aten::cat")


def read(run):
    prep = [a for a in run.trace.host if a.name == "plt.decode.prep"]
    if not prep or not run.calls:
        return None
    return len(outermost_within(prep, [a for a in run.trace.host if a.name in COPIES])) / run.calls
