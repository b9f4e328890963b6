"""Greedy decoder layer (``decode/greedy.py`` → ``decode/fused_greedy.py``
→ ``csrc/greedy.cu``): the decoder kernels' share of their roofline, in
%. Operations: every step run, each row's cells, query, scores over its
own encoder frames, softmax, context, attention layer, logits and argmax
(``counts.decoder``), over the float32 peak; bytes: the speller's weights
once a call, each row's memory and keys once, the tokens written."""

STEMS = ("greedy_",)


def read(run):
    t = run.trace.kernel_seconds(STEMS)
    return 100.0 * run.roofline_s("decoder") / t if t > 0 else None
