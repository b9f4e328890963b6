"""Command-line tools of the port (counterparts of the repository's
``tools/*.py``), one module each, run as ``python -m
phones_las_torch.tools.<name>``:

  * ``make_bench_assets`` — a trained workdir as the bench's accuracy-row
    assets (``ckpt.npz`` + ``eval_set.npz``);
  * ``export_artifact`` — a workdir as one flat-npz serving artifact;
  * ``decode_stats`` — PER of an infer TSV split into derailed and the rest;
  * ``sample_lm_text`` — LM text sampled from the phonotactic model;
  * ``longform_eval`` / ``longform_debug`` — stitched PER over synthesized
    long streams through ``Transcriber.transcribe_long``, and where its
    errors come from.

``tools/tpu_smoke.py`` has its counterpart in the repository's
``chip_smoke.py``. Importing this package loads no tool.
"""
