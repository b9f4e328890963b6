#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``phones_las_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``phones_las_torch/csrc`` (first use),
then:

  0. prints the card's name and power limit, the numerics switches of
     parity mode and the build's seconds;
  1. holds each kernel against its plain PyTorch version on the card at
     the main path's shapes, with the tolerance stated in each line, and
     times kernel, plain version and, where one exists, a single PyTorch
     library call computing the same function (CUDA events, median of
     10 runs, warm L2); the front-end kernel also at the eval set's shape,
     under an odd window and hop and at transforms of 1024 and 2048
     points (smaller frame tiles), with the SM cycles one block spends
     in each part; for the two cluster kernels (the LSTM forward and
     the greedy decoder) it also prints the cluster size, the rows of a
     tile or group, what ``cudaOccupancyMaxActiveClusters`` says, shared
     memory and registers, µs per step and the SM cycles a step spends in
     each of its parts; then holds both on ragged cases (a batch that is no
     multiple of the tile, rows of very different lengths, U = 40 and
     248: the forward at 248, which no cluster cut holds, in the grid
     layout) at a short T; the decoder also on batches of 13, 5 and 9 rows
     of lengths 1..T and with each layout forced (held, grid) there, at
     the flagship shape and at W1024, each against its plain version;
  2. decodes the committed checkpoint on all 64 utterances of the
     committed eval set on the card (load_artifact → encode →
     greedy_decode, launch counters set to 0 just before and read just
     after) and holds the tokens and greedy PER against the port's plain
     path on the CPU and against the reference's PER;
  3. runs the same path at the flagship shape (64 × 10 s of random PCM,
     200 greedy steps) and prints utt/s and the split among front-end,
     listener and decoder;
  4. the training slice, with gradients on:
     a. holds the three training LSTM kernels (``recurrence``,
        ``recurrence_residual``, ``recurrence_bwd``) against their plain
        versions at B = 32 and the listener's widths, and times them as
        phase 1 does, beside cuDNN's ``torch.nn.LSTM``; for the VJP it
        also prints the plan of its cluster kernel, what the card gives
        it, µs per step, the SM cycles a step spends in each part, the
        milliseconds of each of its four kernels and whether two runs
        are bitwise equal, and holds it on the ragged cases of phase 1;
     b. one step of the committed checkpoint on the eval set
        (``compute_loss(train=False)``, backward, one optimizer step) on
        the card and on the CPU plain path: loss, every gradient leaf and
        every updated leaf held within the bounds stated below;
     c. ``Trainer.train_step`` at full width (32 × 10 s of random PCM,
        200-token targets, dropout and scheduled sampling on), 4 steps on
        one batch: ms per step, peak device memory, the loss of each step
        (finite and falling) and each step's kernel launches; then the
        device time of one more step under ``torch.profiler``, and 3 more
        steps driven in their three parts (``Trainer.loss``, backward,
        ``Trainer.apply_gradients``) for the split of a step into
        forward, backward and optimizer;
     d. the ops API: ``lstm_layer`` without and with gradients;
  5. the decode and serving slice (phase 1 has also held the LSTM forward
     kernel at the long-gate listener's width, U = 96):
     a. beam-8 of the committed checkpoint on the eval set on the card
        (launch counters set to 0 just before and read just after) against
        the CPU plain path: the best tokens and all K beams compared, at
        most 2 utterances' best tokens differing, PER within 0.005 of the
        reference's beam-8 PER, the front-end and BiLSTM kernels launched,
        no training kernel and no greedy kernel;
     b. beam-8 at ``bench.py``'s beam shape (32 × 10 s of random PCM, 200
        steps, parity mode), without and with a CTC head of the
        checkpoint's widths drawn from a seeded generator (one-pass joint
        decoding, α = 0.7): utt/s, the split among front-end, listener and
        decoder (one timed call), µs per decode step; without CTC also the
        device launches per step and the device-busy share of one profiled
        call and of its decoder (the kernels launched inside its
        ``record_function``; one profile a run: the bench times both modes
        at this shape, phase 14a);
     c. ``Transcriber.from_artifact`` of ``tests/goldens/long_gate.npz``
        (monotonic attention, CTC head) on the card and with
        ``device="cpu"``: ``transcribe_batch`` of 16 eval-set utterances
        (int16 PCM) greedy, beam-8 and beam-8 + CTC 0.7, at most 2
        utterances differing a mode; ``transcribe_long`` of their
        concatenation with and without ``adapt_cmvn``, at most 2 tokens
        of edit distance a stream;
     d. the same artifact's ``Transcriber`` staging each wave through its
        pinned ring against the pageable staging it had before
        (``pageable_stage``): staged tensors and tokens equal at the
        benchmark cells' waves (64 × 160,000 and 32 × 280,000 samples), on
        a ragged call of three waves and a short call after it; a
        ``decode_aligned`` thread beside a ``transcribe_batch`` thread
        answering as each alone; the ring's counters; the host's ms of the
        staging and of the call, both versions in turns;
  6. production (bf16) mode, augmentation and persistence, each driven with
     the launch counters set to 0 just before and read just after:
     a. the committed checkpoint in production mode (``matmul_precision=
        'default'``, front-end ``precision='high'``: bf16 recurrent dots,
        TF32 in the other GEMMs) on the eval set, greedy and beam-8: PER
        within 0.005 of the reference's, at most 2 of 64 best-token rows
        differing from the CPU plain path in production mode (the fused
        decoder computes float32 on the card, the CPU loop bf16), the bf16
        forward launched on every listener layer;
     b. parity against production mode, timed in turns on the card: at
        phase 3's greedy shape (utt/s, the split, the device-busy share of
        one profiled call each), and at phase 4c's training shape with a
        third mode, TF32 alone, to tell TF32's share of the difference
        from the bf16 dots' (ms a step, losses finite and falling, the bf16
        residual and VJP launched in production mode only; phase 4c
        profiles a step, and the bench times both modes at this shape,
        phase 14a);
     c. the long-gate configuration with its SpecAugment and a frequency
        warp of 0.1 trains 5 steps on the card (losses finite); the masks
        and the warp on the card against the CPU on the same uniforms and α;
     d. ``Trainer(workdir)`` at the checkpoint's widths (the
        ``librispeech_char_las`` preset over a data dir of its vocabulary,
        warm-started from it) trains 3 steps on the eval set with a
        checkpoint at 1 (the first step a fresh workdir is offered, as
        orbax saves it), 2 and 3; a second workdir holding only checkpoint 2
        resumes silently and takes the 3rd step, held to the uninterrupted
        one within 1e-6 of each leaf's largest magnitude; averaging of the
        last 2 against their mean; ``Transcriber(workdir)`` against
        ``Transcriber.from_artifact`` of its export on 16 eval-set
        utterances (equal tokens). Its files go to a directory under
        ``_runs/`` that is removed at the end.
  7. the data layer and the rest of the ``Trainer``, in parity mode, in a
     temporary directory under ``_runs/`` removed at the end:
     a. the port's formant corpus (``data/speechlike.py``, phonotactics
        seed 1234, 2–6 syllables) written as record files, a train split
        of 256 utterances (seed 7) and a held-out split of 64 (seed 8); the
        data dir's CMVN over every training utterance through the
        front-end kernel (``finalize_split_dir``) against the same pass on
        the CPU (mean and std within 1e-4 of their largest magnitude);
     b. a ``DataSource`` over the train split (B = 32, buckets of 1 and
        2 s, 32-token rows): epoch 0 filled by the native C++ reader equal
        to the Python fill in every key; batches an epoch, ms a batch;
     c. the committed checkpoint fine-tuned from the record files: the
        ``librispeech_char_las`` preset over the corpus's data dir (its
        CMVN injected after the warm start, as the training CLI does),
        ``fit`` over the DataSource for two epochs with an eval of the
        held-out split after each (a recording writer gets the scalars and
        the attention image); PER before and after each epoch, ms a step,
        the launches of the five kernels of the path; the held-out eval on
        the card against the CPU (PER within 0.005, loss within 1e-4
        relative, at most 2 of 64 rows differing), beam-8 on its first
        batch (PER within 0.005); the run exported as one artifact (the
        committed ``ckpt.npz`` carries no vocabulary);
     d. one epoch in a second workdir, then a trainer resumed from its
        checkpoint: epoch 0 recorded, the leaves restored bitwise, and
        epoch 0 replayed from its first batch, as the reference does;
     e. the held-out split as 16 kHz WAV files (16 also at 48 kHz) through
        ``transcribe_files`` of that artifact: equal to ``transcribe_batch``
        at 16 kHz, PER at 48 kHz within 0.02 of 16 kHz;
     f. the long-regime gate of ``tests/test_long_regime_gate.py`` through
        the long-gate artifact on the port's synthesized audio: no
        derailment, batch PER ≤ 0.035, stitched PER ≤ 0.04, the stream at
        0.03 gain with stream CMVN ≤ 0.08.

  8. the front doors, in a temporary directory under ``_runs/`` removed
     at the end, every process it starts stopped:
     a. the CLIs as processes on the card (``python -m
        phones_las_torch.cli.*``): ``prepare speechlike`` (128 + 32
        utterances, seeds 7 and 8; started beside phase 7), ``train`` warm-started with
        ``--init-checkpoint`` from the committed checkpoint written as a
        workdir by the library, 1 profiled step and 1 more (its trace must
        name the residual and VJP kernels); then at once ``infer`` on the
        card and with ``--device cpu`` (PER equal to ``Trainer.evaluate``'s,
        at most 1 of the 32 rows differing: ``max_diff_rows``), ``lm``, ``transcribe`` of 16 WAV
        files (equal to ``transcribe_files``), ``export`` and ``serve``;
     b. the ``serve`` process answers /healthz and one request and stops;
        ``make_server`` in this process at ``max_batch`` 16: 32 held-out WAV
        uploads from 16 client threads (at most 1 row differing from one
        ``transcribe_batch``, mean fill above 1, requests/s, p50/p99, the
        serving kernels launched once (the BiLSTM once a layer) a batch), a
        /stream session of the 51.6 s long-regime stream in 0.5 s feeds, a
        ``?stream=1`` upload and a long upload of it (PER within 0.005 of
        ``transcribe_long``'s, real-time factor);
     c. the exported programs (1, 16, 64 × 10 s, greedy): each holds the
        three kernel operators once a call (the BiLSTM once a layer), their
        tokens against the live ``Transcriber`` (at most 1 of the 32 held-out
        rows; the flagship shape's 2 of 64), the
        kernels launched by the exported call, a fresh process that imports
        only ``phones_las_torch.export`` equal, and 64 × 10 s of random PCM
        exported against live, in turns, median of 6.
  9. the seq2seq G2P at its own widths, in a temporary directory under
     ``_runs/`` removed at the end, every process it starts stopped:
     a. its four kernels against their plain versions: the BiLSTM at the
        bundled model's U = 160 (C = 4, 40 units a block) on 64 rows of
        1..28 letters, the decoder on that memory (U = A = 160, M = 320,
        V = 45, 24 steps: tokens equal), the residual forward and the VJP
        at the training widths (B = 256, U = 128, T = the lexicon's
        longest word, lengths 1..T; two waves of clusters), with plans,
        kernel, plain and cuDNN milliseconds and the bounds;
     b. ``NeuralG2P.bundled()`` on the 70 gold words of
        ``tests/test_g2p_coverage.py`` at beam 4 and greedy: PER <= 0.05,
        exact words >= 0.8, at most 1 word differing from the CPU plain
        path; then every lexicon word in 64-word batches (words/s, one
        BiLSTM and, greedy, one decoder launch a batch);
     c. 5 steps of ``_train_from`` at the CLI's widths on the card and the
        CPU from one init (losses within 1e-5 relative, leaves within 1e-5
        outside Adam's eps region), 5 timed steps and one profiled; then
        ``cli.g2p train`` (600 steps) as a process: dev PER at each
        eval, the saved model's gold PER <= 0.15 beside the shipped
        model's and the rule tables', and ``cli.g2p apply`` on 5 words;
     d. mini LibriSpeech (FLAC) and Common Voice (es, it, en WAV) trees
        through ``cli.prepare ... --g2p-model bundled`` on the card and
        with ``--device cpu``, all four started before 9a and run beside
        9a–9c and the training process: records,
        indexes and vocabularies byte-equal (but for the targets of a word
        the model transcribes differently, at most 1), CMVN within 1e-6.
 10. several devices, in parity mode at the committed checkpoint's widths,
     in a temporary directory under ``_runs/`` removed at the end, every
     process it starts stopped and its exit code checked (the kernels are
     built before any rank starts; the ranks only load them):
     a. the sharded training step: ranks sharing the card over gloo (NCCL
        takes one card a rank), data 2 × model 2 and data 2 × model 1
        (plain data parallelism: every rank keeps whole leaves), one start
        of four rank processes for both (``python3 chip_smoke.py
        --mesh-rank JOB RANK``: the layouts in turn, a rank outside a
        layout's world skipping it), on
        32 × 10 s of random PCM whose audio and target lengths differ by
        row, so the shards hold different token counts (``train=False``):
        the loss within 1e-4 and every gradient leaf within 5e-5 of its
        largest magnitude of the unsharded step on the card, the leaves
        after one Adam step gathered within 1e-4, each rank's launches (the
        front-end once, the residual and the VJP once a listener layer),
        ms a step beside the unsharded step's (readings: gloo stages the
        tensors through the host);
     b. NCCL, a world of 1 on the card: a mesh ``Trainer`` against the
        plain one for a training step from one state (the loss and leaves
        within 1e-6), then ``cli.train --mesh`` as a process, a step
        warm-started from the checkpoint on ``prepare speechlike`` records;
     c. ``Transcriber(data_parallel=2, devices=["cuda:0", "cuda:0"])`` on
        the eval set, greedy and beam-8, and at the flagship shape: tokens
        equal to ``data_parallel=1``'s, PER within 0.005 of the
        reference's, the launches of each shard, ms of both in turns;
     d. ``replicate(2)`` on the card behind ``make_server``: 64 eval-set
        requests from 8 client threads, tokens equal to the library's, both
        drainers serving, nothing pending at the end; ``cli.infer --mesh``
        over two shards against ``cli.infer``, the same lines.
 11. degenerate rows and pad content through every serving and training
     kernel, at the committed checkpoint's widths in parity and production
     mode, on B = 6 rows of 0 (a pad row), 1, 100, 400, 16000 and 32000
     samples with targets of 0, 1, 2, 3, 20 and 40 tokens, and on the same
     batch scribbled over (random audio at amplitude 30000 past each
     length, token 9 past each target, as ``tests/test_masking_invariance.py``):
     a. ``encode`` + ``greedy_decode`` / ``beam_decode`` (beam 8) on the
        card against the CPU plain path: no row differing in parity mode
        and at most 2 in production but ties (a differing row prints its
        first differing step and the top-2 logit margin there, or the gap
        between the best two beams; a margin below 1e-5 is a tie); the
        scribbled batch's tokens and encoder lengths equal and its encoder
        output at valid frames within 1e-6; a row with no valid encoder
        position through the decoder kernel against the CPU loop;
        ``phones_las_torch.Transcriber`` on the card against the CPU on
        the batch, its 0- and 1-sample rows alone and an empty request
        (refused with the same error); the launches of each kernel;
     b. one ``Trainer.train_step`` a mode (dropout and sampling off) on the
        card, clean and scribbled, and on the CPU: finite; the loss within
        1e-5 relative (1e-4 in production: TF32 runs on the card only) and,
        in parity, every gradient leaf within 1e-4 of its largest magnitude
        of the CPU's; scribbled against clean, the loss bit-equal and, in
        parity, every gradient leaf bit-equal.
 12. the reference's five presets (``timit_phone_las``, ``timit_multitask``,
     ``librispeech_char_las``, ``common_voice_binf``,
     ``librispeech_offline_infer``) at their own widths, each bound through
     ``resolve_preset`` to a data dir of its published vocabulary (65, 65 +
     32 graphemes, 34, 120 with binf codes, 34) and initialised at random
     from one seed:
     a. the decoder kernel against its plain version, parity mode, at each
        preset's serving shape (TIMIT and the grapheme head: B = 32 × 8 s,
        80 and 120 steps; Common Voice: 32 × 17.5 s, 200 steps; ragged
        lengths; offline inference: 256 × 17.5 s, 300 steps), with the
        checkpoint's shape from phase 1: tokens equal, the shared memory
        the card reports equal to ``decoder_smem_bytes``, ms, µs a step,
        cluster, occupancy and registers; a forced tie (a column of out_w
        copied into another block's slice) taken by the smaller index; and
        widths that clusters of 4, 2 and 1 take, ragged, at V = 65;
     b. each preset's artifact through ``Transcriber.from_artifact`` on the
        card and on the CPU (the grapheme head through a workdir), 8 rows of
        its longest bucket, greedy and beam-8, both modes: 0 rows differing
        in parity, at most 2 greedy rows in production (production beam-8
        is not held: a random init's flat outputs part its beams on gaps
        that TF32, on the card only, moves; ``librispeech_char_las``'s rows
        differing are printed, the others' run on the card alone); launches:
        front-end 1, BiLSTM one a layer, decoder 1 greedy and 0 beam; then
        the checkpoint's widths with Luong attention (greedy through the
        loop) the same way;
     c. two ``Trainer`` steps of ``timit_phone_las``, ``timit_multitask``
        and ``common_voice_binf`` at B = 4 (dropout and sampling off), card
        against the CPU: in parity the loss and each auxiliary term within
        1e-6 relative and the worst gradient leaf within 1e-5 of its
        largest magnitude, in production the first step's terms within
        1e-4 (the second's printed: Adam turns TF32's rounding of the
        gradients into a larger drift); then, for ``common_voice_binf``
        (the largest vocabulary, the longest bucket), one step at its own
        B = 32 and longest bucket, ms, device ms, launches and busy share
        of a profiled step (readings);
     d. ``cli.train --preset timit_multitask`` on ``prepare speechlike
        --graphemes`` records (prepared beside phases 9–11), 4 steps and one
        eval (beside 12b and 12c), then ``cli.infer --head
        grapheme`` on its workdir against ``Transcriber(head='grapheme')``:
        the same tokens on every row.
 13. the reference's width flags, from ``librispeech_char_las`` (V = 34)
     through ``resolve_preset`` at random init (seed 13): W1024, the
     LAS-4-1024 widths (``--encoder-layers 4 --encoder-units 1024
     --decoder-units 1024 --attention-units 1024``: M = 2048, E = 128, the
     attention layer at 256), and W100 (``--encoder-units 100
     --decoder-units 36 --attention-units 60 --embedding-dim 30``), in a
     temporary directory under ``_runs/`` removed at the end:
     a. the listener kernels (forward one and two directions, residual,
        VJP) at U = 264, 320, 512, 1024 and 100 against their plain
        versions in both modes, B = 32 of ragged lengths 1..24, with the
        gates of phases 1 and 4a and within ``forward_rel_tol`` of the plain
        version's largest, every entry launched twice and bitwise equal,
        each plan with the shared memory (held to the plan's) and registers
        the card gives it (the grid layout's: blocks, resident share,
        passes; masked steps passing no gradient), and at U = 1032, 1280
        and 2048 on lengths 1..250 (fault C10); the grid layouts in passes
        of rows (``PASS_CASES``: the passes and ``grid_launches``); at U =
        1024 and 512 (float32) and 1024 (bf16) the four kernels timed at
        T = 999 beside cuDNN as phases 1 and 4a time them (medians of 5),
        the bf16 BiLSTM also at 13b's 8 rows (its plan's mma.sync route;
        at B = 64 wgmma), and there and at 512 and 448 in bf16 the VJP's template and grid
        layout (at U = 1024 also the grid in single blocks against the
        planner's clusters), in turns (``compare_routes``: plans, ms and
        cycles a step by part); the forward's grid layout at each of those
        widths with the cycles a step spends in each part (the product,
        bf16 on wgmma; the cell update; the publication of its chunks; the
        waits for the step's first and later chunks); the decoder kernel at W1024's
        speller (B = 32, T_enc 219 and 438, 200 steps; the grid layout),
        with an attention layer of 1024 (library-built), and at the LAS
        paper's 2 × 512 speller (the held layout): tokens equal to the
        plain version's, shared memory equal to ``decoder_smem_bytes``; and
        W1024's at B = 4096 (``PASS_DECODE``), past what one grid launch
        holds: two launches, tokens against the plain version's (ties
        excepted), two calls bitwise equal;
     b. W1024 and W100 as artifacts through the ``Transcriber`` on the card
        and on the CPU, 8 rows of <= 4 s decoded to at most 60 steps, greedy
        and beam-8, both modes: 0 rows differing in parity, at most 2 greedy
        rows in production (production beam-8 on the card alone, a
        reading); launches: front-end 1, BiLSTM one a layer, decoder 1 greedy;
     c. one W1024 ``Trainer.train_step`` at B = 8 × <= 4 s on the card and on
        the CPU: the loss within 1e-5 relative in parity, 1e-4 in
        production; then ``cli.train`` at the W1024 flags, 2 steps and an
        eval, on ``prepare speechlike`` records (64 + 16 utterances, the
        formant corpus of phase 7 at its seed), and ``cli.infer`` of its
        workdir;
     d. past the old limits (faults C9–C11): the decoder kernel through
        ``greedy_decode`` at B = 8, 60 steps, in its grid layout, at the
        checkpoint's speller at T_enc = 17,100 and 40,000 and W1024's at
        5,900 (tokens equal to the CPU loop's) and at U = A = AL = 2048,
        M = 4096 (tokens equal to the plain version's), each timed; one
        ``Transcriber.transcribe`` of 690 s at the checkpoint's widths
        (random init) on the card, its tokens equal to the CPU loop's on the
        card's own encoder memory; W2048 (one 2048-unit listener layer,
        speller and attention 2048) through the ``Transcriber`` greedy at
        8 × <= 2 s, 0 rows differing from the CPU in parity, and one
        production ``Trainer.train_step`` at B = 4 × <= 2 s within 13c's
        bound; ``lstm_layer`` at W1024's width (13c, both modes, with and
        without grad) and ``bilstm_layer`` there at B = 64 in bf16 (the
        wgmma route); each wide route (the listener's grid layouts, the
        forward's in bf16 by kernel, wgmma or mma.sync, and the VJP's loop's,
        and the decoder's) counted and listed in the last ``kernels`` line.
 14. the reference's entry points as the port's (``bench.py``,
     ``__graft_entry__.py``, ``tools/``):
     a. ``python -m phones_las_torch.bench`` as a process, at the
        reference's shapes, every row once (``PLU_BENCH_PREWARM``: a depth
        cut for the time limit) (greedy B = 64 × 10 s, 200 steps,
        both modes; beam-8 at B = 32 in parity, production, with joint CTC
        and with Luong attention; the training step at B = 32, both modes;
        the accuracy row; the CPU baseline): its one JSON line printed in a
        record beside the card's name and power limit; it fails on an
        ``errors`` field, a missing row or key, a PER not within 0.005 of
        0.0319, a ``value*`` or ``mfu*`` not finite and positive, or a row
        that did not launch exactly its kernels;
     b. ``entry()`` (4 × 4 s, 100 greedy steps, parity) on the card against
        the same forward on the CPU plain path: tokens equal;
     c. ``tools.make_bench_assets`` on phase 7's fine-tuned run (kept until
        here), then the bench's accuracy row on those assets
        (``PLU_BENCH_ASSETS_DIR``): the checkpoint's leaves bitwise, greedy
        PER within 0.005 of phase 7c's held-out eval of the same params.

``python3 chip_smoke.py --sweep`` runs none of the phases: it times the
LSTM forward kernel under every plan it takes at the flagship width
(cluster 8 or 16 blocks, tiles of 8 or 16 rows, both precisions, the
serving and the ops-API shape), each held against the chosen plan's
output, and prints one line a plan; then the VJP's loop kernel the same
way at the training shape; the numbers behind the choice of
``CLUSTER_SIZES`` in ``ops/lstm.py``, and, as a reading with the plan
unchanged, the forward's grid layout in turns against the template at
B = 64, both modes; then the VJP's float32 streamed slice at U = 1024
(its loop at B = 32 under every template plan that fits and the grid
layout's), with the clusters the card runs at once.

``python3 chip_smoke.py --sweep-decoder [LABEL ...]`` runs none of the
phases: the decoder at every shape of ``DECODER_SHAPES`` (``PERF.md``
row 3: the flagship at B = 64 and 8, the G2P, 12a's four, 13a's, 13d's
and one row of 13d's first; or those labelled), each layout it fits
forced in turn (the held layout, the grid layout), held to its plain
version, timed in turns, with the cycles a step spends
in each part (the dense stages' rings and products, their waits on
readiness counters, epilogues and publications, the rings' start-up, the
attention's passes and waits, the context's merge, the argmax's wait and
exchange) and the step model's µs: the readings
``decode/fused_greedy.py``'s step model is fitted to.

``python3 chip_smoke.py --sweep-forward`` runs none of the phases: the
forward's grid layout at T = 999 (``SWEEP_FORWARDS``: U = 1024 the
BiLSTM at B = 64 and the residual at B = 32 in both modes, 512 at B = 64
in both), every layout its kernels take with at most two passes of rows
(float32: three ring slots a k part), each timed with the cycles a step spends in
each part and the planner's modelled step: the numbers the forward's step
model was fitted to.

``python3 chip_smoke.py --bf16-routes`` runs none of the phases: the bf16
forward's grid layout at T = 999 (``BF16_ROUTE_SHAPES``: U = 1024 the
BiLSTM at B = 64, 32 and 8, the residual and one direction at B = 32, U
= 2048 at B = 64, U = 512 the BiLSTM at B = 64 and the residual at B =
32, U = 448 at B = 64), the plan of each of its two routes (wgmma,
mma.sync) timed in turns, with the readings' spread and the planner's
choice: the numbers behind keeping both.

``python3 chip_smoke.py --sweep-vjp`` runs none of the phases: the VJP's
loop in its grid layout at T = 999, B = 32 (``SWEEP_VJPS``: U = 1024 and
512 in both modes, 448 in bf16), every layout its kernels take at each
cluster size with two or three ring slots a k part, each timed with the
cycles a step spends in each part and the planner's modelled step: the
numbers the step model's constants were fitted to.

``python3 chip_smoke.py --compare DIR`` runs none of the phases either: it
times the front-end kernel (flagship shape) and the VJP (T = 999, B = 32,
both precisions) of another checkout of this repository unpacked at DIR
(say the parent commit, ``git archive`` into an ignored directory) and of
this one, the greedy serving call at the flagship shape (phase 3's
path), the decoder kernel at every shape of ``DECODER_SHAPES`` (the layout
each checkout plans there, ms, its two readings' spread and µs a step;
``--compare DIR decoder``: the serving call and the decoder alone) and the listener's forward
at T = 999 past the resident widths (``COMPARE_FORWARDS``: U = 1024 the
BiLSTM at B = 64, the residual and one direction at B = 32, both modes;
U = 512 and 448 at B = 64, and in bf16 at B = 32 the BiLSTM, the residual
and at 512 one direction; and at B = 64 the widths below them where no cluster cut
holds its slices, float32 U = 200 and 248, bf16 264 and 368; the route
each checkout plans there, ms of the wrapper's call and of a launch with
the checkout's plan given, made once beforehand: the kernels alone,
whether or not the checkout caches its plan) and the VJP at
T = 999, B = 32 past the resident widths (``COMPARE_VJPS``: U = 1024 and
512 in both modes, 448 in bf16; the route, the call's ms, the loop's ms
and µs a step), each in a
process of its own, in the order other, this, this, other on the same card, and prints
one line a run: the numbers behind a "[was …]" in ``PERF.md``. ``--time-kernels DIR`` is one such run, of the
package in the checkout at DIR.

``python3 chip_smoke.py --mesh-rank JOB RANK`` is one rank of phase 10a.

The random-init artifacts that phases 12b and 13b serve (compressed npz
files of 30–150 M parameters, 5–30 s of host CPU each) are written by one
thread beside phases 9–11 (``Prewritten``), under ``_runs/``, removed at
the end.

``python3 chip_smoke.py --presets`` runs phase 12 alone (after the
checkpoint's decoder check of phase 1) and prints no kernels record;
``python3 chip_smoke.py --widths`` runs phase 13 alone;
``python3 chip_smoke.py --bench`` runs phases 7 and 14.

Every phase that fails ends the script with a non-zero exit code. The
line before the last holds the card's name and power limit as
``nvidia-smi`` prints them; the line before that the kernels' record;
the last line is ``{"ok": true, "device": {...}}``. Without a CUDA
device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import functools
import glob
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

from types import SimpleNamespace

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(REPO, "phones_las_tpu", "assets", "bench")
REF_GREEDY_PER = 0.0319  # the reference's greedy PER on the eval set
PER_TOL = 0.005
MAX_DIFF_ROWS = 2  # token rows allowed to differ from the CPU plain path, of the eval set's 64

SECONDS = 10.0
SAMPLE_RATE = 16000
FLAGSHIP_B = 64
DECODE_STEPS = 200

# published peaks of one H100 SXM (dense), for the least-time bound
HBM_BYTES_PER_S = 3.35e12
L2_BYTES_PER_S = 5.5e12  # the decoder's design floor where a step's bytes fit the L2
L2_BYTES = 50e6
F32_FLOPS = 67e12  # float32 outside the tensor cores
BF16_FLOPS = 989e12

DEV = "cuda"
# BiLSTM checks: (T, listener layer whose wh is used, recurrent-dot precision);
# the three float32 cases are the three launches of one serving call
LSTM_CASES = ((999, 0, "highest"), (999, 0, "bf16"), (250, 2, "highest"), (250, 2, "bf16"), (500, 1, "highest"))
# ragged agreement checks of the LSTM forward kernel: (T, B, U), each in both
# precisions, one and two directions, with and without the residuals
RAGGED_LSTM = ((37, 13, 256), (20, 5, 40), (20, 9, 248))
RAGGED_DECODER_BS = (13, 5, 9)  # phase 1: ragged batches (lengths 1..T) through the plan's and every layout
RAGGED_DECODER_STEPS = 60
DECODER_BATCHES = (8, 64)
GATE_LSTM = (240, 16, 96)  # (T, B, U) at the long-gate listener's width, held in phase 1
BEAM_K = 8
BEAM_B = 32  # bench.py's beam batch
BEAM_TIMED_CALLS = 1  # phase 5b: timed calls a mode (the median); the bench times beam-8 at this shape (14a)
CTC_ALPHA = 0.7
REF_BEAM8_PER = 0.0319  # the reference's beam-8 PER on the eval set
GATE_ASSET = os.path.join(REPO, "tests", "goldens", "long_gate.npz")
GATE_UTTS = 16
MAX_STREAM_EDITS = 2  # long-form tokens allowed to differ from the CPU plain path
# production mode as bench.py defines it: bf16 recurrent dots and TF32 in
# the other GEMMs (matmul_precision 'default'), front-end precision 'high'
PROD_PRECISION = "default"
GATE_WARP = 0.1  # the frequency warp phase 6c trains the long-gate configuration with
GATE_TRAIN_STEPS = 5
SERVE_ROUNDS = 6  # phase 6b: timed rounds of parity and production serving calls, in turns
TRAIN_ROUNDS = 3  # phase 6b: timed rounds of a step in each numerics mode, in turns
RESUME_TOL = 1e-6  # phase 6d: a resumed step against the uninterrupted one, of each leaf's max
WORKDIR_PRESET = "librispeech_char_las"  # the preset of the checkpoint's widths
TRAIN_B = 32
TRAIN_STEPS = 4  # phase 4c; the bench times 30 steps at this shape (14a)
SPLIT_STEPS = 3  # further steps timed in their three parts
EOS_ID = 2
# phase 4b bounds, card against the CPU plain path: the loss relative to
# the CPU's; each gradient leaf's max |d| over its max |g_cpu|; each
# updated leaf's max |d| (a tenth of Adam's first step, lr = 1e-3)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-4
# phase 7: the formant corpus (phonotactics seed 1234, 2-6 syllables), its
# splits, the DataSource's shapes and the bounds, card against the CPU
DATA_TRAIN_UTTS, DATA_TRAIN_SEED = 256, 7
DATA_HELD_UTTS, DATA_HELD_SEED = 64, 8
DATA_BUCKETS = (16000, 32000)
DATA_MAX_TARGET = 32
DATA_EPOCHS = 2
CMVN_RTOL = 1e-4  # the stats' max |d| over their max |x|, mean and std each
FIT_LOSS_RTOL = 1e-4  # the held-out eval loss
FILES_48K = 16  # held-out files also written at 48 kHz
FILES_PER_TOL = 0.02  # their PER against the same files at 16 kHz
# the long-regime gate's bounds (tests/test_long_regime_gate.py)
GATE_BATCH_PER, GATE_STITCH_PER, GATE_QUIET_PER = 0.035, 0.04, 0.08
DERAIL_SLACK = 15


T0 = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; a phase's record also gets the seconds since start."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - T0, 1)}
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def make_audio(b: int, seed: int = 0) -> np.ndarray:
    """Random PCM at the scale of 16-bit speech, as bench.py::make_audio."""
    rs = np.random.RandomState(seed)
    return (rs.randn(b, int(SECONDS * SAMPLE_RATE)) * 2000).astype(np.float32)


# the plain versions (20–200× slower than their kernels) are timed in one
# run, so the whole script keeps within its time limit
PLAIN_REPS = 1


def time_ms(fn, reps: int = 10, warmup: int = 1) -> float:
    """Median over ``reps`` runs of ``fn`` timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float, peak: float):
    """Least time on the card (ms) and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare(got, want, atol: float, rtol: float):
    """→ (max |got − want|, max relative error, every element within
    atol + rtol·|want|)."""
    max_abs = max_rel = 0.0
    ok = True
    for g, w in zip(got, want):
        d = (g.double() - w.double()).abs()
        max_abs = max(max_abs, float(d.max()))
        max_rel = max(max_rel, float((d / w.double().abs().clamp_min(1e-30)).max()))
        ok = ok and bool((d <= atol + rtol * w.double().abs()).all())
    return max_abs, max_rel, ok


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def check_frontend(cfg_fe, audio, what="flagship"):
    from phones_las_torch.frontend import features as F, fused_frontend
    from phones_las_torch.frontend.fused_frontend import (
        CLOCK_NAMES, frame_tile, fused_logmel, fused_logmel_plain,
    )

    b, s = audio.shape
    t = F.frames_for_samples(s, cfg_fe)
    x = F.preemphasize(audio, cfg_fe.preemphasis).contiguous()
    (lm, en), (plm, pen) = fused_logmel(x, cfg_fe, t), fused_logmel_plain(x, cfg_fe, t)
    torch.cuda.synchronize()
    tol = 1e-4
    max_abs, max_rel, ok = compare([lm], [plm], tol, tol)
    # the energy is a sum of powers (~1e9 for this PCM): held relatively
    en_abs, en_rel, en_ok = compare([en], [pen], 0.0, tol)
    win, nb, nm = cfg_fe.win_samples, cfg_fe.num_bins, cfg_fe.num_mel
    nbytes = 4 * (b * s + win * 2 * nb + nb * nm + b * t * (nm + 1))
    # the mel matrix is sparse (narrow triangles): only its non-zero entries are work
    mel_nnz = int((F.mel_matrix(cfg_fe, x.device) != 0).sum())
    flops = b * t * (2 * win * 2 * nb + 4 * nb + 2 * mel_nnz)
    bms, by = bound(nbytes, flops, F32_FLOPS)
    clocks = torch.zeros(len(CLOCK_NAMES), dtype=torch.int64, device=DEV)
    fused_frontend._launch(x, cfg_fe, t, clocks)
    torch.cuda.synchronize()
    rec = {
        "phase": 1, "kernel": "fused_logmel", "shape": f"B={b} S={s} T={t} ({what})",
        "nfft": cfg_fe.nfft, "frame_tile": frame_tile(cfg_fe), "mel_nonzeros": mel_nnz,
        "cycles_of_one_block": dict(zip(CLOCK_NAMES, clocks.tolist())),
        "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": f"logmel atol=rtol={tol}",
        "energy_max_abs_err": en_abs, "energy_max_rel_err": en_rel, "energy_tol": f"rtol={tol}",
        "ms": time_ms(lambda: fused_logmel(x, cfg_fe, t)),
        "plain_ms": time_ms(lambda: fused_logmel_plain(x, cfg_fe, t), reps=PLAIN_REPS),
        "library_ms": None, "bound_ms": bms, "bound_by": by,
    }
    emit(rec)
    if not (ok and en_ok):
        fail(f"front-end kernel disagrees with its plain version: {rec}")
    return rec


# the forward kernel's cycle counters: the product, the cell update with its
# sends, the output stores and prefetch, the wait for the peers' h (the
# exchange), unused; the grid layout's: the product (bf16: wgmma), the cell
# update with its stores of h, the publication of the block's chunks with
# the stores of out and the residuals and the prefetch, the wait for a
# step's first chunk (its writers' publication and the copy of its h), the
# waits for later chunks (h and the streamed part of wh, from L2)
FWD_CLOCKS = ("product", "cell_update", "stores_prefetch", "h_wait", "unused")
GRID_CLOCKS = ("product", "cell_update", "publish_stores_prefetch", "first_chunk", "later_chunks")


def plan_info(plan, nd: int, prec: str, save_res: bool) -> dict:
    """What the card gives a forward plan: the template's clusters at once,
    or the grid layout's blocks at once, resident share and passes; shared
    memory and registers."""
    from phones_las_torch.ops import lstm as L

    if plan.grid is not None:
        return L.grid_kernel_info(plan.units, nd, prec == "bf16", plan.grid)
    return L.forward_kernel_info(plan.units, prec == "bf16", save_res, plan.cluster, plan.bt, plan.ksplit)


def forward_report(entry, xps, mask, whs, reverse, prec, ms=None):
    """The plan of the forward kernel's last launch, what the card gives it,
    and (one more launch) the SM cycles a step spends in its parts."""
    from phones_las_torch.ops import lstm as L

    plan = L._launch_forward.last_plan
    t = xps[0].shape[0]
    info = plan_info(plan, len(xps), prec, entry == "plt_lstm_residual")
    clocks = torch.zeros(len(FWD_CLOCKS), dtype=torch.int64, device=DEV)
    L._launch_forward(entry, xps, mask, whs, 1.0, reverse, prec, None, clocks)
    torch.cuda.synchronize()
    rep = {
        "cluster": plan.cluster, "bt": plan.bt, "ksplit": plan.ksplit, "wh_in_smem": plan.resident,
        "kernel_units": plan.units, "clusters_launched": -(-xps[0].shape[1] // plan.bt) * len(xps), **info,
        "grid": None if plan.grid is None else plan.grid._asdict(),
        "cycles_per_step": dict(zip(GRID_CLOCKS if plan.grid else FWD_CLOCKS, (c / t for c in clocks.tolist()))),
    }
    if ms is not None:
        rep["us_per_step"] = ms * 1e3 / t
    if info["smem_bytes"] != plan.smem:
        fail(f"the kernel's shared memory ({info['smem_bytes']}) is not what forward_plan computed ({plan.smem})")
    return rep


def check_bilstm(params, b, t, layer, prec, seed):
    pf, pb = params.listener.layers[layer]
    u = pf.units
    g = torch.Generator(device=DEV).manual_seed(seed)
    lengths = torch.randint(t // 2, t + 1, (b,), generator=g, device=DEV)
    lengths[0] = t
    xpf = torch.randn((t, b, 4 * u), generator=g, device=DEV)
    xpb = torch.randn((t, b, 4 * u), generator=g, device=DEV)
    return check_bilstm_inputs(pf, pb, xpf, xpb, lengths, prec, g)


def check_bilstm_inputs(pf, pb, xpf, xpb, lengths, prec, g, phase=1, held=True, plain_reps=PLAIN_REPS, reps=10):
    """The BiLSTM kernel against its plain version on given projected
    inputs [T, B, 4U] and lengths, timed beside cuDNN's ``torch.nn.LSTM``;
    ``held`` fails a launch whose wh slices are not held in shared memory
    by a cluster, or whose clusters take more than one wave."""
    from phones_las_torch.ops.lstm import bidir_recurrence, bidir_recurrence_plain
    from phones_las_torch.ops.masking import length_mask

    t, b, u4 = xpf.shape
    u = u4 // 4
    mask = length_mask(lengths, t).transpose(0, 1).contiguous()
    args = (xpf, xpb, mask, pf.wh, pb.wh, 1.0, prec)
    of, ob, (hf, cf), (hb, cb) = bidir_recurrence(*args)
    pof, pob, (phf, pcf), (phb, pcb) = bidir_recurrence_plain(*args)
    torch.cuda.synchronize()
    atol, rtol = (1e-5, 1e-5) if prec == "highest" else (2e-2, 0.0)
    max_abs, max_rel, ok = compare(
        (of, ob, hf, cf, hb, cb), (pof, pob, phf, pcf, phb, pcb), atol, rtol
    )
    # one bidirectional torch.nn.LSTM (cuDNN) over full-length rows of the
    # layer's real input width: the same recurrence with the forget bias
    # folded into the bias, plus the input projection the kernel leaves out
    d = pf.wx.shape[0]
    lstm = torch.nn.LSTM(d, u, bidirectional=True).to(DEV)
    with torch.no_grad():
        fb = torch.zeros(4 * u, device=DEV)
        fb[u:2 * u] = 1.0
        for sfx, p in (("", pf), ("_reverse", pb)):
            getattr(lstm, f"weight_ih_l0{sfx}").copy_(p.wx.t())
            getattr(lstm, f"weight_hh_l0{sfx}").copy_(p.wh.t())
            getattr(lstm, f"bias_ih_l0{sfx}").copy_(p.b + fb)
            getattr(lstm, f"bias_hh_l0{sfx}").zero_()
    x_in = torch.randn((t, b, d), generator=g, device=DEV)
    wbytes = 2 if prec == "bf16" else 4
    nbytes = 4 * (2 * t * b * 4 * u + t * b + 2 * t * b * u + 4 * b * u) + 2 * wbytes * u * 4 * u
    flops = 2 * t * b * (2 * u * 4 * u)
    bms, by = bound(nbytes, flops, BF16_FLOPS if prec == "bf16" else F32_FLOPS)
    ms = time_ms(lambda: bidir_recurrence(*args), reps=reps)
    launch = forward_report("plt_lstm_recurrence", [xpf, xpb], mask, [pf.wh, pb.wh], [False, True], prec, ms)
    rec = {
        "phase": phase, "kernel": "bidir_recurrence", "shape": f"T={t} B={b} U={u} prec={prec}",
        "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": f"atol={atol} rtol={rtol}",
        "max_rel_to_max": max(rel_err(x, y) for x, y in zip((of, ob, hf, cf, hb, cb), (pof, pob, phf, pcf, phb, pcb))),
        "ms": ms, "launch": launch,
        "plain_ms": time_ms(lambda: bidir_recurrence_plain(*args), reps=plain_reps, warmup=min(1, plain_reps - 1)),
        "library_ms": time_ms(lambda: lstm(x_in), reps=reps),
        "library": f"torch.nn.LSTM({d}, {u}, bidirectional=True), includes the input projection",
        "bound_ms": bms, "bound_by": by,
    }
    emit(rec)
    if not ok:
        fail(f"BiLSTM kernel disagrees with its plain version: {rec}")
    if held and (launch["cluster"] <= 1 or not launch["wh_in_smem"]):
        fail(f"the BiLSTM kernel did not run as a cluster with wh in shared memory: {launch}")
    if held and launch["clusters_launched"] > launch["max_active_clusters"]:
        fail(f"the BiLSTM kernel's clusters do not fit in one wave: {launch}")
    return rec


# the forward against its plain version, max |d| over the plain's largest
# (PERF.md section 6): float32 6.6e-7 up to U = 1024, 2.0e-6 past it; bf16
# 1.6e-2 (the residuals rounded to bf16)
def forward_rel_tol(u: int, prec: str) -> float:
    return 1.6e-2 if prec == "bf16" else 6.6e-7 if u <= 1024 else 2.0e-6


def check_lstm_ragged(t, b, u, seed, phase=1, passes_in=()):
    """The forward kernel on a batch that is no multiple of its tile, rows
    of lengths from 1 to T, and (U = 40, 248) widths only a cluster of one
    or the grid layout serves: both precisions, one and two directions, both entries, each
    launched twice and held bitwise equal, and within ``forward_rel_tol``
    of the plain version's largest; each plan with the shared memory and
    registers the card gives it (its shared memory held to
    ``forward_plan``'s), the grid layout's with its blocks, resident share
    and passes, every call's ``grid_launches`` its plan's passes. In the
    precisions ``passes_in`` every plan must be the grid layout's in
    several passes of rows (a launch each, from row0 > 0 on)."""
    from phones_las_torch.ops import lstm as L
    from phones_las_torch.ops.masking import length_mask

    def counted(fn, *args):
        """``fn(*args)``, its grid launches held to the plan's passes."""
        nonlocal ok
        before = fn.grid_launches
        r = fn(*args)
        grid = L._launch_forward.last_plan.grid
        ok = ok and fn.grid_launches - before == (grid.passes if grid is not None else 0)
        ok = ok and (prec not in passes_in or (grid is not None and grid.passes > 1))
        return r

    g = torch.Generator(device=DEV).manual_seed(seed)
    lengths = torch.randint(1, t + 1, (b,), generator=g, device=DEV)
    lengths[0], lengths[1] = t, 1
    mask = length_mask(lengths, t).transpose(0, 1).contiguous()
    worst, worst_rel = {}, {}
    plans = {}
    ok = True
    for prec in ("highest", "bf16"):
        tol, res_tol = (1e-5, 1e-5) if prec == "highest" else (2e-2, 3e-2)
        for nd in (1, 2):
            xps = [torch.randn((t, b, 4 * u), generator=g, device=DEV) for _ in range(nd)]
            whs = [torch.randn((u, 4 * u), generator=g, device=DEV) / u ** 0.5 for _ in range(nd)]
            rev = [False, True][:nd] if nd == 2 else [True]
            want = L.recurrence_residual_plain(xps, mask, whs, 1.0, rev, prec)
            got = counted(L.recurrence_residual, xps, mask, whs, 1.0, rev, prec)
            again = counted(L.recurrence_residual, xps, mask, whs, 1.0, rev, prec)
            ok = ok and all(torch.equal(x, y) for kg, ag in zip(got, again) for x, y in zip(kg, ag))
            plans[(prec, True, nd, L._launch_forward.last_plan)] = None
            primals = []
            for _ in range(2):
                if nd == 1:
                    out, (h, c) = counted(L.recurrence, xps[0], mask, whs[0], 1.0, rev[0], prec)
                    primals.append([(out, h, c)])
                else:
                    of, ob, (hf, cf), (hb, cb) = counted(L.bidir_recurrence, xps[0], xps[1], mask, whs[0], whs[1],
                                                         1.0, prec)
                    primals.append([(of, hf, cf), (ob, hb, cb)])
            primal = primals[0]
            ok = ok and all(torch.equal(x, y) for ka, kb in zip(*primals) for x, y in zip(ka, kb))
            plans[(prec, False, nd, L._launch_forward.last_plan)] = None
            torch.cuda.synchronize()
            for k, p, pr in zip(got, want, primal):
                a, _, k_ok = compare((k[0], k[3], k[4]), (p[0], p[3], p[4]), tol, tol)
                ar, _, r_ok = compare((k[1], k[2]), (p[1], p[2]), res_tol, res_tol)
                ap, _, p_ok = compare(pr, (p[0], p[3], p[4]), tol, tol)
                rel = max(rel_err(x, y) for x, y in zip((*k, *pr), (*p, p[0], p[3], p[4])))
                ok = ok and k_ok and r_ok and p_ok and rel <= forward_rel_tol(u, prec)
                worst[prec] = max(worst.get(prec, 0.0), a, ar, ap)
                worst_rel[prec] = max(worst_rel.get(prec, 0.0), rel)
    infos = []
    for prec, save, nd, p in plans:
        info = plan_info(p, nd, prec, save)
        infos.append({"prec": prec, "residual": save, "nd": nd, "route": "grid" if p.grid else "template",
                      "plan (cluster, bt, ksplit, wh_in_smem, smem_bytes, units, grid)": p, **info})
        ok = ok and info["smem_bytes"] == p.smem
    rec = {"phase": phase, "kernel": "lstm forward, ragged", "shape": f"T={t} B={b} U={u} lengths 1..{t}",
           "max_abs_err": worst, "max_rel_to_max": worst_rel,
           "tol": f"highest 1e-5; bf16 2e-2, residuals 3e-2; max |d| / max |plain| <= "
                  f"{forward_rel_tol(u, 'highest')} (bf16 {forward_rel_tol(u, 'bf16')}); every entry bitwise "
                  "repeatable; grid_launches the plan's passes"
                  + (f"; several passes in {', '.join(passes_in)}" if passes_in else ""), "plans": infos, "ok": ok}
    emit(rec)
    if not ok:
        fail(f"the LSTM forward kernel disagrees with its plain version (or forward_plan's bytes) on a ragged "
             f"case: {rec}")
    return rec


def greedy_bound(sp, sc, tok, t: int, steps: int):
    """The decoder's bound on tokens ``tok`` [B, steps] over T_enc = t:
    the operations of the row-steps this data runs (each row up to and
    including its <eos>) against every input read once and the tokens
    written → (the row-steps, the row-steps each row ran, ms, what bounds
    it)."""
    b = tok.shape[0]
    is_eos = (tok == sc.eos_id).int()
    first = torch.where(is_eos.any(1), is_eos.argmax(1) + 1, torch.full_like(is_eos[:, 0], steps))
    u, a, m, al, v, e = sc.units, sc.attention_units, sc.memory_dim, sc.attention_layer_size, sc.vocab_size, sc.embedding_dim
    per_step = (
        2 * (e + al) * 4 * u + 2 * (sc.num_layers - 1) * u * 4 * u + 2 * sc.num_layers * u * 4 * u
        + 2 * u * a + t * (3 * a + 2 * m + 4) + 2 * (u + m) * al + 2 * al * v
    )
    wparams = sum(p.numel() for p in sp.parameters())
    nbytes = 4 * (b * t * (a + m + 1) + wparams + b * steps)
    return int(first.sum()), first, *bound(nbytes, int(first.sum()) * per_step, F32_FLOPS)


def check_greedy(params, cfg, memory, enc_mask, b, steps=DECODE_STEPS, timed=True, phase=1, what=None):
    from phones_las_torch.decode import fused_greedy
    from phones_las_torch.decode.fused_greedy import greedy_decode_fused, greedy_decode_fused_plain

    sp, sc = params.speller, cfg.speller
    mem, mask = memory[:b].contiguous(), enc_mask[:b].contiguous()
    tok, _ = greedy_decode_fused(sp, sc, mem, mask, steps)
    ptok, _ = greedy_decode_fused_plain(sp, sc, mem, mask, steps)
    torch.cuda.synchronize()
    diff_rows = int((tok != ptok).any(dim=1).sum())
    t = mem.shape[1]
    row_steps, first, bms, by = greedy_bound(sp, sc, tok, t, steps)
    a, m, v = sc.attention_units, sc.memory_dim, sc.vocab_size
    wparams = sum(p.numel() for p in sp.parameters())
    clocks = torch.zeros(fused_greedy.CLOCKS, dtype=torch.int64, device=DEV)
    wp, widths = fused_greedy._unflatten(fused_greedy.flat_weights(sp), mem, sc.bos_id, sc.eos_id)
    fused_greedy._launch(wp, widths, mem, mask, steps, clocks)
    torch.cuda.synchronize()
    launch = dict(greedy_decode_fused.last_launch)
    counts = clocks.tolist()
    steps_run = max(counts[15], 1)  # of the first group
    launch["steps_of_first_group"] = counts[15]
    launch["cycles_per_step"] = step_cycles(launch["layout"], counts)
    # the design's own floor: the weights the kernel reads once a group (the
    # grid layout: once) and step, each row's keys and memory up to its last
    # valid position once a step; from L2 at 5.5 TB/s where what a step
    # reads fits its 50 MB, else from device memory at 3.35 TB/s
    groups = -(-b // launch["rows"]) if launch["layout"] == "held" else 1
    step_weights = wparams - sp.attention.wk.numel()  # the keys are made once a call, before the kernel
    valid = (mask != 0).int()
    positions = int(torch.where(valid.any(1), t - valid.flip(1).argmax(1), 0).sum())
    launch["bytes_per_step"] = 4 * (groups * step_weights + positions * (a + m))
    from_l2 = 4 * (step_weights + positions * (a + m)) <= L2_BYTES
    rec = {
        "phase": phase, "kernel": "greedy_decode_fused", "shape": f"B={b} T={t} steps={steps}",
        "vocab": v, "cells": sc.num_layers,
        "max_abs_err": float((tok - ptok).abs().max()), "token_rows_differing": diff_rows,
        "tol": "tokens equal",
        "row_steps": row_steps, "launch": launch,
        "library_ms": None, "bound_ms": bms, "bound_by": by,
        # the design's floor: its bytes a step at that rate, over the steps the longest row ran
        "step_floor_ms": launch["bytes_per_step"] / (L2_BYTES_PER_S if from_l2 else HBM_BYTES_PER_S) * 1e3
        * int(first.max()),
        "step_floor_from": "L2" if from_l2 else "device memory",
    }
    if what is not None:
        rec["what"] = what
    if timed:
        rec["ms"] = time_ms(lambda: greedy_decode_fused(sp, sc, mem, mask, steps))
        rec["plain_ms"] = time_ms(lambda: greedy_decode_fused_plain(sp, sc, mem, mask, steps), reps=PLAIN_REPS)
        launch["us_per_step"] = rec["ms"] * 1e3 / max(int(first.max()), 1)
    if diff_rows:
        bad = [{"row": r, "first_step": int((tok[r] != ptok[r]).nonzero()[0])}
               for r in (tok != ptok).any(dim=1).nonzero().flatten().tolist()]
        rec["rows_differing"] = bad
    emit(rec)
    if diff_rows:
        fail(f"greedy kernel tokens differ from its plain version: {rec}")
    # the kernel's shared memory is the wrapper's mirror of its layout (at the
    # kernel's widths), all dynamic
    if (launch["smem_bytes"], launch["static_smem_bytes"]) != (launch["smem_expected"], 0):
        fail(f"the greedy kernel's shared memory is not decoder_smem_bytes: {rec}")
    if timed and launch["cluster"] <= 1 and launch["layout"] == "held":
        fail(f"the greedy kernel did not run as a cluster: {launch}")
    return rec


def step_cycles(layout: str, counts) -> dict:
    """The decoder kernel's cycle counters (the steps at 15) → cycles a
    step of each part, by the layout's names."""
    from phones_las_torch.decode.fused_greedy import CLOCK_NAMES, GRID_CLOCK_NAMES

    names = CLOCK_NAMES if layout == "held" else GRID_CLOCK_NAMES
    steps = max(counts[15], 1)
    return {n: c / steps for n, c in zip(names, counts) if n != "steps"}


# the decoder at each shape of PERF.md's row 3 (--sweep-decoder, --compare, the phases' checks):
# (label, B, T_enc, steps, V, cells, U, A, AL, M, E); the first two decode the checkpoint's encoder
# memory of random PCM (phase 1's), the others a random init (seed 21) on random memory, ragged
DECODER_SHAPES = (
    ("flagship", 64, 250, 200, 26, 2, 256, 256, 256, 512, 128),
    ("flagship B=8", 8, 250, 200, 26, 2, 256, 256, 256, 512, 128),
    ("G2P", 64, 28, 24, 45, 1, 160, 160, 160, 320, 64),
    ("TIMIT", 32, 400, 80, 65, 1, 256, 256, 256, 512, 128),
    ("grapheme head", 32, 400, 120, 32, 1, 256, 256, 256, 512, 128),
    ("Common Voice", 32, 438, 200, 120, 1, 256, 256, 256, 512, 128),
    ("offline", 256, 438, 300, 34, 2, 256, 256, 256, 512, 128),
    ("W1024", 32, 219, 200, 34, 2, 1024, 1024, 256, 2048, 128),
    ("W1024 T=438", 32, 438, 200, 34, 2, 1024, 1024, 256, 2048, 128),
    ("W1024 AL=1024", 32, 219, 200, 34, 2, 1024, 1024, 1024, 2048, 128),
    ("LAS 2x512", 32, 438, 200, 34, 2, 512, 512, 256, 512, 128),
    ("T=17100", 8, 17100, 60, 34, 2, 256, 256, 256, 512, 128),
    ("T=17100 one row", 1, 17100, 60, 34, 2, 256, 256, 256, 512, 128),
    ("T=40000", 8, 40000, 60, 34, 2, 256, 256, 256, 512, 128),
    ("W1024 speller T=5900", 8, 5900, 60, 34, 2, 1024, 1024, 256, 2048, 128),
    ("W2048", 8, 219, 60, 34, 2, 2048, 2048, 2048, 4096, 128),
)
DECODER_LAYOUTS = ("held", "grid")  # decoder_plan's layouts, each forced in turn
SWEEP_DECODER_REPS = 5


def decoder_case(shape, params, cfg, memory, enc_mask):
    """One of DECODER_SHAPES → (speller params, its config, memory, mask,
    steps): the checkpoint's speller on phase 1's memory for the flagship
    shapes, else a random init on random memory of ragged lengths."""
    from phones_las_torch.models.speller import SpellerConfig, init_speller
    from phones_las_torch.ops.masking import length_mask

    label, b, t, steps, v, n, u, a, al, m, e = shape
    if label.startswith("flagship"):
        return params.speller, cfg.speller, memory[:b].contiguous(), enc_mask[:b].contiguous(), steps
    sc = SpellerConfig(vocab_size=v, embedding_dim=e, num_layers=n, units=u, memory_dim=m, attention_units=a,
                       attention_layer_size=al)
    g = torch.Generator(device=DEV).manual_seed(21)
    sp = init_speller(sc, torch.Generator().manual_seed(21), device=DEV)
    mem = torch.randn(b, t, m, generator=g, device=DEV)
    lens = torch.randint(max(1, t // 2), t + 1, (b,), generator=g, device=DEV)
    lens[0] = t
    return sp, sc, mem, length_mask(lens, t), steps


def decoder_layouts(sp, sc, mem, mask, steps, reps=SWEEP_DECODER_REPS) -> dict:
    """Each layout that fits the shape, forced (``_launch(layout=)``): its
    plan, its tokens against the plain version's (two launches bitwise
    equal), its cycles a step by part and the modelled µs a step; then the
    layouts timed in turns (each forward, then backward; medians of
    ``reps``) → {layout: record}."""
    from phones_las_torch.decode import fused_greedy as FG

    wp, widths = FG._unflatten(FG.flat_weights(sp), mem, sc.bos_id, sc.eos_id)
    b, t = mem.shape[:2]
    plain, _ = FG.greedy_decode_fused_plain(sp, sc, mem, mask, steps)
    out = {}
    for layout in DECODER_LAYOUTS:
        try:
            FG.kernel_widths(b, widths, t, layout, torch.cuda.get_device_properties(0).multi_processor_count)
        except ValueError:
            continue
        run = lambda layout=layout: FG._launch(wp, widths, mem, mask, steps, layout=layout)
        toks = [run(), run()]
        torch.cuda.synchronize()
        launch = dict(FG.greedy_decode_fused.last_launch)
        clocks = torch.zeros(FG.CLOCKS, dtype=torch.int64, device=DEV)
        FG._launch(wp, widths, mem, mask, steps, clocks, layout=layout)
        torch.cuda.synchronize()
        counts = clocks.tolist()
        out[layout] = {
            "plan": launch["layout"], "cluster": launch["cluster"], "grid": launch["grid"], "passes": launch["passes"],
            "smem_bytes": launch["smem_bytes"], "smem_expected": launch["smem_expected"],
            "registers": launch["registers"], "co_resident": launch["max_active_clusters"],
            "modelled_us_per_step": launch["modelled_us_per_step"], "steps_run": counts[15],
            "cycles_per_step": step_cycles(launch["layout"], counts),
            "rows_differing_from_plain": int((toks[0] != plain).any(1).sum()),
            "bitwise_repeatable": bool(torch.equal(*toks)), "run": run}
    names = list(out)
    ms = {x: [] for x in names}
    for layout in (names + names[::-1]) if reps else ():
        ms[layout].append(time_ms(out[layout]["run"], reps=reps))
    for layout in names:
        r = out[layout]
        del r["run"]
        if reps:
            r["ms"] = statistics.mean(ms[layout])
            r["ms_turns"] = ms[layout]
            r["us_per_step"] = r["ms"] * 1e3 / max(r["steps_run"], 1)
    return out


def layouts_agree(recs: dict) -> list:
    """The layouts of ``decoder_layouts``' records that disagree with the
    plain version, with themselves or with ``decoder_smem_bytes``."""
    return [k for k, r in recs.items() if r["rows_differing_from_plain"] or not r["bitwise_repeatable"]
            or r["smem_bytes"] != r["smem_expected"]]


def check_decoder_layouts(params, cfg, memory, enc_mask, card) -> None:
    """Phase 1: batches that are no multiple of the group, rows of very
    different lengths (1..T), through the plan's layout (``check_greedy``)
    and each layout forced; each layout forced at the flagship shape and
    at W1024 (B = 32, T_enc 219, random init; the grid alone fits); each against the plain
    version (tokens equal, two launches bitwise equal, shared memory
    ``decoder_smem_bytes``)."""
    from phones_las_torch.ops.masking import length_mask

    t_enc = memory.shape[1]
    cases = []
    for i, b in enumerate(RAGGED_DECODER_BS):
        g = torch.Generator(device=DEV).manual_seed(50 + i)
        rag_len = torch.randint(1, t_enc + 1, (b,), generator=g, device=DEV)
        rag_len[0], rag_len[1] = t_enc, 1
        mask = length_mask(rag_len, t_enc)
        check_greedy(params, cfg, memory, mask, b, steps=RAGGED_DECODER_STEPS, timed=False)
        cases.append((f"ragged B={b}", params.speller, cfg.speller, memory[:b].contiguous(), mask,
                      RAGGED_DECODER_STEPS))
    cases.append(("flagship", params.speller, cfg.speller, memory, enc_mask, DECODE_STEPS))
    w1024 = next(x for x in DECODER_SHAPES if x[0] == "W1024")
    cases.append(("W1024", *decoder_case(w1024, params, cfg, memory, enc_mask)))
    out = {}
    for label, sp, sc, mem, mask, steps in cases:
        recs = decoder_layouts(sp, sc, mem, mask, steps, reps=0)
        out[label] = {k: {x: r[x] for x in ("plan", "smem_bytes", "registers", "rows_differing_from_plain",
                                             "bitwise_repeatable", "steps_run")} for k, r in recs.items()}
        if layouts_agree(recs) or len(recs) < (1 if label == "W1024" else 2):  # W1024 fits only the grid
            fail(f"phase 1: a decoder layout disagrees with the plain version, with itself or with "
                 f"decoder_smem_bytes, or does not run, at {label}: {recs}")
    emit({"phase": 1, "kernel": "greedy_decode_fused", "what": "every layout forced", "layouts": out, "card": card})


def sweep_decoder(params, cfg, memory, enc_mask, labels=()) -> None:
    """``--sweep-decoder``: every layout at each of DECODER_SHAPES (or those
    labelled), held to the plain version, timed in turns, with the cycles
    a step by part and the step model's µs: the readings the model's
    constants are fitted to. Fails on a layout that disagrees with the
    plain version or with itself, or whose shared memory is not
    ``decoder_smem_bytes``."""
    from phones_las_torch.decode import fused_greedy as FG

    for shape in DECODER_SHAPES:
        if labels and shape[0] not in labels:
            continue
        sp, sc, mem, mask, steps = decoder_case(shape, params, cfg, memory, enc_mask)
        recs = decoder_layouts(sp, sc, mem, mask, steps)
        b, t = mem.shape[:2]
        plan = FG.decoder_plan(b, FG.kernel_widths(b, sc, t)[0], t).name
        rec = {"phase": "sweep-decoder", "shape": shape[0], "B": b, "T": t, "steps": steps, "vocab": sc.vocab_size,
               "cells": sc.num_layers, "units": sc.units, "plan": plan, "layouts": recs,
               "fastest": min(recs, key=lambda k: recs[k]["ms"])}
        emit(rec)
        bad = layouts_agree(recs)
        if bad:
            fail(f"--sweep-decoder: {bad} disagree with the plain version, with themselves or with "
                 f"decoder_smem_bytes at {shape[0]}: {rec}")


def rel_err(got, want) -> float:
    """max |got − want| over max |want|."""
    return float((got.double() - want.double()).abs().max()) / max(float(want.double().abs().max()), 1e-30)


BWD_PARTS = ("gates_gemm", "loop", "dwh_partial", "dwh_reduce")
BWD_CLOCKS = ("dgates", "product", "send", "prefetch", "wait")  # the template loop's
GRID_BWD_CLOCK_NAMES = ("dgates", "arrive", "product", "barrier", "intake", "exchange", "partials")


def backward_report(bargs, t):
    """The plan of the VJP's last launch, what the card gives its loop
    kernel, the milliseconds of its four kernels (median of 5 launches) and
    (one more launch) the SM cycles a step of the loop spends in its parts
    (the grid layout's ``GRID_BWD_CLOCK_NAMES``, the template's
    ``BWD_CLOCKS``)."""
    from phones_las_torch.ops import lstm as L

    plan = L._launch_backward.last_plan
    xps, prec = bargs[0], bargs[-1]
    info = L.backward_kernel_info(prec == "bf16", plan)
    runs = []
    for _ in range(5):
        ms = []
        L._launch_backward(*bargs, part_ms=ms)
        runs.append(ms)
    parts = {name: statistics.median(r[i] for r in runs) for i, name in enumerate(BWD_PARTS)}
    names = GRID_BWD_CLOCK_NAMES if plan.grid is not None else BWD_CLOCKS
    clocks = torch.zeros(len(names), dtype=torch.int64, device=DEV)
    L._launch_backward(*bargs, clocks=clocks)
    torch.cuda.synchronize()
    rep = {
        "cluster": plan.cluster, "bt": plan.bt, "ksplit": plan.ksplit, "wh_in_smem": plan.resident,
        "grid": None if plan.grid is None else plan.grid._asdict(), "kernel_units": plan.units,
        "clusters_launched": -(-xps[0].shape[1] // plan.bt) * len(xps), **info, "kernel_ms": parts, "us_per_step": parts["loop"] * 1e3 / t,
        "cycles_per_step": dict(zip(names, (c / t for c in clocks.tolist()))),
    }
    if info["smem_bytes"] != plan.smem:
        fail(f"the loop kernel's shared memory ({info['smem_bytes']}) is not what backward_plan computed ({plan.smem})")
    return rep


def check_lstm_bwd_ragged(t, b, u, seed, phase="4a", passes_in=()):
    """The VJP on a batch that is no multiple of its tile, rows of lengths
    from 1 to T, and (U = 40, 248) widths only a cluster of one serves:
    both precisions, one and two directions, against the plain version on
    the plain version's residuals; two runs bitwise equal; masked steps pass
    no gradient; every call's ``grid_launches`` its plan's passes, and in
    the modes of ``passes_in`` more than one pass."""
    from phones_las_torch.ops import lstm as L
    from phones_las_torch.ops.masking import length_mask

    g = torch.Generator(device=DEV).manual_seed(seed)
    lengths = torch.randint(1, t + 1, (b,), generator=g, device=DEV)
    lengths[0], lengths[1] = t, 1
    mask = length_mask(lengths, t).transpose(0, 1).contiguous()
    worst, plans = {}, set()
    ok = True

    def counted(bargs):
        before = L.recurrence_bwd.grid_launches
        out = L.recurrence_bwd(*bargs)
        grid = L._launch_backward.last_plan.grid
        return out, L.recurrence_bwd.grid_launches - before == (grid.passes if grid is not None else 0)

    for prec in ("highest", "bf16"):
        tol = 1e-4 if prec == "highest" else 3e-2
        for nd in (1, 2):
            rnd = lambda *shape: torch.randn(shape, generator=g, device=DEV)
            xps = [rnd(t, b, 4 * u) for _ in range(nd)]
            whs = [rnd(u, 4 * u) / u ** 0.5 for _ in range(nd)]
            rev = [False, True][:nd] if nd == 2 else [True]
            res = L.recurrence_residual_plain(xps, mask, whs, 1.0, rev, prec)
            bargs = (xps, mask, whs, [r[1] for r in res], [r[2] for r in res],
                     [rnd(t, b, u) for _ in range(nd)], [rnd(b, u) for _ in range(nd)],
                     [rnd(b, u) for _ in range(nd)], 1.0, rev, prec)
            got, counts_ok = counted(bargs)
            plan = L._launch_backward.last_plan
            plans.add((prec, nd, plan))
            again, again_ok = counted(bargs)
            want = L.recurrence_bwd_plain(*bargs)
            torch.cuda.synchronize()
            err = max(rel_err(k, p) for kg, pg in zip(got, want) for k, p in zip(kg, pg))
            same = all(torch.equal(x, y) for kg, ag in zip(got, again) for x, y in zip(kg, ag))
            # masked steps pass no gradient into xp
            dead = all(float((kg[0] * (1.0 - mask)[:, :, None]).abs().max()) == 0.0 for kg in got)
            passes = plan.grid.passes if plan.grid is not None else 1
            ok = ok and err <= tol and same and dead and counts_ok and again_ok
            ok = ok and (passes > 1 or prec not in passes_in)
            worst[prec] = max(worst.get(prec, 0.0), err)
    infos = []
    for prec, nd, p in sorted(plans, key=lambda x: x[:2]):
        info = L.backward_kernel_info(prec == "bf16", p)
        infos.append({"prec": prec, "nd": nd, "plan (cluster, bt, ksplit, wh_in_smem, smem_bytes, units, grid)": p,
                      **info})
        ok = ok and info["smem_bytes"] == p.smem
    rec = {"phase": phase, "kernel": "recurrence_bwd, ragged", "shape": f"T={t} B={b} U={u} lengths 1..{t}",
           "max_rel_to_max": worst, "tol": "dxp, dwh max|d|/max|plain|: highest 1e-4, bf16 3e-2; bitwise repeatable; "
                                           "masked steps pass no gradient; grid_launches the plan's passes",
           "plans": infos, "ok": ok}
    emit(rec)
    if not ok:
        fail(f"the VJP kernel disagrees with its plain version on a ragged case: {rec}")
    return rec


def cudnn_lstm(d, u, bidirectional):
    """A torch.nn.LSTM (cuDNN) of the listener layer's width, for library_ms."""
    return torch.nn.LSTM(d, u, bidirectional=bidirectional).to(DEV)


def check_lstm_train(pair, t, prec, seed, b=TRAIN_B, ragged=False, phase="4a", one_wave=True, held=True,
                     plain_reps=PLAIN_REPS, reps=10):
    """Phase 4a: the training path's three LSTM kernels against their
    plain versions at B = TRAIN_B, both directions, with the weights of
    ``pair`` (forward, backward LSTMParams) → (recurrence record, residual
    record, VJP record). ``ragged`` draws lengths 1..T in place of T/2..T;
    ``one_wave`` fails a VJP whose clusters take more than one wave (a batch
    that no plan fits in one wave runs in several); ``held`` one whose loop
    does not hold its slices of wh in shared memory; the plain versions are
    timed over ``plain_reps`` runs, the kernels and cuDNN over ``reps``."""
    from phones_las_torch.ops import lstm as L
    from phones_las_torch.ops.masking import length_mask

    pf, pb = pair
    u, d = pf.units, pf.wx.shape[0]
    g = torch.Generator(device=DEV).manual_seed(seed)
    lengths = torch.randint(1 if ragged else t // 2, t + 1, (b,), generator=g, device=DEV)
    lengths[0] = t
    if ragged:
        lengths[1] = 1
    xpf, xpb = (torch.randn((t, b, 4 * u), generator=g, device=DEV) for _ in range(2))
    mask = length_mask(lengths, t).transpose(0, 1).contiguous()
    whs = [pf.wh.detach(), pb.wh.detach()]
    bf16 = prec == "bf16"
    tol = 2e-2 if bf16 else 1e-5
    res_tol = 3e-2 if bf16 else 1e-5
    vjp_tol = 3e-2 if bf16 else 1e-4
    peak = BF16_FLOPS if bf16 else F32_FLOPS
    wbytes = rbytes = 2 if bf16 else 4
    dot = 2 * t * b * u * 4 * u  # one direction's recurrent dots
    shape = f"T={t} B={b} U={u} prec={prec}"

    # library yardsticks: cuDNN LSTMs of the layer's width over full-length rows
    x_in = torch.randn((t, b, d), generator=g, device=DEV, requires_grad=True)
    uni, bi = cudnn_lstm(d, u, False), cudnn_lstm(d, u, True)
    g_out = torch.randn((t, b, 2 * u), generator=g, device=DEV)

    def lib_fwd_bwd():
        torch.autograd.backward(bi(x_in)[0], g_out)

    with torch.no_grad():
        lib_uni_ms = time_ms(lambda: uni(x_in), reps=reps)
    lib_fwd_ms = time_ms(lambda: bi(x_in), reps=reps)
    lib_fwd_bwd_ms = time_ms(lib_fwd_bwd, reps=reps)

    # recurrence (one direction a call): forward on xpf, reverse on xpb
    recs = []
    ok = True
    max_abs = 0.0
    for xp, wh, rev in ((xpf, whs[0], False), (xpb, whs[1], True)):
        out, (h, c) = L.recurrence(xp, mask, wh, 1.0, rev, prec)
        pout, (ph, pc) = L.recurrence_plain(xp, mask, wh, 1.0, rev, prec)
        torch.cuda.synchronize()
        a, _, k_ok = compare((out, h, c), (pout, ph, pc), tol, tol)
        ok, max_abs = ok and k_ok, max(max_abs, a)
    nbytes = 4 * (t * b * 4 * u + t * b + t * b * u + 2 * b * u) + wbytes * u * 4 * u
    bms, by = bound(nbytes, dot, peak)
    ms = time_ms(lambda: L.recurrence(xpf, mask, whs[0], 1.0, False, prec), reps=reps)
    recs.append({
        "phase": phase, "kernel": "recurrence", "shape": shape + " one direction",
        "max_abs_err": max_abs, "tol": f"atol=rtol={tol}", "ok": ok,
        "ms": ms, "launch": forward_report("plt_lstm_recurrence", [xpf], mask, whs[:1], [False], prec, ms),
        "plain_ms": time_ms(lambda: L.recurrence_plain(xpf, mask, whs[0], 1.0, False, prec), reps=plain_reps,
                            warmup=min(1, plain_reps - 1)),
        "library_ms": lib_uni_ms, "library": f"torch.nn.LSTM({d}, {u}) forward, no grad",
        "library_fwd_bwd_ms": lib_fwd_bwd_ms, "bound_ms": bms, "bound_by": by,
    })

    # recurrence_residual: both directions in one launch
    args = ([xpf, xpb], mask, whs, 1.0, [False, True], prec)
    res = L.recurrence_residual(*args)
    pres = L.recurrence_residual_plain(*args)
    torch.cuda.synchronize()
    max_abs, ok = 0.0, True
    for k, pk in zip(res, pres):
        a, _, s_ok = compare((k[0], k[3], k[4]), (pk[0], pk[3], pk[4]), tol, tol)
        ar, _, r_ok = compare((k[1], k[2]), (pk[1], pk[2]), res_tol, res_tol)
        ok, max_abs = ok and s_ok and r_ok, max(max_abs, a, ar)
    res_rel = max(rel_err(x, y) for k, pk in zip(res, pres) for x, y in zip(k, pk))
    nbytes = 2 * (4 * t * b * 4 * u + 4 * t * b * u + 2 * rbytes * t * b * u + 4 * 2 * b * u + wbytes * u * 4 * u) + 4 * t * b
    bms, by = bound(nbytes, 2 * dot, peak)
    ms = time_ms(lambda: L.recurrence_residual(*args), reps=reps)
    recs.append({
        "phase": phase, "kernel": "recurrence_residual", "shape": shape + " both directions",
        "max_abs_err": max_abs, "max_rel_to_max": res_rel,
        "tol": f"out, h, c atol=rtol={tol}; hprev, cprev atol=rtol={res_tol}", "ok": ok,
        "ms": ms, "launch": forward_report("plt_lstm_residual", [xpf, xpb], mask, whs, [False, True], prec, ms),
        "plain_ms": time_ms(lambda: L.recurrence_residual_plain(*args), reps=plain_reps, warmup=min(1, plain_reps - 1)),
        "library_ms": lib_fwd_ms, "library": f"torch.nn.LSTM({d}, {u}, bidirectional=True) forward under grad",
        "library_fwd_bwd_ms": lib_fwd_bwd_ms, "bound_ms": bms, "bound_by": by,
    })

    # recurrence_bwd on the kernel's own residuals, both directions in one launch
    douts = [torch.randn((t, b, u), generator=g, device=DEV) for _ in range(2)]
    dhs = [torch.randn((b, u), generator=g, device=DEV) for _ in range(2)]
    dcs = [torch.randn((b, u), generator=g, device=DEV) for _ in range(2)]
    bargs = ([xpf, xpb], mask, whs, [r[1] for r in res], [r[2] for r in res], douts, dhs, dcs,
             1.0, [False, True], prec)
    grads = L.recurrence_bwd(*bargs)
    pgrads = L.recurrence_bwd_plain(*bargs)
    again = L.recurrence_bwd(*bargs)
    torch.cuda.synchronize()
    errs = [rel_err(k, p) for kg, pg in zip(grads, pgrads) for k, p in zip(kg, pg)]
    deterministic = all(torch.equal(x, y) for kg, ag in zip(grads, again) for x, y in zip(kg, ag))
    nbytes = 2 * (2 * 4 * t * b * 4 * u + (2 * rbytes + 4) * t * b * u + 4 * 2 * b * u + 2 * wbytes * u * 4 * u + 4 * u * 4 * u) + 4 * t * b
    bms, by = bound(nbytes, 3 * 2 * dot, peak)
    launch = backward_report(bargs, t)
    recs.append({
        "phase": phase, "kernel": "recurrence_bwd", "shape": shape + " both directions",
        "max_abs_err": max(float((k - p).abs().max()) for kg, pg in zip(grads, pgrads) for k, p in zip(kg, pg)),
        "max_rel_to_max": max(errs), "tol": f"dxp, dwh max|d|/max|plain| <= {vjp_tol}",
        "bitwise_repeatable": deterministic, "ok": max(errs) <= vjp_tol and deterministic,
        "ms": time_ms(lambda: L.recurrence_bwd(*bargs), reps=reps), "launch": launch,
        "plain_ms": time_ms(lambda: L.recurrence_bwd_plain(*bargs), reps=plain_reps, warmup=min(1, plain_reps - 1)),
        "library_ms": lib_fwd_bwd_ms, "library": f"torch.nn.LSTM({d}, {u}, bidirectional=True) forward + backward",
        "library_fwd_bwd_ms": lib_fwd_bwd_ms, "bound_ms": bms, "bound_by": by,
    })
    for rec in recs:
        emit(rec)
    bad = [r["kernel"] for r in recs if not r["ok"]]
    if bad:
        fail(f"training LSTM kernels disagree with their plain versions at {shape}: {bad}")
    if held and (launch["grid"] is not None or launch["cluster"] <= 1 or not launch["wh_in_smem"]):
        fail(f"the VJP's loop did not run as a cluster with its slice of wh in shared memory: {launch}")
    if one_wave and launch["grid"] is None and launch["clusters_launched"] > launch["max_active_clusters"]:
        fail(f"the VJP's clusters do not fit in one wave: {launch}")
    return recs


def eval_batch(data) -> dict:
    """All utterances of the committed eval set, targets = refs + <eos>."""
    refs = data["refs"]
    ref_lens = (refs >= 0).sum(axis=1)
    targets = np.zeros((len(refs), int(ref_lens.max()) + 1), np.int32)
    for i, n in enumerate(ref_lens):
        targets[i, :n] = refs[i, :n]
        targets[i, n] = EOS_ID
    return {
        "audio": data["audio"], "audio_lengths": data["lengths"],
        "targets": targets, "target_lengths": (ref_lens + 1).astype(np.int32),
    }


def check_train_step(ckpt, data, kernels):
    """Phase 4b: compute_loss(train=False), backward and one optimizer step
    of the committed checkpoint on the eval set, on the card and on the
    CPU plain path; loss, every gradient leaf and every updated leaf held."""
    from phones_las_torch.models.las import compute_loss
    from phones_las_torch.train.loop import Trainer
    from phones_las_torch.train.state import TrainConfig
    from phones_las_torch.utils.param_io import load_artifact, named_leaves

    batch = eval_batch(data)
    runs = {}
    for dev in (DEV, "cpu"):
        params, cfg, _ = load_artifact(ckpt, device=dev)
        tr = Trainer(cfg, TrainConfig(), device=dev)
        tr.warm_start(params)
        if dev == DEV:
            reset_counters(kernels)
        loss, _ = compute_loss(tr.state.params, cfg, tr.device_batch(batch), train=False, prec=tr.prec)
        loss.backward()
        grads = {k: t.grad.detach().cpu() for k, t in named_leaves(tr.state.params) if t.grad is not None}
        tr.apply_gradients()
        if dev == DEV:
            torch.cuda.synchronize()
            launches = launch_counts(kernels)
        runs[dev] = (loss.item(), grads, {k: t.detach().cpu() for k, t in named_leaves(tr.state.params)})
    (gl, gg, gp), (cl, cg, cp) = runs[DEV], runs["cpu"]
    loss_rel = abs(gl - cl) / abs(cl)
    grad_rel = {k: rel_err(gg[k], cg[k]) for k in cg}
    param_abs = {k: float((gp[k] - cp[k]).abs().max()) for k in cp}
    worst_g = max(grad_rel, key=grad_rel.get)
    worst_p = max(param_abs, key=param_abs.get)
    rec = {
        "phase": "4b", "utterances": len(batch["audio"]), "loss_gpu": gl, "loss_cpu": cl,
        "loss_rel_err": loss_rel, "loss_tol": LOSS_TOL,
        "grad_leaves": len(grad_rel), "grad_max_rel_to_max": grad_rel[worst_g], "grad_worst_leaf": worst_g,
        "grad_tol": GRAD_TOL, "param_max_abs_err": param_abs[worst_p], "param_worst_leaf": worst_p,
        "param_tol": PARAM_TOL, "launches": launches,
    }
    emit(rec)
    if set(gg) != set(cg):
        fail(f"gradient leaves differ between the card and the CPU: {sorted(set(gg) ^ set(cg))}")
    if loss_rel > LOSS_TOL or grad_rel[worst_g] > GRAD_TOL or param_abs[worst_p] > PARAM_TOL:
        fail(f"the training step on the card disagrees with the CPU plain path: {rec}")
    if launches["bidir_recurrence"] or not (launches["recurrence_residual"] and launches["recurrence_bwd"]):
        fail(f"the step under grad did not run the residual and VJP kernels alone: {launches}")
    return rec


def profile_part(prof, part: str, part_ms: float, top: int) -> dict:
    """The device kernels launched under ``record_function(part)`` in a
    finished profile: their summed device time, its share of ``part_ms``,
    their count and the heaviest, and the host self time of the operators
    there. A kernel is the range's when the host operator that launched it
    (the one the profiler links it to) lies inside the range."""
    from torch.autograd import DeviceType

    inside = []
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        p = e.cpu_parent
        while p is not None and p.name != part:
            p = p.cpu_parent
        if p is not None:
            inside.append(e)
    kernels = [k for e in inside for k in e.kernels]
    if not kernels:
        return {"device_ms": "not measured"}
    by_name = {}
    for k in kernels:
        n, us = by_name.get(k.name, (0, 0.0))
        by_name[k.name] = (n + 1, us + k.duration)
    device_ms = sum(k.duration for k in kernels) / 1e3
    return {
        "device_ms": device_ms, "device_busy_share": device_ms / part_ms, "device_launches": len(kernels),
        "top": [{"name": n[:80], "ms": us / 1e3, "count": c}
                for n, (c, us) in sorted(by_name.items(), key=lambda x: -x[1][1])[:top]],
        "host_self_ms": sum(e.self_cpu_time_total for e in inside) / 1e3,
    }


def profile_step(step, step_ms: float, top: int = 8, part=None) -> dict:
    """One more call of ``step`` under ``torch.profiler`` (not part of any
    timing or check): the device time its kernels took, summed (one
    stream, so they do not overlap), their share of ``step_ms`` (the
    unprofiled median step) and the kernels that took the most. A
    profiler that records no device time gives "not measured". ``part``,
    a (name, ms) pair, adds under "part" the same record for the kernels
    launched inside ``record_function(name)`` (``profile_part``), whose
    unprofiled median is ms."""
    from torch.profiler import ProfilerActivity, profile

    # only the profiler's own failures (no CUPTI on the machine) give "not
    # measured": a failure of the step itself propagates
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as e:
        return {"device_ms": "not measured", "error": str(e)[:200]}
    stop_error = None
    try:
        step()
        torch.cuda.synchronize()
    finally:
        try:
            prof.stop()
        except RuntimeError as e:
            stop_error = str(e)[:200]
    if stop_error is not None:
        return {"device_ms": "not measured", "error": stop_error}
    from torch.autograd import DeviceType

    dev_us = lambda e: e.self_device_time_total
    # the kernels' own events (an operator's row repeats its kernels' time)
    events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation and dev_us(e) > 0
    ]
    total_ms = sum(dev_us(e) for e in events) / 1e3
    if not total_ms:
        return {"device_ms": "not measured"}
    events.sort(key=dev_us, reverse=True)
    # the host's side: operators by their own CPU time (inflated by the
    # profiler's per-event cost, so read as shares, not as times)
    host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0]
    host.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
    rec = {
        "device_ms": total_ms, "device_busy_share": total_ms / step_ms,
        "device_launches": sum(e.count for e in events),
        "top": [{"name": e.key[:80], "ms": dev_us(e) / 1e3, "count": e.count} for e in events[:top]],
        "host_self_ms": sum(e.self_cpu_time_total for e in host) / 1e3,
        "host_top": [{"name": e.key[:60], "self_ms": e.self_cpu_time_total / 1e3, "count": e.count}
                     for e in host[:top]],
    }
    if part is not None:
        rec["part"] = profile_part(prof, *part, top)
    return rec


def split_step(tr, batch) -> dict:
    """One optimizer step driven as ``Trainer.train_step`` composes it
    (``loss``, backward, ``apply_gradients``), the device synchronised
    between the three so that each is timed on the host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = tr.loss(batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    tr.apply_gradients()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return {"loss": float(loss), "forward_ms": (t1 - t0) * 1e3, "backward_ms": (t2 - t1) * 1e3,
            "optimizer_ms": (t3 - t2) * 1e3}


# the VJP's four kernels, as the profiler names them (csrc/lstm.cu)
VJP_KERNEL_NAMES = ("gates_kernel", "lstm_bwd", "dwh_partial_kernel", "dwh_reduce_kernel")


def vjp_share(tr, batch) -> dict:
    """One more step's backward under the profiler (its loss first, the
    optimizer after, unprofiled): the device ms of every kernel it ran and
    of the VJP's four kernels among them, by name."""
    from torch.profiler import ProfilerActivity, profile

    loss, _ = tr.loss(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loss.backward()
        torch.cuda.synchronize()
    tr.apply_gradients()
    torch.cuda.synchronize()
    kernels = [k for e in prof.events() for k in e.kernels]
    if not kernels:
        return {"backward_device_ms": "not measured"}
    vjp = {}
    for k in kernels:
        name = next((n for n in VJP_KERNEL_NAMES if n in k.name), None)
        if name is not None:
            vjp[name] = vjp.get(name, 0.0) + k.duration / 1e3
    return {"backward_device_ms": sum(k.duration for k in kernels) / 1e3, "vjp_device_ms": sum(vjp.values()),
            "vjp_kernels_ms": vjp}


def production_cfg(cfg):
    """The configuration in production mode, as bench.py defines it."""
    return dataclasses.replace(
        cfg, matmul_precision=PROD_PRECISION, frontend=dataclasses.replace(cfg.frontend, precision="high")
    )


def flagship_train_batch(vocab_size: int) -> dict:
    """B = TRAIN_B × 10 s of random PCM with 200-token targets, on the card."""
    rs = np.random.RandomState(0)  # as bench.py::bench_train
    n = int(SECONDS * SAMPLE_RATE)
    return {
        "audio": torch.from_numpy((rs.randn(TRAIN_B, n) * 2000).astype(np.float32)).to(DEV),
        "audio_lengths": torch.full((TRAIN_B,), n, dtype=torch.int32, device=DEV),
        "targets": torch.from_numpy(rs.randint(4, vocab_size, (TRAIN_B, DECODE_STEPS))).to(DEV),
        "target_lengths": torch.full((TRAIN_B,), DECODE_STEPS, dtype=torch.int32, device=DEV),
    }


def train_flagship(ckpt, kernels):
    """Phase 4c: Trainer.train_step at full width on B = TRAIN_B × 10 s of
    random PCM with 200-token targets, TRAIN_STEPS steps on one batch."""
    from phones_las_torch.train.loop import Trainer
    from phones_las_torch.train.state import TrainConfig
    from phones_las_torch.utils.param_io import load_artifact

    device = None if DEV == "cuda" else DEV  # the entry points' default is CUDA
    params, cfg, _ = load_artifact(ckpt, device=device)
    tr = Trainer(cfg, TrainConfig(), device=device)
    tr.warm_start(params)
    del params
    batch = flagship_train_batch(cfg.speller.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(TRAIN_STEPS):
        reset_counters(kernels)
        t0 = time.perf_counter()
        out = tr.train_step(batch)
        loss = float(out["loss"])
        torch.cuda.synchronize()
        steps.append({
            "step": i + 1, "loss": loss, "grad_norm": float(out["grad_norm"]),
            "ms": (time.perf_counter() - t0) * 1e3,
            "launches": launch_counts(kernels),
        })
        emit({"phase": "4c", **steps[-1]})
    step_ms = statistics.median(s["ms"] for s in steps[1:])
    totals = {name: sum(s["launches"][name] for s in steps) for name in steps[0]["launches"]}
    profiled = profile_step(lambda: tr.train_step(batch), step_ms)
    splits = [split_step(tr, batch) for _ in range(SPLIT_STEPS)]
    med = lambda key: statistics.median(s[key] for s in splits)
    rec = {
        "phase": "4c", "shape": f"B={TRAIN_B} x {SECONDS} s, {DECODE_STEPS}-token targets, {TRAIN_STEPS} steps",
        "step_ms": step_ms, "timed_steps": f"2-{TRAIN_STEPS}",
        "forward_ms": med("forward_ms"), "backward_ms": med("backward_ms"),
        "optimizer_ms": med("optimizer_ms"), "split_steps": f"{TRAIN_STEPS + 2}-{TRAIN_STEPS + 1 + SPLIT_STEPS}",
        "split_losses": [s["loss"] for s in splits],
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": [s["loss"] for s in steps], "launches_total": totals,
        "prec": tr.prec, "card": card_line(), "device_profile": profiled,
    }
    emit(rec)
    losses = rec["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"training losses are not finite and falling: {losses}")
    for s in steps:
        la = s["launches"]
        if la["recurrence_residual"] != cfg.listener.num_layers or la["recurrence_bwd"] != cfg.listener.num_layers:
            fail(f"step {s['step']}: the residual and VJP kernels must launch once per listener layer: {la}")
        if la["bidir_recurrence"] != 0 or la["fused_logmel"] != 1:
            fail(f"step {s['step']}: unexpected launches under grad: {la}")
    return rec, totals


def drive_lstm_layer(params, kernels):
    """Phase 4d: the ops API, ``lstm_layer`` at the listener's first-layer
    width (T = 250), without grad (the ``recurrence`` kernel, both
    directions) and under grad (residual + VJP kernels, one direction)."""
    from phones_las_torch.ops.lstm import lstm_layer

    p = params.listener.layers[0][0]
    g = torch.Generator(device=DEV).manual_seed(7)
    t, d = 250, p.wx.shape[0]
    x = torch.randn((TRAIN_B, t, d), generator=g, device=DEV)
    lens = torch.randint(t // 2, t + 1, (TRAIN_B,), generator=g, device=DEV)
    reset_counters(kernels)
    with torch.no_grad():
        outs = [lstm_layer(p, x, lens, reverse=rev)[0] for rev in (False, True)]
    x.requires_grad_(True)
    out, (h, c) = lstm_layer(p, x, lens, reverse=True)
    (out.square().sum() + h.sum() + c.sum()).backward()
    torch.cuda.synchronize()
    launches = launch_counts(kernels)
    finite = all(bool(torch.isfinite(v).all()) for v in (*outs, out, x.grad))
    rec = {"phase": "4d", "shape": f"lstm_layer B={TRAIN_B} T={t} D={d}", "finite": finite, "launches": launches}
    emit(rec)
    if not finite or not (launches["recurrence"] == 2 and launches["recurrence_residual"] == 1
                          and launches["recurrence_bwd"] == 1):
        fail(f"lstm_layer did not run its kernels as expected: {rec}")
    return launches


def sweep_forward_plans(params) -> None:
    """``--sweep``: the forward kernel under each plan at U = 256, T = 999,
    and (a reading, in turns against the template the plan keeps) the grid
    layout at B = 64, both directions, both modes."""
    from phones_las_torch.ops import lstm as L
    from phones_las_torch.ops.masking import length_mask

    t, u = 999, 256
    pf, pb = params.listener.layers[0]
    entry = "plt_lstm_recurrence"
    for b, nd in ((FLAGSHIP_B, 2), (TRAIN_B, 1)):
        g = torch.Generator(device=DEV).manual_seed(60)
        lengths = torch.randint(t // 2, t + 1, (b,), generator=g, device=DEV)
        mask = length_mask(lengths, t).transpose(0, 1).contiguous()
        xps = [torch.randn((t, b, 4 * u), generator=g, device=DEV) for _ in range(nd)]
        whs, rev = [pf.wh, pb.wh][:nd], [False, True][:nd]
        for prec in ("highest", "bf16"):
            want = L._launch_forward(entry, xps, mask, whs, 1.0, rev, prec)
            chosen = L._launch_forward.last_plan
            for c in (8, 16):
                for bt in L.ROW_TILES:
                    ks = L._ksplit(u, c, bt, prec == "bf16")
                    smem = L.forward_smem_bytes(u, c, bt, ks, prec == "bf16")
                    if smem > L.SMEM_MAX:
                        continue
                    plan = L.ForwardPlan(c, bt, ks, True, smem, u)
                    got = L._launch_forward(entry, xps, mask, whs, 1.0, rev, prec, plan)
                    torch.cuda.synchronize()
                    err, _, _ = compare([k[0] for k in got], [k[0] for k in want], 0.0, 0.0)
                    ms = time_ms(lambda: L._launch_forward(entry, xps, mask, whs, 1.0, rev, prec, plan), reps=5)
                    info = L.forward_kernel_info(u, prec == "bf16", False, c, bt, ks)
                    emit({
                        "sweep": "lstm forward", "shape": f"T={t} B={b} U={u} nd={nd} prec={prec}",
                        "cluster": c, "bt": bt, "ksplit": ks, "chosen": plan == chosen,
                        "clusters_launched": -(-b // bt) * nd, **info, "ms": ms, "us_per_step": ms * 1e3 / t,
                        "max_abs_diff_to_chosen_plan": err,
                    })
            if nd == 2:  # a reading, the plan unchanged: the grid layout against the template, in turns
                grid = L.forward_plan(b, u, nd, prec, layout="grid",
                                      sms=torch.cuda.get_device_properties(0).multi_processor_count)
                got = L._launch_forward(entry, xps, mask, whs, 1.0, rev, prec, grid)
                torch.cuda.synchronize()
                err, _, _ = compare([k[0] for k in got], [k[0] for k in want], 0.0, 0.0)
                ms = {"template": [], "grid": []}
                for name in ("template", "grid", "grid", "template"):
                    p_ = chosen if name == "template" else grid
                    ms[name].append(time_ms(lambda: L._launch_forward(entry, xps, mask, whs, 1.0, rev, prec, p_),
                                            reps=5))
                emit({"sweep": "lstm forward, the grid layout at the flagship width (a reading)",
                      "shape": f"T={t} B={b} U={u} nd={nd} prec={prec}", "grid": grid.grid._asdict(),
                      **plan_info(grid, nd, prec, False), "ms": statistics.mean(ms["grid"]),
                      "template_ms": statistics.mean(ms["template"]), "max_abs_diff_to_chosen_plan": err})


def sweep_streamed_plans() -> None:
    """``--sweep``: float32 at U = 1024, T = 999: the VJP's loop (B = 32)
    under every plan of the template that fits in shared memory (C of 8 and
    16, tiles of 8 and 16, the k split halved until the layout fits, the
    block's slice of whᵀ streamed) and the grid layout's (its layouts one
    by one: ``--sweep-vjp``), each timed (median of 3) with the clusters
    the card runs at once, and held against the chosen plan's output."""
    from phones_las_torch.ops import lstm as L
    from phones_las_torch.ops.masking import length_mask

    t, u, nd = 999, 1024, 2
    g = torch.Generator(device=DEV).manual_seed(63)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=DEV)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def candidates():
        for c in (8, 16):
            for bt in L.ROW_TILES:
                ks = L._bwd_ksplit(u, c, bt, False)
                while ks > 1 and L.backward_smem_bytes(u, c, bt, ks, False, False) > L.SMEM_MAX:
                    ks //= 2
                smem = L.backward_smem_bytes(u, c, bt, ks, False, False)
                if smem <= L.SMEM_MAX:
                    yield L.BackwardPlan(c, bt, ks, False, smem, u)
        yield L.backward_plan(TRAIN_B, u, 2, "highest", functools.partial(L.backward_held, False), sms=sms)

    b, rev = TRAIN_B, [False, True]
    lengths = torch.randint(t // 2, t + 1, (b,), generator=g, device=DEV)
    mask = length_mask(lengths, t).transpose(0, 1).contiguous()
    whs = [rnd(u, 4 * u) / u ** 0.5 for _ in range(nd)]
    xps = [rnd(t, b, 4 * u) for _ in range(nd)]
    res = L.recurrence_residual(xps, mask, whs, 1.0, rev, "highest")
    bargs = (xps, mask, whs, [r[1] for r in res], [r[2] for r in res], [rnd(t, b, u) for _ in range(nd)],
             [rnd(b, u) for _ in range(nd)], [rnd(b, u) for _ in range(nd)], 1.0, rev, "highest")
    want = L.recurrence_bwd(*bargs)
    chosen = L._launch_backward.last_plan
    for plan in candidates():
        got = L._launch_backward(*bargs, plan=plan)
        torch.cuda.synchronize()
        err = max(rel_err(k, p) for kg, pg in zip(got, want) for k, p in zip(kg, pg))
        loops = []
        for _ in range(3):
            part = []
            L._launch_backward(*bargs, plan=plan, part_ms=part)
            loops.append(part[1])
        loop_ms = statistics.median(loops)
        emit({"sweep": "streamed vjp loop", "shape": f"T={t} B={b} U={u} nd={nd} prec=highest",
              **route_plan_record(plan, b, nd, L.backward_kernel_info(False, plan)), "chosen": plan == chosen,
              "loop_ms": loop_ms, "us_per_step": loop_ms * 1e3 / t, "max_rel_diff_to_chosen_plan": err})


# --sweep-vjp: the VJP's loop in the grid layout at T = 999, B = TRAIN_B, both
# directions: (U, mode); every layout with two or three ring slots a k part
SWEEP_VJPS = ((1024, "highest"), (1024, "bf16"), (512, "highest"), (512, "bf16"), (448, "bf16"))
# --compare: the VJP (``L.recurrence_bwd``, the route each checkout plans) at those shapes
COMPARE_VJPS = SWEEP_VJPS


def random_vjp_args(u: int, prec: str, seed: int, b: int = TRAIN_B, t: int = 999):
    """The arguments of ``L.recurrence_bwd`` for both directions at U on the
    kernel's own residuals: random xp, wh, lengths T/2..T and cotangents."""
    from phones_las_torch.ops import lstm as L
    from phones_las_torch.ops.masking import length_mask

    g = torch.Generator(device=DEV).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=DEV)
    lengths = torch.randint(t // 2, t + 1, (b,), generator=g, device=DEV)
    lengths[0] = t
    mask = length_mask(lengths, t).transpose(0, 1).contiguous()
    xps, whs = [rnd(t, b, 4 * u) for _ in range(2)], [rnd(u, 4 * u) / u ** 0.5 for _ in range(2)]
    res = L.recurrence_residual(xps, mask, whs, 1.0, [False, True], prec)
    return (xps, mask, whs, [r[1] for r in res], [r[2] for r in res], [rnd(t, b, u) for _ in range(2)],
            [rnd(b, u) for _ in range(2)], [rnd(b, u) for _ in range(2)], 1.0, [False, True], prec)


def loop_reading(L, bargs, plan, reps: int) -> tuple:
    """The VJP's loop under ``plan``: its ms (median of ``reps`` calls' loop
    kernels; None for none) and, from one more call, the SM cycles a step
    spends in each of its parts (the grid layout's ``GRID_BWD_CLOCK_NAMES``,
    else ``BWD_CLOCKS``)."""
    loops = []
    for _ in range(reps):
        part = []
        L._launch_backward(*bargs, plan=plan, part_ms=part)
        loops.append(part[1])
    names = GRID_BWD_CLOCK_NAMES if plan.grid is not None else BWD_CLOCKS
    clocks = torch.zeros(len(names), dtype=torch.int64, device=DEV)
    L._launch_backward(*bargs, plan=plan, clocks=clocks)
    torch.cuda.synchronize()
    t = bargs[0][0].shape[0]
    return statistics.median(loops) if loops else None, dict(zip(names, (c / t for c in clocks.tolist())))


def sweep_grid_vjp() -> None:
    """``--sweep-vjp``: the VJP's loop in the grid layout at each shape of
    ``SWEEP_VJPS``: at each cluster size (a cut over the blocks the card
    holds in such clusters) every layout its kernels take with two or three
    ring slots a k part, timed (the loop, median of 3) with the SM cycles a
    step spends in each part and the planner's modelled step, and held
    against the planner's choice: the numbers behind ``_grid_bwd_step_cycles``."""
    from phones_las_torch.ops import lstm as L

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for i, (u, prec) in enumerate(SWEEP_VJPS):
        bf16 = prec == "bf16"
        bargs = random_vjp_args(u, prec, 270 + i)
        chosen = L.backward_plan(TRAIN_B, u, 2, prec, functools.partial(L.backward_held, bf16), layout="grid", sms=sms)
        want = L._launch_backward(*bargs, plan=chosen)
        for cl in L.GRID_CLUSTERS:
            budget = sms
            first = L.grid_bwd_candidates(TRAIN_B, u, 2, bf16, cl, budget)
            if first:
                budget = min(sms, L.backward_held(bf16, L._as_backward_plan(first[0], 2, prec)))
            if budget < 2 * cl:
                emit({"sweep": "vjp grid loop", "u": u, "prec": prec, "cl": cl, "held_blocks": budget})
                continue
            for g in L.grid_bwd_candidates(TRAIN_B, u, 2, bf16, cl, budget):
                if g.ns > 3 * g.ks:
                    continue
                plan = L._as_backward_plan(g, 2, prec)
                got = L._launch_backward(*bargs, plan=plan)
                torch.cuda.synchronize()
                err = max(rel_err(k, p) for kg, pg in zip(got, want) for k, p in zip(kg, pg))
                loop_ms, cycles = loop_reading(L, bargs, plan, 3)
                emit({"sweep": "vjp grid loop", "shape": f"T=999 B={TRAIN_B} U={u} nd=2 prec={prec}",
                      "grid": g._asdict(), "chosen": plan == chosen, "loop_ms": loop_ms,
                      "us_per_step": loop_ms * 1e3 / 999, "model_us_per_step": L._grid_bwd_step_cycles(g, bf16) / 1980,
                      "cycles_per_step": cycles, "max_rel_diff_to_chosen_plan": err})
        del bargs, want


# --sweep-forward: the forward's grid layout at T = 999, both directions:
# (entry, U, mode, B); every layout with at most two passes of rows (float32:
# three ring slots a k part)
SWEEP_FORWARDS = (("plt_lstm_recurrence", 1024, "highest", FLAGSHIP_B), ("plt_lstm_residual", 1024, "highest", TRAIN_B),
                  ("plt_lstm_recurrence", 1024, "bf16", FLAGSHIP_B), ("plt_lstm_residual", 1024, "bf16", TRAIN_B),
                  ("plt_lstm_recurrence", 512, "highest", FLAGSHIP_B), ("plt_lstm_recurrence", 512, "bf16", FLAGSHIP_B))


def sweep_grid_forward() -> None:
    """``--sweep-forward``: the forward's grid layout at each shape of
    ``SWEEP_FORWARDS``: every layout its kernels take with at most two
    passes (float32: three ring slots a k part), timed (median of 3) with the SM
    cycles a step spends in each part and the planner's modelled step, and
    held against the planner's choice: the numbers behind
    ``_grid_step_cycles``."""
    from phones_las_torch.ops import lstm as L
    from phones_las_torch.ops.masking import length_mask

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t = 999
    for i, (entry, u, prec, b) in enumerate(SWEEP_FORWARDS):
        bf16 = prec == "bf16"
        g = torch.Generator(device=DEV).manual_seed(280 + i)
        lengths = torch.randint(t // 2, t + 1, (b,), generator=g, device=DEV)
        mask = length_mask(lengths, t).transpose(0, 1).contiguous()
        xps = [torch.randn((t, b, 4 * u), generator=g, device=DEV) for _ in range(2)]
        whs = [torch.randn((u, 4 * u), generator=g, device=DEV) / u ** 0.5 for _ in range(2)]
        rev = [False, True]
        chosen = L.forward_plan(b, u, 2, prec, sms=sms)
        want = L._launch_forward(entry, xps, mask, whs, 1.0, rev, prec, chosen)
        for gp in L.grid_candidates(b, u, 2, prec, sms):
            if (not bf16 and gp.ns > 3 * gp.ks) or gp.passes > 2:
                continue
            plan = chosen._replace(bt=gp.rows, ksplit=gp.ks, resident=gp.nres == gp.kp // gp.kc,
                                   smem=L.grid_smem_bytes(gp.us, gp.rows, gp.kc, gp.kp, gp.nres, gp.ns, bf16), grid=gp)
            got = L._launch_forward(entry, xps, mask, whs, 1.0, rev, prec, plan)
            torch.cuda.synchronize()
            err, _, _ = compare([k[0] for k in got], [k[0] for k in want], 0.0, 0.0)
            ms = time_ms(lambda: L._launch_forward(entry, xps, mask, whs, 1.0, rev, prec, plan), reps=3)
            clocks = torch.zeros(len(GRID_CLOCKS), dtype=torch.int64, device=DEV)
            L._launch_forward(entry, xps, mask, whs, 1.0, rev, prec, plan, clocks)
            torch.cuda.synchronize()
            emit({"sweep": "forward grid layout", "shape": f"T={t} B={b} U={u} nd=2 prec={prec} {entry}",
                  "grid": gp._asdict(), "chosen": gp == chosen.grid, "ms": ms, "us_per_step": ms * 1e3 / t,
                  "model_us_per_step": gp.passes * L._grid_step_cycles(gp, bf16) / 1980,
                  "cycles_per_step": dict(zip(GRID_CLOCKS, (c / t / gp.passes for c in clocks.tolist()))),
                  "max_abs_diff_to_chosen_plan": err})
        del xps, want


# --bf16-routes: the bf16 forward's two routes at T = 999: (entry, U, nd, B); B = 8 as 13b serves W1024
BF16_ROUTE_SHAPES = (("plt_lstm_recurrence", 1024, 2, FLAGSHIP_B), ("plt_lstm_recurrence", 1024, 2, TRAIN_B),
                     ("plt_lstm_recurrence", 1024, 2, 8), ("plt_lstm_residual", 1024, 2, TRAIN_B),
                     ("plt_lstm_recurrence", 1024, 1, TRAIN_B), ("plt_lstm_recurrence", 2048, 2, FLAGSHIP_B),
                     ("plt_lstm_recurrence", 512, 2, FLAGSHIP_B), ("plt_lstm_residual", 512, 2, TRAIN_B),
                     ("plt_lstm_recurrence", 448, 2, FLAGSHIP_B))


def route_plan(L, b: int, u: int, nd: int, mma: bool, sms: int):
    """The plan ``grid_plan`` would make in bf16 were the route (``mma``:
    mma.sync, else wgmma) the only one → a ForwardPlan."""
    g = min((p for p in L.grid_candidates(b, u, nd, "bf16", sms) if p.mma == mma),
            key=lambda p: p.passes * L._grid_step_cycles(p, True))
    return L.ForwardPlan(1, g.rows, g.ks, g.nres == g.kp // g.kc,
                         L.grid_smem_bytes(g.us, g.rows, g.kc, g.kp, g.nres, g.ns, True, g.mma),
                         g.us * g.blocks // nd, g)


def bf16_routes() -> None:
    """``--bf16-routes``: the bf16 forward's grid layout at each shape of
    ``BF16_ROUTE_SHAPES``, the plan of each route (``route_plan``) timed in
    turns (wgmma, mma.sync, mma.sync, wgmma, wgmma, mma.sync; median of 5
    each) with the readings' spread, the planner's choice and the largest
    difference between the routes' outputs: the numbers behind keeping
    both routes."""
    from phones_las_torch.ops import lstm as L
    from phones_las_torch.ops.masking import length_mask

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t = 999
    for i, (entry, u, nd, b) in enumerate(BF16_ROUTE_SHAPES):
        g = torch.Generator(device=DEV).manual_seed(300 + i)
        lengths = torch.randint(t // 2, t + 1, (b,), generator=g, device=DEV)
        lengths[0] = t
        mask = length_mask(lengths, t).transpose(0, 1).contiguous()
        xps = [torch.randn((t, b, 4 * u), generator=g, device=DEV) for _ in range(nd)]
        whs = [torch.randn((u, 4 * u), generator=g, device=DEV) / u ** 0.5 for _ in range(nd)]
        rev = [False, True][:nd]
        plans = {"wgmma": route_plan(L, b, u, nd, False, sms), "mma.sync": route_plan(L, b, u, nd, True, sms)}
        outs = {k: L._launch_forward(entry, xps, mask, whs, 1.0, rev, "bf16", p) for k, p in plans.items()}
        torch.cuda.synchronize()
        err, _, _ = compare([o[0] for o in outs["wgmma"]], [o[0] for o in outs["mma.sync"]], 0.0, 0.0)
        ms = {k: [] for k in plans}
        for k in ("wgmma", "mma.sync", "mma.sync", "wgmma", "wgmma", "mma.sync"):
            ms[k].append(time_ms(lambda: L._launch_forward(entry, xps, mask, whs, 1.0, rev, "bf16", plans[k]), reps=5))
        emit({"bf16 routes": f"T={t} B={b} U={u} nd={nd} {entry}", "card": card_line(),
              "chosen": "mma.sync" if L.forward_plan(b, u, nd, "bf16", sms=sms).grid.mma else "wgmma",
              **{k: {"grid": plans[k].grid._asdict(), "ms": statistics.mean(v), "min_ms": min(v), "max_ms": max(v),
                     "model_ms": plans[k].grid.passes * L._grid_step_cycles(plans[k].grid, True) / 1980 * t / 1e3}
                 for k, v in ms.items()},
              "max_abs_diff_between_routes": err})
        del xps, outs


def vjp_cases(L, params, seed):
    """The VJP's arguments at the training shape (the listener's first layer,
    T = 999, B = TRAIN_B, both directions, random lengths and cotangents),
    once per precision → (prec, the arguments of ``L.recurrence_bwd``)."""
    from phones_las_torch.ops.masking import length_mask

    t, b = 999, TRAIN_B
    pf, pb = params.listener.layers[0]
    u = pf.units
    g = torch.Generator(device=DEV).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=DEV)
    lengths = torch.randint(t // 2, t + 1, (b,), generator=g, device=DEV)
    mask = length_mask(lengths, t).transpose(0, 1).contiguous()
    xps, whs, rev = [rnd(t, b, 4 * u) for _ in range(2)], [pf.wh.detach(), pb.wh.detach()], [False, True]
    cots = ([rnd(t, b, u) for _ in range(2)], [rnd(b, u) for _ in range(2)], [rnd(b, u) for _ in range(2)])
    for prec in ("highest", "bf16"):
        res = L.recurrence_residual(xps, mask, whs, 1.0, rev, prec)
        yield prec, (xps, mask, whs, [r[1] for r in res], [r[2] for r in res], *cots, 1.0, rev, prec)


def sweep_backward_plans(params) -> None:
    """``--sweep``: the VJP under each plan of its loop at U = 256, T = 999, B = TRAIN_B."""
    from phones_las_torch.ops import lstm as L

    t, u, b = 999, 256, TRAIN_B
    for prec, bargs in vjp_cases(L, params, seed=61):
        want = L.recurrence_bwd(*bargs)
        chosen = L._launch_backward.last_plan
        for c in (8, 16):
            for bt in L.ROW_TILES:
                ks = L._bwd_ksplit(u, c, bt, prec == "bf16")
                while ks > 1 and L.backward_smem_bytes(u, c, bt, ks, True, prec == "bf16") > L.SMEM_MAX:
                    ks //= 2
                smem = L.backward_smem_bytes(u, c, bt, ks, True, prec == "bf16")
                if smem > L.SMEM_MAX:
                    continue
                plan = L.BackwardPlan(c, bt, ks, True, smem, u)
                got = L._launch_backward(*bargs, plan=plan)
                torch.cuda.synchronize()
                err = max(rel_err(k, p) for kg, pg in zip(got, want) for k, p in zip(kg, pg))
                runs = []
                for _ in range(5):
                    ms = []
                    L._launch_backward(*bargs, plan=plan, part_ms=ms)
                    runs.append(ms[1])
                loop_ms = statistics.median(runs)
                emit({
                    "sweep": "lstm vjp loop", "shape": f"T={t} B={b} U={u} nd=2 prec={prec}",
                    "cluster": c, "bt": bt, "ksplit": ks, "chosen": plan == chosen,
                    "clusters_launched": -(-b // bt) * 2, **L.backward_kernel_info(prec == "bf16", plan),
                    "loop_ms": loop_ms, "us_per_step": loop_ms * 1e3 / t, "max_rel_diff_to_chosen_plan": err,
                })


def time_kernels(tree: str, only_decoder: bool = False) -> None:
    """``--time-kernels DIR``: the kernels a ``--compare`` is about, the
    greedy serving call at the flagship shape (encode and decode, the
    host's dispatch included), the decoder kernel at every shape of
    ``DECODER_SHAPES`` (the flagship at B = 64 and 8, 12a's, offline
    B = 256, 13a's and 13d's: the layout the checkout plans there, ms, µs a
    step, rows differing from its plain version; ``only_decoder``: these
    two alone), the listener's
    forward past the resident widths (``COMPARE_FORWARDS``: the route the
    checkout plans there, ms) and the VJP there (``COMPARE_VJPS``: the
    route, the ms of a call, the loop's ms and µs a step), of the package
    in the checkout at DIR, through calls that every slice of the port
    since the grid forward has."""
    sys.path.insert(0, tree)
    from phones_las_torch.decode.fused_greedy import greedy_decode_fused, greedy_decode_fused_plain
    from phones_las_torch.decode.greedy import greedy_decode
    from phones_las_torch.frontend import features as F
    from phones_las_torch.frontend.fused_frontend import fused_logmel
    from phones_las_torch.models.las import encode
    from phones_las_torch.models.speller import SpellerConfig, init_speller
    from phones_las_torch.ops import lstm as L
    from phones_las_torch.ops.masking import length_mask
    from phones_las_torch.utils.param_io import load_artifact

    torch.set_grad_enabled(False)
    params, cfg, _ = load_artifact(os.path.join(ASSETS, "ckpt.npz"), device=None)
    audio = torch.from_numpy(make_audio(FLAGSHIP_B)).to(DEV)
    x = F.preemphasize(audio, cfg.frontend.preemphasis).contiguous()
    t_fe = F.frames_for_samples(x.shape[1], cfg.frontend)
    rec = {"tree": tree, "card": card_line(),
           "fused_logmel_ms": time_ms(lambda: fused_logmel(x, cfg.frontend, t_fe))}
    for prec, bargs in vjp_cases(L, params, seed=62):
        rec[f"recurrence_bwd_{prec}_ms"] = time_ms(lambda: L.recurrence_bwd(*bargs))
    lens = torch.full((FLAGSHIP_B,), audio.shape[1], dtype=torch.int32, device=DEV)

    def serve():
        mem, _, mask = encode(params, cfg, audio, lens)
        greedy_decode(params.speller, cfg.speller, mem, mask, DECODE_STEPS)

    rec["serving_call_ms"] = time_ms(serve)
    rec["forwards"] = []
    for i, (kernel, u, prec, b) in enumerate(() if only_decoder else COMPARE_FORWARDS):
        t = 999
        g = torch.Generator(device=DEV).manual_seed(250 + i)
        lengths = torch.randint(t // 2, t + 1, (b,), generator=g, device=DEV)
        lengths[0] = t
        mask = length_mask(lengths, t).transpose(0, 1).contiguous()
        xps = [torch.randn((t, b, 4 * u), generator=g, device=DEV) for _ in range(2)]
        whs = [torch.randn((u, 4 * u), generator=g, device=DEV) / u ** 0.5 for _ in range(2)]
        if kernel == "bidir_recurrence":
            run = lambda: L.bidir_recurrence(xps[0], xps[1], mask, whs[0], whs[1], 1.0, prec)
        elif kernel == "recurrence":
            run = lambda: L.recurrence(xps[0], mask, whs[0], 1.0, False, prec)
        else:
            run = lambda: L.recurrence_residual(xps, mask, whs, 1.0, [False, True], prec)
        run()
        plan = L._launch_forward.last_plan
        route = ("grid" if getattr(plan, "grid", None) is not None else "ring" if getattr(plan, "ring", False)
                 else "template")
        # the launch with the plan given (made once, outside the timing): the kernels alone, whether or not the
        # checkout caches its plan
        nd = 1 if kernel == "recurrence" else 2
        entry = "plt_lstm_residual" if kernel == "recurrence_residual" else "plt_lstm_recurrence"
        launch = lambda: L._launch_forward(entry, xps[:nd], mask, whs[:nd], 1.0, [False, True][:nd], prec, plan)
        rec["forwards"].append({"kernel": kernel, "shape": f"T={t} B={b} U={u} nd={nd} prec={prec}", "route": route,
                                "ms": time_ms(run, reps=5), "plan_given_ms": time_ms(launch, reps=5)})
        del xps
    rec["vjps"] = []
    for i, (u, prec) in enumerate(() if only_decoder else COMPARE_VJPS):
        bargs = random_vjp_args(u, prec, 260 + i)
        L.recurrence_bwd(*bargs)
        plan = L._launch_backward.last_plan
        route = ("grid" if getattr(plan, "grid", None) is not None else "ring" if getattr(plan, "ring", False)
                 else "template")
        loops = []
        for _ in range(5):
            part = []
            L._launch_backward(*bargs, part_ms=part)
            loops.append(part[1])
        loop_ms = statistics.median(loops)
        rec["vjps"].append({"kernel": "recurrence_bwd", "shape": f"T=999 B={TRAIN_B} U={u} nd=2 prec={prec}",
                            "route": route, "ms": time_ms(lambda: L.recurrence_bwd(*bargs), reps=5),
                            "loop_ms": loop_ms, "loop_us_per_step": loop_ms * 1e3 / 999})
        del bargs
    rec["decoders"] = []
    memory, _, enc_mask = encode(params, cfg, audio, lens)
    # the cycles a step spends in each part at the flagship shape, in the plan's layout and the grid layout
    # (the checkout's own counters and names)
    from phones_las_torch.decode import fused_greedy as FG

    wp, widths = FG._unflatten(FG.flat_weights(params.speller), memory, cfg.speller.bos_id, cfg.speller.eos_id)
    rec["flagship_cycles"] = {}
    for layout in (None, "grid"):
        clocks = torch.zeros(20, dtype=torch.int64, device=DEV)
        FG._launch(wp, widths, memory, enc_mask, DECODE_STEPS, clocks, layout=layout)
        torch.cuda.synchronize()
        name = greedy_decode_fused.last_launch["layout"]
        names = FG.CLOCK_NAMES if name == "held" else FG.GRID_CLOCK_NAMES
        counts = clocks.tolist()
        rec["flagship_cycles"][f"{layout or 'plan'}: {name}"] = {
            n: c / max(counts[15], 1) for n, c in zip(names, counts) if n != "steps"}
    for shape in DECODER_SHAPES:
        sp, sc, mem, mask, steps = decoder_case(shape, params, cfg, memory, enc_mask)
        tok, _ = greedy_decode_fused(sp, sc, mem, mask, steps)
        launch = greedy_decode_fused.last_launch
        plain, _ = greedy_decode_fused_plain(sp, sc, mem, mask, steps)
        is_eos = (tok == sc.eos_id).int()
        ran = int(torch.where(is_eos.any(1), is_eos.argmax(1) + 1, steps).max())  # the steps the launch ran
        ms = [time_ms(lambda: greedy_decode_fused(sp, sc, mem, mask, steps), reps=5) for _ in range(2)]
        rec["decoders"].append({
            "shape": f"{shape[0]}, B={mem.shape[0]} T_enc={mem.shape[1]} steps={steps}", "layout": launch["layout"],
            "ms": statistics.mean(ms), "ms_spread": max(ms) - min(ms), "us_per_step": statistics.mean(ms) * 1e3
            / max(ran, 1), "steps_run": ran, "rows_differing_from_plain": int((tok != plain).any(1).sum())})
        del sp, mem
    emit(rec)


def compare_trees(other: str, parts=()) -> int:
    """``--compare DIR [decoder]``: ``--time-kernels`` of the checkout at DIR
    and of this one, in turns, each in its own process (``decoder``: the
    serving call and the decoder alone)."""
    other = os.path.abspath(other)
    for tree in (other, REPO, REPO, other):
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-kernels", tree, *parts])
        if run.returncode:
            return run.returncode
    return 0


def launch_counts(kernels) -> dict:
    return {fn.__name__: fn.launches for fn in kernels}


# a wrapper's counts: all its launches, of them in bf16 mode, and through each
# wide route (the grid layouts of the listener's forward and of the VJP's
# loop, of them in bf16, of the forward's bf16 on wgmma, and of the decoder)
COUNTERS = ("launches", "bf16_launches", "grid_launches", "bf16_grid_launches", "wgmma_grid_launches")
ROUTE_COUNTERS = COUNTERS[2:]


def route_counts(kernels) -> dict:
    """Of each wrapper's launches, those through each wide route →
    {"<wrapper> <route>": n}."""
    return {f"{fn.__name__} {c[:-len('_launches')]}": getattr(fn, c) for fn in kernels for c in ROUTE_COUNTERS
            if hasattr(fn, c)}


def bf16_counts(kernels) -> dict:
    """Of each LSTM wrapper's launches, those in bf16 mode."""
    return {fn.__name__: fn.bf16_launches for fn in kernels if hasattr(fn, "bf16_launches")}


def check_beam_eval(params, params_cpu, cfg, data, kernels) -> dict:
    """Phase 5a: beam-8 on the eval set, card against the CPU plain path."""
    from phones_las_torch.decode import beam_decode
    from phones_las_torch.models.las import encode
    from phones_las_torch.utils.metrics import edit_distance_stats, per_from_stats

    cap = int(data["decode_cap"][0])

    def run(p, device):
        audio = torch.from_numpy(data["audio"]).to(device)
        lens = torch.from_numpy(data["lengths"]).to(device)
        mem, _, mask = encode(p, cfg, audio, lens)
        res = beam_decode(p.speller, cfg.speller, mem, mask, cap, beam_width=BEAM_K)
        return {k: getattr(res, k).cpu() for k in ("tokens", "lengths", "beam_tokens", "beam_logp")}

    reset_counters(kernels)
    gpu = run(params, DEV)
    torch.cuda.synchronize()
    launches = launch_counts(kernels)
    cpu = run(params_cpu, "cpu")
    best_rows = [i for i in range(len(gpu["tokens"])) if not torch.equal(gpu["tokens"][i], cpu["tokens"][i])]
    beams_differing = int((gpu["beam_tokens"] != cpu["beam_tokens"]).any(dim=-1).sum())
    refs = data["refs"]
    per = per_from_stats(*edit_distance_stats(
        gpu["tokens"].numpy(), gpu["lengths"].numpy(), np.where(refs >= 0, refs, 0), (refs >= 0).sum(axis=1)
    ))
    rec = {
        "phase": "5a", "utterances": len(gpu["tokens"]), "beam_width": BEAM_K, "decode_cap": cap,
        "beam8_per": per, "reference_per": REF_BEAM8_PER, "best_rows_differing_from_cpu_plain": best_rows,
        "beams_differing_from_cpu_plain": f"{beams_differing} of {gpu['beam_tokens'].shape[0] * BEAM_K}",
        "beam_logp_max_abs_diff": float((gpu["beam_logp"] - cpu["beam_logp"]).abs().max()),
        "launches": launches,
    }
    emit(rec)
    if len(best_rows) > MAX_DIFF_ROWS:
        fail(f"{len(best_rows)} best-beam rows differ from the CPU plain path (at most {MAX_DIFF_ROWS})")
    if abs(per - REF_BEAM8_PER) > PER_TOL:
        fail(f"beam-8 PER {per} is not within {PER_TOL} of {REF_BEAM8_PER}")
    if not (launches["fused_logmel"] and launches["bidir_recurrence"]) or any(
        n for name, n in launches.items() if name not in ("fused_logmel", "bidir_recurrence")
    ):
        fail(f"the beam path must launch the front-end and BiLSTM kernels and no other: {launches}")
    return rec


def beam_flagship(params, cfg, audio, lens, ctc_head):
    """PCM → front-end → listener → beam-8 (200 steps), the phases
    synchronised apart, the decoder inside ``record_function('decoder')``
    → (BeamResult, (front-end, listener, decoder) seconds)."""
    from torch.profiler import record_function

    from phones_las_torch.decode import beam_decode
    from phones_las_torch.models.las import ctc_logp, featurize
    from phones_las_torch.models.listener import listen
    from phones_las_torch.ops.masking import length_mask

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats, flens = featurize(params, cfg, audio, lens)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mem, enc_lens = listen(params.listener, cfg.listener, feats, flens)
    mask = length_mask(enc_lens, mem.shape[1])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with record_function("decoder"):  # profile_step's part
        res = beam_decode(
            params.speller, cfg.speller, mem, mask, DECODE_STEPS, beam_width=BEAM_K,
            ctc_logp=None if ctc_head is None else ctc_logp(ctc_head, mem),
            ctc_alpha=1.0 if ctc_head is None else CTC_ALPHA,
        )
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return res, (t1 - t0, t2 - t1, t3 - t2)


def time_beam_flagship(params, cfg, kernels, card) -> list:
    """Phase 5b: beam-8 at bench.py's beam shape, without and with joint CTC."""
    from types import SimpleNamespace

    from phones_las_torch.ops.lstm import glorot_

    audio = torch.from_numpy(make_audio(BEAM_B)).to(DEV)
    lens = torch.full((BEAM_B,), audio.shape[1], dtype=torch.int32, device=DEV)
    m, v = cfg.listener.output_dim, cfg.speller.vocab_size
    w = torch.zeros((m, v))
    glorot_(w, torch.Generator().manual_seed(5))  # the reference's CTC-head initialiser
    head = SimpleNamespace(ctc_w=w.to(DEV), ctc_b=torch.zeros(v, device=DEV))
    recs = []
    for name, ctc_head in (("beam8", None), ("beam8_ctc", head)):
        reset_counters(kernels)
        res, _ = beam_flagship(params, cfg, audio, lens, ctc_head)
        launches = launch_counts(kernels)
        finite = bool(torch.isfinite(res.beam_logp).all())
        if res.beam_tokens.shape != (BEAM_B, BEAM_K, DECODE_STEPS) or not finite:
            fail(f"{name}: beam tokens {tuple(res.beam_tokens.shape)}, finite log-probs {finite}")
        if launches["fused_logmel"] != 1 or launches["bidir_recurrence"] != cfg.listener.num_layers or any(
            n for k, n in launches.items() if k not in ("fused_logmel", "bidir_recurrence")
        ):
            fail(f"{name}: unexpected launches on the beam path: {launches}")
        splits = [beam_flagship(params, cfg, audio, lens, ctc_head)[1] for _ in range(BEAM_TIMED_CALLS)]
        fe_s, li_s, de_s = (statistics.median(x) for x in zip(*splits))
        total_ms = (fe_s + li_s + de_s) * 1e3
        # one profile a run, of the call without CTC; its decoder's share read off the same trace
        call = (profile_step(lambda: beam_flagship(params, cfg, audio, lens, ctc_head), total_ms,
                             part=("decoder", de_s * 1e3)) if ctc_head is None
                else {"device_ms": "not measured: one profile a run, of beam-8 without CTC"})
        decode = call.pop("part", {"device_ms": "not measured"})
        per_step = decode.get("device_launches")
        rec = {
            "phase": "5b", "mode": name, "shape": f"B={BEAM_B} x {SECONDS} s, K={BEAM_K}, {DECODE_STEPS} steps",
            "utt_per_s": BEAM_B / (total_ms / 1e3), "total_ms": total_ms, "frontend_ms": fe_s * 1e3,
            "listener_ms": li_s * 1e3, "decoder_ms": de_s * 1e3, "us_per_step": de_s * 1e6 / DECODE_STEPS,
            "launches_per_step": per_step / DECODE_STEPS if isinstance(per_step, int) else "not measured",
            "call_device_busy_share": call.get("device_busy_share", "not measured"),
            "decoder_device_busy_share": decode.get("device_busy_share", "not measured"),
            "call_profile": call, "decoder_profile": decode, "launches": launches, "card": card,
        }
        emit(rec)
        recs.append(rec)
    return recs


def check_gate_transcriber(data, kernels) -> dict:
    """Phase 5c: the long-gate artifact's Transcriber on the card against
    the same calls with device='cpu'."""
    from phones_las_torch.api import Transcriber
    from phones_las_torch.utils.metrics import _edit_distance

    utts = [np.clip(np.rint(data["audio"][i, : data["lengths"][i]]), -32768, 32767).astype(np.int16)
            for i in range(GATE_UTTS)]
    stream = np.concatenate(utts)
    modes = {"greedy": {}, "beam8": {"beam_width": BEAM_K},
             "beam8_ctc": {"beam_width": BEAM_K, "ctc_joint": CTC_ALPHA}}
    rec = {"phase": "5c", "artifact": os.path.relpath(GATE_ASSET, REPO), "utterances": GATE_UTTS,
           "stream_seconds": len(stream) / SAMPLE_RATE}
    bad = []
    for name, kw in modes.items():
        gpu = Transcriber.from_artifact(GATE_ASSET, device=None if DEV == "cuda" else DEV, **kw)
        cpu = Transcriber.from_artifact(GATE_ASSET, device="cpu", **kw)
        reset_counters(kernels)
        t0 = time.perf_counter()
        got = gpu.transcribe_batch(utts)
        ms = (time.perf_counter() - t0) * 1e3
        launches = launch_counts(kernels)
        want = cpu.transcribe_batch(utts)
        rows = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        rec[name] = {"rows_differing_from_cpu_plain": rows, "tokens": sum(map(len, got)),
                     "ms_first_call": ms, "launches": launches}
        if len(rows) > MAX_DIFF_ROWS or not (launches["fused_logmel"] and launches["bidir_recurrence"]):
            bad.append(name)
        if name != "greedy":
            continue
        for adapt in (False, True):
            t0 = time.perf_counter()
            hyp = gpu.transcribe_long(stream, adapt_cmvn=adapt)
            ms = (time.perf_counter() - t0) * 1e3
            ref = cpu.transcribe_long(stream, adapt_cmvn=adapt)
            edits = _edit_distance(gpu.vocab.encode(hyp), gpu.vocab.encode(ref))
            key = f"long_adapt_cmvn_{str(adapt).lower()}"
            rec[key] = {"tokens": len(hyp), "tokens_cpu": len(ref), "edit_distance": edits, "ms": ms}
            if edits > MAX_STREAM_EDITS or not hyp:
                bad.append(key)
    emit(rec)
    if bad:
        fail(f"the long-gate Transcriber on the card disagrees with the CPU plain path in {bad}: {rec}")
    return rec


# phase 5d: the benchmark cells' waves (rows, samples a row, the pad transcribe_batch gives them), timed in turns
STAGE_SHAPES = ((64, 160000, 160000), (32, 280000, 288000))
STAGE_ROUNDS = 4
STAGE_THREAD_CALLS = 3  # calls each of the two threads makes side by side


def pageable_stage(self, rows, wave, pad, dtype):
    """The staging before the pinned ring, the plain version of
    ``Transcriber._stage``: a fresh array, the rows filled one by one, and
    copies to the card from pageable memory (the host waits for each)."""
    wav_batch = np.zeros((wave, pad), dtype)
    for i, a in enumerate(rows):
        wav_batch[i, : len(a)] = a
    wav_lens = np.zeros((wave,), np.int32)
    wav_lens[: len(rows)] = [len(a) for a in rows]
    return torch.from_numpy(wav_batch).to(self.device), torch.from_numpy(wav_lens).to(self.device)


def check_staging() -> dict:
    """Phase 5d: ``transcribe_batch`` and ``decode_aligned`` staging through
    the pinned ring against ``pageable_stage``, on the long-gate artifact:
    the staged tensors and the tokens equal at both benchmark cells' waves,
    on a ragged call of three waves and on a short call after a long one;
    a ``decode_aligned`` thread beside a ``transcribe_batch`` thread giving
    what each gives alone; the ring's counters engaged; the host's ms of
    the staging (as ``plt.stage`` covers it) and of the whole call, both
    versions in turns at the cells' waves."""
    import threading
    import types

    from phones_las_torch.api import Transcriber, stage_wave

    dev = None if DEV == "cuda" else DEV
    pinned = Transcriber.from_artifact(GATE_ASSET, device=dev)
    plain = Transcriber.from_artifact(GATE_ASSET, device=dev)
    plain._stage = types.MethodType(pageable_stage, plain)
    rng = np.random.default_rng(25)
    pcm = lambda lens: [rng.integers(-3000, 3000, size=int(n), dtype=np.int16) for n in lens]
    calls = {f"b{b}x{n}": pcm([n] * b) for b, n, _ in STAGE_SHAPES}
    calls["ragged_3_waves"] = pcm(rng.integers(1, 160001, size=150))  # waves of 64, 64 and 22
    calls["short_after_long"] = pcm([8000, 19000, 1])
    rec = {"phase": "5d", "artifact": os.path.relpath(GATE_ASSET, REPO), "cases": {}}
    bad = []
    waves0, plain0, growths0 = stage_wave.pinned_waves, stage_wave.plain_waves, stage_wave.growths
    waves = 0
    for name, call in calls.items():  # in this order: the short call after the ragged one's long waves
        pad = -(-max(len(a) for a in call) // 32000) * 32000
        wave = pinned._wave_size(len(call))
        staged_equal = all(
            all(torch.equal(x, y) for x, y in zip(pinned._stage(call[o : o + wave], wave, pad, np.int16),
                                                 plain._stage(call[o : o + wave], wave, pad, np.int16)))
            for o in range(0, len(call), wave))
        got, want = pinned.transcribe_batch(call), plain.transcribe_batch(call)
        waves += 2 * -(-len(call) // wave)
        rec["cases"][name] = {"rows": len(call), "pad": pad, "staged_equal": staged_equal,
                              "tokens_equal": got == want, "tokens": sum(map(len, got))}
        if not (staged_equal and got == want):
            bad.append(name)

    # a decode_aligned thread beside a transcribe_batch thread, each call's answer against its own alone
    call = calls[f"b{STAGE_SHAPES[0][0]}x{STAGE_SHAPES[0][1]}"]
    windows, win = pcm([80000, 61000, 96000, 5]), 96000
    alone_tb = pinned.transcribe_batch(call)
    alone_da = pinned.decode_aligned(windows, window_samples=win)
    same_da = lambda got: all(np.array_equal(a, c) and np.array_equal(b, d)
                              for (a, b), (c, d) in zip(got, alone_da))
    results, errors = {"transcribe_batch": [], "decode_aligned": []}, []

    def run(name, fn):
        try:
            for _ in range(STAGE_THREAD_CALLS):
                results[name].append(fn())
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=("transcribe_batch", lambda: pinned.transcribe_batch(call))),
               threading.Thread(target=run, args=("decode_aligned",
                                                  lambda: pinned.decode_aligned(windows, window_samples=win)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    waves += 2 + 2 * STAGE_THREAD_CALLS
    rec["threads"] = {
        "transcribe_batch_as_alone": [r == alone_tb for r in results["transcribe_batch"]],
        "decode_aligned_as_alone": [same_da(r) for r in results["decode_aligned"]],
        "errors": errors, "alive": [t.is_alive() for t in threads]}
    th = rec["threads"]
    if (errors or any(th["alive"]) or len(th["transcribe_batch_as_alone"]) != STAGE_THREAD_CALLS
            or not all(th["transcribe_batch_as_alone"] + th["decode_aligned_as_alone"])
            or len(th["decode_aligned_as_alone"]) != STAGE_THREAD_CALLS):
        bad.append("threads")

    # the host's ms of the staging and of the call, both versions in turns at the cells' waves
    for b, n, pad in STAGE_SHAPES:
        call = calls[f"b{b}x{n}"]
        ms = {"pageable": {"stage": [], "call": []}, "pinned": {"stage": [], "call": []}}
        for r in range(STAGE_ROUNDS):
            order = ("pageable", "pinned") if r % 2 == 0 else ("pinned", "pageable")
            for name in order + order[::-1]:
                t = plain if name == "pageable" else pinned
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                t._stage(call, b, pad, np.int16)
                ms[name]["stage"].append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                t.transcribe_batch(call)
                ms[name]["call"].append((time.perf_counter() - t0) * 1e3)
        waves += 4 * STAGE_ROUNDS
        rec[f"ms_b{b}x{n}"] = {k: {part: {"median": statistics.median(v), "all": [round(x, 3) for x in v]}
                                   for part, v in parts.items()} for k, parts in ms.items()}
    rec["counters"] = {"pinned_waves": stage_wave.pinned_waves - waves0,
                       "plain_waves": stage_wave.plain_waves - plain0, "growths": stage_wave.growths - growths0,
                       "pinned_waves_expected": waves}
    # every wave of the pinned transcriber through its ring; the plain one staged by pageable_stage
    if rec["counters"]["pinned_waves"] != waves or rec["counters"]["plain_waves"] != 0 \
            or not 2 <= rec["counters"]["growths"] <= 8:
        bad.append("counters")
    rec["card"] = card_line()
    emit(rec)
    if bad:
        fail(f"phase 5d: the pinned staging disagrees with the pageable one in {bad}: {rec}")
    return rec


def eval_per(tokens, lengths, data) -> float:
    from phones_las_torch.utils.metrics import edit_distance_stats, per_from_stats

    refs = data["refs"]
    return per_from_stats(*edit_distance_stats(tokens, lengths, np.where(refs >= 0, refs, 0), (refs >= 0).sum(axis=1)))


def check_production_eval(params, params_cpu, cfg, data, kernels) -> dict:
    """Phase 6a: the committed checkpoint in production mode on the eval
    set, greedy and beam-8, card against the CPU plain path."""
    from phones_las_torch.decode import beam_decode, greedy_decode
    from phones_las_torch.models.las import encode
    from phones_las_torch.ops.lstm import resolve_rnn_precision
    from phones_las_torch.utils.device import matmul_precision_scope

    pcfg = production_cfg(cfg)
    prec = resolve_rnn_precision(pcfg.matmul_precision)
    cap = int(data["decode_cap"][0])

    def run(p, device, beam):
        with matmul_precision_scope(pcfg.matmul_precision):
            audio = torch.from_numpy(data["audio"]).to(device)
            lens = torch.from_numpy(data["lengths"]).to(device)
            mem, _, mask = encode(p, pcfg, audio, lens, prec=prec)
            if beam:
                res = beam_decode(p.speller, pcfg.speller, mem, mask, cap, beam_width=beam, prec=prec)
                tok, tl = res.tokens, res.lengths
            else:
                tok, tl, _ = greedy_decode(p.speller, pcfg.speller, mem, mask, cap, prec=prec)
        return tok.cpu().numpy(), tl.cpu().numpy()

    rec = {"phase": "6a", "mode": f"matmul_precision={pcfg.matmul_precision!r}, front-end precision='high'",
           "recurrent_dots": prec, "utterances": len(data["audio"]), "decode_cap": cap}
    bad = []
    for name, beam in (("greedy", 0), ("beam8", BEAM_K)):
        reset_counters(kernels)
        t0 = time.perf_counter()
        tok_g, len_g = run(params, DEV, beam)
        ms = (time.perf_counter() - t0) * 1e3
        launches, bf16 = launch_counts(kernels), bf16_counts(kernels)
        tok_c, _ = run(params_cpu, "cpu", beam)
        rows = [i for i in range(len(tok_g)) if (tok_g[i] != tok_c[i]).any()]
        per = eval_per(tok_g, len_g, data)
        ref = REF_GREEDY_PER if not beam else REF_BEAM8_PER
        rec[name] = {"per": per, "reference_per": ref, "rows_differing_from_cpu_plain": rows,
                     "ms_first_call": ms, "launches": launches, "bf16_launches": bf16}
        n_layers = cfg.listener.num_layers
        ok = (
            len(rows) <= MAX_DIFF_ROWS and abs(per - ref) <= PER_TOL
            and launches["fused_logmel"] == 1 and launches["bidir_recurrence"] == n_layers
            and bf16["bidir_recurrence"] == n_layers and launches["greedy_decode_fused"] == (0 if beam else 1)
            and not any(launches[k] for k in ("recurrence", "recurrence_residual", "recurrence_bwd"))
        )
        if not ok:
            bad.append(name)
    emit(rec)
    if bad:
        fail(f"production mode on the eval set failed in {bad}: {rec}")
    return rec


def in_turns(names, rounds: int):
    """The order of ``rounds`` rounds, each running every name once,
    reversed every other round (a, b, b, a, a, b, ...), after one round of
    warm-up (round 0)."""
    for r in range(rounds + 1):
        for n in (names if r % 2 == 0 else names[::-1]):
            yield r, n


def serve_modes_in_turns(params, cfg, kernels, card) -> dict:
    """Phase 6b, serving: phase 3's greedy shape in parity and in
    production mode, the calls in turns."""
    from phones_las_torch.decode.greedy import greedy_decode
    from phones_las_torch.models.las import featurize
    from phones_las_torch.models.listener import listen
    from phones_las_torch.ops.lstm import resolve_rnn_precision
    from phones_las_torch.ops.masking import length_mask
    from phones_las_torch.utils.device import matmul_precision_scope

    modes = {"parity": cfg, "production": production_cfg(cfg)}
    audio = torch.from_numpy(make_audio(FLAGSHIP_B)).to(DEV)
    lens = torch.full((FLAGSHIP_B,), audio.shape[1], dtype=torch.int32, device=DEV)

    def call(c):
        prec = resolve_rnn_precision(c.matmul_precision)
        with matmul_precision_scope(c.matmul_precision):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats, flens = featurize(params, c, audio, lens)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            mem, enc_lens = listen(params.listener, c.listener, feats, flens, prec=prec)
            mask = length_mask(enc_lens, mem.shape[1])
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            tok, _, _ = greedy_decode(params.speller, c.speller, mem, mask, DECODE_STEPS, prec=prec)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
        return tok, (t1 - t0, t2 - t1, t3 - t2)

    splits = {n: [] for n in modes}
    launches = {}
    for r, n in in_turns(list(modes), SERVE_ROUNDS):
        reset_counters(kernels)
        tok, split = call(modes[n])
        launches[n] = (launch_counts(kernels), bf16_counts(kernels))
        if r:
            splits[n].append(split)
    rec = {"phase": "6b", "mode": "greedy serving, parity and production in turns",
           "shape": f"B={FLAGSHIP_B} x {SECONDS} s, {DECODE_STEPS} greedy steps", "rounds": SERVE_ROUNDS}
    for n, c in modes.items():
        fe_s, li_s, de_s = (statistics.median(x) for x in zip(*splits[n]))
        total = fe_s + li_s + de_s
        profiled = profile_step(lambda: call(c), total * 1e3)
        rec[n] = {
            "utt_per_s": FLAGSHIP_B / total, "total_ms": total * 1e3, "frontend_ms": fe_s * 1e3,
            "listener_ms": li_s * 1e3, "decoder_ms": de_s * 1e3,
            "total_ms_each": [sum(x) * 1e3 for x in splits[n]],
            "device_busy_share": profiled.get("device_busy_share", "not measured"),
            "launches": launches[n][0], "bf16_launches": launches[n][1], "device_profile": profiled,
        }
    rec["card"] = card
    emit(rec)
    n_layers = cfg.listener.num_layers
    la, bf = launches["production"]
    if tok.shape != (FLAGSHIP_B, DECODE_STEPS) or la["greedy_decode_fused"] != 1 or (
        la["bidir_recurrence"] != n_layers or bf["bidir_recurrence"] != n_layers
    ):
        fail(f"production serving did not run the bf16 forward and the decoder kernel: {rec}")
    return rec


def train_modes_in_turns(ckpt, kernels, card) -> dict:
    """Phase 6b, training: phase 4c's step with one Trainer per numerics
    mode on the same batch, stepped in turns: parity ('highest'), TF32
    alone ('high': TF32 in the GEMMs, float32 recurrent dots) and
    production ('default': TF32 and bf16 recurrent dots); the difference
    between the last two is the bf16 dots', between the first two TF32's."""
    from phones_las_torch.train.loop import Trainer
    from phones_las_torch.train.state import TrainConfig
    from phones_las_torch.utils.param_io import load_artifact

    device = None if DEV == "cuda" else DEV
    params, cfg, _ = load_artifact(ckpt, device=device)
    modes = {"parity": cfg, "tf32": dataclasses.replace(cfg, matmul_precision="high"),
             "production": production_cfg(cfg)}
    trainers = {}
    for n, c in modes.items():
        trainers[n] = Trainer(c, TrainConfig(), device=device)
        trainers[n].warm_start(params)
    del params
    batch = flagship_train_batch(cfg.speller.vocab_size)
    steps = {n: [] for n in modes}
    for r, n in in_turns(list(modes), TRAIN_ROUNDS):
        reset_counters(kernels)
        t0 = time.perf_counter()
        out = trainers[n].train_step(batch)
        loss = float(out["loss"])
        torch.cuda.synchronize()
        steps[n].append({"round": r, "loss": loss, "ms": (time.perf_counter() - t0) * 1e3,
                         "launches": launch_counts(kernels), "bf16_launches": bf16_counts(kernels)})
    rec = {"phase": "6b", "mode": "training, three numerics modes in turns",
           "shape": f"B={TRAIN_B} x {SECONDS} s, {DECODE_STEPS}-token targets", "rounds": TRAIN_ROUNDS}
    for n in modes:
        ms = [s["ms"] for s in steps[n] if s["round"]]
        rec[n] = {
            "matmul_precision": modes[n].matmul_precision, "prec": trainers[n].prec,
            "step_ms": statistics.median(ms), "step_ms_each": ms, "losses": [s["loss"] for s in steps[n]],
            "launches": steps[n][-1]["launches"], "bf16_launches": steps[n][-1]["bf16_launches"],
        }
    rec["card"] = card
    emit(rec)
    n_layers = cfg.listener.num_layers
    for n in modes:
        losses = rec[n]["losses"]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail(f"phase 6b, {n}: training losses are not finite and falling: {losses}")
        want_bf16 = n_layers if n == "production" else 0
        for s in steps[n]:
            la, bf = s["launches"], s["bf16_launches"]
            if la["recurrence_residual"] != n_layers or la["recurrence_bwd"] != n_layers or la["fused_logmel"] != 1:
                fail(f"phase 6b, {n}: the step did not launch its kernels once per layer: {la}")
            if bf["recurrence_residual"] != want_bf16 or bf["recurrence_bwd"] != want_bf16:
                fail(f"phase 6b, {n}: {want_bf16} bf16 launches of the residual and VJP expected: {bf}")
    return rec


def train_gate_augmented(data, kernels) -> dict:
    """Phase 6c: the long-gate configuration with its SpecAugment and a
    frequency warp trains on the card; the masks and the warp on the card
    against the CPU on the same uniforms and α."""
    from phones_las_torch.frontend.freq_warp import apply_freq_warp, draw_alpha
    from phones_las_torch.frontend.specaugment import apply_specaugment, draw_uniforms
    from phones_las_torch.models.las import featurize
    from phones_las_torch.train.loop import Trainer
    from phones_las_torch.train.state import TrainConfig
    from phones_las_torch.utils.param_io import load_artifact

    device = None if DEV == "cuda" else DEV
    params, cfg, _ = load_artifact(GATE_ASSET, device=device)
    cfg = dataclasses.replace(cfg, freq_warp=GATE_WARP)
    tr = Trainer(cfg, TrainConfig(), device=device)
    tr.warm_start(params)
    batch = eval_batch(data)
    reset_counters(kernels)
    t0 = time.perf_counter()
    losses = [float(tr.train_step(batch)["loss"]) for _ in range(GATE_TRAIN_STEPS)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / GATE_TRAIN_STEPS
    launches = launch_counts(kernels)

    # the augmentation alone, card against CPU, on draws made once on the CPU
    with torch.no_grad():
        audio = torch.from_numpy(data["audio"]).to(DEV)
        feats, flens = featurize(params, cfg, audio, torch.from_numpy(data["lengths"]).to(DEV))
        b, bins = feats.shape[0], feats.shape[-1] // 3
        g = torch.Generator().manual_seed(60)
        alpha = draw_alpha(b, GATE_WARP, g)
        sa = cfg.specaugment
        fu, tu = draw_uniforms(b, sa.freq_masks, g), draw_uniforms(b, sa.time_masks, g)
        on = lambda t, dev: tuple(x.to(dev) for x in t)
        out = {}
        for dev, f, fl in ((DEV, feats, flens), ("cpu", feats.cpu(), flens.cpu())):
            w = apply_freq_warp(f, GATE_WARP, bins, alpha=alpha.to(dev))
            keep = apply_specaugment(torch.ones_like(w), fl, sa, bins, freq_uniforms=on(fu, dev),
                                     time_uniforms=on(tu, dev))
            out[dev] = (w.cpu(), keep.cpu())
    warp_err = float((out[DEV][0] - out["cpu"][0]).abs().max())
    masks_equal = torch.equal(out[DEV][1], out["cpu"][1])
    rec = {
        "phase": "6c", "artifact": os.path.relpath(GATE_ASSET, REPO), "freq_warp": GATE_WARP,
        "specaugment": dataclasses.asdict(sa), "utterances": len(batch["audio"]),
        "losses": losses, "ms_per_step": ms, "launches": launches,
        "warp_max_abs_diff_card_cpu": warp_err, "masked_cells": int((out["cpu"][1] == 0).sum()),
        "masks_equal_card_cpu": masks_equal,
    }
    emit(rec)
    n_layers = cfg.listener.num_layers
    if not all(np.isfinite(losses)) or not masks_equal or warp_err > 1e-5 or not rec["masked_cells"]:
        fail(f"the augmented long-gate training or its augmentation on the card failed: {rec}")
    if launches["recurrence_residual"] != n_layers * GATE_TRAIN_STEPS or launches["recurrence_bwd"] != n_layers * GATE_TRAIN_STEPS:
        fail(f"the augmented training did not run the residual and VJP kernels on every step: {launches}")
    return rec


def check_workdir(ckpt, data, kernels) -> dict:
    """Phase 6d: a training workdir at the checkpoint's widths: 3 steps with
    checkpoints at 1, 2 and 3, a silent resume from 2, averaging, the export
    and the workdir Transcriber against the exported artifact's."""
    import shutil
    import tempfile

    from phones_las_torch.api import Transcriber
    from phones_las_torch.cli.common import resolve_preset
    from phones_las_torch.data.vocab import Vocab
    from phones_las_torch.train.checkpoint import CheckpointManager, load_averaged_params
    from phones_las_torch.train.loop import Trainer
    from phones_las_torch.utils.param_io import load_artifact, named_leaves

    device = None if DEV == "cuda" else DEV
    params, cfg, _ = load_artifact(ckpt, device=device)
    os.makedirs(os.path.join(REPO, "_runs"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_workdir_", dir=os.path.join(REPO, "_runs"))
    try:
        data_dir, wd, wd2 = (os.path.join(work, n) for n in ("data", "run", "resumed"))
        os.makedirs(data_dir)
        Vocab([f"p{i}" for i in range(cfg.speller.vocab_size - 4)]).save(os.path.join(data_dir, "vocab.txt"))
        cap = int(data["decode_cap"][0])
        overrides = {"num_steps": 3, "checkpoint_every": 2, "max_target_len": cap, "buckets": [32000]}
        os.makedirs(wd)
        with open(os.path.join(wd, "config.json"), "w") as f:
            json.dump({"preset": WORKDIR_PRESET, "data": data_dir, "overrides": overrides, "precision": None}, f)
        preset, *_ = resolve_preset(WORKDIR_PRESET, data_dir, overrides)
        if dataclasses.asdict(preset.model) != dataclasses.asdict(cfg):
            fail(f"the {WORKDIR_PRESET} preset does not give the checkpoint's configuration")
        full = eval_batch(data)
        rows = [slice(0, 32), slice(32, 64), slice(16, 48)]
        batches = [{k: v[r] for k, v in full.items()} for r in rows]

        reset_counters(kernels)
        tr = Trainer(preset.model, preset.train, wd, device=device)
        tr.warm_start(params)
        tr.fit(iter(batches), log_fn=lambda m: None)
        torch.cuda.synchronize()
        launches = launch_counts(kernels)
        steps = tr.ckpt.all_steps()
        os.makedirs(os.path.join(wd2, "checkpoints"))
        shutil.copytree(os.path.join(wd, "checkpoints", "2"), os.path.join(wd2, "checkpoints", "2"))
        resumed = Trainer(preset.model, preset.train, wd2, device=device)
        resumed_from = resumed.state.step
        resumed.fit(iter(batches[2:]), log_fn=lambda m: None)
        want = dict(named_leaves(tr.state.params))
        diffs = {k: rel_err(t.detach(), want[k].detach()) for k, t in named_leaves(resumed.state.params)}
        worst = max(diffs, key=diffs.get)

        avg, used = load_averaged_params(wd, tr.state, 2)
        ck = [CheckpointManager(wd).read(s)[0] for s in used]
        avg_err = max(
            float(np.abs(t.detach().cpu().numpy().astype(np.float64) - (ck[0][k] + ck[1][k]) / 2.0).max())
            for k, t in named_leaves(avg)
        )

        utts = [np.clip(np.rint(data["audio"][i, : data["lengths"][i]]), -32768, 32767).astype(np.int16)
                for i in range(GATE_UTTS)]
        served = Transcriber(wd, beam_width=0, device=device)
        art = os.path.join(work, "model.npz")
        extras = served.export_artifact(art)
        reset_counters(kernels)
        got = served.transcribe_batch(utts)
        serve_launches = launch_counts(kernels)
        want_tok = Transcriber.from_artifact(art, device=device).transcribe_batch(utts)
        differing = [i for i, (a, b) in enumerate(zip(got, want_tok)) if a != b]
        rec = {
            "phase": "6d", "preset": WORKDIR_PRESET, "overrides": overrides, "checkpoints": steps,
            "train_launches": launches, "resumed_from_step": resumed_from,
            "resumed_step3_max_rel_to_max": diffs[worst], "resumed_worst_leaf": worst, "tol": RESUME_TOL,
            "averaged_steps": used, "average_max_abs_err": avg_err,
            "export": {k: v for k, v in extras.items() if k != "vocab"},
            "transcriber_utterances": len(utts), "rows_differing_from_artifact": differing,
            "tokens": sum(map(len, got)), "serve_launches": serve_launches,
        }
        emit(rec)
        n_layers = cfg.listener.num_layers
        if steps != [1, 2, 3] or resumed_from != 2 or resumed.state.step != 3 or diffs[worst] > RESUME_TOL:
            fail(f"checkpoint and resume on the card failed: {rec}")
        if used != [2, 3] or avg_err > 1e-6 or differing or extras["step"] != 3:
            fail(f"averaging, export or the workdir Transcriber failed: {rec}")
        if launches["recurrence_residual"] != 3 * n_layers or serve_launches["greedy_decode_fused"] != 1:
            fail(f"the workdir run did not launch its kernels as expected: {rec}")
        return rec
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---- phase 7: the data layer and fit over record files


class RecordingWriter:
    """The metric writer ``Trainer.fit`` takes (any object with these two
    methods): keeps what it is given, by step."""

    def __init__(self):
        self.scalars, self.images = {}, {}

    def write_scalars(self, step, values):
        self.scalars.setdefault(step, {}).update(values)

    def write_images(self, step, images):
        self.images.setdefault(step, {}).update(images)


class NotingSource:
    """A ``DataSource`` that notes the real ``utt_ids`` of each batch it
    hands out, with its epoch."""

    def __init__(self, src):
        self.src, self.batches = src, []

    def epoch(self, epoch=0, prefetch=4):
        for b in self.src.epoch(epoch, prefetch):
            self.batches.append((epoch, b["utt_ids"][: b["num_real"]]))
            yield b

    def repeat(self, start_epoch=0):
        return self.src.repeat(start_epoch)


def vector_err(got, want) -> float:
    """max |got − want| over max |want| of a stats vector (Δ means sit at 0)."""
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


def token_per(hyps, refs, vocab) -> float:
    from phones_las_torch.utils.metrics import _edit_distance

    pairs = list(zip(hyps, refs))
    errs = sum(_edit_distance(vocab.encode(h), vocab.encode(r)) for h, r in pairs)
    return errs / max(sum(len(r) for _, r in pairs), 1)


def check_corpus_prep(work, cfg, kernels) -> dict:
    """Phase 7a: the formant corpus's train and held-out splits written as
    record files by the port, and the data dir's CMVN through the
    front-end kernel over every training utterance, against the CPU."""
    from phones_las_torch.data.prep_common import compute_cmvn, finalize_split_dir
    from phones_las_torch.data.speechlike import write_speechlike_corpus
    from phones_las_torch.frontend.cmvn import CmvnStats

    t0 = time.perf_counter()
    train, vocab = write_speechlike_corpus(os.path.join(work, "train.plu"), n_utts=DATA_TRAIN_UTTS,
                                           seed=DATA_TRAIN_SEED)
    held, _ = write_speechlike_corpus(os.path.join(work, "held.plu"), n_utts=DATA_HELD_UTTS, seed=DATA_HELD_SEED)
    synth_s = time.perf_counter() - t0
    data_dir = os.path.join(work, "data")
    os.makedirs(data_dir)
    reset_counters(kernels)
    t0 = time.perf_counter()
    finalize_split_dir(data_dir, vocab, cmvn_from=train, frontend_cfg=cfg.frontend, cmvn_max_utts=None,
                       device=None if DEV == "cuda" else DEV)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = launch_counts(kernels)
    card = CmvnStats.load(os.path.join(data_dir, "cmvn.json"))
    t0 = time.perf_counter()
    cpu = compute_cmvn(train, cfg.frontend, max_utts=None, device="cpu")
    cpu_s = time.perf_counter() - t0
    errs = {"mean": vector_err(card.mean, cpu.mean), "std": vector_err(card.std, cpu.std)}
    mb = sum(os.path.getsize(p) + os.path.getsize(p + ".idx") for p in (train, held)) / 1e6
    rec = {
        "phase": "7a", "train": {"utterances": DATA_TRAIN_UTTS, "seed": DATA_TRAIN_SEED},
        "held_out": {"utterances": DATA_HELD_UTTS, "seed": DATA_HELD_SEED}, "record_mb": mb,
        "synthesis_s": synth_s, "cmvn_frames": card.count, "cmvn_card_s": card_s, "cmvn_cpu_s": cpu_s,
        "cmvn_err_card_cpu": errs, "tol": CMVN_RTOL, "launches": launches,
    }
    emit(rec)
    if max(errs.values()) > CMVN_RTOL or card.count != cpu.count:
        fail(f"the card's CMVN stats are not within {CMVN_RTOL} of the CPU's: {rec}")
    if launches["fused_logmel"] != DATA_TRAIN_UTTS:
        fail(f"the CMVN pass did not run the front-end kernel once an utterance: {launches}")
    return train, held, vocab, data_dir


def check_datasource(train, vocab) -> int:
    """Phase 7b: epoch 0 of the training split through the native fill and
    the Python fill, batch for batch → the number of batches an epoch."""
    from phones_las_torch.data.pipeline import DataSource, PipelineConfig
    from phones_las_torch.data.records import RecordReader

    pipe = PipelineConfig(batch_size=TRAIN_B, buckets=DATA_BUCKETS, max_target_len=DATA_MAX_TARGET,
                          eos_id=vocab.eos_id, pad_id=vocab.pad_id)
    native, python = DataSource([train], pipe), DataSource([train], pipe, use_native="never")
    if native.native is None:
        fail("the native record reader did not build on this host: the DataSource filled in Python")
    out, secs = {}, {}
    for name, src in (("native", native), ("python", python)):
        t0 = time.perf_counter()
        out[name] = list(src.epoch(0))
        secs[name] = time.perf_counter() - t0
    same = len(out["native"]) == len(out["python"]) and all(
        sorted(a) == sorted(b) and all(
            np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray) else a[k] == b[k] for k in a)
        for a, b in zip(out["native"], out["python"])
    )
    lens = RecordReader(train).lengths()
    n = len(out["native"])
    rec = {
        "phase": "7b", "batch": TRAIN_B, "buckets": list(DATA_BUCKETS), "max_target_len": DATA_MAX_TARGET,
        "batches_epoch0": n, "epoch1_batches": sum(1 for _ in native.epoch(1)),
        "utterances_in_batches": sum(b["num_real"] for b in out["native"]),
        "dropped_long_targets": int((lens[:, 1] > DATA_MAX_TARGET - 1).sum()),
        "dropped_long_audio": int((lens[:, 0] > DATA_BUCKETS[-1]).sum()),
        "max_targets": int(lens[:, 1].max()), "max_seconds": float(lens[:, 0].max()) / SAMPLE_RATE,
        "ms_per_batch_native": secs["native"] * 1e3 / max(n, 1),
        "ms_per_batch_python": secs["python"] * 1e3 / max(len(out["python"]), 1),
        "native_equals_python": same, "audio_dtype": str(out["native"][0]["audio"].dtype),
    }
    emit(rec)
    if not same or not n:
        fail(f"the native fill does not equal the Python fill: {rec}")
    return n


def eval_rows(tr, batches) -> list:
    """Greedy tokens of every real row of ``batches`` at their decode caps."""
    from phones_las_torch.decode.greedy import greedy_decode
    from phones_las_torch.models.las import encode

    rows = []
    p, cfg = tr.state.params, tr.model_cfg
    with torch.no_grad():
        for b in batches:
            db = tr.device_batch(b)
            mem, _, mask = encode(p, cfg, db["audio"], db["audio_lengths"], prec=tr.prec)
            toks, lens, _ = greedy_decode(p.speller, cfg.speller, mem, mask, tr.decode_cap(b), prec=tr.prec)
            toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
            rows += [toks[i, : lens[i]].tolist() for i in range(b["num_real"])]
    return rows


def check_fit(ckpt, cfg, train, held, data_dir, n_epoch, kernels) -> dict:
    """Phases 7c and 7d: fine-tune the committed checkpoint from the record
    files for two epochs at full width (the user's path: preset over the
    data dir, warm start, the data dir's CMVN, ``fit`` over a DataSource
    with an eval every epoch), the eval on the card against the CPU; then
    an epoch resumed by the reference's rule."""
    import shutil

    from phones_las_torch.api import Transcriber
    from phones_las_torch.cli.common import apply_cmvn_to_params, resolve_preset
    from phones_las_torch.data.pipeline import DataSource
    from phones_las_torch.train.checkpoint import CheckpointManager
    from phones_las_torch.train.loop import Trainer
    from phones_las_torch.utils.param_io import load_artifact, named_leaves

    device = None if DEV == "cuda" else DEV
    overrides = {"num_steps": DATA_EPOCHS * n_epoch, "eval_every": n_epoch, "checkpoint_every": n_epoch,
                 "log_every": 1, "batch_size": TRAIN_B, "max_target_len": DATA_MAX_TARGET,
                 "buckets": list(DATA_BUCKETS)}
    preset, vocab, _, cmvn, _ = resolve_preset(WORKDIR_PRESET, data_dir, overrides)
    if dataclasses.asdict(preset.model) != dataclasses.asdict(cfg):
        fail(f"the {WORKDIR_PRESET} preset over the corpus's data dir does not give the checkpoint's configuration")
    params, _, _ = load_artifact(ckpt, device=device)

    def trainer(tc, workdir=None, on=device):
        tr = Trainer(preset.model, tc, workdir, device=on)
        if tr.state.step == 0:
            tr.warm_start(params)
            apply_cmvn_to_params(tr.state.params, cmvn)
        return tr

    held_src = DataSource([held], dataclasses.replace(preset.pipeline, shuffle=False, drop_remainder=False))
    held_batches = lambda: held_src.epoch(0)
    run = os.path.join(os.path.dirname(held), "run")
    os.makedirs(run)
    with open(os.path.join(run, "config.json"), "w") as f:  # as the training CLI writes it
        json.dump({"preset": WORKDIR_PRESET, "data": data_dir, "overrides": overrides, "precision": None}, f)
    tr = trainer(preset.train, run)
    before = tr.evaluate(held_batches())
    source = NotingSource(DataSource([train], preset.pipeline))
    writer, logs = RecordingWriter(), []
    reset_counters(kernels)
    t0 = time.perf_counter()
    with torch.enable_grad():
        tr.fit(source, eval_batches_fn=held_batches, writer=writer, log_fn=logs.append)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = launch_counts(kernels)
    steps = [m for m in logs if m["tag"] == "train"]
    evals = [{k: v for k, v in m.items() if k != "tag"} for m in logs if m["tag"] == "eval"]
    step_ms = [TRAIN_B * 1e3 / m["utt_per_sec"] for m in steps[1:]]
    images = [im["attention_alignment"] for im in writer.images.values()]
    image_ok = len(images) == len(evals) and all(
        im.ndim == 4 and im.shape[0] == 1 and im.shape[-1] == 1 and 0.0 <= im.min() and im.max() <= 1.0
        for im in images
    )

    # the eval on the card against the same params on the CPU
    cpu_tr = trainer(preset.train, on="cpu")
    cpu_tr.warm_start(tr.state.params)
    t0 = time.perf_counter()
    gpu_ev = tr.evaluate(held_batches())
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    cpu_ev = cpu_tr.evaluate(held_batches())
    gpu_rows, cpu_rows = eval_rows(tr, held_batches()), eval_rows(cpu_tr, held_batches())
    differing = [i for i, (a, b) in enumerate(zip(gpu_rows, cpu_rows)) if a != b]
    first = list(held_batches())[:1]
    gpu_beam = tr.evaluate(first, beam_width=BEAM_K)
    cpu_beam = cpu_tr.evaluate(first, beam_width=BEAM_K)
    rec = {
        "phase": "7c", "preset": WORKDIR_PRESET, "overrides": overrides, "steps": tr.state.step,
        "epochs_seen": sorted({e for e, _ in source.batches}), "per_before": before["per"],
        "evals": evals, "losses": [m["loss"] for m in steps], "fit_s": fit_s,
        "ms_per_step_median": statistics.median(step_ms), "ms_per_step_min": min(step_ms),
        "utt_per_s_median": statistics.median(m["utt_per_sec"] for m in steps[1:]),
        "launches": launches, "writer_scalar_steps": sorted(writer.scalars),
        "images": [list(im.shape) for im in images], "checkpoints": tr.ckpt.all_steps(),
        "eval_card": gpu_ev, "eval_cpu": cpu_ev, "eval_card_s": eval_s,
        "rows_differing_from_cpu": differing, "rows": len(gpu_rows),
        "beam8_first_batch": {"card": gpu_beam, "cpu": cpu_beam, "utterances": first[0]["num_real"]},
        "card": card_line(),
    }
    emit(rec)
    finite = all(np.isfinite(rec["losses"])) and len(steps) == DATA_EPOCHS * n_epoch
    if not finite or not image_ok or any("eval/per" not in writer.scalars.get(e["step"], {}) for e in evals):
        fail(f"fit over the DataSource: losses not finite, or the writer missed its scalars or images: {rec}")
    if len(evals) != DATA_EPOCHS or rec["epochs_seen"] != list(range(DATA_EPOCHS)):
        fail(f"fit over the DataSource did not run {DATA_EPOCHS} epochs with an eval after each: {rec}")
    if not all(launches[n] for n in ("fused_logmel", "bidir_recurrence", "recurrence_residual", "recurrence_bwd",
                                     "greedy_decode_fused")):
        fail(f"a kernel of the fit path never launched: {launches}")
    if (abs(gpu_ev["per"] - cpu_ev["per"]) > PER_TOL or len(differing) > MAX_DIFF_ROWS
            or abs(gpu_ev["loss"] - cpu_ev["loss"]) > FIT_LOSS_RTOL * abs(cpu_ev["loss"])):
        fail(f"the held-out eval on the card disagrees with the CPU: {rec}")
    if abs(gpu_beam["per"] - cpu_beam["per"]) > PER_TOL:
        fail(f"the held-out beam-8 eval on the card disagrees with the CPU: {rec}")
    # the fine-tuned run served as one artifact (the committed ckpt.npz
    # carries no vocabulary, which from_artifact needs)
    artifact = os.path.join(os.path.dirname(held), "model.npz")
    Transcriber(run, beam_width=0, device=device).export_artifact(artifact)

    # 7d: one epoch with a checkpoint at its end, then a trainer resumed from it
    wd = os.path.join(os.path.dirname(held), "resume")
    one = dataclasses.replace(preset.train, num_steps=n_epoch)
    with torch.enable_grad():
        trainer(one, wd).fit(DataSource([train], preset.pipeline), log_fn=lambda m: None)
    saved, meta = CheckpointManager(wd).read()
    t0 = time.perf_counter()
    resumed = trainer(dataclasses.replace(preset.train, num_steps=2 * n_epoch), wd)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    bitwise = all(np.array_equal(t.detach().cpu().numpy(), saved[k]) for k, t in named_leaves(resumed.state.params))
    noted = NotingSource(DataSource([train], preset.pipeline))
    with torch.enable_grad():
        resumed.fit(noted, log_fn=lambda m: None)
    replay = [ids for _, ids in noted.batches] == [ids for e, ids in source.batches if e == 0]
    rec = {
        "phase": "7d", "saved": meta, "restored_step": n_epoch, "start_epoch": resumed.start_epoch,
        "restored_bitwise": bitwise, "restore_s": restore_s, "replayed_epoch": sorted({e for e, _ in noted.batches}),
        "replay_equals_first_epoch": replay, "steps_after": resumed.state.step,
    }
    emit(rec)
    if (meta != {"step": n_epoch, "epoch": 0} or resumed.start_epoch != 0 or not bitwise or not replay
            or resumed.state.step != 2 * n_epoch):
        fail(f"the epoch resume did not follow the reference's rule: {rec}")
    shutil.rmtree(wd, ignore_errors=True)
    return artifact, run, gpu_ev


def check_transcribe_files(artifact, held, vocab, kernels) -> dict:
    """Phase 7e: the held-out split as 16 kHz WAV files (and some at 48 kHz)
    through ``Transcriber.transcribe_files`` of the fine-tuned run's
    artifact."""
    from phones_las_torch.api import Transcriber
    from phones_las_torch.data.audio_io import resample, write_wav
    from phones_las_torch.data.records import RecordReader

    utts = list(RecordReader(held))
    d = os.path.join(os.path.dirname(held), "wav")
    os.makedirs(d)
    p16 = [os.path.join(d, f"{u.utt_id}.wav") for u in utts]
    for p, u in zip(p16, utts):
        write_wav(p, u.audio, SAMPLE_RATE)
    p48 = [os.path.join(d, f"{u.utt_id}_48k.wav") for u in utts[:FILES_48K]]
    for p, u in zip(p48, utts):
        write_wav(p, resample(u.audio, SAMPLE_RATE, 48000), 48000)
    t = Transcriber.from_artifact(artifact, device=None if DEV == "cuda" else DEV)
    reset_counters(kernels)
    t0 = time.perf_counter()
    got16 = t.transcribe_files(p16)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts(kernels)
    want = t.transcribe_batch([u.audio for u in utts])
    got48 = t.transcribe_files(p48)
    refs = [vocab.decode(u.targets) for u in utts]
    per16, per48 = token_per(got16[:FILES_48K], refs, vocab), token_per(got48, refs, vocab)
    rec = {
        "phase": "7e", "files_16k": len(p16), "files_48k": len(p48), "ms_16k_files": ms,
        "rows_differing_from_transcribe_batch": [i for i, (a, b) in enumerate(zip(got16, want)) if a != b],
        "per_16k_all": token_per(got16, refs, vocab), "per_16k_first": per16, "per_48k": per48,
        "tol": FILES_PER_TOL, "launches": launches,
    }
    emit(rec)
    if rec["rows_differing_from_transcribe_batch"] or abs(per48 - per16) > FILES_PER_TOL:
        fail(f"transcribe_files disagrees with transcribe_batch, or 48 kHz files with 16 kHz ones: {rec}")
    if not all(launches[n] for n in ("fused_logmel", "bidir_recurrence", "greedy_decode_fused")):
        fail(f"transcribe_files did not run the serving kernels: {launches}")
    return rec


def check_long_gate(kernels) -> dict:
    """Phase 7f: the long-regime gate of ``tests/test_long_regime_gate.py``
    (its seeds and bounds) on the card, through the long-gate artifact's
    ``Transcriber``, on audio the port's ``speechlike`` synthesizes."""
    from phones_las_torch.api import Transcriber
    from phones_las_torch.data.speechlike import make_phonotactics, speechlike_phone_inventory, synth_speech_utterance
    from phones_las_torch.data.vocab import Vocab

    vocab, lang = Vocab(speechlike_phone_inventory()), make_phonotactics(1234)
    t = Transcriber.from_artifact(GATE_ASSET, device=None if DEV == "cuda" else DEV)
    rng = np.random.RandomState(9001)
    utts = [synth_speech_utterance(rng, vocab, f"gate-{i}", model=lang, n_syllables_range=(22, 28),
                                   word_syllables=(1, 3), snr_db_range=(8.0, 30.0)) for i in range(8)]
    stream = synth_speech_utterance(np.random.RandomState(9002), vocab, "gate-stream", model=lang,
                                    n_syllables_range=(170, 170), word_syllables=(1, 3), snr_db_range=(10.0, 30.0))
    reset_counters(kernels)
    t0 = time.perf_counter()
    hyps = [t.transcribe(u.audio) for u in utts]
    refs = [vocab.decode(u.targets) for u in utts]
    batch_s = time.perf_counter() - t0
    derailed = [i for i, (h, r) in enumerate(zip(hyps, refs)) if len(h) >= len(r) + DERAIL_SLACK]
    ref = vocab.decode(stream.targets)
    t0 = time.perf_counter()
    stitched = t.transcribe_long(stream.audio)
    quiet = t.transcribe_long((stream.audio * 0.03).astype(np.float32), adapt_cmvn=True)
    stream_s = time.perf_counter() - t0
    launches = launch_counts(kernels)
    rec = {
        "phase": "7f", "artifact": os.path.relpath(GATE_ASSET, REPO), "utterances": len(utts),
        "seconds": [round(len(u.audio) / SAMPLE_RATE, 2) for u in utts], "derailments": derailed,
        "batch_per": token_per(hyps, refs, vocab), "stream_seconds": len(stream.audio) / SAMPLE_RATE,
        "stitched_per": token_per([stitched], [ref], vocab), "quiet_adapted_per": token_per([quiet], [ref], vocab),
        "bounds": [GATE_BATCH_PER, GATE_STITCH_PER, GATE_QUIET_PER], "batch_s": batch_s, "stream_s": stream_s,
        "launches": launches,
    }
    emit(rec)
    if (derailed or rec["batch_per"] > GATE_BATCH_PER or rec["stitched_per"] > GATE_STITCH_PER
            or rec["quiet_adapted_per"] > GATE_QUIET_PER):
        fail(f"the long-regime gate failed on the card: {rec}")
    if not (launches["fused_logmel"] and launches["bidir_recurrence"]):
        fail(f"the long-gate Transcriber did not run the front-end and LSTM kernels: {launches}")
    return rec


def check_data_layer(ckpt, cfg, kernels) -> SimpleNamespace:
    """Phase 7, in a temporary directory under ``_runs/`` → its fine-tuned
    run for phase 14 (``work``, removed by the caller; the directory is
    removed here if the phase fails)."""
    import shutil
    import tempfile

    os.makedirs(os.path.join(REPO, "_runs"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_data_", dir=os.path.join(REPO, "_runs"))
    try:
        train, held, vocab, data_dir = check_corpus_prep(work, cfg, kernels)
        n_epoch = check_datasource(train, vocab)
        artifact, run, held_eval = check_fit(ckpt, cfg, train, held, data_dir, n_epoch, kernels)
        check_transcribe_files(artifact, held, vocab, kernels)
        check_long_gate(kernels)
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise
    return SimpleNamespace(work=work, run=run, held=held, data_dir=data_dir, eval_per=held_eval["per"])


# ---- phase 8: the front doors — the CLIs, the HTTP server, exported programs

FRONT_TRAIN_UTTS = 128  # prepare speechlike: 128 training utterances, 32 held out (seeds 7 and 8)
FRONT_STEPS, FRONT_PROFILE_STEPS = 1, 1  # the training CLI's steps after its profiled ones
FRONT_FILES = 16  # held-out utterances through the transcribe CLI as WAV files
SERVE_BATCH, SERVE_CLIENTS = 16, 16
STREAM_CHUNK = SAMPLE_RATE // 2  # /stream feeds of 0.5 s
STREAM_PER_TOL = 0.005  # streamed tokens' PER against transcribe_long's
EXPORT_BATCHES = (1, 16, 64)
EXPORT_ROUNDS = 6  # timed rounds of exported against live, in turns
CLI_TIMEOUT = 600
OPS = ("phones_las_torch.fused_logmel.default", "phones_las_torch.bidir_recurrence.default",
       "phones_las_torch.greedy_decode_fused.default")


def cli(name: str, *args: str, started=None):
    """``python -m phones_las_torch.cli.<name> ARGS`` in a process of its own,
    from the checkout, on the card (``DEV``) unless ARGS name a device →
    the completed process (its stdout); given a list ``started``, the
    running ``Popen``, appended to it. A failed command fails the phase."""
    if DEV != "cuda" and name != "lm" and "--device" not in args:
        args = (*args, "--device", DEV)
    cmd = [sys.executable, "-m", f"phones_las_torch.cli.{name}", *args]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    if started is not None:
        started.append(subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True))
        return started[-1]
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=CLI_TIMEOUT)
    if r.returncode:
        fail(f"cli.{name} {' '.join(args)} exited {r.returncode}: {r.stderr[-3000:]}")
    return r


def finish(proc: subprocess.Popen, name: str) -> str:
    """Wait for a started CLI → its stdout; a failure fails the phase."""
    out, err = proc.communicate(timeout=CLI_TIMEOUT)
    if proc.returncode:
        fail(f"cli.{name} exited {proc.returncode}: {err[-3000:]}")
    return out


def per_footer(out: str):
    """The infer CLI's last line → (utterances, edit distance, reference tokens)."""
    m = re.search(r"^# (\d+) utterances, PER=[0-9.]+ \((\d+)/(\d+)\)", out, re.M)
    if not m:
        fail(f"the infer CLI printed no PER footer: {out[-2000:]}")
    return int(m.group(1)), int(m.group(2)), int(m.group(3))


def check_clis(ckpt, cfg, work, started):
    """Phase 8a: prepare → train (warm-started, profiled), then infer (card
    and CPU), lm, transcribe, export and serve at once, each a process of
    its own on the card, against the library in this process → (workdir,
    held-out utterances, vocab, the running server process, the export
    directory, the flagship export directory: the warm start's source
    exported at 64 × 10 s with the flagship's 200-step cap)."""
    from phones_las_torch.api import Transcriber
    from phones_las_torch.cli.common import resolve_preset
    from phones_las_torch.data.audio_io import write_wav
    from phones_las_torch.data.pipeline import DataSource
    from phones_las_torch.data.records import RecordReader
    from phones_las_torch.decode.lm import load_lm
    from phones_las_torch.train.checkpoint import CheckpointManager
    from phones_las_torch.train.loop import Trainer
    from phones_las_torch.utils.param_io import load_artifact

    data, source, run = (os.path.join(work, n) for n in ("data", "source", "run"))
    secs = {}
    t0 = time.perf_counter()
    finish(started[0], "prepare")  # started beside phase 7 (start_front_prepare)
    secs["prepare_wait"] = time.perf_counter() - t0
    # the warm start's source: the committed checkpoint as a workdir, written by the library
    preset, vocab, *_ = resolve_preset(WORKDIR_PRESET, data, None)
    if dataclasses.asdict(preset.model) != dataclasses.asdict(cfg):
        fail(f"the {WORKDIR_PRESET} preset over the prepared data dir does not give the checkpoint's configuration")
    device = None if DEV == "cuda" else DEV
    tr = Trainer(preset.model, preset.train, device=device)
    tr.warm_start(load_artifact(ckpt, device=device)[0])
    CheckpointManager(source).save(0, tr.state, force=True)
    del tr
    with open(os.path.join(source, "config.json"), "w") as f:  # as the training CLI writes it
        json.dump({"preset": WORKDIR_PRESET, "data": data, "overrides": {"max_target_len": DECODE_STEPS},
                   "precision": None}, f)
    n_steps = FRONT_PROFILE_STEPS + FRONT_STEPS
    t0 = time.perf_counter()
    train_out = cli(
        "train", "--preset", WORKDIR_PRESET, "--data", data, "--workdir", run, "--num-steps", str(n_steps),
        "--profile-steps", str(FRONT_PROFILE_STEPS), "--batch-size", str(TRAIN_B), "--buckets",
        *map(str, DATA_BUCKETS), "--max-target-len", str(DATA_MAX_TARGET), "--init-checkpoint", source,
    ).stdout
    secs["train"] = time.perf_counter() - t0
    traces = sorted(glob.glob(os.path.join(run, "profile", "trace_*.json")))
    kernels_traced = set()
    for path in traces:
        with open(path) as f:
            kernels_traced |= {e.get("name", "") for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"}
    # the kernels' base names (a CUDA name reads "void (anonymous namespace)::name<T>(args)")
    lstm_traced = sorted({m for n in kernels_traced for m in re.findall(r"\w+_kernel(?:<[^>]*>)?", n)
                          if m.startswith(("lstm_", "gates_", "dwh_"))})
    # the commands that read the run, at once: infer on the card and on the
    # CPU, lm, transcribe, export (8c) and serve (8b, left running)
    test = os.path.join(data, "test.plu")
    held = list(RecordReader(test))
    wavs = [os.path.join(work, f"{u.utt_id}.wav") for u in held[:FRONT_FILES]]
    for p, u in zip(wavs, held):
        write_wav(p, u.audio, SAMPLE_RATE)
    export_dir, flagship_dir = os.path.join(work, "export"), os.path.join(work, "export_flagship")
    t0 = time.perf_counter()
    procs = {
        "infer": cli("infer", "--workdir", run, "--data", test, "--beam-width", "0",
                     "--output", os.path.join(run, "hyps.tsv"), started=started),
        "infer --device cpu": cli("infer", "--workdir", run, "--data", test, "--beam-width", "0", "--device", "cpu",
                                  "--output", os.path.join(run, "hyps_cpu.tsv"), started=started),
        "lm": cli("lm", "--data", data, "--out", os.path.join(run, "lm.npz"), started=started),
        "transcribe": cli("transcribe", "--workdir", run, "--beam-width", "0", *wavs, started=started),
        "export": cli("export", "--workdir", run, "--out", export_dir, "--batch-sizes",
                      ",".join(map(str, EXPORT_BATCHES)), "--pad-seconds", str(SECONDS), "--beam-width", "0",
                      started=started),
        "export flagship": cli("export", "--workdir", source, "--out", flagship_dir, "--batch-sizes",
                               str(FLAGSHIP_B), "--pad-seconds", str(SECONDS), "--beam-width", "0",
                               started=started),
        "serve": cli("serve", "--workdir", run, "--host", "127.0.0.1", "--port", "0", "--beam-width", "0",
                     "--max-batch", str(SERVE_BATCH), started=started),
    }
    with open(os.path.join(run, "config.json")) as f:
        cfg_file = json.load(f)
    preset, vocab, *_ = resolve_preset(cfg_file["preset"], cfg_file["data"], cfg_file["overrides"])
    tr = Trainer(preset.model, preset.train, run, device=device)
    eval_src = DataSource([test], dataclasses.replace(preset.pipeline, shuffle=False, drop_remainder=False))
    ev = tr.evaluate(eval_src.epoch(0), max_steps=preset.pipeline.max_target_len)
    want = Transcriber(run, beam_width=0, device=device).transcribe_files(wavs)
    outs = {name: finish(p, name) for name, p in procs.items() if name != "serve"}
    secs["infer_lm_transcribe_export"] = time.perf_counter() - t0
    footer = per_footer(outs["infer"])
    files_equal = outs["transcribe"].splitlines() == [f"{p}\t{' '.join(t)}" for p, t in zip(wavs, want)]
    rows = {}
    for name in ("hyps.tsv", "hyps_cpu.tsv"):
        with open(os.path.join(run, name)) as f:
            rows[name] = [line.rstrip("\n") for line in f]
    differing = [i for i, (a, b) in enumerate(zip(rows["hyps.tsv"], rows["hyps_cpu.tsv"])) if a != b]
    lm_shape = list(load_lm(os.path.join(run, "lm.npz")).shape)
    train_lines = [line for line in train_out.splitlines() if line.startswith("{'tag': 'train'")]
    rec = {
        "phase": "8a", "preset": WORKDIR_PRESET, "steps": n_steps, "profiled_steps": FRONT_PROFILE_STEPS,
        "checkpoints": CheckpointManager(run).all_steps(), "warm_started": "warm-started [all]" in train_out,
        "train_log": train_lines[-1:], "trace_files": len(traces),
        "trace_mb": sum(os.path.getsize(p) for p in traces) / 1e6, "lstm_kernels_traced": lstm_traced,
        "infer_utterances": footer[0], "infer_per": footer[1] / max(footer[2], 1), "infer_ref_tokens": footer[2],
        "evaluate_per": ev["per"], "evaluate_ref_tokens": ev["ref_tokens"],
        "infer_rows_differing_from_cpu": differing, "transcribe_files": len(wavs),
        "transcribe_equals_library": files_equal, "lm_shape": lm_shape, "export": outs["export"].strip(),
        "export_flagship": outs["export flagship"].strip(),
        "seconds": secs,
    }
    emit(rec)
    if rec["checkpoints"][-1:] != [n_steps] or not rec["warm_started"] or not train_lines:
        fail(f"the training CLI did not warm-start and train {n_steps} steps: {rec}")
    if DEV == "cuda" and not (any("lstm_fwd_kernel" in n for n in lstm_traced)
                              and any("lstm_bwd_kernel" in n for n in lstm_traced)):
        fail(f"the training CLI's trace does not name the residual and VJP kernels: {rec}")
    if footer[0] != len(held) or abs(rec["infer_per"] - ev["per"]) > 1e-9 or footer[2] != ev["ref_tokens"]:
        fail(f"the infer CLI's PER is not Trainer.evaluate's: {rec}")
    if len(differing) > max_diff_rows(len(held)) or not files_equal or lm_shape != [len(vocab)] * 3:
        fail(f"infer against the CPU, transcribe against the library, or the LM file failed: {rec}")
    return run, held, vocab, procs["serve"], export_dir, flagship_dir


def max_diff_rows(rows: int) -> int:
    """MAX_DIFF_ROWS at the share of ``rows`` it is of the eval set's 64
    (1 of phase 8's 32 held-out rows)."""
    return MAX_DIFF_ROWS * rows // 64


def http_post(url: str, body: bytes):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=body), timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def check_server(run, held, vocab, serve_proc, kernels) -> dict:
    """Phase 8b: the ``cli.serve`` process started in 8a (up, one request,
    down), then the same ``make_server`` in this process: 32 held-out WAV
    uploads from 16 client threads against ``transcribe_batch``, a /stream
    session and a ``?stream=1`` upload of the long-regime stream against
    ``transcribe_long``."""
    import threading
    import urllib.request

    from phones_las_torch.api import Transcriber
    from phones_las_torch.cli.serve import make_server
    from phones_las_torch.data.audio_io import write_wav
    from phones_las_torch.data.speechlike import make_phonotactics, synth_speech_utterance

    utts = [u.audio for u in held]
    try:
        line = serve_proc.stdout.readline()
        if not line.startswith("serving "):
            serve_proc.kill()
            fail(f"cli.serve did not come up: {line!r} {serve_proc.communicate(timeout=60)[1][-3000:]}")
        base = "http://" + line.split(" on ")[1].split(" ")[0]
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        code, body = http_post(base + "/transcribe?raw=1", utts[0].tobytes())
        cli_answer = (code, json.loads(body))
    finally:
        serve_proc.terminate()
        serve_proc.wait(timeout=60)

    t = Transcriber(run, beam_width=0, device=None if DEV == "cuda" else DEV)
    t.transcribe_batch([np.zeros(SAMPLE_RATE, np.int16)] * SERVE_BATCH)  # as cli.serve warms it
    want = t.transcribe_batch(utts)
    wav_bodies = []
    path = os.path.join(os.path.dirname(run), "serve.wav")
    for u in utts:
        write_wav(path, u, SAMPLE_RATE)
        with open(path, "rb") as f:
            wav_bodies.append(f.read())
    server, worker = make_server(t, "127.0.0.1", 0, max_batch=SERVE_BATCH)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        got, lat = [None] * len(utts), [0.0] * len(utts)

        def client(c):
            for i in range(c, len(utts), SERVE_CLIENTS):
                t0 = time.perf_counter()
                code, body = http_post(base + "/transcribe", wav_bodies[i])
                lat[i] = time.perf_counter() - t0
                got[i] = json.loads(body)["tokens"] if code == 200 else f"HTTP {code}: {body[:200]!r}"

        reset_counters(kernels)
        threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        [th.start() for th in threads]
        [th.join(timeout=300) for th in threads]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts(kernels)
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        counter = lambda name: int(float(next(
            ln.split()[1] for ln in metrics.splitlines() if ln.startswith(name + " "))))
        batches, filled = counter("plu_batches_total"), counter("plu_batched_requests_total")
        differing = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]

        # the long-regime stream (as phase 7f) through /stream in 0.5 s feeds
        stream = synth_speech_utterance(np.random.RandomState(9002), vocab, "gate-stream", model=make_phonotactics(1234),
                                        n_syllables_range=(170, 170), word_syllables=(1, 3),
                                        snr_db_range=(10.0, 30.0))
        audio, ref = stream.audio, vocab.decode(stream.targets)
        offline = t.transcribe_long(audio)
        reset_counters(kernels)
        t0 = time.perf_counter()
        sid = json.loads(http_post(base + "/stream/start", b"")[1])["id"]
        streamed, feeds = [], 0
        for ofs in range(0, len(audio), STREAM_CHUNK):
            code, body = http_post(base + f"/stream/{sid}", audio[ofs: ofs + STREAM_CHUNK].tobytes())
            if code != 200:
                fail(f"/stream/{sid} answered {code}: {body[:500]!r}")
            streamed += json.loads(body)["tokens"]
            feeds += 1
        end = json.loads(http_post(base + f"/stream/{sid}/end", b"")[1])
        streamed += end["tokens"]
        stream_s = time.perf_counter() - t0
        stream_launches = launch_counts(kernels)
        code, body = http_post(base + "/transcribe?raw=1&stream=1", audio.tobytes())
        ndjson = [json.loads(x) for x in body.decode().splitlines()]
        upload = [tok for ln in ndjson for tok in ln.get("tokens", [])]
        code_long, body_long = http_post(base + "/transcribe?raw=1", audio.tobytes())
        routed = json.loads(body_long).get("tokens")
    finally:
        worker.stop()
        server.shutdown()
        server.server_close()
    seconds = len(audio) / SAMPLE_RATE
    per = {name: token_per([toks], [ref], vocab) for name, toks in
           (("transcribe_long", offline), ("stream", streamed), ("stream_upload", upload), ("long_upload", routed))}
    lat_ms = sorted(x * 1e3 for x in lat)
    rec = {
        "phase": "8b", "cli_serve": {"healthz": health, "answer_status": cli_answer[0],
                                      "answer_equals": cli_answer[1].get("tokens") == want[0]},
        "requests": len(utts), "clients": SERVE_CLIENTS, "max_batch": SERVE_BATCH, "batches": batches,
        "mean_fill": filled / max(batches, 1), "rows_differing_from_transcribe_batch": differing,
        "req_per_s": len(utts) / wall, "p50_ms": lat_ms[len(lat_ms) // 2],
        "p99_ms": lat_ms[min(len(lat_ms) - 1, int(0.99 * len(lat_ms)))], "launches": launches,
        "stream_seconds": seconds, "stream_feeds": feeds, "stream_rtf": stream_s / seconds,
        "stream_equals_transcribe_long": streamed == offline, "stream_upload_equals": upload == offline,
        "stream_upload_final": bool(ndjson) and ndjson[-1].get("final") is True,
        "long_upload_equals": routed == offline, "per": per, "stream_launches": stream_launches,
        "card": card_line(),
    }
    emit(rec)
    if cli_answer[0] != 200 or not rec["cli_serve"]["answer_equals"] or health.get("status") != "ok":
        fail(f"cli.serve did not answer as the library does: {rec}")
    if len(differing) > max_diff_rows(len(utts)) or filled != len(utts) or rec["mean_fill"] <= 1.0:
        fail(f"the served tokens or the micro-batches are off: {rec}")
    n_layers = t.model_cfg.listener.num_layers
    if DEV == "cuda" and ((launches["fused_logmel"], launches["bidir_recurrence"], launches["greedy_decode_fused"]) != (
            batches, n_layers * batches, batches) or launches["recurrence_residual"] or launches["recurrence_bwd"]):
        fail(f"the server's kernel launches do not follow its batches: {rec}")
    if any(abs(p - per["transcribe_long"]) > STREAM_PER_TOL for p in per.values()) or not rec["stream_upload_final"]:
        fail(f"the streamed transcripts are not within {STREAM_PER_TOL} PER of transcribe_long's: {rec}")
    if code != 200 or code_long != 200 or DEV == "cuda" and not (
            stream_launches["fused_logmel"] and stream_launches["bidir_recurrence"]):
        fail(f"the long-form routes failed or ran no kernel: {rec}")
    return rec


def check_export(run, out, flagship_dir, held, kernels) -> dict:
    """Phase 8c: the programs ``cli.export`` wrote in 8a (1, 16 and 64 × 10 s,
    greedy, the run's 32-step cap): their operators, their tokens against
    the live ``Transcriber``, a fresh process that imports only
    ``phones_las_torch.export``; and the flagship shape (64 × 10 s, 200
    steps, the checkpoint's workdir) exported against live, in turns."""
    from phones_las_torch.api import Transcriber
    from phones_las_torch.export import ExportedTranscriber

    utts = [u.audio for u in held]
    device = None if DEV == "cuda" else DEV
    # the fresh process runs while this one checks the programs
    inputs = os.path.join(os.path.dirname(run), "export_inputs.npz")
    np.savez(inputs, *[np.asarray(u) for u in utts])
    code = (
        "import json, sys, numpy as np\n"
        "from phones_las_torch.export import ExportedTranscriber\n"
        f"z = np.load({inputs!r})\n"
        "utts = [z[f'arr_{i}'] for i in range(len(z.files))]\n"
        f"print(json.dumps(ExportedTranscriber({out!r}, device={device!r}).transcribe_batch(utts)))\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.startswith(('phones_las_torch.models', "
        "'phones_las_torch.api', 'phones_las_torch.train')))))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    fresh_proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
    try:
        with open(os.path.join(out, "export.json")) as f:
            meta = json.load(f)
        with open(os.path.join(flagship_dir, "export.json")) as f:
            flag_meta = json.load(f)
        ops = {}
        for d, m in ((out, meta), (flagship_dir, flag_meta)):
            for e in m["entries"]:
                ep = torch.export.load(os.path.join(d, e["file"]))
                targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
                ops[f"{os.path.basename(d)}/{e['file']}"] = (
                    {op.split(".")[1]: targets.count(op) for op in OPS} | {"nodes": len(targets)})
        live = Transcriber(run, beam_width=0, device=device)
        exported = ExportedTranscriber(out, device=device)
        want = live.transcribe_batch(utts)
        exported.transcribe_batch(utts)  # loads the b=64 program
        reset_counters(kernels)
        got = exported.transcribe_batch(utts)
        torch.cuda.synchronize()
        launches = launch_counts(kernels)
        differing = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        fresh_out, fresh_err = fresh_proc.communicate(timeout=CLI_TIMEOUT)
    finally:
        if fresh_proc.poll() is None:
            fresh_proc.kill()
            fresh_proc.wait(timeout=60)
    if fresh_proc.returncode:
        fail(f"a fresh process could not serve the export: {fresh_err[-3000:]}")
    fresh_lines = fresh_out.strip().splitlines()
    fresh, model_modules = json.loads(fresh_lines[-2]), json.loads(fresh_lines[-1])

    audio = [np.clip(np.rint(a), -32768, 32767).astype(np.int16) for a in make_audio(FLAGSHIP_B, seed=8)]
    flag_live = Transcriber(os.path.join(os.path.dirname(run), "source"), beam_width=0, device=device)
    flag_exported = ExportedTranscriber(flagship_dir, device=device)
    if flag_live.max_steps != DECODE_STEPS:
        fail(f"the flagship workdir decodes {flag_live.max_steps} steps, not {DECODE_STEPS}")
    calls = {"live": lambda: flag_live.transcribe_batch(audio),
             "exported": lambda: flag_exported.transcribe_batch(audio)}
    times = {n: [] for n in calls}
    for r_, n in in_turns(list(calls), EXPORT_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        calls[n]()
        torch.cuda.synchronize()
        if r_:
            times[n].append((time.perf_counter() - t0) * 1e3)
    reset_counters(kernels)
    flag_tokens = calls["exported"]()
    torch.cuda.synchronize()
    flag_launches = launch_counts(kernels)
    flag_differing = [i for i, (a, b) in enumerate(zip(flag_tokens, calls["live"]())) if a != b]
    rec = {
        "phase": "8c", "entries": meta["entries"], "platforms": meta["platforms"],
        "pt2_mb": sum(os.path.getsize(os.path.join(out, e["file"])) for e in meta["entries"]) / 1e6,
        "operators": ops, "utterances": len(utts), "rows_differing_from_live": differing, "launches": launches,
        "fresh_process_equal": fresh == got, "fresh_process_model_modules": model_modules,
        "flagship": f"B={FLAGSHIP_B} x {SECONDS} s random PCM, greedy, {flag_live.max_steps} steps",
        "flagship_rows_differing_from_live": flag_differing, "flagship_launches": flag_launches,
        "flagship_longest_hypothesis": max(map(len, flag_tokens)),
        "live_ms": times["live"], "exported_ms": times["exported"],
        "live_ms_median": statistics.median(times["live"]), "exported_ms_median": statistics.median(times["exported"]),
        "card": card_line(),
    }
    emit(rec)
    n_layers = live.model_cfg.listener.num_layers
    if any(o[op.split(".")[1]] != (n_layers if "bidir" in op else 1) for o in ops.values() for op in OPS):
        fail(f"an exported program does not hold the three operators once a kernel call: {rec}")
    if len(differing) > max_diff_rows(len(utts)) or not rec["fresh_process_equal"] or model_modules:
        fail(f"the exported programs' tokens disagree, or the loader needed the model code: {rec}")
    if DEV == "cuda" and any((n["fused_logmel"], n["bidir_recurrence"], n["greedy_decode_fused"]) != (1, n_layers, 1)
                             for n in (launches, flag_launches)):
        fail(f"the exported programs did not launch the three kernels once a call each: {launches} {flag_launches}")
    if len(flag_differing) > MAX_DIFF_ROWS:
        fail(f"the flagship program's tokens disagree with the live Transcriber's: {rec}")
    return rec


def start_front_prepare(started) -> str:
    """8a's records: ``prepare speechlike`` started as a process (appended
    to ``started``) beside phase 7 → phase 8's temporary directory under
    ``_runs/``."""
    import tempfile

    os.makedirs(os.path.join(REPO, "_runs"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_front_", dir=os.path.join(REPO, "_runs"))
    cli("prepare", "speechlike", "--out", os.path.join(work, "data"), "--n-utts", str(FRONT_TRAIN_UTTS), "--seed",
        str(DATA_TRAIN_SEED), started=started)
    return work


def stop(started) -> None:
    """Every process of ``started`` that still runs, stopped."""
    for p in started:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=60)


def check_front_doors(ckpt, cfg, kernels, work, started) -> None:
    """Phase 8, in ``work`` (``start_front_prepare``'s, its first process
    the records' ``prepare``), removed at the end; every process it starts
    is stopped."""
    import shutil

    try:
        run, held, vocab, serve_proc, export_dir, flagship_dir = check_clis(ckpt, cfg, work, started)
        check_server(run, held, vocab, serve_proc, kernels)
        check_export(run, export_dir, flagship_dir, held, kernels)
    finally:
        stop(started)
        shutil.rmtree(work, ignore_errors=True)


# ---- phase 9: the seq2seq G2P at its own widths: kernels, serving, training, corpus prep

# the 70 held-out gold words, a copy of tests/test_g2p_coverage.py::_EN_GOLD
# (this script imports nothing of the JAX package or its tests)
G2P_GOLD = {
    "make": "m eɪ k", "making": "m eɪ k ɪ ŋ", "time": "t aɪ m",
    "times": "t aɪ m z", "hope": "h oʊ p", "cake": "k eɪ k",
    "name": "n eɪ m", "home": "h oʊ m", "side": "s aɪ d",
    "bright": "b ɹ aɪ t", "teacher": "t i tʃ ɚ", "station": "s t eɪ ʃ ə n",
    "nation": "n eɪ ʃ ə n", "nature": "n eɪ tʃ ɚ", "famous": "f eɪ m ə s",
    "played": "p l eɪ d", "table": "t eɪ b ə l", "little": "l ɪ t ə l",
    "apple": "æ p ə l", "find": "f aɪ n d", "cold": "k oʊ l d",
    "car": "k ɑ ɹ", "care": "k ɛ ɹ", "bird": "b ɝ d", "turn": "t ɝ n",
    "corner": "k ɔ ɹ n ɚ", "store": "s t ɔ ɹ", "near": "n ɪ ɹ",
    "rain": "ɹ eɪ n", "boat": "b oʊ t", "moon": "m u n",
    "mouse": "m aʊ s", "snow": "s n oʊ", "coin": "k ɔɪ n",
    "blue": "b l u", "fruit": "f ɹ u t", "judge": "dʒ ʌ dʒ",
    "bridge": "b ɹ ɪ dʒ", "city": "s ɪ t i", "page": "p eɪ dʒ",
    "phone": "f oʊ n", "green": "ɡ ɹ i n", "street": "s t ɹ i t",
    "spring": "s p ɹ ɪ ŋ", "think": "θ ɪ ŋ k", "catch": "k æ tʃ",
    "lunch": "l ʌ n tʃ", "stand": "s t æ n d", "plant": "p l æ n t",
    "walking": "w ɔ k ɪ ŋ", "started": "s t ɑ ɹ t ɪ d",
    "stopped": "s t ɑ p t", "running": "ɹ ʌ n ɪ ŋ", "happy": "h æ p i",
    "yellow": "j ɛ l oʊ", "window": "w ɪ n d oʊ", "paper": "p eɪ p ɚ",
    "open": "oʊ p ɛ n", "music": "m j u z ɪ k", "riding": "ɹ aɪ d ɪ ŋ",
    "red": "ɹ ɛ d", "bed": "b ɛ d", "fed": "f ɛ d", "led": "l ɛ d",
    "wed": "w ɛ d", "shed": "ʃ ɛ d", "yes": "j ɛ s", "ring": "ɹ ɪ ŋ",
    "sing": "s ɪ ŋ", "king": "k ɪ ŋ",
}
G2P_PAD_B, G2P_PAD_T = 64, 28  # NeuralG2P's padded batch: 64 words x 28 chars
G2P_STEPS = 24  # predict's decode cap
G2P_TRAIN_B, G2P_TRAIN_U, G2P_LR = 256, 128, 2e-3  # cli.g2p train's defaults
G2P_TRAIN = dict(batch_size=G2P_TRAIN_B, learning_rate=G2P_LR, label_smoothing=0.1, dev_fraction=0.05,
                 eval_every=150, seed=0)  # train_g2p's defaults, the CLI's widths
G2P_LIB_STEPS = 5  # 9c: library steps, card against CPU
G2P_TIMED_STEPS = 5  # 9c: timed steps
G2P_CLI_STEPS = 600  # cut from 1,200 for the script's time (dev PER 0.045 at step 600 on an H100)
G2P_LOSS_RTOL = 1e-5  # 9c: each step's loss, card against CPU, relative
G2P_LEAF_TOL = 1e-5  # 9c: every leaf after 5 steps, max |d|
# 9c: gradient elements in Adam's eps region (|g| below this on the CPU's
# first step), where rounding moves the update by ~1e-5: held to lr a step
ADAM_FLAT = 1e-7
G2P_GOLD_PER, G2P_GOLD_EXACT = 0.05, 0.8  # the bundled model's gate (tests/test_g2p_coverage.py)
G2P_TRAINED_PER = 0.15  # the rule tables' gate, for the card-trained model
G2P_MAX_DIFF_WORDS = 1  # words whose hypothesis may differ from the CPU plain path
G2P_CMVN_TOL = 1e-6  # 9d: CMVN mean and std, card against CPU, of their max |x|
# 9d: the mini corpora; their out-of-lexicon words go through the model
G2P_LS = {
    ("train-clean-100", "19", "198"): [
        "CHAPTER ONE THE STATIONMASTER OF KNIGHTSBRIDGE",
        "HE PAINTED THE XYLOPHONES WITH ZEPHYRS AND PLOVERS",
        "THE THIRTY NINE STEPS WERE GRANITE AND MARBLE",
        "SHE WHISPERED TO THE CARTOGRAPHER ABOUT THE GLACIERS",
    ],
    ("dev-clean", "84", "121"): [
        "THE LIGHTHOUSE KEEPER COUNTED FORTY TWO PELICANS",
        "WONDERFULLY QUIET MEADOWS STRETCHED BEYOND THE ORCHARD",
    ],
}
G2P_CV = {
    "es": ["Hola mundo, buenos días.", "El pingüino come churros."],
    "it": ["Ciao, perché no?", "Gli gnocchi della nonna."],
    "en": ["The stations of 42 xylophones.", "Hello, zephyrs and plovers!", "Wonderfully quiet meadows."],
}


def g2p_gold_per(hyps: dict):
    """→ (PER, exact-word share) of ``hyps`` on the gold words."""
    from phones_las_torch.utils.metrics import _edit_distance

    dist = total = exact = 0
    for word, gold in G2P_GOLD.items():
        ref, hyp = gold.split(), list(hyps[word])
        ids = {t: i for i, t in enumerate(dict.fromkeys(hyp + ref))}
        dist += _edit_distance([ids[t] for t in hyp], [ids[t] for t in ref])
        total += len(ref)
        exact += hyp == ref
    return dist / total, exact / len(G2P_GOLD)


def check_g2p_kernels(model) -> None:
    """Phase 9a: the four kernels of the G2P path at its widths against
    their plain versions: the BiLSTM at the bundled model's U = 160 on 64
    rows of 1..28 letters, the decoder on that memory (U = A = 160, M =
    320, V = 45, 24 steps), the residual forward and the VJP at the
    training widths (B = 256, U = 128, T = the lexicon's longest word)."""
    from phones_las_torch.data.lexicon_en import expanded_lexicon
    from phones_las_torch.models.g2p_model import encode_chars, g2p_setup, init_g2p
    from phones_las_torch.ops.lstm import _project_tm
    from phones_las_torch.ops.masking import length_mask

    g = torch.Generator(device=DEV).manual_seed(90)
    lengths = torch.randint(1, G2P_PAD_T + 1, (G2P_PAD_B,), generator=g, device=DEV)
    lengths[0], lengths[1] = G2P_PAD_T, 1
    letters = torch.randint(4, 4 + 28, (G2P_PAD_B, G2P_PAD_T), generator=g, device=DEV)
    chars = letters * length_mask(lengths, G2P_PAD_T, torch.long)
    pf, pb = model.params.listener.layers[0]
    emb = model.params.char_embed[chars]
    bi = check_bilstm_inputs(pf, pb, _project_tm(pf, emb), _project_tm(pb, emb), lengths, "highest", g, phase="9a")
    if bi["launch"]["cluster"] != 4:
        fail(f"forward_plan did not take C = 4 at U = 160: {bi['launch']}")
    memory, mask = encode_chars(model.params, model.cfg, chars, lengths)
    check_greedy(model.params, model.cfg, memory, mask, G2P_PAD_B, steps=G2P_STEPS, phase="9a")
    lex = expanded_lexicon()
    cfg, _, _ = g2p_setup(lex, G2P_TRAIN_U)
    fresh = init_g2p(cfg, torch.Generator().manual_seed(0), DEV)
    with torch.enable_grad():
        # 2 x 16 tiles of 16 rows: two waves of the card's 15 clusters of 8
        check_lstm_train(fresh.listener.layers[0], max(len(w) for w in lex), "highest", seed=91, b=G2P_TRAIN_B,
                         ragged=True, phase="9a", one_wave=False)


def serve_g2p(kernels) -> dict:
    """Phase 9b: the bundled model served on the card, beam 4 and greedy:
    gold PER and exact words against the gate and the CPU plain path, then
    every lexicon word in 64-word batches (words/s: readings) → the
    launches of these lookups."""
    from phones_las_torch.data.g2p import text_to_ipa
    from phones_las_torch.data.lexicon_en import expanded_lexicon
    from phones_las_torch.models.g2p_model import NeuralG2P

    gold = list(G2P_GOLD)
    total = dict.fromkeys(launch_counts(kernels), 0)
    rec = {"phase": "9b", "gold_words": len(gold), "rules": dict(zip(
        ("gold_per", "exact"), g2p_gold_per({w: text_to_ipa(w, "en") for w in gold})))}
    words = sorted(expanded_lexicon())
    batches = -(-len(words) // G2P_PAD_B)
    for bw in (4, 1):
        m = NeuralG2P.bundled(beam_width=bw, device=DEV)
        reset_counters(kernels)
        hyps = m.lookup(gold)
        torch.cuda.synchronize()
        la = launch_counts(kernels)
        cpu = NeuralG2P.bundled(beam_width=bw, device="cpu").lookup(gold)
        per, exact = g2p_gold_per(hyps)
        diff = sorted(w for w in gold if hyps[w] != cpu[w])
        m = NeuralG2P.bundled(beam_width=bw, device=DEV)  # an empty cache
        reset_counters(kernels)
        t0 = time.perf_counter()
        m.lookup(words)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        lex_la = launch_counts(kernels)
        for k in total:
            total[k] += la[k] + lex_la[k]
        rec[f"beam{bw}"] = {
            "gold_per": per, "exact": exact, "words_differing_from_cpu": diff, "gold_launches": la,
            "lexicon_words": len(words), "batches": batches, "words_per_s": len(words) / secs,
            "launches_per_batch": {k: v / batches for k, v in lex_la.items()},
        }
        if per > G2P_GOLD_PER or exact < G2P_GOLD_EXACT:
            fail(f"the bundled G2P at beam {bw} misses its gate (PER <= {G2P_GOLD_PER}, exact >= {G2P_GOLD_EXACT}): {rec}")
        if len(diff) > G2P_MAX_DIFF_WORDS:
            fail(f"{len(diff)} gold words differ from the CPU plain path at beam {bw}: {diff}")
        want = {"bidir_recurrence": batches, "greedy_decode_fused": batches if bw == 1 else 0}
        if any(lex_la[k] != v for k, v in want.items()):
            fail(f"the lookups at beam {bw} did not launch the kernels once a batch: {lex_la}, {batches} batches")
    emit(rec)
    return total


def g2p_first_gradient(cfg, vc, vp, lex):
    """The first step's gradient of ``_train_from`` (``G2P_TRAIN``) on the
    CPU, drawn as it draws (the dev permutation, then one batch) → a list
    over the leaves."""
    from phones_las_torch.models import g2p_model as G

    items = sorted(lex.items())
    rng = np.random.RandomState(G2P_TRAIN["seed"])
    perm = rng.permutation(len(items))
    train = [items[i] for i in perm[max(int(len(items) * G2P_TRAIN["dev_fraction"]), 1):]]
    max_word, max_pron = max(len(w) for w, _ in train), max(len(p) for _, p in train) + 1
    idx = rng.randint(0, len(train), G2P_TRAIN["batch_size"])
    batch = G._pad_batch(vc, vp, [train[i] for i in idx], max_word, max_pron)
    p0 = G.init_g2p(cfg, torch.Generator().manual_seed(G2P_TRAIN["seed"]), "cpu")
    leaves = [t.requires_grad_(True) for _, t in G.named_leaves(p0)]
    with torch.enable_grad():
        loss = G.g2p_loss(p0, cfg, {k: torch.from_numpy(v) for k, v in batch.items()}, G2P_TRAIN["label_smoothing"])
        return torch.autograd.grad(loss, leaves)


def train_g2p_library(kernels) -> dict:
    """Phase 9c, the library: 5 steps of ``_train_from`` at the CLI's
    widths on the card and on the CPU from one init (losses and leaves
    held), then 10 timed steps and one profiled step on the card → the
    launches of the card's steps."""
    from phones_las_torch.data.lexicon_en import expanded_lexicon
    from phones_las_torch.models import g2p_model as G

    lex = expanded_lexicon()
    cfg, vc, vp = G.g2p_setup(lex, G2P_TRAIN_U)
    runs = {}
    for dev in ("cpu", DEV):
        p = G.init_g2p(cfg, torch.Generator().manual_seed(0), dev)
        reset_counters(kernels)
        p, losses = G._train_from(p, cfg, vc, vp, lex, steps=G2P_LIB_STEPS, **G2P_TRAIN)
        runs[dev] = (p, losses, launch_counts(kernels))
    (pc, lc, _), (pg, lg, la) = runs["cpu"], runs[DEV]
    g1 = g2p_first_gradient(cfg, vc, vp, lex)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    worst, worst_flat, n_flat = 0.0, 0.0, 0
    for (_, a), (_, b), g in zip(G.named_leaves(pg), G.named_leaves(pc), g1):
        d = (a.detach().cpu() - b.detach()).abs()
        flat = g.abs() < ADAM_FLAT
        n_flat += int(flat.sum())
        worst = max(worst, float(d[~flat].max()) if (~flat).any() else 0.0)
        worst_flat = max(worst_flat, float(d[flat].max()) if flat.any() else 0.0)
    total = dict(la)
    p = G.init_g2p(cfg, torch.Generator().manual_seed(0), DEV)
    reset_counters(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    G._train_from(p, cfg, vc, vp, lex, steps=G2P_TIMED_STEPS, **G2P_TRAIN)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / G2P_TIMED_STEPS
    timed = launch_counts(kernels)
    for k in total:
        total[k] += timed[k]
    prof = profile_step(lambda: G._train_from(p, cfg, vc, vp, lex, steps=1, **G2P_TRAIN), step_ms)
    rec = {
        "phase": "9c", "shape": f"B={G2P_TRAIN_B} U={G2P_TRAIN_U} lr={G2P_LR}, the expanded lexicon",
        "losses_card": lg, "losses_cpu": lc, "loss_max_rel": loss_rel, "leaf_max_abs": worst,
        "adam_flat_elements": n_flat, "adam_flat_max_abs": worst_flat,
        "tol": f"loss rel {G2P_LOSS_RTOL}; leaves {G2P_LEAF_TOL}, elements with |g1| < {ADAM_FLAT} {G2P_LR} a step",
        "step_ms": step_ms, "launches_per_step": {k: v / G2P_TIMED_STEPS for k, v in timed.items()},
        "profiled_step": prof,
    }
    emit(rec)
    if loss_rel > G2P_LOSS_RTOL or worst > G2P_LEAF_TOL or worst_flat > G2P_LR * G2P_LIB_STEPS:
        fail(f"G2P training on the card disagrees with the CPU: {rec}")
    if timed["recurrence_residual"] != G2P_TIMED_STEPS or timed["recurrence_bwd"] != G2P_TIMED_STEPS:
        fail(f"a G2P training step did not launch the residual forward and the VJP once: {timed}")
    return total


def write_g2p_corpora(work: str):
    """The mini LibriSpeech tree (FLAC, ``tests/flac_encoder.py``) and the
    mini Common Voice tree (WAV clips in es, it, en) → their roots."""
    import importlib.util

    from phones_las_torch.data.audio_io import write_wav

    # by path: the card's Python may have another top-level ``tests`` package
    spec = importlib.util.spec_from_file_location("flac_encoder", os.path.join(REPO, "tests", "flac_encoder.py"))
    flac = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(flac)
    encode_flac = flac.encode_flac

    rs = np.random.RandomState(9)
    pcm = lambda: (rs.randn(rs.randint(16000, 32000)) * 2000).astype(np.int16)
    ls = os.path.join(work, "LibriSpeech")
    for (split, speaker, chapter), texts in G2P_LS.items():
        d = os.path.join(ls, split, speaker, chapter)
        os.makedirs(d)
        lines = []
        for i, text in enumerate(texts):
            uid = f"{speaker}-{chapter}-{i:04d}"
            with open(os.path.join(d, uid + ".flac"), "wb") as f:
                f.write(encode_flac(pcm(), mode="fixed2"))
            lines.append(f"{uid} {text}")
        with open(os.path.join(d, f"{speaker}-{chapter}.trans.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    cv = os.path.join(work, "cv")
    for lang, sents in G2P_CV.items():
        d = os.path.join(cv, lang, "clips")
        os.makedirs(d)
        rows = ["client_id\tpath\tsentence"]
        for i, s in enumerate(sents):
            write_wav(os.path.join(d, f"clip{i}.wav"), pcm())
            rows.append(f"c{i}\tclip{i}.mp3\t{s}")
        with open(os.path.join(cv, lang, "validated.tsv"), "w", encoding="utf-8") as f:
            f.write("\n".join(rows) + "\n")
    return ls, cv


def g2p_words_differing(texts) -> list:
    """The words of ``texts`` the bundled model transcribes (out of the
    lexicon, in its alphabet) whose hypothesis differs card against CPU."""
    from phones_las_torch.data.g2p import _EN_LEXICON, normalize_text
    from phones_las_torch.models.g2p_model import NeuralG2P

    words = sorted({w for t in texts for w in normalize_text(t) if w not in _EN_LEXICON})
    card, cpu = NeuralG2P.bundled(device=DEV).lookup(words), NeuralG2P.bundled(device="cpu").lookup(words)
    return sorted(w for w in card if card[w] != cpu[w])


def compare_prep(card_dir: str, cpu_dir: str, differing: list) -> dict:
    """Phase 9d's comparison of two prepared directories → a report; the
    files byte for byte, the records one by one (the targets of an
    utterance holding a word of ``differing`` may differ), CMVN within
    ``G2P_CMVN_TOL`` of its largest magnitude."""
    import filecmp

    from phones_las_torch.data.g2p import normalize_text
    from phones_las_torch.data.records import RecordReader
    from phones_las_torch.frontend.cmvn import CmvnStats

    names = sorted(f for f in os.listdir(card_dir) if f.endswith((".plu", ".idx", ".txt")))
    if names != sorted(f for f in os.listdir(cpu_dir) if f.endswith((".plu", ".idx", ".txt"))):
        fail(f"the card's and the CPU's prep wrote other files: {names}")
    unequal = [f for f in names if not filecmp.cmp(os.path.join(card_dir, f), os.path.join(cpu_dir, f), shallow=False)]
    excused, utts = [], 0
    for f in names:
        if not f.endswith(".plu"):
            continue
        a, b = RecordReader(os.path.join(card_dir, f)), RecordReader(os.path.join(cpu_dir, f))
        if len(a) != len(b):
            fail(f"{f}: {len(a)} records on the card, {len(b)} on the CPU")
        for i in range(len(a)):
            x, y = a[i], b[i]
            utts += 1
            same = x.utt_id == y.utt_id and x.text == y.text and np.array_equal(x.audio, y.audio) and (
                np.array_equal(x.grapheme_targets, y.grapheme_targets))
            if not same:
                fail(f"{f}: record {i} differs beyond its targets")
            if not np.array_equal(x.targets, y.targets):
                if not set(normalize_text(x.text)) & set(differing):
                    fail(f"{f}: record {i}'s targets differ and it holds no word the model transcribes differently")
                excused.append(x.utt_id)
    if unequal and not excused:
        fail(f"files differ between the card's and the CPU's prep: {unequal}")
    sa, sb = CmvnStats.load(os.path.join(card_dir, "cmvn.json")), CmvnStats.load(os.path.join(cpu_dir, "cmvn.json"))
    cmvn = max(float(np.abs(p - q).max() / np.abs(q).max()) for p, q in ((sa.mean, sb.mean), (sa.std, sb.std)))
    if sa.count != sb.count or cmvn > G2P_CMVN_TOL:
        fail(f"CMVN stats differ between the card's and the CPU's prep: {cmvn}, counts {sa.count} {sb.count}")
    return {"files": len(names), "records": utts, "files_unequal": unequal, "records_excused": excused,
            "cmvn_max_rel_to_max": cmvn}


def check_g2p(kernels) -> dict:
    """Phase 9, its files under ``_runs/`` (removed at the end), every
    process it starts stopped → the launches of its main path (the lookups
    of 9b, the card's training steps of 9c)."""
    import shutil
    import tempfile

    from phones_las_torch.models.g2p_model import NeuralG2P

    os.makedirs(os.path.join(REPO, "_runs"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_g2p_", dir=os.path.join(REPO, "_runs"))
    started = []
    try:
        # 9d's four preps, started first: they run beside 9a-9c
        t0 = time.perf_counter()
        ls, cv = write_g2p_corpora(work)
        preps = {}
        for dev in ("card", "cpu"):
            extra = ("--device", "cpu") if dev == "cpu" else ()
            preps["librispeech", dev] = cli(
                "prepare", "librispeech", "--root", ls, "--out", os.path.join(work, f"ls_{dev}"), "--targets", "phone",
                "--g2p-model", "bundled", "--splits", "train-clean-100", "dev-clean", *extra, started=started)
            preps["common_voice", dev] = cli(
                "prepare", "common_voice", "--root", cv, "--out", os.path.join(work, f"cv_{dev}"), "--langs",
                *G2P_CV, "--g2p-model", "bundled", *extra, started=started)
        bundled = NeuralG2P.bundled(device=DEV)
        check_g2p_kernels(bundled)
        launches = serve_g2p(kernels)
        for k, v in train_g2p_library(kernels).items():
            launches[k] += v
        model_path = os.path.join(work, "g2p.npz")
        t1 = time.perf_counter()
        train = cli("g2p", "train", "--out", model_path, "--steps", str(G2P_CLI_STEPS), started=started)
        for (corpus, dev), proc in preps.items():
            finish(proc, f"prepare {corpus} ({dev})")
        prep_s = time.perf_counter() - t0
        differing = g2p_words_differing([t for ts in G2P_LS.values() for t in ts] + G2P_CV["en"])
        if len(differing) > G2P_MAX_DIFF_WORDS:
            fail(f"{len(differing)} corpus words transcribed differently on the card and the CPU: {differing}")
        emit({
            "phase": "9d", "seconds_four_preps_at_once_beside_9a_9c": prep_s, "words_differing_from_cpu": differing,
            "librispeech": compare_prep(os.path.join(work, "ls_card"), os.path.join(work, "ls_cpu"), differing),
            "common_voice": compare_prep(os.path.join(work, "cv_card"), os.path.join(work, "cv_cpu"), differing),
        })
        out = finish(train, "g2p train")
        train_s = time.perf_counter() - t1
        evals = [dict(zip(("step", "loss", "dev_per", "best"), map(float, m)))
                 for m in re.findall(r"g2p step (\d+): loss ([0-9.]+) dev_per ([0-9.]+) best ([0-9.]+)", out)]
        trained = NeuralG2P(model_path, device=DEV)
        per, exact = g2p_gold_per(trained.lookup(list(G2P_GOLD)))
        shipped = g2p_gold_per(bundled.lookup(list(G2P_GOLD)))
        words = ("make", "station", "xylophone", "running", "zephyr")
        applied = cli("g2p", "apply", "--model", model_path, *words).stdout.strip().split("\n")
        rec = {
            "phase": "9c", "cli": f"g2p train --steps {G2P_CLI_STEPS} (B={G2P_TRAIN_B}, U={G2P_TRAIN_U}, lr={G2P_LR})",
            "seconds_with_the_preps_beside_it": train_s, "evals": evals, "gold_per": per, "exact": exact,
            "shipped_gold_per": shipped[0], "shipped_exact": shipped[1], "apply": applied,
        }
        emit(rec)
        if len(evals) != G2P_CLI_STEPS // 150 or per > G2P_TRAINED_PER:
            fail(f"the card-trained G2P misses its gate (gold PER <= {G2P_TRAINED_PER}, an eval every 150 steps): {rec}")
        if [ln.split("\t")[0] for ln in applied] != list(words) or any(len(ln.split("\t")[1].split()) < 2
                                                                      for ln in applied):
            fail(f"cli.g2p apply did not transcribe its five words: {applied}")
    finally:
        for p in started:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        shutil.rmtree(work, ignore_errors=True)
    return launches


# ---- phase 10: several devices: the sharded step, NCCL, data-parallel and replica serving

MESH_B = 32  # the sharded step's global batch: 32 × 10 s
MESH_LAYOUTS = ((2, 2), (2, 1))  # (data, model), ranks sharing the card over gloo, in this order
MESH_LOSS_TOL = 1e-4  # |Δloss| against the unsharded step (__graft_entry__.py's bound)
MESH_GRAD_TOL = 5e-5  # each gradient leaf's max |d| over its max |g| (the same)
MESH_TIMED_STEPS = 1
NCCL_STEPS = 1  # cut from 2 to keep the script in its time limit
NCCL_TOL = 1e-6  # the NCCL world-1 trainer against the plain one, relative
MESH_CLI_STEPS = 1  # cut from 2 likewise
MESH_TRAIN_UTTS = 128  # prepare speechlike for cli.train --mesh (32 held out)
DP_DEVICES = ("cuda:0", "cuda:0")  # two shards, or two replicas, on the one card
REPLICA_BATCH, REPLICA_CLIENTS = 8, 8
RANK_TIMEOUT = 600


def mesh_batch(vocab_size: int) -> dict:
    """Host batch of MESH_B × 10 s of random PCM whose audio lengths
    (5–10 s) and target lengths (50–200 tokens) are drawn per row, so the
    data ranks' shards hold different token counts."""
    rs = np.random.RandomState(10)
    n = int(SECONDS * SAMPLE_RATE)
    audio = (rs.randn(MESH_B, n) * 2000).astype(np.float32)
    lens = rs.randint(n // 2, n + 1, MESH_B).astype(np.int32)
    tl = rs.randint(DECODE_STEPS // 4, DECODE_STEPS + 1, MESH_B).astype(np.int32)
    targets = rs.randint(4, vocab_size, (MESH_B, DECODE_STEPS)).astype(np.int32)
    for i in range(MESH_B):
        audio[i, lens[i]:] = 0
        targets[i, tl[i] - 1] = EOS_ID
        targets[i, tl[i]:] = 0
    return {"audio": audio, "audio_lengths": lens, "targets": targets, "target_lengths": tl}


def timed_steps(tr, batch) -> float:
    """Median ms of MESH_TIMED_STEPS ``entry.sharded_step``s (host clock
    around a synchronised step)."""
    from phones_las_torch.entry import sharded_step

    times = []
    for _ in range(MESH_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded_step(tr, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def train_kernels():
    from phones_las_torch.decode.fused_greedy import greedy_decode_fused
    from phones_las_torch.frontend.fused_frontend import fused_logmel
    from phones_las_torch.ops.lstm import bidir_recurrence, recurrence, recurrence_bwd, recurrence_residual

    return (fused_logmel, bidir_recurrence, greedy_decode_fused, recurrence, recurrence_residual, recurrence_bwd)


def mesh_rank(job_path: str, rank: int) -> int:
    """One rank of phase 10a: for each layout of the job whose world holds
    this rank, join its gloo group, take its rows of the batch on the
    card, run the sharded step, write rank 0's results (the global loss,
    the whole gradients and the gathered leaves after the update), time
    MESH_TIMED_STEPS more steps and leave the group; one JSON line a
    layout. One process serves every layout, so its start is paid once."""
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from phones_las_torch.entry import sharded_step
    from phones_las_torch.parallel import initialize_distributed, make_mesh
    from phones_las_torch.train.loop import Trainer
    from phones_las_torch.train.state import TrainConfig
    from phones_las_torch.utils.device import set_parity_mode
    from phones_las_torch.utils.param_io import load_artifact, named_leaves

    with open(job_path) as f:
        layouts = json.load(f)
    set_parity_mode()
    params, cfg, _ = load_artifact(os.path.join(ASSETS, "ckpt.npz"), device=DP_DEVICES[0])
    batch = mesh_batch(cfg.speller.vocab_size)
    kernels = train_kernels()
    for job in layouts:
        world = job["data"] * job["model"]
        if rank >= world:
            continue
        t0 = time.perf_counter()
        initialize_distributed(job["init"], world, rank, backend="gloo")
        mesh = make_mesh(job["data"], job["model"], [DP_DEVICES[0]] * world)
        tr = Trainer(cfg, TrainConfig(), mesh=mesh)
        tr.warm_start(params)
        reset_counters(kernels)
        total, grads = sharded_step(tr, batch)
        torch.cuda.synchronize()
        launches = launch_counts(kernels)
        whole = tr.whole_state()
        if rank == 0:
            arrays = {"loss": total.cpu().numpy()}
            arrays.update({"grad" + k: g.cpu().numpy() for k, g in grads.items()})
            arrays.update({"param" + k: t.detach().cpu().numpy() for k, t in named_leaves(whole.params)})
            np.savez(job["out"], **arrays)
        ms = timed_steps(tr, batch)
        print(json.dumps({"layout": job["name"], "rank": rank, "data_index": mesh.data_index,
                          "model_index": mesh.model_index, "rows": len(batch["audio"]) // job["data"],
                          "launches": launches, "ms": ms, "seconds": time.perf_counter() - t0}), flush=True)
        del tr, total, grads, whole
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    return 0


def run_ranks(cmds, started, logs: str, what: str, timeout: float = RANK_TIMEOUT) -> list:
    """Start every rank at once (stdout and stderr to files under
    ``logs``) and wait for all → their stdouts. A rank that fails or
    outlives ``timeout`` fails the phase at once, and the others are
    stopped (they would wait in a collective for it)."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    files = [(os.path.join(logs, f"rank{i}.out"), os.path.join(logs, f"rank{i}.err")) for i in range(len(cmds))]
    procs = []
    for cmd, (out, err) in zip(cmds, files):
        with open(out, "w") as fo, open(err, "w") as fe:
            procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, stdout=fo, stderr=fe, text=True))
    started.extend(procs)
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
        if any(p.poll() not in (None, 0) for p in procs):
            break
        time.sleep(0.2)
    read = lambda path: open(path).read()
    for i, p in enumerate(procs):
        if p.poll() != 0:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait(timeout=60)
            bad = next((j for j, q in enumerate(procs) if q.returncode not in (None, 0, -9)), i)
            fail(f"{what} {bad} exited {procs[bad].returncode} (or timed out): {read(files[bad][1])[-3000:]}")
    return [read(out) for out, _ in files]


def check_mesh_training(ckpt, kernels, work, started, card) -> dict:
    """Phase 10a → the launches of every rank's checked step, summed."""
    from phones_las_torch.entry import sharded_step
    from phones_las_torch.train.loop import Trainer
    from phones_las_torch.train.state import TrainConfig
    from phones_las_torch.utils.param_io import load_artifact, named_leaves

    params, cfg, _ = load_artifact(ckpt, device=None if DEV == "cuda" else DEV)
    tr = Trainer(cfg, TrainConfig(), device=params.cmvn_mean.device)
    tr.warm_start(params)
    batch = mesh_batch(cfg.speller.vocab_size)
    with torch.enable_grad():
        reset_counters(kernels)
        total, grads = sharded_step(tr, batch)
        torch.cuda.synchronize()
        unsharded_launches = launch_counts(kernels)
        ref_loss = float(total)
        ref_grads = {k: g.cpu() for k, g in grads.items()}
        ref_params = {k: t.detach().cpu().clone() for k, t in named_leaves(tr.state.params)}
        unsharded_ms = timed_steps(tr, batch)
    del tr
    torch.cuda.empty_cache()
    n_layers = cfg.listener.num_layers
    summed = {fn.__name__: 0 for fn in kernels}
    jobs = [{"name": f"d{d}m{m}", "data": d, "model": m,
             "init": f"file://{os.path.join(work, f'd{d}m{m}.rendezvous')}",
             "out": os.path.join(work, f"d{d}m{m}.npz")} for d, m in MESH_LAYOUTS]
    job_path = os.path.join(work, "mesh.json")
    with open(job_path, "w") as f:
        json.dump(jobs, f)
    logs = os.path.join(work, "ranks")
    os.makedirs(logs)
    world = max(j["data"] * j["model"] for j in jobs)
    t0 = time.perf_counter()
    outs = run_ranks([[sys.executable, os.path.join(REPO, "chip_smoke.py"), "--mesh-rank", job_path, str(r)]
                      for r in range(world)], started, logs, "phase 10a: rank")
    wall = time.perf_counter() - t0
    lines = [json.loads(ln) for out in outs for ln in out.strip().splitlines() if ln.startswith("{")]
    for job in jobs:
        data_ranks, model_ranks = job["data"], job["model"]
        ranks = [r for r in lines if r["layout"] == job["name"]]
        if len(ranks) != data_ranks * model_ranks:
            fail(f"phase 10a {job['name']}: {len(ranks)} ranks reported, not {data_ranks * model_ranks}")
        with np.load(job["out"]) as z:
            got = {k: z[k] for k in z.files}
        d_loss = abs(float(got["loss"]) - ref_loss)
        grad_rel = {k: rel_err(torch.from_numpy(got["grad" + k]), g) for k, g in ref_grads.items()}
        param_abs = {k: float((torch.from_numpy(got["param" + k]) - t).abs().max()) for k, t in ref_params.items()}
        worst_g, worst_p = max(grad_rel, key=grad_rel.get), max(param_abs, key=param_abs.get)
        rec = {
            "phase": "10a", "mesh": f"data {data_ranks} x model {model_ranks}", "backend": "gloo",
            "shape": f"B={MESH_B} x {SECONDS} s, audio {SECONDS / 2}-{SECONDS} s and targets "
                     f"{DECODE_STEPS // 4}-{DECODE_STEPS} tokens a row, train=False",
            "rows_a_rank": MESH_B // data_ranks, "loss_unsharded": ref_loss, "loss_sharded": float(got["loss"]),
            "loss_abs_diff": d_loss, "loss_tol": MESH_LOSS_TOL, "grad_leaves": len(grad_rel),
            "grad_max_rel_to_max": grad_rel[worst_g], "grad_worst_leaf": worst_g, "grad_tol": MESH_GRAD_TOL,
            "param_max_abs_err": param_abs[worst_p], "param_worst_leaf": worst_p, "param_tol": PARAM_TOL,
            "rank_launches": [r["launches"] for r in ranks], "unsharded_launches": unsharded_launches,
            "ms_a_step_ranks": [r["ms"] for r in ranks], "ms_a_step_unsharded": unsharded_ms,
            "seconds_ranks": [r["seconds"] for r in ranks], "seconds_world_alive": wall, "card": card,
        }
        emit(rec)
        if d_loss > MESH_LOSS_TOL or grad_rel[worst_g] > MESH_GRAD_TOL or param_abs[worst_p] > PARAM_TOL:
            fail(f"the sharded step disagrees with the unsharded one: {rec}")
        for r in ranks:
            la = r["launches"]
            if DEV == "cuda" and (la["fused_logmel"], la["recurrence_residual"], la["recurrence_bwd"],
                                  la["bidir_recurrence"]) != (1, n_layers, n_layers, 0):
                fail(f"rank {r['rank']} did not launch the front-end once and the residual and VJP once a layer: {rec}")
            for k, v in la.items():
                summed[k] += v
    return summed


def write_source_workdir(ckpt, data_dir: str, source: str, cap: int) -> None:
    """The committed checkpoint as a training workdir (step 0), decoding
    with the eval set's cap, as phase 8a writes it."""
    from phones_las_torch.cli.common import resolve_preset
    from phones_las_torch.train.checkpoint import CheckpointManager
    from phones_las_torch.train.loop import Trainer
    from phones_las_torch.utils.param_io import load_artifact

    preset, *_ = resolve_preset(WORKDIR_PRESET, data_dir, None)
    device = None if DEV == "cuda" else DEV
    tr = Trainer(preset.model, preset.train, device=device)
    tr.warm_start(load_artifact(ckpt, device=device)[0])
    CheckpointManager(source).save(0, tr.state, force=True)
    with open(os.path.join(source, "config.json"), "w") as f:
        json.dump({"preset": WORKDIR_PRESET, "data": data_dir, "overrides": {"max_target_len": cap},
                   "precision": None}, f)


def check_nccl_world(ckpt, kernels, work, data_dir, source, card):
    """Phase 10b → (the launches of the mesh trainer's steps, the
    ``cli.train --mesh`` run's workdir)."""
    import torch.distributed as dist

    from phones_las_torch.parallel import initialize_distributed, make_mesh
    from phones_las_torch.train.checkpoint import CheckpointManager
    from phones_las_torch.train.loop import Trainer
    from phones_las_torch.train.state import TrainConfig
    from phones_las_torch.utils.param_io import load_artifact, named_leaves

    initialize_distributed(f"file://{os.path.join(work, 'nccl.rendezvous')}", 1, 0, backend="nccl")
    try:
        backend = dist.get_backend()
        mesh = make_mesh(1, 1, DP_DEVICES[:1])
        params, cfg, _ = load_artifact(ckpt, device=mesh.device)
        batch = mesh_batch(cfg.speller.vocab_size)
        plain, meshed = Trainer(cfg, TrainConfig(), device=mesh.device), Trainer(cfg, TrainConfig(), mesh=mesh)
        plain.warm_start(params)
        meshed.warm_start(params)
        del params
        losses = {"plain": [], "mesh": []}
        with torch.enable_grad():
            for i in range(NCCL_STEPS):
                losses["plain"].append(float(plain.train_step(batch)["loss"]))
                if i == NCCL_STEPS - 1:
                    reset_counters(kernels)
                losses["mesh"].append(float(meshed.train_step(batch)["loss"]))
        torch.cuda.synchronize()
        launches = launch_counts(kernels)
        whole = dict(named_leaves(meshed.whole_state().params))
        leaf_rel = max(rel_err(whole[k].detach(), t.detach()) for k, t in named_leaves(plain.state.params))
        bitwise = all(torch.equal(whole[k], t) for k, t in named_leaves(plain.state.params))
        del plain, meshed, whole
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["mesh"], losses["plain"]))
    run = os.path.join(work, "run")
    t0 = time.perf_counter()
    out = cli("train", "--preset", WORKDIR_PRESET, "--data", data_dir, "--workdir", run, "--num-steps",
              str(MESH_CLI_STEPS), "--batch-size", str(TRAIN_B), "--buckets", *map(str, DATA_BUCKETS),
              "--max-target-len", str(DATA_MAX_TARGET), "--init-checkpoint", source, "--mesh").stdout
    cli_s = time.perf_counter() - t0
    train_lines = [line for line in out.splitlines() if line.startswith("{'tag': 'train'")]
    rec = {
        "phase": "10b", "backend": backend, "world": 1, "steps": NCCL_STEPS, "losses": losses,
        "loss_max_rel_diff": loss_rel, "leaf_max_rel_to_max": leaf_rel, "bitwise_equal": bitwise,
        "tol": NCCL_TOL, "launches_last_step": launches,
        "cli_train_mesh": {"steps": MESH_CLI_STEPS, "mesh_1x1": "mesh=1x1" in out, "train_log": train_lines[-1:],
                           "checkpoints": CheckpointManager(run).all_steps(),
                           "final_eval": "final eval:" in out, "seconds": cli_s},
        "card": card,
    }
    emit(rec)
    if backend != "nccl" or loss_rel > NCCL_TOL or leaf_rel > NCCL_TOL:
        fail(f"the NCCL world-1 mesh trainer is not the plain trainer: {rec}")
    n_layers = cfg.listener.num_layers
    if DEV == "cuda" and (launches["fused_logmel"], launches["recurrence_residual"],
                          launches["recurrence_bwd"]) != (1, n_layers, n_layers):
        fail(f"the mesh trainer's step did not launch the front-end once and the residual and VJP once a layer: {rec}")
    c = rec["cli_train_mesh"]
    if not (c["mesh_1x1"] and train_lines and c["checkpoints"][-1:] == [MESH_CLI_STEPS] and c["final_eval"]):
        fail(f"cli.train --mesh did not train {MESH_CLI_STEPS} steps and evaluate: {rec}")
    return launches, run


def rows_differing(a, b) -> list:
    return [i for i, (x, y) in enumerate(zip(a, b)) if x != y]


def check_dp_serving(source, data, kernels, card) -> dict:
    """Phase 10c → the launches of the greedy data-parallel eval-set call."""
    from phones_las_torch.api import Transcriber

    device = None if DEV == "cuda" else DEV
    utts = [np.asarray(data["audio"][i, : data["lengths"][i]], np.int16) for i in range(len(data["lengths"]))]
    refs = [[int(x) for x in r if x >= 0] for r in data["refs"]]
    rec = {"phase": "10c", "shards": list(DP_DEVICES), "utterances": len(utts)}
    n_layers = None
    launches = None
    for beam in (0, BEAM_K):
        one = Transcriber(source, beam_width=beam, device=device)
        two = Transcriber(source, beam_width=beam, data_parallel=len(DP_DEVICES), devices=DP_DEVICES)
        n_layers = one.model_cfg.listener.num_layers
        want = one.transcribe_batch(utts)
        reset_counters(kernels)
        got = two.transcribe_batch(utts)
        torch.cuda.synchronize()
        la = launch_counts(kernels)
        ids = [one.vocab.encode(t) for t in got]
        lens = np.asarray([len(t) for t in ids])
        toks = np.zeros((len(ids), max(1, lens.max())), np.int32)
        for i, t in enumerate(ids):
            toks[i, : len(t)] = t
        per = eval_per(toks, lens, data)
        name = "greedy" if beam == 0 else f"beam{beam}"
        rec[name] = {"rows_differing": rows_differing(got, want), "per": per, "launches": la}
        if beam == 0:
            launches = la
    # the flagship shape: 64 × 10 s, 200 greedy steps, the two in turns
    audio = list(make_audio(FLAGSHIP_B))
    one = Transcriber(source, beam_width=0, device=device)
    two = Transcriber(source, beam_width=0, data_parallel=len(DP_DEVICES), devices=DP_DEVICES)
    one.max_steps = two.max_steps = DECODE_STEPS
    times = {"data_parallel=1": [], "data_parallel=2": []}
    outs = {}
    for r, name in in_turns(list(times), 2):
        t = one if name == "data_parallel=1" else two
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[name] = t.transcribe_batch(audio)
        torch.cuda.synchronize()
        if r:
            times[name].append((time.perf_counter() - t0) * 1e3)
    rec["flagship"] = {
        "shape": f"B={FLAGSHIP_B} x {SECONDS} s, {DECODE_STEPS} greedy steps",
        "rows_differing": rows_differing(outs["data_parallel=2"], outs["data_parallel=1"]),
        "ms_in_turns": times,
    }
    rec["card"] = card
    emit(rec)
    for name in ("greedy", f"beam{BEAM_K}"):
        r = rec[name]
        if r["rows_differing"] or abs(r["per"] - (REF_GREEDY_PER if name == "greedy" else REF_BEAM8_PER)) > PER_TOL:
            fail(f"data-parallel {name} is not single-device {name}, or its PER is off: {rec}")
    if rec["flagship"]["rows_differing"]:
        fail(f"data-parallel decoding at the flagship shape is not single-device decoding: {rec}")
    shards = len(DP_DEVICES)
    if DEV == "cuda" and (launches["fused_logmel"], launches["bidir_recurrence"], launches["greedy_decode_fused"]) != (
            shards, n_layers * shards, shards):
        fail(f"each shard did not launch the serving kernels once (the BiLSTM once a layer): {rec}")
    return launches


def check_replica_serving(source, run, data_dir, data, kernels, card, started) -> dict:
    """Phase 10d → the launches of the replicated server's run."""
    import threading

    from phones_las_torch.api import Transcriber
    from phones_las_torch.cli.serve import make_server

    device = None if DEV == "cuda" else DEV
    utts = [np.asarray(data["audio"][i, : data["lengths"][i]], np.int16) for i in range(len(data["lengths"]))]
    test = os.path.join(data_dir, "test.plu")
    infer_procs = {
        "infer": cli("infer", "--workdir", run, "--data", test, "--beam-width", "0", started=started),
        "infer --mesh": cli("infer", "--workdir", run, "--data", test, "--beam-width", "0", "--mesh", "--devices",
                            ",".join(DP_DEVICES), started=started),
    }
    base = Transcriber(source, beam_width=0, device=device)
    reps = base.replicate(len(DP_DEVICES), devices=DP_DEVICES)
    # the library in the server's shapes: micro-batches of REPLICA_BATCH rows
    want = []
    for i in range(0, len(utts), REPLICA_BATCH):
        want += base.transcribe_batch(utts[i: i + REPLICA_BATCH])
    for r in reps:  # as cli.serve warms each replica
        r.transcribe_batch([np.zeros(SAMPLE_RATE, np.int16)] * REPLICA_BATCH)
    server, worker = make_server(reps, "127.0.0.1", 0, max_batch=REPLICA_BATCH, batch_wait_ms=5.0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}/transcribe?raw=1"
    got = [None] * len(utts)
    try:
        def client(c):
            for i in range(c, len(utts), REPLICA_CLIENTS):
                code, body = http_post(url, utts[i].tobytes())
                got[i] = json.loads(body)["tokens"] if code == 200 else f"HTTP {code}: {body[:200]!r}"

        reset_counters(kernels)
        threads = [threading.Thread(target=client, args=(c,)) for c in range(REPLICA_CLIENTS)]
        t0 = time.perf_counter()
        [th.start() for th in threads]
        [th.join(timeout=300) for th in threads]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts(kernels)
        pending = worker.q.qsize()
        alive = sum(th.is_alive() for th in threads)
    finally:
        worker.stop()
        server.shutdown()
        server.server_close()
    outs = {name: finish(p, name) for name, p in infer_procs.items()}
    lines = {name: [ln for ln in out.splitlines() if ln.strip()] for name, out in outs.items()}
    batches = sum(worker.served)
    rec = {
        "phase": "10d", "replicas": list(DP_DEVICES), "requests": len(utts), "clients": REPLICA_CLIENTS,
        "max_batch": REPLICA_BATCH, "batches_a_replica": list(worker.served), "pending_at_stop": pending,
        "client_threads_alive": alive, "rows_differing_from_library": rows_differing(got, want),
        "req_per_s": len(utts) / wall, "launches": launches,
        "cli_infer_mesh": {"lines": len(lines["infer --mesh"]), "equal": lines["infer --mesh"] == lines["infer"],
                           "footer": lines["infer"][-1:]},
        "card": card,
    }
    emit(rec)
    if rec["rows_differing_from_library"] or pending or alive or not all(worker.served):
        fail(f"replica serving: tokens differ from the library, a drainer served nothing, or requests are left: {rec}")
    n_layers = base.model_cfg.listener.num_layers
    if DEV == "cuda" and (launches["fused_logmel"], launches["bidir_recurrence"], launches["greedy_decode_fused"]) != (
            batches, n_layers * batches, batches):
        fail(f"the replicas' kernel launches do not follow their batches: {rec}")
    if not rec["cli_infer_mesh"]["equal"] or not lines["infer"] or not lines["infer"][-1].startswith("# "):
        fail(f"cli.infer --mesh does not print cli.infer's lines: {rec}")
    return launches


def check_multi_device(ckpt, data, kernels) -> dict:
    """Phase 10, in a temporary directory under ``_runs/`` removed at the
    end; every process it starts is stopped → its launches, summed over
    the runs it counts (10a's ranks, 10b's mesh step, 10c's greedy call,
    10d's server)."""
    import shutil
    import tempfile

    card = card_line()
    os.makedirs(os.path.join(REPO, "_runs"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_", dir=os.path.join(REPO, "_runs"))
    started = []
    try:
        data_dir, source = os.path.join(work, "data"), os.path.join(work, "source")
        # the records of 10b, prepared on the host while 10a's ranks run
        prep = cli("prepare", "speechlike", "--out", data_dir, "--n-utts", str(MESH_TRAIN_UTTS), "--seed",
                   str(DATA_TRAIN_SEED), started=started)
        launches = [check_mesh_training(ckpt, kernels, work, started, card)]
        finish(prep, "prepare")
        write_source_workdir(ckpt, data_dir, source, int(data["decode_cap"][0]))
        la, run = check_nccl_world(ckpt, kernels, work, data_dir, source, card)
        launches.append(la)
        launches.append(check_dp_serving(source, data, kernels, card))
        launches.append(check_replica_serving(source, run, data_dir, data, kernels, card, started))
    finally:
        for p in started:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        shutil.rmtree(work, ignore_errors=True)
    return {k: sum(la.get(k, 0) for la in launches) for k in launches[0]}


# ---- phase 11: degenerate inputs and pad content through every serving and training kernel

DEGEN_SAMPLES = (0, 1, 100, 400, 16000, 32000)  # the row of 0 samples is a pad row
DEGEN_TARGETS = (0, 1, 2, 3, 20, 40)  # target lengths, <eos> counted; 0: the pad row
DEGEN_STEPS = 48  # the decode cap
SCRIBBLE_AMPLITUDE = 30000.0  # tests/test_masking_invariance.py's scribble over pad audio
SCRIBBLE_TOKEN = 9  # and over pad targets
TIE_MARGIN = 1e-5  # a top-2 margin below this at a differing step is a tie, not a fault
PAD_MEMORY_TOL = 1e-6  # the encoder output at valid frames, scribbled against clean
# phase 11b in production mode: the card's GEMMs run TF32 and the CPU's do
# not; operands rounded to TF32 on the CPU move this batch's loss by
# 2.5e-5–3.8e-5 relative, so the loss is held to 1e-4 there (LOSS_TOL in parity)
PROD_LOSS_TOL = 1e-4


def degenerate_batch(vocab_size: int, scribbled: bool = False) -> dict:
    """B = 6 rows of 0, 1, 100, 400, 16000 and 32000 samples of integral
    random PCM (so int16 carries them exactly), targets of 0 (the pad row),
    1 (<eos> alone), 2, 3, 20 and 40; ``scribbled`` writes random audio at
    amplitude 30000 past each row's length and token 9 past each target."""
    rs = np.random.RandomState(11)
    b, s, st = len(DEGEN_SAMPLES), max(DEGEN_SAMPLES), max(DEGEN_TARGETS)
    audio = np.zeros((b, s), np.float32)
    targets = np.zeros((b, st), np.int32)
    for i, (n, t) in enumerate(zip(DEGEN_SAMPLES, DEGEN_TARGETS)):
        audio[i, :n] = np.clip(np.rint(rs.randn(n) * 3000), -32768, 32767)
        if t:
            targets[i, : t - 1] = rs.randint(4, vocab_size, t - 1)
            targets[i, t - 1] = EOS_ID
    if scribbled:
        rs = np.random.RandomState(12)
        for i, (n, t) in enumerate(zip(DEGEN_SAMPLES, DEGEN_TARGETS)):
            audio[i, n:] = rs.randn(s - n) * SCRIBBLE_AMPLITUDE
            targets[i, t:] = SCRIBBLE_TOKEN
    return {"audio": audio, "audio_lengths": np.asarray(DEGEN_SAMPLES, np.int32), "targets": targets,
            "target_lengths": np.asarray(DEGEN_TARGETS, np.int32)}


def rows_against(got, want, margin_at) -> list:
    """Rows whose tokens differ → [{row, first_step, margin, tie}], the
    margin being ``margin_at(row, step)`` on the reference side."""
    out = []
    for i in range(len(want)):
        diff = np.nonzero(got[i] != want[i])[0]
        if len(diff):
            margin = margin_at(i, int(diff[0]))
            out.append({"row": i, "first_step": int(diff[0]), "margin": margin, "tie": margin < TIE_MARGIN})
    return out


def transcriber_outcomes(t, batches) -> list:
    """Each request's tokens, or the kind of error it raised."""
    out = []
    for batch in batches:
        try:
            out.append(t.transcribe_batch(batch))
        except (ValueError, RuntimeError) as e:  # a refusal, or a kernel's error: its kind is compared
            out.append(type(e).__name__)
    return out


def check_degenerate_serving(params, params_cpu, cfg, kernels, card) -> dict:
    """Phase 11a → the launches of the card's serving runs: the degenerate
    batch through encode + greedy_decode / beam_decode in parity and in
    production mode, card against the CPU plain path, clean against
    scribbled, a row with no valid encoder position through the decoder
    kernel, and ``phones_las_torch.Transcriber`` on the card against the
    CPU on the batch, its shortest rows alone and an empty request."""
    import shutil
    import tempfile

    from phones_las_torch import Transcriber
    from phones_las_torch.data.vocab import Vocab
    from phones_las_torch.decode import beam_decode, greedy_decode
    from phones_las_torch.models import encode, teacher_forced_decode
    from phones_las_torch.ops.lstm import resolve_rnn_precision
    from phones_las_torch.utils.device import matmul_precision_scope
    from phones_las_torch.utils.param_io import save_params_npz

    v = cfg.speller.vocab_size
    clean, scribbled = degenerate_batch(v), degenerate_batch(v, scribbled=True)
    rec = {"phase": "11a", "samples": list(DEGEN_SAMPLES), "decode_cap": DEGEN_STEPS, "beam_width": BEAM_K}
    bad, launches = [], []
    for mode, c in (("parity", cfg), ("production", production_cfg(cfg))):
        prec = resolve_rnn_precision(c.matmul_precision)

        def run(p, device, batch, mem_mask=None):
            with matmul_precision_scope(c.matmul_precision):
                if mem_mask is None:
                    audio = torch.from_numpy(batch["audio"]).to(device)
                    lens = torch.from_numpy(batch["audio_lengths"]).to(device)
                    mem, el, mask = encode(p, c, audio, lens, prec=prec)
                else:
                    (mem, mask), el = (t.to(device) for t in mem_mask), None
                tok, tl, _ = greedy_decode(p.speller, c.speller, mem, mask, DEGEN_STEPS, prec=prec)
                beam = beam_decode(p.speller, c.speller, mem, mask, DEGEN_STEPS, beam_width=BEAM_K, prec=prec)
            return {"mem": mem, "el": el, "mask": mask, "tok": tok.cpu().numpy(), "tl": tl.cpu().numpy(),
                    "beam": beam.tokens.cpu().numpy(), "scores": beam.beam_scores.cpu(),
                    "finite": bool(torch.isfinite(mem).all() and torch.isfinite(beam.beam_logp).all())}

        def against_cpu(g, cpu):
            logits = []  # the CPU loop's, computed once a row differs

            def top2(i, s):
                if not logits:  # the loop's own steps: fed its own tokens, <sos> first
                    tok = torch.from_numpy(cpu["tok"]).long()
                    fed = torch.cat([torch.full_like(tok[:, :1], c.speller.bos_id), tok[:, :-1]], dim=1)
                    logits.append(teacher_forced_decode(params_cpu.speller, c.speller, fed, cpu["mem"],
                                                        cpu["mask"], prec=prec)[0])
                return float(logits[0][i, s].topk(2).values.diff().abs())

            beam_gap = lambda i, s: float((cpu["scores"][i, 0] - cpu["scores"][i, 1]).abs())
            return rows_against(g["tok"], cpu["tok"], top2), rows_against(g["beam"], cpu["beam"], beam_gap)

        reset_counters(kernels)
        g = run(params, DEV, clean)
        torch.cuda.synchronize()
        la = launch_counts(kernels)
        gs = run(params, DEV, scribbled)
        cpu = run(params_cpu, "cpu", clean)
        greedy_rows, beam_rows = against_cpu(g, cpu)
        valid = g["mask"] > 0
        mem_dev = float((g["mem"] - gs["mem"]).abs()[valid].max())
        # a row with no valid encoder position: row 0 masked whole, its
        # memory zero as the listener leaves every frame past a length
        mem0, mask0 = g["mem"].clone(), g["mask"].clone()
        mem0[0], mask0[0] = 0.0, 0.0
        reset_counters(kernels)
        g0 = run(params, DEV, None, (mem0, mask0))
        la0 = launch_counts(kernels)
        c0 = run(params_cpu, "cpu", None, (mem0, mask0))
        empty_rows, empty_beam_rows = against_cpu(g0, c0)
        launches += [la, la0]
        rec[mode] = {
            "enc_lengths": g["el"].tolist(), "greedy_lengths": g["tl"].tolist(),
            "greedy_rows_differing_from_cpu": greedy_rows, "beam_rows_differing_from_cpu": beam_rows,
            "scribbled": {"tokens_equal": bool((g["tok"] == gs["tok"]).all()),
                          "beam_tokens_equal": bool((g["beam"] == gs["beam"]).all()),
                          "enc_lengths_equal": bool(torch.equal(g["el"], gs["el"])),
                          "memory_max_abs_diff_at_valid_frames": mem_dev},
            "empty_encoder_row": {"greedy_rows_differing_from_cpu": empty_rows,
                                  "beam_rows_differing_from_cpu": empty_beam_rows,
                                  "greedy_lengths": g0["tl"].tolist(), "launches": la0},
            "finite": g["finite"] and gs["finite"] and g0["finite"], "launches": la,
        }
        faults = [r for r in greedy_rows + beam_rows + empty_rows + empty_beam_rows if not r["tie"]]
        allowed = 0 if mode == "parity" else MAX_DIFF_ROWS
        sc = rec[mode]["scribbled"]
        if (len(faults) > allowed or not rec[mode]["finite"] or not (sc["tokens_equal"] and sc["beam_tokens_equal"])
                or not sc["enc_lengths_equal"] or mem_dev > PAD_MEMORY_TOL):
            bad.append(mode)
        if DEV == "cuda" and not (la["fused_logmel"] == 1 and la["bidir_recurrence"] == cfg.listener.num_layers
                                  and la["greedy_decode_fused"] == 1 and la0["greedy_decode_fused"] == 1
                                  and not any(la[k] for k in ("recurrence", "recurrence_residual", "recurrence_bwd"))):
            bad.append(f"{mode} launches")

    # the top-level Transcriber on the card and on the CPU, parity mode
    os.makedirs(os.path.join(REPO, "_runs"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_degenerate_", dir=os.path.join(REPO, "_runs"))
    try:
        art = os.path.join(work, "ckpt_vocab.npz")
        vocab = Vocab([f"p{i}" for i in range(v - 4)])
        save_params_npz(art, params_cpu, cfg, extras={"vocab": vocab.tokens, "buckets": [max(DEGEN_SAMPLES)],
                                                      "max_target_len": DEGEN_STEPS})
        rows = [clean["audio"][i, :n].astype(np.int16) for i, n in enumerate(DEGEN_SAMPLES)]
        requests = [rows, rows[:1], rows[1:2], []]
        reset_counters(kernels)
        on_card = transcriber_outcomes(Transcriber.from_artifact(art, device=None if DEV == "cuda" else DEV), requests)
        la_t = launch_counts(kernels)
        on_cpu = transcriber_outcomes(Transcriber.from_artifact(art, device="cpu"), requests)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches.append(la_t)
    rec["transcriber"] = {
        "requests": ["the batch", "0 samples alone", "1 sample alone", "empty"],
        "card": [o if isinstance(o, str) else [len(t) for t in o] for o in on_card],
        "equal_to_cpu": [a == b for a, b in zip(on_card, on_cpu)], "launches": la_t,
    }
    # the reference takes every row, a 0-sample one too, and refuses an
    # empty request with ValueError (tests/test_torch_edge_cases.py)
    if on_card != on_cpu or on_card[-1] != "ValueError" or any(isinstance(o, str) for o in on_card[:-1]):
        bad.append("transcriber")
    rec["card"] = card
    emit(rec)
    if bad:
        fail(f"phase 11a: degenerate serving failed in {bad}: {rec}")
    return {k: sum(la[k] for la in launches) for k in launches[0]}


def check_degenerate_training(ckpt, kernels, card) -> dict:
    """Phase 11b → the launches of the card's steps: one
    ``Trainer.train_step`` per numerics mode on the degenerate batch
    (dropout and scheduled sampling off) on the card, clean and scribbled,
    and on the CPU plain path, the gradients read as the step applies them."""
    from phones_las_torch.train import TrainConfig, Trainer
    from phones_las_torch.utils.param_io import load_artifact

    device = None if DEV == "cuda" else DEV
    params, cfg, _ = load_artifact(ckpt, device=device)
    params_cpu, _, _ = load_artifact(ckpt, device="cpu")
    cfg = dataclasses.replace(cfg, listener=dataclasses.replace(cfg.listener, dropout=0.0),
                              speller=dataclasses.replace(cfg.speller, sampling_probability=0.0))
    v = cfg.speller.vocab_size
    batches = {"clean": degenerate_batch(v), "scribbled": degenerate_batch(v, scribbled=True)}
    n_layers = cfg.listener.num_layers
    rec = {"phase": "11b", "samples": list(DEGEN_SAMPLES), "targets": list(DEGEN_TARGETS)}
    bad, launches = [], []
    for mode, c in (("parity", cfg), ("production", production_cfg(cfg))):
        runs = {}
        for name, dev, p, which in (("card", device, params, "clean"), ("card_scribbled", device, params, "scribbled"),
                                    ("cpu", "cpu", params_cpu, "clean")):
            tr = Trainer(c, TrainConfig(), device=dev)
            tr.warm_start(p)
            grads = {}
            apply = tr.apply_gradients

            def capture(g=None, tr=tr, apply=apply, grads=grads):
                g = tr.gradients() if g is None else g
                grads.update({k: t.detach().cpu().clone() for k, t in g.items()})
                return apply(g)

            tr.apply_gradients = capture
            if name == "card":
                reset_counters(kernels)
            out = tr.train_step(batches[which])
            loss = float(out["loss"])
            if name == "card":
                torch.cuda.synchronize()
                launches.append(launch_counts(kernels))
            runs[name] = (loss, grads)
        (gl, gg), (sl, sg), (cl, cg) = runs["card"], runs["card_scribbled"], runs["cpu"]
        grad_rel = {k: rel_err(gg[k], cg[k]) for k in cg}
        worst = max(grad_rel, key=grad_rel.get)
        bits = [k for k in gg if not torch.equal(gg[k], sg[k])]
        finite = all(np.isfinite([gl, sl, cl])) and all(bool(torch.isfinite(t).all()) for t in gg.values())
        parity = mode == "parity"
        rec[mode] = {
            "loss_card": gl, "loss_cpu": cl, "loss_rel_err": abs(gl - cl) / abs(cl),
            "loss_tol": LOSS_TOL if parity else PROD_LOSS_TOL,
            "grad_max_rel_to_max": grad_rel[worst], "grad_worst_leaf": worst,
            "grad_tol": GRAD_TOL if parity else "not held: TF32 on the card only",
            "scribbled_loss_bit_equal": gl == sl, "scribbled_grad_leaves_not_bit_equal": bits,
            "scribbled_grad_max_abs_diff": max(float((gg[k] - sg[k]).abs().max()) for k in gg),
            "finite": finite, "launches": launches[-1],
        }
        la = launches[-1]
        ok = (finite and rec[mode]["loss_rel_err"] <= rec[mode]["loss_tol"] and gl == sl and set(gg) == set(cg)
              and (not parity or (grad_rel[worst] <= GRAD_TOL and not bits)))
        if not ok:
            bad.append(mode)
        if DEV == "cuda" and (la["recurrence_residual"], la["recurrence_bwd"], la["fused_logmel"]) != (n_layers, n_layers, 1):
            bad.append(f"{mode} launches")
    rec["card"] = card
    emit(rec)
    if bad:
        fail(f"phase 11b: degenerate training failed in {bad}: {rec}")
    return {k: sum(la[k] for la in launches) for k in launches[0]}


# ---- phase 12: the reference's five presets at their own widths

PRESET_NAMES = ("timit_phone_las", "timit_multitask", "librispeech_char_las", "common_voice_binf",
                "librispeech_offline_infer")
# the vocabularies of the published configurations (phones_las_tpu/utils/config.py)
PRESET_VOCAB = {"timit_phone_las": 65, "timit_multitask": 65, "librispeech_char_las": 34,
                "common_voice_binf": 120, "librispeech_offline_infer": 34}
PRESET_GRAPHEME_VOCAB = 32  # timit_multitask's grapheme head
PRESET_SEED = 12  # the random init of every preset
# 12a: (preset, head, B, samples a row, decode steps, ragged lengths); the
# checkpoint's shape (B = 64 × 10 s, 200 steps) is phase 1's
PRESET_DECODES = (
    ("timit_phone_las", "phone", 32, 128000, 80, True),
    ("timit_multitask", "grapheme", 32, 128000, 120, True),
    ("common_voice_binf", "phone", 32, 280000, 200, True),
    ("librispeech_offline_infer", "phone", 256, 280000, 300, False),
)
# 12a: widths no 8-way cut takes (units, attention layer) → the cluster size
# they get, at TIMIT's vocabulary: B = 13, T_enc = 37, 40 steps, ragged
SMALL_CLUSTERS = ((48, 48, 4), (40, 40, 2), (36, 40, 1))
PRESET_ROWS = 8  # 12b: rows of the preset's longest bucket through the Transcriber
LUONG_CAP = 60  # 12b: the Luong check's decode cap (a random init runs to it), as 13b's WIDTH_CAP
LUONG_SAMPLES = 64000  # 12b: the Luong check's rows, <= 4 s
# 12b: the one preset whose production beam-8 is also decoded on the CPU, a
# reading (the bench's configuration); the others' runs on the card alone
PRESET_BEAM_READING = "librispeech_char_las"
PRESET_TRAINED = ("timit_phone_las", "timit_multitask", "common_voice_binf")  # 12c
PRESET_OWN_SHAPE = "common_voice_binf"  # 12c: the one preset also stepped at its own B = 32 (a reading)
PRESET_TRAIN_B = 4  # 12c: rows held against the CPU plain path
PRESET_TRAIN_SAMPLES = 32000  # their longest row
PRESET_TRAIN_TARGET = 30  # their longest target, <eos> counted
PRESET_LOSS_TOL = 1e-6  # parity: the loss and each auxiliary term, relative
PRESET_GRAD_TOL = 1e-5  # parity: the worst gradient leaf, of its largest magnitude
FRONT12_UTTS = 128  # 12d: prepare speechlike --graphemes, training utterances (32 held out)
FRONT12_STEPS = 4


def preset_tokens(name: str):
    """The phone tokens (and grapheme tokens) of a prepared data dir of the
    preset at its published vocabulary size (four specials added): the 61
    TIMIT phones, the LibriSpeech characters and two more, 116 IPA phones
    of ``data/ipa.py``'s inventory (each with its binf code)."""
    from phones_las_torch.data import ipa
    from phones_las_torch.data.timit import _GRAPHEMES

    n = PRESET_VOCAB[name] - 4
    if name.startswith("timit"):
        phones = list(ipa.ARPABET_TO_IPA)
    elif name == "common_voice_binf":
        phones = list(ipa._CONSONANTS) + list(ipa._AFFRICATES) + list(ipa._VOWELS) + list(ipa._DIPHTHONGS)
    else:
        phones = _GRAPHEMES + ["-", "."]
    return phones[:n], (_GRAPHEMES if name == "timit_multitask" else None)


def preset_model(name: str, work: str, device, seed: int = PRESET_SEED, **overrides):
    """The preset bound to a data dir of its own vocabulary (written under
    ``work``) through ``resolve_preset`` with the flags' ``overrides``,
    random params from ``seed`` on ``device`` → (preset, data dir, params,
    vocab, grapheme vocab, binf codes)."""
    from phones_las_torch.cli.common import resolve_preset
    from phones_las_torch.data.vocab import Vocab
    from phones_las_torch.models import init_las

    data_dir = os.path.join(work, f"data_{name}")
    if not os.path.isdir(data_dir):
        os.makedirs(data_dir)
        phones, graphemes = preset_tokens(name)
        Vocab(phones).save(os.path.join(data_dir, "vocab.txt"))
        if graphemes is not None:
            Vocab(graphemes).save(os.path.join(data_dir, "grapheme_vocab.txt"))
    preset, vocab, gvocab, _, codes = resolve_preset(name, data_dir, overrides or None)
    m = preset.model
    if m.speller.vocab_size != PRESET_VOCAB[name] or (
        m.grapheme_speller is not None and m.grapheme_speller.vocab_size != PRESET_GRAPHEME_VOCAB
    ):
        fail(f"phase 12: the {name} data dir does not give the published vocabulary sizes: {m}")
    return preset, data_dir, init_las(m, seed, codes, device=device), vocab, gvocab, codes


def write_preset_artifact(path: str, name: str, mode: str) -> None:
    """12b's artifact of a preset in a mode: its random init (PRESET_SEED)
    with its vocabulary, buckets and target cap."""
    from phones_las_torch.utils.param_io import save_params_npz

    preset, _, params, vocab, _, _ = preset_model(name, os.path.dirname(path), "cpu")
    cfg, pl = preset.model, preset.pipeline
    save_params_npz(path, params, cfg if mode == "parity" else production_cfg(cfg),
                    extras={"preset": name, "vocab": vocab.tokens, "buckets": list(pl.buckets),
                            "max_target_len": pl.max_target_len})


class Prewritten:
    """The random-init artifacts that phases 12b and 13b serve, written
    ahead by one thread beside earlier phases: ``np.savez_compressed`` of
    30–150 M random parameters takes 5–30 s a file on the host's CPU, which
    those phases leave mostly idle. ``ahead(key, write)`` queues
    ``write(path)``; ``get(key, write)`` waits for it (or, not queued,
    writes now) → the path. ``close`` waits for the thread and removes the
    files (a directory under ``_runs/``)."""

    def __init__(self):
        import tempfile
        from concurrent.futures import ThreadPoolExecutor

        os.makedirs(os.path.join(REPO, "_runs"), exist_ok=True)
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_artifacts_", dir=os.path.join(REPO, "_runs"))
        self.pool = ThreadPoolExecutor(max_workers=1)
        self.futures = {}

    def path(self, key: str) -> str:
        return os.path.join(self.dir, f"{key}.npz")

    def ahead(self, key: str, write) -> None:
        self.futures[key] = self.pool.submit(write, self.path(key))

    def get(self, key: str, write) -> str:
        fut = self.futures.pop(key, None)
        if fut is None:
            write(self.path(key))
        else:
            fut.result()
        return self.path(key)

    def close(self) -> None:
        import shutil

        self.pool.shutdown(wait=True, cancel_futures=True)
        for fut in self.futures.values():  # a write's failure, unless a phase failed first
            if fut.done() and not fut.cancelled() and fut.exception() is not None:
                print(f"chip_smoke: an artifact written ahead failed: {fut.exception()!r}", file=sys.stderr)
        shutil.rmtree(self.dir, ignore_errors=True)

    def queue_served(self) -> None:
        """Every artifact of 12b and 13b, in the order they are served."""
        for name in PRESET_NAMES:
            for mode in ("parity", "production"):
                self.ahead(f"preset_{name}_{mode}", lambda path, name=name, mode=mode: write_preset_artifact(
                    path, name, mode))
        for name in WIDTH_FLAGS:
            for mode in ("parity", "production"):
                self.ahead(f"width_{name}_{mode}", lambda path, name=name, mode=mode: write_width_artifact(
                    path, name, mode))
        for name in ("checkpoint", "W2048"):  # 13d
            self.ahead(f"width_{name}_parity", lambda path, name=name: write_width_artifact(path, name, "parity"))


def preset_pcm(b: int, n: int, seed: int, ragged: bool):
    """B rows of integral random PCM of up to ``n`` samples (int16 carries
    them exactly) → (audio [B, n] float32, lengths [B] int32); ragged rows
    take 1/4 to all of ``n`` (row 0 all of it), the others all of it."""
    rs = np.random.RandomState(seed)
    audio = np.clip(np.rint(rs.randn(b, n) * 2000), -32768, 32767).astype(np.float32)
    lens = rs.randint(n // 4, n + 1, b).astype(np.int32) if ragged else np.full(b, n, np.int32)
    lens[0] = n
    audio[np.arange(n)[None, :] >= lens[:, None]] = 0.0
    return audio, lens


def forced_tie(sp, sc, memory, mask, b, steps, tok, cluster):
    """Two equal columns of out_w (and out_b) in different blocks' slices:
    the most emitted real token's column copied one slice earlier and one
    slice later; the kernel's tokens against the plain version's, and the
    tie seen to go to the smaller index (the larger never emitted)."""
    import copy

    from phones_las_torch.decode.fused_greedy import _pad4, greedy_decode_fused

    v = sc.vocab_size
    vc = _pad4(-(-v // cluster))
    counts = np.bincount(tok.cpu().numpy().ravel(), minlength=v)
    counts[:4] = 0  # the specials
    if not counts.any():
        fail("phase 12a: the TIMIT shape emitted no real token to force a tie on")
    j = int(counts.argmax())
    out = []
    for k in (j - vc, j + vc):
        if not 4 <= k < v:
            continue
        tied = copy.deepcopy(sp)
        with torch.no_grad():
            tied.out_w[:, k] = tied.out_w[:, j]
            tied.out_b[k] = tied.out_b[j]
        rec = check_greedy(SimpleNamespace(speller=tied), SimpleNamespace(speller=sc), memory, mask, b, steps=steps,
                           timed=False, phase="12a", what=f"forced tie: column {j} copied to {k}")
        got = greedy_decode_fused(tied, sc, memory, mask, steps)[0]
        lo, hi = min(j, k), max(j, k)
        out.append({"columns": [lo, hi], "blocks": [lo // vc, hi // vc], "emitted_lower": int((got == lo).sum()),
                    "emitted_higher": int((got == hi).sum()), "rows_differing": rec["token_rows_differing"]})
        if out[-1]["emitted_lower"] == 0 or out[-1]["emitted_higher"] or lo // vc == hi // vc:
            fail(f"phase 12a: the forced tie was not taken by the smaller index: {out[-1]}")
    if not out:
        fail(f"phase 12a: no column for a forced tie beside {j} (V = {v})")
    return out


def check_preset_decoders(work, ckpt_rec, card) -> list:
    """Phase 12a: the decoder kernel against its plain version at every
    preset's serving shape (random init, parity mode), with the forced tie
    on the TIMIT shape → the records."""
    from phones_las_torch.decode.fused_greedy import greedy_decode_fused
    from phones_las_torch.models import encode
    from phones_las_torch.models.speller import init_speller
    from phones_las_torch.ops.masking import length_mask

    recs, summary = [], []
    for i, (name, head, b, samples, steps, ragged) in enumerate(PRESET_DECODES):
        preset, _, params, *_ = preset_model(name, work, DEV)
        cfg = preset.model
        audio, lens = preset_pcm(b, samples, 120 + i, ragged)
        memory, _, mask = encode(params, cfg, torch.from_numpy(audio).to(DEV), torch.from_numpy(lens).to(DEV))
        sp, sc = (params.grapheme_speller, cfg.grapheme_speller) if head == "grapheme" else (params.speller, cfg.speller)
        rec = check_greedy(SimpleNamespace(speller=sp), SimpleNamespace(speller=sc), memory, mask, b, steps=steps,
                           phase="12a", what=f"{name}, {head} head, {samples} samples a row"
                           + (", ragged" if ragged else ""))
        if i == 0:
            tok = greedy_decode_fused(sp, sc, memory, mask, steps)[0]
            rec["forced_tie"] = forced_tie(sp, sc, memory, mask, b, steps, tok, rec["launch"]["cluster"])
        recs.append(rec)
        del params, memory, mask
    small = []  # the cells, queries and vocabulary sliced C < 8 ways
    for i, (units, layer, want) in enumerate(SMALL_CLUSTERS):
        sc = dataclasses.replace(preset_model("timit_phone_las", work, "cpu")[0].model.speller, units=units,
                                 attention_units=units, attention_layer_size=layer, memory_dim=2 * units)
        sp = init_speller(sc, torch.Generator().manual_seed(150 + i), device=DEV)
        g = torch.Generator(device=DEV).manual_seed(150 + i)
        memory = torch.randn(13, 37, 2 * units, generator=g, device=DEV)
        lens = torch.randint(1, 38, (13,), generator=g, device=DEV)
        lens[0] = 37
        rec = check_greedy(SimpleNamespace(speller=sp), SimpleNamespace(speller=sc), memory, length_mask(lens, 37),
                           13, steps=40, timed=False, phase="12a", what=f"U={units} AL={layer} V={sc.vocab_size}")
        small.append({"units": units, "cluster": rec["launch"]["cluster"], "smem_bytes": rec["launch"]["smem_bytes"]})
        if rec["launch"]["cluster"] != want:
            fail(f"phase 12a: U={units} took cluster {rec['launch']['cluster']}, not {want}")
    for (name, head, b, samples, steps, _), rec in zip(PRESET_DECODES + (("checkpoint", "phone", FLAGSHIP_B,
                                                                           int(SECONDS * SAMPLE_RATE), DECODE_STEPS,
                                                                           False),), recs + [ckpt_rec]):
        la = rec["launch"]
        summary.append({"preset": name, "head": head, "shape": rec["shape"], "vocab": rec["vocab"],
                        "cells": rec["cells"], "cluster": la["cluster"], "smem_bytes": la["smem_bytes"],
                        "max_active_clusters": la["max_active_clusters"], "registers": la["registers"],
                        "ms": rec["ms"], "us_per_step": la["us_per_step"], "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"], "step_floor_ms": rec["step_floor_ms"], "step_floor_from": rec["step_floor_from"]})
    emit({"phase": "12a", "decoders": summary, "forced_tie": recs[0]["forced_tie"], "small_clusters": small,
          "card": card})
    return recs


def transcribe_modes(art_or_workdir, rows, kernels, beam: int, head=None, against_cpu=True) -> dict:
    """One request through the ``Transcriber`` on the card and (unless
    ``against_cpu`` is false) on the CPU → the rows differing, the card's
    token counts and launches."""
    from phones_las_torch import Transcriber

    def make(device):
        if head is None:
            return Transcriber.from_artifact(art_or_workdir, beam_width=beam, device=device)
        return Transcriber(art_or_workdir, beam_width=beam, head=head, device=device)

    reset_counters(kernels)
    card_tok = make(None if DEV == "cuda" else DEV).transcribe_batch(rows)
    torch.cuda.synchronize()
    la = launch_counts(kernels)
    out = {"lengths": [len(t) for t in card_tok], "launches": la}
    if against_cpu:
        cpu_tok = make("cpu").transcribe_batch(rows)
        out["rows_differing"] = [i for i, (a, b) in enumerate(zip(card_tok, cpu_tok)) if a != b]
    return out


def write_preset_workdir(wd: str, name: str, data_dir: str, preset, params_cpu, codes, mode: str) -> None:
    """A training workdir (step 0 = ``params_cpu``), as the training CLI writes one."""
    from phones_las_torch.train.checkpoint import CheckpointManager
    from phones_las_torch.train.loop import Trainer

    tr = Trainer(preset.model, preset.train, binf_codes=codes, device="cpu")
    tr.warm_start(params_cpu)
    CheckpointManager(wd).save(0, tr.state, force=True)
    with open(os.path.join(wd, "config.json"), "w") as f:
        json.dump({"preset": name, "data": data_dir,
                   "overrides": {"frontend_precision": "high"} if mode == "production" else {},
                   "precision": PROD_PRECISION if mode == "production" else None}, f)


def serve_presets(work, ckpt_cfg, kernels, card, artifacts) -> dict:
    """Phase 12b: each preset's random-init artifact through
    ``Transcriber.from_artifact`` on the card and on the CPU, 8 rows of its
    longest bucket, greedy and beam-8, parity and production (the grapheme
    head through a workdir); then the checkpoint's widths with Luong
    attention (greedy through the loop, to LUONG_CAP steps) → the card's
    launches summed.
    Production beam-8 is not held against the CPU: a random init's output
    distributions are nearly flat, so its beams part on score gaps below
    what TF32 (on the card only) moves; it runs on the card alone but for
    PRESET_BEAM_READING, whose rows differing are printed. Phase 6a holds
    production beam-8 on the trained checkpoint. The artifacts come from
    ``artifacts`` (``Prewritten``)."""
    from phones_las_torch.models import init_las
    from phones_las_torch.utils.param_io import save_params_npz

    rec = {"phase": "12b", "rows": PRESET_ROWS, "beam_width": BEAM_K}
    bad, launches = [], []
    served = {}  # model configuration → the preset that served it
    for name in PRESET_NAMES:
        preset, data_dir, params, _, _, codes = preset_model(name, work, "cpu")
        cfg, pl = preset.model, preset.pipeline
        key = json.dumps([dataclasses.asdict(cfg), pl.buckets, pl.max_target_len], sort_keys=True)
        if key in served:
            # the same model, seed and rows (librispeech_offline_infer differs from
            # librispeech_char_las in its batch of 256 alone: 12a's shape)
            rec[name] = {"same_model_and_rows_as": served[key]}
            continue
        served[key] = name
        n = max(pl.buckets)
        audio, lens = preset_pcm(PRESET_ROWS, n, 130, ragged=True)
        rows = [audio[i, :k].astype(np.int16) for i, k in enumerate(lens)]
        out = {"samples": [int(k) for k in lens], "cap": pl.max_target_len}
        for mode in ("parity", "production"):
            art = artifacts.get(f"preset_{name}_{mode}", lambda path: write_preset_artifact(path, name, mode))
            heads = {}
            cpu = lambda beam: mode == "parity" or beam == 0 or name == PRESET_BEAM_READING
            for beam in (0, BEAM_K):
                heads[f"phone beam {beam}"] = transcribe_modes(art, rows, kernels, beam, against_cpu=cpu(beam))
            if cfg.grapheme_speller is not None:
                wd = os.path.join(work, f"{name}_{mode}_workdir")
                write_preset_workdir(wd, name, data_dir, preset, params, codes, mode)
                for beam in (0, BEAM_K):
                    heads[f"grapheme beam {beam}"] = transcribe_modes(wd, rows, kernels, beam, head="grapheme",
                                                                      against_cpu=cpu(beam))
            out[mode] = heads
            allowed = 0 if mode == "parity" else MAX_DIFF_ROWS
            for h, r in heads.items():
                launches.append(r["launches"])
                la = r["launches"]
                want_dec = 0 if f"beam {BEAM_K}" in h else 1
                held = mode == "parity" or want_dec  # production beam-8: a reading
                if held and len(r.get("rows_differing", ())) > allowed:
                    bad.append(f"{name} {mode} {h}: rows differing")
                if DEV == "cuda" and (la["fused_logmel"], la["bidir_recurrence"], la["greedy_decode_fused"]) != (
                        1, cfg.listener.num_layers, want_dec):
                    bad.append(f"{name} {mode} {h}: launches")
        rec[name] = out
    # Luong attention at the checkpoint's widths: the speller loop, not the kernel
    luong = dataclasses.replace(ckpt_cfg, speller=dataclasses.replace(ckpt_cfg.speller, attention_type="luong"))
    params = init_las(luong, PRESET_SEED, device="cpu")
    audio, lens = preset_pcm(PRESET_ROWS, LUONG_SAMPLES, 131, ragged=True)
    rows = [audio[i, :k].astype(np.int16) for i, k in enumerate(lens)]
    out = {"samples": [int(k) for k in lens], "cap": LUONG_CAP}
    vocab = [f"p{i}" for i in range(luong.speller.vocab_size - 4)]
    for mode, c in (("parity", luong), ("production", production_cfg(luong))):
        art = os.path.join(work, f"luong_{mode}.npz")
        save_params_npz(art, params, c, extras={"vocab": vocab, "buckets": [len(rows[0])],
                                                "max_target_len": LUONG_CAP})
        heads = {f"beam {beam}": transcribe_modes(art, rows, kernels, beam,
                                                  against_cpu=mode == "parity" or beam == 0) for beam in (0, BEAM_K)}
        out[mode] = heads
        for h, r in heads.items():
            launches.append(r["launches"])
            if len(r.get("rows_differing", ())) > (0 if mode == "parity" else MAX_DIFF_ROWS):
                bad.append(f"luong {mode} {h}: rows differing")
            if DEV == "cuda" and (r["launches"]["greedy_decode_fused"]
                                  or r["launches"]["bidir_recurrence"] != luong.listener.num_layers):
                bad.append(f"luong {mode} {h}: launches")
    rec["luong_checkpoint_widths"] = out
    rec["card"] = card
    emit(rec)
    if bad:
        fail(f"phase 12b: preset serving failed in {bad}")
    return {k: sum(la[k] for la in launches) for k in launches[0]}


def preset_train_batch(preset, b: int, n: int, t_max: int, seed: int, device) -> dict:
    """B rows of up to ``n`` samples (ragged) with targets of up to
    ``t_max`` tokens, <eos> counted (grapheme targets as well for a
    multitask preset), random over the real tokens."""
    rs = np.random.RandomState(seed)
    audio, lens = preset_pcm(b, n, seed, ragged=True)
    out = {"audio": audio, "audio_lengths": lens}
    heads = [("targets", "target_lengths", preset.model.speller)]
    if preset.model.grapheme_speller is not None:
        heads.append(("grapheme_targets", "grapheme_lengths", preset.model.grapheme_speller))
    for key, len_key, sc in heads:
        t_lens = rs.randint(2, t_max + 1, b).astype(np.int32)
        targets = np.zeros((b, t_max), np.int32)
        for i, t in enumerate(t_lens):
            targets[i, : t - 1] = rs.randint(4, sc.vocab_size, t - 1)
            targets[i, t - 1] = sc.eos_id
        out[key], out[len_key] = targets, t_lens
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def train_presets(work, kernels, card) -> dict:
    """Phase 12c: two ``Trainer`` steps of each trained preset at B = 4,
    dropout and sampling off, card against the CPU plain path in parity and
    production mode; then, for PRESET_OWN_SHAPE, one step at its own B = 32
    and longest bucket, timed and profiled → the card's launches summed."""
    from phones_las_torch.train.loop import Trainer

    device = None if DEV == "cuda" else DEV
    rec = {"phase": "12c", "batch": PRESET_TRAIN_B, "samples": PRESET_TRAIN_SAMPLES}
    bad, launches = [], []
    for name in PRESET_TRAINED:
        preset, _, params, _, _, codes = preset_model(name, work, "cpu", dropout=0.0, sampling_probability=0.0)
        cfg, n_layers = preset.model, preset.model.listener.num_layers
        if cfg.grapheme_speller is not None:  # the override reaches the phone speller only
            cfg = dataclasses.replace(cfg, grapheme_speller=dataclasses.replace(cfg.grapheme_speller,
                                                                                sampling_probability=0.0))
        batch = preset_train_batch(preset, PRESET_TRAIN_B, PRESET_TRAIN_SAMPLES, PRESET_TRAIN_TARGET, 140, "cpu")
        out = {}
        for mode, c in (("parity", cfg), ("production", production_cfg(cfg))):
            runs = {}
            for side, dev in (("card", device), ("cpu", "cpu")):
                tr = Trainer(c, preset.train, binf_codes=codes, device=dev)
                tr.warm_start(params)
                grads, apply = {}, tr.apply_gradients

                def capture(g=None, tr=tr, apply=apply, grads=grads):
                    g = tr.gradients() if g is None else g
                    if not grads:  # the first step's
                        grads.update({k: t.detach().cpu().clone() for k, t in g.items()})
                    return apply(g)

                tr.apply_gradients = capture
                steps = []
                for _ in range(2):
                    if side == "card":
                        reset_counters(kernels)
                    o = tr.train_step(batch)
                    steps.append({k: float(v) for k, v in o.items() if k.endswith("loss")})
                    if side == "card":
                        torch.cuda.synchronize()
                        launches.append(launch_counts(kernels))
                runs[side] = (steps, grads)
            (gs, gg), (cs, cg) = runs["card"], runs["cpu"]
            terms = {f"step{i + 1} {k}": abs(g[k] - cs[i][k]) / max(abs(cs[i][k]), 1e-30)
                     for i, g in enumerate(gs) for k in g}
            # production holds the first step, as 11b: Adam turns the gradients'
            # TF32 rounding into a second step's 1e-4-size drift (a reading)
            held = {k: e for k, e in terms.items() if mode == "parity" or k.startswith("step1 ")}
            grad_rel = {k: rel_err(gg[k], cg[k]) for k in cg}
            worst = max(grad_rel, key=grad_rel.get)
            parity = mode == "parity"
            tol = PRESET_LOSS_TOL if parity else PROD_LOSS_TOL
            keys = set(gs[0])
            out[mode] = {"card": gs, "cpu": cs, "rel_err": terms, "tol": tol, "held": sorted(held),
                         "grad_max_rel_to_max": grad_rel[worst], "grad_worst_leaf": worst,
                         "grad_tol": PRESET_GRAD_TOL if parity else "not held: TF32 on the card only",
                         "launches": launches[-1]}
            finite = all(np.isfinite(list(s.values())).all() for s in gs + cs)
            want = {"loss", "phone_loss"} | ({"grapheme_loss"} if cfg.grapheme_speller else set()) | (
                {"binf_loss"} if cfg.speller.binf_mode != "none" else set())
            if not finite or keys != want or max(held.values()) > tol or (parity and grad_rel[worst] > PRESET_GRAD_TOL):
                bad.append(f"{name} {mode}")
            la = launches[-1]
            if DEV == "cuda" and (la["fused_logmel"], la["recurrence_residual"], la["recurrence_bwd"]) != (
                    1, n_layers, n_layers):
                bad.append(f"{name} {mode} launches")
        rec[name] = out
        if name != PRESET_OWN_SHAPE:
            continue
        # one step at the preset's own batch and longest bucket: a reading
        pl = preset.pipeline
        tr = Trainer(cfg, preset.train, binf_codes=codes, device=device)
        tr.warm_start(params)
        big = preset_train_batch(preset, pl.batch_size, max(pl.buckets), pl.max_target_len, 141, DEV)
        tr.train_step(big)  # warm-up
        torch.cuda.synchronize()
        reset_counters(kernels)
        t0 = time.perf_counter()
        tr.train_step(big)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        launches.append(launch_counts(kernels))
        prof = profile_step(lambda: tr.train_step(big), step_ms, top=4)
        out["own_shape"] = {"batch": pl.batch_size, "samples": max(pl.buckets), "step_ms": step_ms,
                            "device_ms": prof.get("device_ms"), "device_launches": prof.get("device_launches"),
                            "device_busy_share": prof.get("device_busy_share", "not measured"),
                            "launches": launches[-1]}
        del tr, big
    rec["card"] = card
    emit(rec)
    if bad:
        fail(f"phase 12c: preset training failed in {bad}")
    return {k: sum(la[k] for la in launches) for k in launches[0]}


def start_preset_prepare(work, started):
    """12d's records: ``prepare speechlike --graphemes`` started as a
    process (appended to ``started``) → its data dir."""
    data = os.path.join(work, "front_data")
    cli("prepare", "speechlike", "--out", data, "--n-utts", str(FRONT12_UTTS), "--seed", str(DATA_TRAIN_SEED),
        "--graphemes", started=started)
    return data


def start_preset_train(work, data, prepare, started):
    """12d's ``cli.train --preset timit_multitask`` on the records of the
    ``prepare`` process, a few steps and one eval, started as a process
    (appended to ``started``) once they are written."""
    finish(prepare, "prepare")
    return cli("train", "--preset", "timit_multitask", "--data", data, "--workdir", os.path.join(work, "front_run"),
               "--num-steps", str(FRONT12_STEPS), "--eval-every", str(FRONT12_STEPS), started=started)


def check_preset_front_doors(work, data, train, kernels, card) -> dict:
    """Phase 12d: once the ``train`` process (``start_preset_train``, beside
    12b and 12c) has ended, ``cli.infer --head grapheme`` on its workdir
    against the library's ``Transcriber(head='grapheme')``."""
    from phones_las_torch import Transcriber
    from phones_las_torch.data.records import RecordReader

    run = os.path.join(work, "front_run")
    t0 = time.perf_counter()
    train_out = finish(train, "train")
    hyps = os.path.join(run, "hyps_grapheme.tsv")
    infer_out = cli("infer", "--workdir", run, "--data", os.path.join(data, "test.plu"), "--beam-width", "0",
                    "--head", "grapheme", "--output", hyps).stdout
    seconds = time.perf_counter() - t0
    held = list(RecordReader(os.path.join(data, "test.plu")))
    reset_counters(kernels)
    want = Transcriber(run, beam_width=0, head="grapheme", device=None if DEV == "cuda" else DEV).transcribe_batch(
        [u.audio for u in held])
    la = launch_counts(kernels)
    with open(hyps) as f:
        got = dict(line.rstrip("\n").split("\t", 1) for line in f)
    differing = [u.utt_id for u, w in zip(held, want) if got.get(u.utt_id) != " ".join(w)]
    evals = [line for line in train_out.splitlines() if "'tag': 'eval'" in line or line.startswith("final eval")]
    rec = {"phase": "12d", "preset": "timit_multitask", "steps": FRONT12_STEPS, "eval_lines": evals[-2:],
           "infer_footer": infer_out.strip().splitlines()[-1:], "utterances": len(held),
           "rows_differing_from_library": differing, "library_launches": la, "seconds": seconds, "card": card}
    emit(rec)
    if not evals or len(got) != len(held) or differing or (DEV == "cuda" and la["greedy_decode_fused"] < 1):
        fail(f"phase 12d: the preset's front doors failed: {rec}")
    return la


def make_preset_work() -> str:
    """Phase 12's temporary directory under ``_runs/``."""
    import tempfile

    os.makedirs(os.path.join(REPO, "_runs"), exist_ok=True)
    return tempfile.mkdtemp(prefix="chip_smoke_presets_", dir=os.path.join(REPO, "_runs"))


def check_presets(ckpt_cfg, ckpt_rec, kernels, card, artifacts, work=None, started=None) -> dict:
    """Phase 12, in ``work`` (``make_preset_work``'s; made here if None)
    removed at the end → the card's launches of 12b–d summed. 12d's records
    are prepared by a process started beside phases 9–11 (the first of
    ``started``; here, if None, after 12a), and its ``cli.train`` runs
    beside 12b and 12c (after 12a's timings); every process it starts is
    stopped."""
    import shutil

    work = work or make_preset_work()
    started = [] if started is None else started
    try:
        data = os.path.join(work, "front_data")
        check_preset_decoders(work, ckpt_rec, card)
        if not started:
            start_preset_prepare(work, started)
        train = start_preset_train(work, data, started[0], started)
        parts = [serve_presets(work, ckpt_cfg, kernels, card, artifacts)]
        with torch.enable_grad():
            parts.append(train_presets(work, kernels, card))
        parts.append(check_preset_front_doors(work, data, train, kernels, card))
    finally:
        stop(started)
        shutil.rmtree(work, ignore_errors=True)
    return {k: sum(p[k] for p in parts) for k in parts[0]}


# ---- phase 13: the reference's width flags (fault C8)
WIDTH_SEED = 13  # the random init of both configurations
WIDTH_PRESET = "librispeech_char_las"
# the flags of cli/train.py: the LAS-4-1024 widths (SpecAugment paper:
# bidirectional layers of 1024 cells, a 1024-wide decoder; M = 2048, E = 128
# and the attention layer at the preset's 256), and an odd width that runs
# the padding path of every kernel
WIDTH_FLAGS = {
    "W1024": {"encoder_layers": 4, "encoder_units": 1024, "decoder_units": 1024, "attention_units": 1024},
    "W100": {"encoder_units": 100, "decoder_units": 36, "attention_units": 60, "embedding_dim": 30},
}
WIDTH_UNITS = (264, 320, 512, 1024, 100)  # 13a: the listener kernels against their plain versions, both modes
WIDTH_KERNEL_T, WIDTH_KERNEL_B = 24, 32  # ... on ragged lengths 1..T
WIDE_UNITS, WIDE_T = (1032, 1280, 2048), 250  # 13a: past 1024 (fault C10), both modes, at T = 250
# 13a: the grid layouts (the forward's, the VJP's) in passes of rows (a launch each): (U, B, the modes whose
# every plan takes several)
PASS_CASES = ((1024, 130, ("highest", "bf16")), (448, 200, ("bf16",)))
WIDTH_TIMED = ((1024, "highest"), (512, "highest"), (1024, "bf16"))  # 13a: T = 999, with cuDNN beside
# 13a: cuDNN's BiLSTM alone at T = 999, B = 64 at the widths where the forward's grid layout stands in for the
# template's streamed slice (float32 200, 248; bf16 264, 368): PERF.md's row 2 library column
LIBRARY_UNITS = (200, 248, 264, 368)
WIDTH_REPS = 5  # ... timed as the median of 5 runs (the plain versions once)
# 13a: each kernel's two routes in turns on one card (``compare_routes``): the forward's template
# (its slice of wh streamed) against the grid layout the plan takes past 256 (bf16: 384); the VJP's
# template against its grid layout, the plan's past GRID_UNITS_BWD (bf16: RING_UNITS_BF16), and at
# ROUTE_C1_UNITS the grid layout in single blocks (C = 1) against the planner's clusters
ROUTE_CASES = WIDTH_TIMED + ((512, "bf16"), (448, "bf16"))
ROUTE_C1_UNITS = (1024,)
ROUTE_REPS = 3  # ... each turn the median of 3 launches
# 13a: the decoder kernel at B = 32, 200 steps: (label, T_enc, U, A, AL, M)
WIDTH_DECODES = (("W1024", 219, 1024, 1024, 256, 2048), ("W1024", 438, 1024, 1024, 256, 2048),
                 ("W1024, attention layer 1024 (library-built)", 219, 1024, 1024, 1024, 2048),
                 ("LAS paper speller", 438, 512, 512, 256, 512))
WIDTH_ROWS, WIDTH_SAMPLES, WIDTH_CAP = 8, 64000, 60  # 13b: 8 rows of <= 4 s through the Transcriber, cap 60
WIDTH_TRAIN_B, WIDTH_TRAIN_SAMPLES, WIDTH_TRAIN_TARGET = 8, 64000, 30  # 13c: B = 8 × <= 4 s
WIDTH_CLI_UTTS, WIDTH_CLI_STEPS = 64, 2  # 13c: prepare speechlike (16 held out), cli.train steps
# 13d: the decoder kernel past its old limits (faults C9, C11) at B = 8, 60
# steps, timed: (label, T_enc, U, A, AL, M, tokens also against the CPU
# loop's; the speller at U = A = AL = 2048 only against its plain version on
# the card: its CPU loop would take a minute, and W2048's serving holds it)
LONG_DECODES = (("the checkpoint's speller", 17100, 256, 256, 256, 512, True),
                ("the checkpoint's speller", 40000, 256, 256, 256, 512, True),
                ("W1024's speller", 5900, 1024, 1024, 256, 2048, True),
                ("U = A = AL = 2048, M = 4096", 219, 2048, 2048, 2048, 4096, False))
LONG_B, LONG_STEPS = 8, 60
PASS_DECODE = (4096, 219, 12)  # 13a: W1024 at B = 4096 (two grid launches), T_enc 219, 12 steps
# --compare: the listener's forward at T = 999 past the resident widths: (kernel, U, mode, B), both
# directions (one with "recurrence")
COMPARE_FORWARDS = (("bidir_recurrence", 1024, "highest", FLAGSHIP_B), ("recurrence_residual", 1024, "highest", TRAIN_B),
                    ("recurrence", 1024, "highest", TRAIN_B), ("recurrence", 1024, "bf16", TRAIN_B),
                    ("bidir_recurrence", 1024, "bf16", FLAGSHIP_B), ("recurrence_residual", 1024, "bf16", TRAIN_B),
                    ("bidir_recurrence", 512, "highest", FLAGSHIP_B), ("bidir_recurrence", 512, "bf16", FLAGSHIP_B),
                    ("bidir_recurrence", 448, "bf16", FLAGSHIP_B),
                    # U = 512 and 448 in bf16 at the training batch, both entries and one direction
                    ("bidir_recurrence", 512, "bf16", TRAIN_B), ("recurrence_residual", 512, "bf16", TRAIN_B),
                    ("recurrence", 512, "bf16", TRAIN_B), ("bidir_recurrence", 448, "bf16", TRAIN_B),
                    ("recurrence_residual", 448, "bf16", TRAIN_B),
                    # the widths no cluster cut holds: the template's streamed slice in checkouts before the
                    # forward's second grid layout, the grid layout since
                    ("bidir_recurrence", 200, "highest", FLAGSHIP_B), ("bidir_recurrence", 248, "highest", FLAGSHIP_B),
                    ("bidir_recurrence", 264, "bf16", FLAGSHIP_B), ("bidir_recurrence", 368, "bf16", FLAGSHIP_B))
LONG_SECONDS = 690  # 13d: one Transcriber.transcribe of 690 s at the checkpoint's widths (T_enc ≈ 17,250)
# 13d: W2048: encoder, decoder and attention units 2048, one listener layer (M = 4096), served at 8 × 2 s
# greedy in parity, and one production training step at 13c's bounds
W2048_FLAGS = {"encoder_layers": 1, "encoder_units": 2048, "decoder_units": 2048, "attention_units": 2048}
W2048_ROWS, W2048_SAMPLES = 8, 32000
W2048_TRAIN_B, W2048_TRAIN_SAMPLES = 4, 32000


def route_plan_record(plan, b: int, nd: int, info: dict) -> dict:
    """A plan of the listener kernels as 13a prints it: the cut, the
    clusters of the launch against what the card runs at once, the waves;
    the grid layout's cut, blocks, resident share and passes."""
    if getattr(plan, "grid", None) is not None:
        return {"grid": plan.grid._asdict(), "kernel_units": plan.units, **info}
    clusters = -(-b // plan.bt) * nd
    return {"cluster": plan.cluster, "bt": plan.bt, "ksplit": plan.ksplit, "wh_in_smem": plan.resident, "kernel_units": plan.units, "clusters": clusters,
            "max_active_clusters": info["max_active_clusters"],
            "waves": -(-clusters // info["max_active_clusters"]), "smem_bytes": info["smem_bytes"],
            "registers": info["registers"]}


def compare_routes(u: int, seed: int, prec: str = "highest") -> list:
    """13a: the four listener kernels at U in a mode, T = 999 (the BiLSTM
    forward at B = 64, the others at the training batch): the forward
    kernels in the grid layout the plan takes past the resident widths
    (median of ``ROUTE_REPS``); the VJP's loop under the template
    (``layout="template"``) and its grid layout (``layout="grid"``) in turns
    on one card (template, grid, grid, template), and at
    ``ROUTE_C1_UNITS`` the grid layout cut in single blocks (C = 1) beside
    the planner's clusters: each plan with its cut (clusters,
    ``max_active_clusters`` and waves; the grid's blocks, clusters,
    resident share and passes), the ms, and the SM cycles a step spends in
    each part (the forward's: product, cell update, publication, first and
    later chunks; the grid loop's: cell gradients, arrival, product,
    barrier, intake, exchange, partials); the VJP's routes' outputs against
    each other and which was faster. The plain versions and the gates are
    the other records'; the layouts the grid layouts replaced are read
    against them by ``--compare``."""
    from phones_las_torch.ops import lstm as L
    from phones_las_torch.ops.masking import length_mask

    t = 999
    g = torch.Generator(device=DEV).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=DEV)

    def case(b, nd):
        lengths = torch.randint(t // 2, t + 1, (b,), generator=g, device=DEV)
        lengths[0] = t
        mask = length_mask(lengths, t).transpose(0, 1).contiguous()
        return [rnd(t, b, 4 * u) for _ in range(nd)], mask, [rnd(u, 4 * u) / u ** 0.5 for _ in range(nd)]

    recs = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kernel, entry, b, nd in (("bidir_recurrence", "plt_lstm_recurrence", FLAGSHIP_B, 2),
                                 ("recurrence", "plt_lstm_recurrence", TRAIN_B, 1),
                                 ("recurrence_residual", "plt_lstm_residual", TRAIN_B, 2)):
        xps, mask, whs = case(b, nd)
        rev = [False, True][:nd]
        save = entry == "plt_lstm_residual"
        plan = L.forward_plan(b, u, nd, prec, sms=sms)
        if plan.grid is None:
            fail(f"phase 13a: the forward did not plan the grid layout at U = {u} ({prec})")
        run = lambda: L._launch_forward(entry, xps, mask, whs, 1.0, rev, prec, plan)
        ms = time_ms(run, reps=ROUTE_REPS)
        clocks = torch.zeros(len(GRID_CLOCKS), dtype=torch.int64, device=DEV)
        L._launch_forward(entry, xps, mask, whs, 1.0, rev, prec, plan, clocks)
        torch.cuda.synchronize()
        recs.append({"phase": "13a", "kernel": kernel, "what": "the grid layout",
                     "shape": f"T={t} B={b} U={u} nd={nd} prec={prec}",
                     "routes": {"grid": {**route_plan_record(plan, b, nd, plan_info(plan, nd, prec, save)), "ms": ms,
                                         "us_per_step": ms * 1e3 / t,
                                         "cycles_per_step": dict(zip(GRID_CLOCKS, (c / t for c in clocks.tolist())))}}})
        del xps
    xps, mask, whs = case(TRAIN_B, 2)
    res = L.recurrence_residual(xps, mask, whs, 1.0, [False, True], prec)
    bargs = (xps, mask, whs, [r[1] for r in res], [r[2] for r in res], [rnd(t, TRAIN_B, u) for _ in range(2)],
             [rnd(TRAIN_B, u) for _ in range(2)], [rnd(TRAIN_B, u) for _ in range(2)], 1.0, [False, True], prec)
    bf16 = prec == "bf16"
    active = functools.partial(L.backward_held, bf16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {"template": L.backward_plan(TRAIN_B, u, 2, prec, active, layout="template", sms=sms),
             "grid": L.backward_plan(TRAIN_B, u, 2, prec, active, layout="grid", sms=sms)}
    if u in ROUTE_C1_UNITS:
        plans["grid, C = 1"] = L._as_backward_plan(L.grid_bwd_plan(TRAIN_B, u, 2, prec, sms, clusters=(1,)), 2, prec)
    outs = {name: L._launch_backward(*bargs, plan=plan) for name, plan in plans.items()}
    torch.cuda.synchronize()
    diff = max(rel_err(x, y) for name in plans if name != "grid"
               for kt, kr in zip(outs[name], outs["grid"]) for x, y in zip(kt, kr))
    del outs
    loops = {name: [] for name in plans}
    for name in list(plans) + list(plans)[::-1]:
        for _ in range(ROUTE_REPS):
            part = []
            L._launch_backward(*bargs, plan=plans[name], part_ms=part)
            loops[name].append(part[1])
    routes = {}
    for name, plan in plans.items():
        _, cycles = loop_reading(L, bargs, plan, 0)
        loop_ms = statistics.median(loops[name])
        routes[name] = {**route_plan_record(plan, TRAIN_B, 2, L.backward_kernel_info(bf16, plan)),
                        "loop_ms": loop_ms, "us_per_step": loop_ms * 1e3 / t, "cycles_per_step": cycles}
    recs.append({"phase": "13a", "kernel": "recurrence_bwd (the loop)",
                 "what": "the template's streamed slice and the grid layout (and its single blocks), in turns",
                 "shape": f"T={t} B={TRAIN_B} U={u} nd=2 prec={prec}", "routes": routes,
                 "max_rel_diff_between_routes": diff,
                 "faster": min(routes, key=lambda k: routes[k]["loop_ms"])})
    for rec in recs:
        emit(rec)
    return recs


def width_flags_argv(name: str) -> list:
    return [a for k, v in WIDTH_FLAGS[name].items() for a in (f"--{k.replace('_', '-')}", str(v))]


def check_width_kernels(work) -> dict:
    """Phase 13a: the listener kernels at U = 264, 320, 512, 1024 and 100
    (the forward past 256, bf16 past 384, through the grid layout; the
    VJP's loop past 512, bf16 past 384, through its grid layout; the
    padding path) and past 1024 against their plain versions in both modes
    on ragged lengths, the grid layouts also in passes of rows
    (``PASS_CASES``); timed at T = 999 beside cuDNN at U =
    1024 and 512 in float32 and at 1024 in bf16; the forward's grid layout
    and the VJP's two routes in turns (``compare_routes``); the decoder kernel at W1024's speller (the grid
    layout), with an attention layer of 1024, and at the LAS paper's (whose
    held layout fits 6.4 KB under the limit; the plan takes the grid
    layout), each in its plan's layout; W1024's at B = 4096 in passes
    (``check_grid_passes``)."""
    from phones_las_torch.decode.fused_greedy import kernel_widths
    from phones_las_torch.models.speller import SpellerConfig, init_speller
    from phones_las_torch.ops import lstm as L
    from phones_las_torch.ops.masking import length_mask

    fwd, vjp = [], []
    for i, u in enumerate(WIDTH_UNITS):
        fwd.append(check_lstm_ragged(WIDTH_KERNEL_T, WIDTH_KERNEL_B, u, 130 + i, phase="13a"))
        vjp.append(check_lstm_bwd_ragged(WIDTH_KERNEL_T, WIDTH_KERNEL_B, u, 140 + i, phase="13a"))
    for i, u in enumerate(WIDE_UNITS):  # every route past 1024 (fault C10)
        fwd.append(check_lstm_ragged(WIDE_T, WIDTH_KERNEL_B, u, 200 + i, phase="13a"))
        vjp.append(check_lstm_bwd_ragged(WIDE_T, WIDTH_KERNEL_B, u, 210 + i, phase="13a"))
    for i, (u, b, modes) in enumerate(PASS_CASES):
        fwd.append(check_lstm_ragged(WIDTH_KERNEL_T, b, u, 220 + i, phase="13a", passes_in=modes))
        vjp.append(check_lstm_bwd_ragged(WIDTH_KERNEL_T, b, u, 225 + i, phase="13a", passes_in=modes))
    emit({"phase": "13a", "what": "listener kernels at the new widths against their plain versions",
          "forward_max_abs_err": {r["shape"]: r["max_abs_err"] for r in fwd},
          "vjp_max_rel_to_max": {r["shape"]: r["max_rel_to_max"] for r in vjp},
          "readings_at_u256": "forward within 3.6e-7, VJP 9.4e-7 / 6.0e-4 (f32 / bf16) of the plain version's "
                              "largest (PERF.md, section 6)"})
    library = {}
    for i, u in enumerate(LIBRARY_UNITS):  # as check_bilstm_inputs reads it: a pyramid layer's input width, float32
        lstm = torch.nn.LSTM(4 * u, u, bidirectional=True).to(DEV)
        x_in = torch.randn((999, FLAGSHIP_B, 4 * u), generator=torch.Generator(device=DEV).manual_seed(190 + i),
                           device=DEV)
        library[f"U={u}"] = time_ms(lambda: lstm(x_in), reps=WIDTH_REPS)
        del lstm, x_in
    emit({"phase": "13a", "kernel": "bidir_recurrence", "what": "cuDNN's BiLSTM alone, the library column",
          "shape": f"T=999 B={FLAGSHIP_B}", "library": "torch.nn.LSTM(4U, U, bidirectional=True), includes the input "
          "projection", "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32, "library_ms": library})
    timed = []
    for i, (u, prec) in enumerate(WIDTH_TIMED):
        gen = torch.Generator().manual_seed(WIDTH_SEED + i)
        pair = [L.init_lstm_params(4 * u, u, gen, device=DEV) for _ in range(2)]  # a pyramid layer's input width
        g = torch.Generator(device=DEV).manual_seed(150 + i)
        t, b = 999, FLAGSHIP_B
        lengths = torch.randint(t // 2, t + 1, (b,), generator=g, device=DEV)
        lengths[0] = t
        xpf, xpb = (torch.randn((t, b, 4 * u), generator=g, device=DEV) for _ in range(2))
        rec = check_bilstm_inputs(pair[0], pair[1], xpf, xpb, lengths, prec, g, phase="13a", held=False, plain_reps=1,
                                  reps=WIDTH_REPS)
        del xpf, xpb
        with torch.enable_grad():
            train = check_lstm_train(pair, t, prec, 160 + i, phase="13a", one_wave=False, held=False, plain_reps=1,
                                     reps=WIDTH_REPS)
        timed.append({"u": u, "prec": prec, "bidir_recurrence": rec, "recurrence": train[0],
                      "recurrence_residual": train[1], "recurrence_bwd": train[2]})
    # the bf16 BiLSTM at U = 1024 at 13b's served rows, the plan's other bf16 route (mma.sync) than at B = 64
    gen, g = torch.Generator().manual_seed(WIDTH_SEED + 9), torch.Generator(device=DEV).manual_seed(159)
    pair = [L.init_lstm_params(4096, 1024, gen, device=DEV) for _ in range(2)]
    lengths = torch.randint(499, 1000, (WIDTH_ROWS,), generator=g, device=DEV)
    lengths[0] = 999
    xpf, xpb = (torch.randn((999, WIDTH_ROWS, 4096), generator=g, device=DEV) for _ in range(2))
    rows_rec = check_bilstm_inputs(pair[0], pair[1], xpf, xpb, lengths, "bf16", g, phase="13a", held=False,
                                   plain_reps=1, reps=WIDTH_REPS)
    del xpf, xpb
    routes = [compare_routes(u, 180 + i, prec) for i, (u, prec) in enumerate(ROUTE_CASES)]
    decs = []
    for i, (label, t, u, a, al, m) in enumerate(WIDTH_DECODES):
        sc = SpellerConfig(vocab_size=PRESET_VOCAB[WIDTH_PRESET], embedding_dim=128, num_layers=2, units=u,
                           memory_dim=m, attention_units=a, attention_layer_size=al)
        sp = init_speller(sc, torch.Generator().manual_seed(WIDTH_SEED + i), device=DEV)
        g = torch.Generator(device=DEV).manual_seed(170 + i)
        memory = torch.randn(WIDTH_KERNEL_B, t, m, generator=g, device=DEV)
        lens = torch.randint(t // 4, t + 1, (WIDTH_KERNEL_B,), generator=g, device=DEV)
        lens[0] = t
        mask = length_mask(lens, t)
        rec = check_greedy(SimpleNamespace(speller=sp), SimpleNamespace(speller=sc), memory, mask,
                           WIDTH_KERNEL_B, steps=DECODE_STEPS, phase="13a", what=f"{label}, T_enc {t}, ragged")
        if rec["launch"]["layout"] != kernel_widths(WIDTH_KERNEL_B, sc, t)[1].name:
            fail(f"phase 13a: the decoder did not take its plan's layout at {label}: {rec['launch']}")
        decs.append(rec)
        del sp, memory
    decs.append(check_grid_passes())
    return {"timed": timed, "bidir_bf16_rows": rows_rec, "routes": routes, "decoders": decs}


def check_grid_passes() -> dict:
    """Phase 13a: W1024's speller at a batch past what one grid launch
    holds (``PASS_DECODE``: B = 4096, ``grid_rows`` 3,512), decoded in two
    passes, a launch each: the grid launches counted, the tokens against
    the plain version's (a row that differs fails unless the plain side's
    top-2 margin at its first differing step, from ``teacher_forced_decode``
    on the plain tokens, is below ``TIE_MARGIN``: a tie), two calls
    bitwise equal, the call timed beside its bound."""
    from phones_las_torch.decode.fused_greedy import (decoder_plan, greedy_decode_fused, greedy_decode_fused_plain,
                                                      grid_rows)
    from phones_las_torch.models.speller import SpellerConfig, init_speller, teacher_forced_decode
    from phones_las_torch.ops.masking import length_mask

    b, t, steps = PASS_DECODE
    sc = SpellerConfig(vocab_size=PRESET_VOCAB[WIDTH_PRESET], embedding_dim=128, num_layers=2, units=1024,
                       memory_dim=2048, attention_units=1024, attention_layer_size=256)
    sp = init_speller(sc, torch.Generator().manual_seed(WIDTH_SEED), device=DEV)
    g = torch.Generator(device=DEV).manual_seed(175)
    memory = torch.randn(b, t, sc.memory_dim, generator=g, device=DEV)
    lens = torch.randint(t // 4, t + 1, (b,), generator=g, device=DEV)
    lens[0] = t
    mask = length_mask(lens, t)
    n0 = greedy_decode_fused.grid_launches
    tok, _ = greedy_decode_fused(sp, sc, memory, mask, steps)
    torch.cuda.synchronize()
    launches, launch = greedy_decode_fused.grid_launches - n0, dict(greedy_decode_fused.last_launch)
    again, _ = greedy_decode_fused(sp, sc, memory, mask, steps)
    plain, _ = greedy_decode_fused_plain(sp, sc, memory, mask, steps)
    logits = []  # the plain side's, computed once a row differs

    def top2(i, s):
        if not logits:  # fed the plain tokens, <sos> first
            fed = torch.cat([torch.full_like(plain[:, :1], sc.bos_id), plain[:, :-1]], dim=1).long()
            logits.append(teacher_forced_decode(sp, sc, fed, memory, mask)[0].cpu())
        return float(logits[0][i, s].topk(2).values.diff().abs())

    differ = rows_against(tok.cpu().numpy(), plain.cpu().numpy(), top2)
    rec = {"phase": "13a", "kernel": "greedy_decode_fused", "what": "W1024 at a batch past one grid launch: passes",
           "shape": f"B={b} T={t} steps={steps}", "grid_rows": grid_rows(sc),
           "passes": decoder_plan(b, sc, t).passes, "grid_launches": launches, "launch": launch,
           "rows_differing": differ, "bitwise_repeatable": bool(torch.equal(tok, again)),
           "ms": time_ms(lambda: greedy_decode_fused(sp, sc, memory, mask, steps), reps=3),
           "plain_ms": time_ms(lambda: greedy_decode_fused_plain(sp, sc, memory, mask, steps), reps=1)}
    rec["row_steps"], _, rec["bound_ms"], rec["bound_by"] = greedy_bound(sp, sc, tok, t, steps)
    emit(rec)
    if launches != rec["passes"] or rec["passes"] < 2 or any(not d["tie"] for d in differ) or not rec[
            "bitwise_repeatable"] or launch["layout"] == "held":
        fail(f"phase 13a: the grid layout's passes failed: {rec}")
    return rec


def write_width_artifact(path: str, name: str, mode: str) -> None:
    """13b's (and 13d's) artifact of a width configuration in a mode: its
    random init (WIDTH_SEED), decoded to at most WIDTH_CAP steps."""
    from phones_las_torch.utils.param_io import save_params_npz

    flags = {**WIDTH_FLAGS, "checkpoint": {}, "W2048": W2048_FLAGS}[name]
    preset, _, params, vocab, _, _ = preset_model(WIDTH_PRESET, os.path.dirname(path), "cpu", seed=WIDTH_SEED,
                                                  **flags)
    cfg = preset.model
    save_params_npz(path, params, cfg if mode == "parity" else production_cfg(cfg),
                    extras={"preset": WIDTH_PRESET, "vocab": vocab.tokens, "buckets": [WIDTH_SAMPLES],
                            "max_target_len": WIDTH_CAP})


def serve_widths(work, kernels, card, artifacts) -> dict:
    """Phase 13b: W1024 and W100 as random-init artifacts through
    ``Transcriber.from_artifact`` on the card and on the CPU, 8 rows of 10 s,
    greedy and beam-8 (one ``Transcriber`` a mode and device, its beam width
    set between the two), both modes: 0 rows differing in parity, at most 2
    greedy rows in production; production beam-8 runs on the card alone (a
    reading, as 12b's) → the card's launches summed. The artifacts come
    from ``artifacts`` (``Prewritten``)."""
    from phones_las_torch import Transcriber

    rec = {"phase": "13b", "rows": WIDTH_ROWS, "samples": WIDTH_SAMPLES, "cap": WIDTH_CAP, "beam_width": BEAM_K}
    bad, launches, routes = [], [], []
    audio, lens = preset_pcm(WIDTH_ROWS, WIDTH_SAMPLES, 180, ragged=True)
    rows = [audio[i, :k].astype(np.int16) for i, k in enumerate(lens)]
    for name in WIDTH_FLAGS:
        preset = preset_model(WIDTH_PRESET, work, "cpu", seed=WIDTH_SEED, **WIDTH_FLAGS[name])[0]
        cfg = preset.model
        out = {"listener": [cfg.listener.num_layers, cfg.listener.units],
               "speller": [cfg.speller.units, cfg.speller.attention_units, cfg.speller.memory_dim,
                           cfg.speller.embedding_dim, cfg.speller.attention_layer_size]}
        for mode in ("parity", "production"):
            art = artifacts.get(f"width_{name}_{mode}", lambda path: write_width_artifact(path, name, mode))
            card_t = Transcriber.from_artifact(art, device=None if DEV == "cuda" else DEV)
            cpu_t = Transcriber.from_artifact(art, device="cpu")
            heads = {}
            for beam in (0, BEAM_K):
                card_t.beam = cpu_t.beam = beam
                reset_counters(kernels)
                card_tok = card_t.transcribe_batch(rows)
                torch.cuda.synchronize()
                r = {"lengths": [len(x) for x in card_tok], "launches": launch_counts(kernels)}
                routes.append(route_counts(kernels))
                if mode == "parity" or beam == 0:
                    cpu_tok = cpu_t.transcribe_batch(rows)
                    r["rows_differing"] = [i for i, (a, b) in enumerate(zip(card_tok, cpu_tok)) if a != b]
                heads[f"beam {beam}"] = r
                launches.append(r["launches"])
                la = r["launches"]
                if len(r.get("rows_differing", ())) > (0 if mode == "parity" else MAX_DIFF_ROWS):
                    bad.append(f"{name} {mode} beam {beam}: rows differing")
                if DEV == "cuda" and (la["fused_logmel"], la["bidir_recurrence"], la["greedy_decode_fused"]) != (
                        1, cfg.listener.num_layers, 0 if beam else 1):
                    bad.append(f"{name} {mode} beam {beam}: launches")
            out[mode] = heads
            del card_t, cpu_t
        rec[name] = out
    rec["card"] = card
    emit(rec)
    if bad:
        fail(f"phase 13b: serving at the width flags failed in {bad}")
    return summed(launches), summed(routes)


def summed(counts: list) -> dict:
    """Counts of several runs (dicts of the same keys), added key by key."""
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def train_widths(work, kernels, card, name="W1024", modes=("parity", "production"), b=WIDTH_TRAIN_B,
                 samples=WIDTH_TRAIN_SAMPLES, phase="13c", beside=None) -> tuple:
    """Phase 13c (library): one ``Trainer.train_step`` of W1024 at B = 8 ×
    <= 4 s (13d: of W2048 in production at B = 4 × <= 2 s), dropout and
    sampling off, card against the CPU plain path: the loss within 1e-5 relative in parity,
    1e-4 in production (TF32 on the card only), every term finite, the
    residual and VJP kernels once a listener layer, past U = 1024 both
    through their grid layouts in either mode; for W1024 then, as readings,
    a warm step timed in its parts (``split_step``) and one more backward
    profiled (``vjp_share``: the VJP's kernels' device ms in it), and
    whether the process ``beside`` (13c's ``cli.train``) was still running
    on the card then → the card's launches and route counts summed."""
    from phones_las_torch.train.loop import Trainer

    device = None if DEV == "cuda" else DEV
    flags = {**WIDTH_FLAGS, "W2048": W2048_FLAGS}[name]
    preset, _, params, _, _, codes = preset_model(WIDTH_PRESET, work, "cpu", seed=WIDTH_SEED, dropout=0.0,
                                                  sampling_probability=0.0, **flags)
    cfg, n_layers = preset.model, preset.model.listener.num_layers
    batch = preset_train_batch(preset, b, samples, WIDTH_TRAIN_TARGET, 190, "cpu")
    rec = {"phase": phase, "config": name, "batch": b, "samples": samples}
    bad, launches, routes = [], [], []
    for mode in modes:
        c = cfg if mode == "parity" else production_cfg(cfg)
        runs = {}
        for side, dev in (("card", device), ("cpu", "cpu")):
            tr = Trainer(c, preset.train, binf_codes=codes, device=dev)
            tr.warm_start(params)
            if side == "card":
                reset_counters(kernels)
            t0 = time.perf_counter()
            o = tr.train_step(batch)
            runs[side] = {k: float(v) for k, v in o.items() if k.endswith("loss")}
            if side == "card":
                torch.cuda.synchronize()
                runs["card_step_ms"] = (time.perf_counter() - t0) * 1e3
                launches.append(launch_counts(kernels))
                routes.append(route_counts(kernels))
                if name == "W1024":  # readings of warm steps after the held one
                    runs["warm_step_split_ms"] = split_step(tr, batch)
                    runs["warm_backward"] = vjp_share(tr, batch)
                    runs["cli_train_running_beside"] = beside is not None and beside.poll() is None
            del tr
        tol = LOSS_TOL if mode == "parity" else PROD_LOSS_TOL
        err = abs(runs["card"]["loss"] - runs["cpu"]["loss"]) / abs(runs["cpu"]["loss"])
        rec[mode] = {**runs, "loss_rel_err": err, "tol": tol, "launches": launches[-1], "routes": routes[-1]}
        la, ro = launches[-1], routes[-1]
        if err > tol or not np.isfinite(list(runs["card"].values()) + list(runs["cpu"].values())).all():
            bad.append(f"{mode}: loss")
        if DEV == "cuda" and (la["fused_logmel"], la["recurrence_residual"], la["recurrence_bwd"]) != (
                1, n_layers, n_layers):
            bad.append(f"{mode}: launches")
        grid = "bf16_grid" if mode == "production" else "grid"
        if DEV == "cuda" and cfg.listener.units > 1024 and (
                ro[f"recurrence_residual {grid}"], ro[f"recurrence_bwd {grid}"]) != (n_layers, n_layers):
            bad.append(f"{mode}: the {grid} routes")
    rec["card"] = card
    emit(rec)
    if bad:
        fail(f"phase {phase}: the {name} training step disagrees with the CPU: {bad}")
    return summed(launches), summed(routes)


def start_width_train(work, data, prepare, started):
    """13c's CLI run: once the ``prepare`` process has written ``data``,
    ``cli.train`` at the W1024 flags (2 steps and an eval) started as a
    process beside 13b and 13c's library step (appended to ``started``) →
    (its workdir, the ``Popen``, its start time)."""
    run = os.path.join(work, "w1024_run")
    t0 = time.perf_counter()
    finish(prepare, "prepare")
    proc = cli("train", "--preset", WIDTH_PRESET, "--data", data, "--workdir", run, "--num-steps",
               str(WIDTH_CLI_STEPS), "--eval-every", str(WIDTH_CLI_STEPS), "--batch-size", str(WIDTH_TRAIN_B),
               *width_flags_argv("W1024"), started=started)
    return run, proc, t0


def check_width_clis(data, run, train, t0, card) -> None:
    """Phase 13c (CLIs): the ``cli.train`` process at the W1024 flags
    finishes, then ``cli.infer`` of its workdir: the footer counts every
    held-out utterance."""
    from phones_las_torch.data.records import RecordReader

    train_out = finish(train, "train")
    infer_out = cli("infer", "--workdir", run, "--data", os.path.join(data, "test.plu"), "--beam-width", "0").stdout
    n, _, _ = per_footer(infer_out)
    held = len(list(RecordReader(os.path.join(data, "test.plu"))))
    evals = [line for line in train_out.splitlines() if "'tag': 'eval'" in line or line.startswith("final eval")]
    rec = {"phase": "13c", "what": "cli.train then cli.infer at the W1024 flags", "flags": width_flags_argv("W1024"),
           "steps": WIDTH_CLI_STEPS, "eval_lines": evals[-2:], "infer_footer": infer_out.strip().splitlines()[-1:],
           "seconds_since_train_started": time.perf_counter() - t0, "card": card}
    emit(rec)
    if not evals or n != held:
        fail(f"phase 13c: the CLIs at the W1024 flags failed: {rec}")


def check_long_decodes(kernels) -> tuple:
    """Phase 13d (1): the decoder kernel past its old limits, through
    ``greedy_decode`` on the card at B = 8, 60 steps, ragged: the
    checkpoint's speller at T_enc = 17,100 and 40,000 (fault C9), W1024's
    at 5,900 and U = A = AL = 2048 with M = 4096 (fault C11), each one
    launch of the kernel in its grid layout (never the loop), tokens equal
    to the CPU loop's (``greedy_decode_steps``, parity) on the same weights
    and memory (but the widest); each timed against its plain version on
    the card (``check_greedy``) → (the launches, the route counts, the
    record at T_enc = 40,000)."""
    import copy

    from phones_las_torch.decode.greedy import greedy_decode, greedy_decode_steps
    from phones_las_torch.models.speller import SpellerConfig, init_speller
    from phones_las_torch.ops.masking import length_mask

    launches, routes, timed = [], [], None
    for i, (label, t, u, a, al, m, against_cpu) in enumerate(LONG_DECODES):
        sc = SpellerConfig(vocab_size=PRESET_VOCAB[WIDTH_PRESET], embedding_dim=128, num_layers=2, units=u,
                           memory_dim=m, attention_units=a, attention_layer_size=al)
        sp = init_speller(sc, torch.Generator().manual_seed(WIDTH_SEED + 10 + i), device=DEV)
        g = torch.Generator(device=DEV).manual_seed(220 + i)
        memory = torch.randn(LONG_B, t, m, generator=g, device=DEV)
        lens = torch.randint(t // 4, t + 1, (LONG_B,), generator=g, device=DEV)
        lens[0] = t
        mask = length_mask(lens, t)
        reset_counters(kernels)
        t0 = time.perf_counter()
        tok, _, _ = greedy_decode(sp, sc, memory, mask, LONG_STEPS)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        launches.append(launch_counts(kernels))
        routes.append(route_counts(kernels))
        rows = []
        if against_cpu:
            cpu_tok, _, _ = greedy_decode_steps(copy.deepcopy(sp).cpu(), sc, memory.cpu(), mask.cpu(), LONG_STEPS)
            rows = [r for r in range(LONG_B) if not torch.equal(tok[r].cpu(), cpu_tok[r])]
        rec = check_greedy(SimpleNamespace(speller=sp), SimpleNamespace(speller=sc), memory, mask, LONG_B,
                           steps=LONG_STEPS, phase="13d", what=f"{label}, T_enc {t}, ragged")
        out = {"phase": "13d", "what": f"greedy_decode on the card against the CPU loop: {label}, T_enc {t}",
               "against_cpu_loop": against_cpu, "rows_differing_from_cpu_loop": rows, "first_call_ms": first_ms,
               "launches": launches[-1],
               "routes": routes[-1], "tokens_emitted": int((tok != sc.eos_id).sum())}
        emit(out)
        if rows or DEV == "cuda" and (launches[-1]["greedy_decode_fused"], routes[-1]["greedy_decode_fused grid"]) != (
                1, 1):
            fail(f"phase 13d: the decoder kernel past its old limits failed: {out}")
        if t == 40000:
            timed = rec
        del sp, memory
    return summed(launches), summed(routes), timed


def check_long_transcriber(kernels, card, artifacts) -> tuple:
    """Phase 13d (2): one ``Transcriber.transcribe`` of 690 s of speech-like
    PCM (the eval set's utterances end to end, repeated) on the card, at
    the checkpoint's widths (random init): its encoder length past what
    the held layout holds (fault C9), so the decoder kernel takes the grid
    layout; its tokens equal to the CPU loop's (``greedy_decode_steps``) on
    the card's own encoder memory, copied over → (launches, route counts)."""
    from phones_las_torch import Transcriber
    from phones_las_torch.decode.greedy import greedy_decode_steps
    from phones_las_torch.models.las import encode
    from phones_las_torch.utils.device import matmul_precision_scope

    art = artifacts.get("width_checkpoint_parity", lambda path: write_width_artifact(path, "checkpoint", "parity"))
    data = np.load(os.path.join(ASSETS, "eval_set.npz"), allow_pickle=False)
    speech = np.concatenate([data["audio"][i, :k] for i, k in enumerate(data["lengths"])])
    n = LONG_SECONDS * SAMPLE_RATE
    pcm = np.clip(np.rint(np.resize(speech, n)), -32768, 32767).astype(np.int16)
    card_t = Transcriber.from_artifact(art, device=None if DEV == "cuda" else DEV)
    cpu_t = Transcriber.from_artifact(art, device="cpu")
    reset_counters(kernels)
    t0 = time.perf_counter()
    got = card_t.transcribe(pcm)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    la, ro = launch_counts(kernels), route_counts(kernels)
    with torch.no_grad(), matmul_precision_scope(card_t.model_cfg.matmul_precision):
        memory, _, enc_mask = encode(card_t.params, card_t.model_cfg, torch.from_numpy(pcm[None]).to(DEV),
                                     torch.tensor([n], dtype=torch.int32, device=DEV), prec=card_t.prec)
    tok, lens, _ = greedy_decode_steps(cpu_t.params.speller, cpu_t.speller_cfg, memory.cpu(), enc_mask.cpu(),
                                       card_t.max_steps, prec=cpu_t.prec)
    want = cpu_t.vocab.decode(tok[0][: int(lens[0])].numpy())
    rec = {"phase": "13d", "what": "Transcriber.transcribe of 690 s on the card against the CPU loop on its memory",
           "seconds_of_audio": LONG_SECONDS, "encoder_length": int(memory.shape[1]), "cap": card_t.max_steps,
           "tokens": len(got), "equal": got == want, "ms": sec * 1e3, "launches": la, "routes": ro, "card": card}
    emit(rec)
    if got != want or DEV == "cuda" and (la["fused_logmel"], la["greedy_decode_fused"],
                                         ro["greedy_decode_fused grid"]) != (1, 1, 1):
        fail(f"phase 13d: the 690 s Transcriber call failed: {rec}")
    return la, ro


def serve_w2048(kernels, card, artifacts) -> tuple:
    """Phase 13d (3): W2048 (encoder, decoder and attention units 2048,
    one listener layer, M = 4096; random init) through
    ``Transcriber.from_artifact`` greedy at 8 × <= 2 s, card against the
    CPU in parity: 0 rows differing, the listener through the float32 ring
    and the decoder in its grid layout → (launches, route counts)."""
    from phones_las_torch import Transcriber

    art = artifacts.get("width_W2048_parity", lambda path: write_width_artifact(path, "W2048", "parity"))
    audio, lens = preset_pcm(W2048_ROWS, W2048_SAMPLES, 230, ragged=True)
    rows = [audio[i, :k].astype(np.int16) for i, k in enumerate(lens)]
    card_t = Transcriber.from_artifact(art, device=None if DEV == "cuda" else DEV)
    reset_counters(kernels)
    t0 = time.perf_counter()
    got = card_t.transcribe_batch(rows)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    la, ro = launch_counts(kernels), route_counts(kernels)
    del card_t
    want = Transcriber.from_artifact(art, device="cpu").transcribe_batch(rows)
    differ = [i for i, (x, y) in enumerate(zip(got, want)) if x != y]
    rec = {"phase": "13d", "what": "W2048 served greedy, card against the CPU (parity)", "flags": W2048_FLAGS,
           "rows": W2048_ROWS, "samples": W2048_SAMPLES, "rows_differing": differ, "lengths": [len(x) for x in got],
           "first_call_ms": ms, "launches": la, "routes": ro, "card": card}
    emit(rec)
    if differ or DEV == "cuda" and (la["bidir_recurrence"], ro["bidir_recurrence grid"], la["greedy_decode_fused"],
                                    ro["greedy_decode_fused grid"]) != (1, 1, 1, 1):
        fail(f"phase 13d: W2048 serving failed: {rec}")
    return la, ro


def check_widths(kernels, card, artifacts) -> dict:
    """Phase 13, in a temporary directory under ``_runs/`` removed at the
    end → {"launches", "routes": the card's launches and route counts of
    13b–13d's model runs summed, "records": the timed records of the wide
    routes (13a's listener kernels at U = 1024 in each mode, the decoder's
    grid layout at W1024)}. 13c's records are prepared by a process that runs
    beside 13a, and its ``cli.train`` beside 13b and 13c's library step;
    every process it starts is stopped."""
    import shutil
    import tempfile

    os.makedirs(os.path.join(REPO, "_runs"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_widths_", dir=os.path.join(REPO, "_runs"))
    started = []
    try:
        data = os.path.join(work, "data")
        cli("prepare", "speechlike", "--out", data, "--n-utts", str(WIDTH_CLI_UTTS), "--seed", str(DATA_TRAIN_SEED),
            started=started)
        kern = check_width_kernels(work)
        run, train, t0 = start_width_train(work, data, started[0], started)
        parts = [serve_widths(work, kernels, card, artifacts)]
        with torch.enable_grad():
            parts.append(train_widths(work, kernels, card, beside=train))
            parts.append(drive_wide_lstm_layer(kernels))
        check_width_clis(data, run, train, t0, card)
        # ---- 13d: past the old limits: long encoder sequences, U = 2048
        *dec, long_rec = check_long_decodes(kernels)
        parts += [tuple(dec), check_long_transcriber(kernels, card, artifacts), serve_w2048(kernels, card, artifacts)]
        with torch.enable_grad():
            parts.append(train_widths(work, kernels, card, "W2048", ("production",), W2048_TRAIN_B, W2048_TRAIN_SAMPLES,
                                      "13d"))
    finally:
        for p in started:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        shutil.rmtree(work, ignore_errors=True)
    u1024 = {prec: next(r for r in kern["timed"] if r["u"] == 1024 and r["prec"] == prec)
             for prec in ("highest", "bf16")}
    return {"launches": summed([p[0] for p in parts]), "routes": summed([p[1] for p in parts]),
            "records": {"u1024": u1024, "bidir_bf16_rows": kern["bidir_bf16_rows"], "grid": kern["decoders"][0],
                        "long": long_rec}}


def drive_wide_lstm_layer(kernels) -> tuple:
    """Phase 13c: the ops API's ``lstm_layer`` at W1024's width (U = 1024,
    a pyramid layer's 2048-wide input, B = 8, T = 250) in both modes:
    without grad (the ``recurrence`` kernel, each direction; in parity
    against the CPU plain path within 1e-5) and under grad (residual and
    VJP, one direction; finite); then ``bilstm_layer`` at B = 64 in bf16
    without grad (the BiLSTM on wgmma; finite) → the card's launches and
    route counts."""
    from phones_las_torch.ops.lstm import bilstm_layer, init_lstm_params, lstm_layer

    u, d, b, t = 1024, 2048, 8, 250
    rs = np.random.RandomState(WIDTH_SEED)
    x_cpu = torch.from_numpy(rs.randn(b, t, d).astype(np.float32))
    lens_cpu = torch.from_numpy(rs.randint(t // 2, t + 1, b))
    p_cpu = init_lstm_params(d, u, torch.Generator().manual_seed(WIDTH_SEED))
    p = init_lstm_params(d, u, torch.Generator().manual_seed(WIDTH_SEED), device=DEV)
    x, lens = x_cpu.to(DEV), lens_cpu.to(DEV)
    reset_counters(kernels)
    rec, finite = {"phase": "13c", "shape": f"lstm_layer B={b} T={t} D={d} U={u}"}, True
    for prec in ("highest", "bf16"):
        with torch.no_grad():
            outs = [lstm_layer(p, x, lens, reverse=rev, prec=prec)[0] for rev in (False, True)]
        xg = x.clone().requires_grad_(True)
        out, (h, c) = lstm_layer(p, xg, lens, reverse=True, prec=prec)
        (out.square().sum() + h.sum() + c.sum()).backward()
        torch.cuda.synchronize()
        finite = finite and all(bool(torch.isfinite(v).all()) for v in (*outs, out, xg.grad))
        if prec == "highest":
            with torch.no_grad():
                want = [lstm_layer(p_cpu, x_cpu, lens_cpu, reverse=rev)[0] for rev in (False, True)]
            rec["max_abs_err_no_grad"], _, ok = compare([o.cpu() for o in outs], want, 1e-5, 1e-5)
            finite = finite and ok
    # the BiLSTM at the flagship batch in bf16, the shape the bf16 plan takes to wgmma
    pb = init_lstm_params(d, u, torch.Generator().manual_seed(WIDTH_SEED + 1), device=DEV)
    xb = torch.from_numpy(rs.randn(FLAGSHIP_B, t, d).astype(np.float32)).to(DEV)
    lens_b = torch.from_numpy(rs.randint(t // 2, t + 1, FLAGSHIP_B)).to(DEV)
    with torch.no_grad():
        out_b, _ = bilstm_layer(p, pb, xb, lens_b, prec="bf16")
    torch.cuda.synchronize()
    finite = finite and bool(torch.isfinite(out_b).all())
    rec["bilstm_layer"] = f"B={FLAGSHIP_B} T={t} D={d} U={u} prec=bf16"
    launches, routes = launch_counts(kernels), route_counts(kernels)
    rec.update(ok=finite, launches=launches, routes=routes)
    emit(rec)
    if (not finite or launches["recurrence"] != 4 or routes["recurrence grid"] != 4
            or routes["bidir_recurrence wgmma_grid"] != 1):
        fail(f"phase 13c: lstm_layer at W1024's width did not run its kernels as expected: {rec}")
    return launches, routes


# ---- phase 14: the reference's entry points as the port's: the bench, entry(), the tools

BENCH_TIMEOUT = 900  # the bench process, its worker's rows included
SERVE_KERNELS = ("fused_logmel", "bidir_recurrence", "greedy_decode_fused")
TRAIN_KERNELS = ("recurrence", "recurrence_residual", "recurrence_bwd")
# the kernels each bench row must launch; a row launches no other
BENCH_ROW_KERNELS = {
    "parity": SERVE_KERNELS, "production": SERVE_KERNELS, "accuracy": SERVE_KERNELS,
    "beam8_parity": SERVE_KERNELS[:2], "beam8_production": SERVE_KERNELS[:2],
    "beam8_ctcjoint_production": SERVE_KERNELS[:2], "beam8_luong_production": SERVE_KERNELS[:2],
    "train_parity": ("fused_logmel", "recurrence_residual", "recurrence_bwd"),
    "train_production": ("fused_logmel", "recurrence_residual", "recurrence_bwd"),
}
# every key bench.py's rows and summary write, beside the card's
BENCH_KEYS = ("value", "vs_baseline", "value_parity", "rtf_x_parity", "value_production", "rtf_x_production",
              "value_beam8_parity", "value_beam8_production", "value_beam8_ctcjoint_production",
              "value_beam8_luong_production", "value_train_step_ms_parity", "value_train_step_ms_production",
              "bench_per_greedy", "bench_per_beam8", "cpu_baseline_utt_per_s", "vs_baseline_production",
              "mfu_production", "mfu_parity", "mfu_beam8_production", "mfu_train_production", "mfu_train_parity",
              "card", "power_limit")


def run_bench(card) -> dict:
    """Phase 14a: ``python -m phones_las_torch.bench`` as a process, as a
    user runs it, at the reference's shapes but every row once (its own
    ``PLU_BENCH_PREWARM``: the depth cut to keep this script in its time
    limit; its worker reuses the kernels built in phase 0) → the launches
    of its rows, summed. Its progress lines go to this script's stderr."""
    import signal

    from phones_las_torch.bench import ROW_ORDER

    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for key in ("PLU_BENCH_TINY", "PLU_BENCH_ASSETS_DIR", "PLU_BENCH_FORCE_FAIL"):
        env.pop(key, None)
    env["PLU_BENCH_PREWARM"] = "1"
    t0 = time.perf_counter()
    # a process group of its own, so that a timeout stops its worker too
    proc = subprocess.Popen([sys.executable, "-m", "phones_las_torch.bench"], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, text=True, start_new_session=True)
    try:
        stdout, _ = proc.communicate(timeout=BENCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"the bench did not finish in {BENCH_TIMEOUT} s")
    seconds = time.perf_counter() - t0
    lines = stdout.strip().splitlines()
    if proc.returncode != 0 or len(lines) != 1:
        fail(f"the bench exited {proc.returncode} or printed {len(lines)} lines, not one: {stdout[-3000:]}")
    out = json.loads(lines[0])
    emit({"phase": "14a", "command": "python -m phones_las_torch.bench", "seconds": seconds, "bench": out,
          "card": card})
    if out.get("errors"):
        fail(f"the bench reported errors: {out['errors']}")
    missing = [k for k in BENCH_KEYS if out.get(k) is None] + [r for r in ROW_ORDER if r not in out["launches"]]
    if missing:
        fail(f"the bench's JSON lacks {missing}")
    for key in ("bench_per_greedy", "bench_per_beam8"):
        if abs(out[key] - REF_GREEDY_PER) > PER_TOL:  # greedy and beam-8 alike (phases 2 and 5a)
            fail(f"the bench's {key} {out[key]} is not within {PER_TOL} of {REF_GREEDY_PER}")
    bad = [k for k, v in out.items() if k.startswith(("value", "mfu")) and not (np.isfinite(v) and v > 0)]
    if bad:
        fail(f"the bench's {bad} are not finite and positive")
    if out["card"] not in card:
        fail(f"the bench names the card {out['card']!r}, nvidia-smi says {card!r}")
    for row, want in BENCH_ROW_KERNELS.items():
        got = out["launches"][row]
        if set(got) != set(want):
            fail(f"the bench's {row} row launched {got}, not each of {want}")
    steps = [out[f"greedy_steps_run_{m}"] for m in ("parity", "production")]
    if steps != [DECODE_STEPS, DECODE_STEPS]:
        print(f"chip_smoke: the random init ended the greedy rows after {steps} of {DECODE_STEPS} steps",
              file=sys.stderr, flush=True)
    totals = {fn: 0 for fn in SERVE_KERNELS + TRAIN_KERNELS}
    for row in out["launches"].values():
        for fn, n in row.items():
            totals[fn] += n
    return totals


def check_entry(kernels) -> dict:
    """Phase 14b: ``entry()``'s forward on the card (4 × 4 s, 100 greedy
    steps, parity) against the same forward on the CPU plain path, on the
    card's weights → its launches."""
    import copy

    from phones_las_torch.entry import entry

    fn, (params, audio, lengths) = entry()
    reset_counters(kernels)
    t0 = time.perf_counter()
    tokens, lens = fn(params, audio, lengths)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts(kernels)
    cpu_tokens, cpu_lens = fn(copy.deepcopy(params).to("cpu"), audio.cpu(), lengths.cpu())
    tokens, lens = tokens.cpu(), lens.cpu()
    differing = [i for i in range(len(tokens)) if not torch.equal(tokens[i], cpu_tokens[i])]
    rec = {"phase": "14b", "entry": "phones_las_torch.entry.entry()", "shape": list(tokens.shape), "ms": ms,
           "lengths": lens.tolist(), "rows_differing_from_cpu_plain": differing, "launches": launches}
    emit(rec)
    if differing or not torch.equal(lens, cpu_lens) or tuple(tokens.shape) != (4, 100):
        fail(f"entry() on the card disagrees with the CPU plain path: {rec}")
    if [launches[n] for n in SERVE_KERNELS] != [1, 3, 1] or any(launches[n] for n in TRAIN_KERNELS):
        fail(f"entry() did not launch the serving kernels once (the BiLSTM once a layer): {launches}")
    return launches


def check_bench_assets(tuned, kernels) -> dict:
    """Phase 14c: ``tools.make_bench_assets`` on phase 7's fine-tuned run
    (its held-out split), then the bench's accuracy row on those assets
    (``PLU_BENCH_ASSETS_DIR``) in this process → its launches. The
    greedy PER is held to phase 7c's held-out eval of the same params."""
    import contextlib
    import io

    from phones_las_torch import bench
    from phones_las_torch.tools import make_bench_assets
    from phones_las_torch.train.checkpoint import CheckpointManager
    from phones_las_torch.utils.param_io import load_params_npz, named_leaves

    out = os.path.join(tuned.work, "bench_assets")
    said = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(said):
        make_bench_assets.main(["--workdir", tuned.run, "--out", out, "--n-utts", "64",
                                "--split", os.path.relpath(tuned.held, tuned.data_dir)])
    assets_s = time.perf_counter() - t0
    saved, _ = CheckpointManager(tuned.run).read()
    params, _ = load_params_npz(os.path.join(out, "ckpt.npz"), device="cpu")
    same = all(np.array_equal(t.numpy(), saved[k]) for k, t in named_leaves(params))
    os.environ["PLU_BENCH_ASSETS_DIR"] = out
    try:
        reset_counters(kernels)
        t0 = time.perf_counter()
        fields = bench.bench_accuracy()
        torch.cuda.synchronize()
        row_s = time.perf_counter() - t0
        launches = launch_counts(kernels)
    finally:
        del os.environ["PLU_BENCH_ASSETS_DIR"]
    rec = {"phase": "14c", "tool": said.getvalue().strip(), "assets_s": assets_s, "ckpt_equals_checkpoint": same,
           "accuracy_row": fields, "accuracy_row_s": row_s, "phase_7c_eval_per": tuned.eval_per, "tol": PER_TOL,
           "launches": launches}
    emit(rec)
    if not same or not fields or abs(fields["bench_per_greedy"] - tuned.eval_per) > PER_TOL:
        fail(f"the bench assets of the fine-tuned run, or their accuracy row, disagree with phase 7: {rec}")
    if not np.isfinite(fields["bench_per_beam8"]) or [launches[n] for n in SERVE_KERNELS] != [1, 3, 1]:
        fail(f"the accuracy row did not run greedy and beam-8 through the serving kernels: {rec}")
    return launches


def check_entry_points(tuned, kernels, card) -> dict:
    """Phase 14 → the launches of its paths, summed (the bench's rows as
    its process reports them)."""
    parts = [run_bench(card), check_entry(kernels), check_bench_assets(tuned, kernels)]
    return {k: sum(p[k] for p in parts) for k in parts[0]}


def reset_counters(kernels) -> None:
    for fn in kernels:
        for c in COUNTERS:
            if hasattr(fn, c):
                setattr(fn, c, 0)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--compare"]:
        return compare_trees(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["--time-kernels"]:
        time_kernels(sys.argv[2], sys.argv[3:] == ["decoder"])
        return 0
    sys.path.insert(0, REPO)
    if sys.argv[1:2] == ["--bf16-routes"]:
        bf16_routes()
        return 0
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank(sys.argv[2], int(sys.argv[3]))
    from phones_las_torch.csrc import _build
    from phones_las_torch.decode.fused_greedy import greedy_decode_fused
    from phones_las_torch.decode.greedy import greedy_decode
    from phones_las_torch.frontend.fused_frontend import fused_logmel
    from phones_las_torch.models.las import encode, featurize
    from phones_las_torch.models.listener import listen
    from phones_las_torch.ops.lstm import (bidir_recurrence, forward_plan, recurrence, recurrence_bwd,
                                           recurrence_residual)
    from phones_las_torch.ops.masking import length_mask
    from phones_las_torch.utils.device import set_parity_mode
    from phones_las_torch.utils.metrics import edit_distance_stats, per_from_stats
    from phones_las_torch.utils.param_io import load_artifact

    serve_kernels = (fused_logmel, bidir_recurrence, greedy_decode_fused)
    train_kernels = (recurrence, recurrence_residual, recurrence_bwd)
    kernels = serve_kernels + train_kernels
    serving_ran_only_its_kernels = lambda la: (
        all(la[fn.__name__] for fn in serve_kernels) and not any(la[fn.__name__] for fn in train_kernels)
    )
    card = card_line()
    _build.library()
    emit({
        "phase": 0, "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "parity_mode": set_parity_mode(), "build_seconds": _build.last_build_seconds,
    })
    print((_build.BUILD_DIR / "build.log").read_text() if (_build.BUILD_DIR / "build.log").exists() else "",
          file=sys.stderr, flush=True)
    torch.set_grad_enabled(False)

    ckpt = os.path.join(ASSETS, "ckpt.npz")
    params, cfg, _ = load_artifact(ckpt, device=None if DEV == "cuda" else DEV)
    if sys.argv[1:] == ["--sweep"]:
        sweep_forward_plans(params)
        sweep_backward_plans(params)
        sweep_streamed_plans()
        print(card, flush=True)
        return 0
    if sys.argv[1:2] == ["--sweep-decoder"]:
        audio64 = torch.from_numpy(make_audio(FLAGSHIP_B)).to(DEV)
        memory, _, enc_mask = encode(params, cfg, audio64, torch.full((FLAGSHIP_B,), audio64.shape[1],
                                                                       dtype=torch.int32, device=DEV))
        sweep_decoder(params, cfg, memory.contiguous(), enc_mask.contiguous(), tuple(sys.argv[2:]))
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--sweep-forward"]:
        sweep_grid_forward()
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--sweep-vjp"]:
        sweep_grid_vjp()
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--presets"]:
        audio64 = torch.from_numpy(make_audio(FLAGSHIP_B)).to(DEV)
        memory, _, enc_mask = encode(params, cfg, audio64, torch.full((FLAGSHIP_B,), audio64.shape[1],
                                                                       dtype=torch.int32, device=DEV))
        artifacts = Prewritten()
        try:
            check_presets(cfg, check_greedy(params, cfg, memory, enc_mask, FLAGSHIP_B), kernels, card, artifacts)
        finally:
            artifacts.close()
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--widths"]:
        artifacts = Prewritten()
        try:
            check_widths(kernels, card, artifacts)
        finally:
            artifacts.close()
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--bench"]:
        tuned = check_data_layer(ckpt, cfg, kernels)
        try:
            check_entry_points(tuned, kernels, card)
        finally:
            shutil.rmtree(tuned.work, ignore_errors=True)
        print(card, flush=True)
        return 0

    # ---- phase 1: each kernel against its plain version, at main-path shapes
    audio64 = torch.from_numpy(make_audio(FLAGSHIP_B)).to(DEV)
    full_len = torch.full((FLAGSHIP_B,), audio64.shape[1], dtype=torch.int32, device=DEV)
    fe_rec = check_frontend(cfg.frontend, audio64)
    data = np.load(os.path.join(ASSETS, "eval_set.npz"), allow_pickle=False)
    check_frontend(cfg.frontend, torch.from_numpy(data["audio"]).to(DEV), "the eval set")
    # a window of 401 samples (padded to 416 rows) under a hop of 161: the
    # frames' samples are not 8-byte aligned in the staged window
    odd = dataclasses.replace(cfg.frontend, win_ms=25.0625, hop_ms=10.0625, window="hamming")
    check_frontend(odd, audio64[:3, :20000], "odd window and hop")
    # longer transforms, whose power tile leaves room for fewer frames a block
    for nfft, tile in ((1024, 32), (2048, 16)):
        long_fft = dataclasses.replace(cfg.frontend, nfft=nfft, win_ms=40.0)
        rec = check_frontend(long_fft, audio64[:3, :40000], f"nfft {nfft}")
        if rec["frame_tile"] != tile:
            fail(f"the front-end kernel took an unexpected frame tile at nfft {nfft}: {rec}")
    lstm_recs = [
        check_bilstm(params, FLAGSHIP_B, t, layer, prec, seed=10 + i)
        for i, (t, layer, prec) in enumerate(LSTM_CASES)
    ]
    for i, (t, b, u) in enumerate(RAGGED_LSTM):
        check_lstm_ragged(t, b, u, seed=40 + i)
    check_lstm_ragged(*GATE_LSTM, seed=45)
    memory, _, enc_mask = encode(params, cfg, audio64, full_len)
    dec_recs = [check_greedy(params, cfg, memory, enc_mask, b) for b in DECODER_BATCHES]
    check_decoder_layouts(params, cfg, memory, enc_mask, card)

    # ---- phase 2: the committed checkpoint on the committed eval set
    cap = int(data["decode_cap"][0])
    refs = data["refs"]
    ref_lens = (refs >= 0).sum(axis=1)
    ref_ids = np.where(refs >= 0, refs, 0)

    def decode_eval(p, device):
        audio = torch.from_numpy(data["audio"]).to(device)
        lens = torch.from_numpy(data["lengths"]).to(device)
        mem, _, mask = encode(p, cfg, audio, lens)
        tok, tl, _ = greedy_decode(p.speller, cfg.speller, mem, mask, cap)
        return tok.cpu().numpy(), tl.cpu().numpy()

    reset_counters(kernels)
    tok_gpu, len_gpu = decode_eval(params, DEV)
    torch.cuda.synchronize()
    launches = launch_counts(kernels)
    params_cpu, _, _ = load_artifact(ckpt, device="cpu")
    tok_cpu, _ = decode_eval(params_cpu, "cpu")
    diff = [
        {"row": i, "first_step": int(np.nonzero(tok_gpu[i] != tok_cpu[i])[0][0])}
        for i in range(len(tok_gpu)) if (tok_gpu[i] != tok_cpu[i]).any()
    ]
    per = per_from_stats(*edit_distance_stats(tok_gpu, len_gpu, ref_ids, ref_lens))
    emit({
        "phase": 2, "utterances": len(tok_gpu), "decode_cap": cap, "greedy_per": per,
        "reference_per": REF_GREEDY_PER, "rows_differing_from_cpu_plain": diff,
        "launches": launches,
    })
    if len(diff) > MAX_DIFF_ROWS:
        fail(f"{len(diff)} token rows differ from the CPU plain path (at most {MAX_DIFF_ROWS})")
    if abs(per - REF_GREEDY_PER) > PER_TOL:
        fail(f"greedy PER {per} is not within {PER_TOL} of {REF_GREEDY_PER}")
    if not serving_ran_only_its_kernels(launches):
        fail(f"a kernel of the main path never launched, or a training kernel did: {launches}")

    # ---- phase 3: the flagship shape, 64 × 10 s, 200 greedy steps
    def flagship():
        t0 = time.perf_counter()
        feats, flens = featurize(params, cfg, audio64, full_len)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mem, enc_lens = listen(params.listener, cfg.listener, feats, flens)
        mask = length_mask(enc_lens, mem.shape[1])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        tok, _, _ = greedy_decode(params.speller, cfg.speller, mem, mask, DECODE_STEPS)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        return tok, (t1 - t0, t2 - t1, t3 - t2)

    reset_counters(kernels)
    tok3, _ = flagship()
    flag_launches = launch_counts(kernels)
    if not serving_ran_only_its_kernels(flag_launches):
        fail(f"a kernel of the main path never launched at the flagship shape, or a training kernel did: {flag_launches}")
    if tok3.shape != (FLAGSHIP_B, DECODE_STEPS):
        fail(f"flagship tokens have shape {tuple(tok3.shape)}")
    splits = [flagship()[1] for _ in range(5)]
    fe_s, li_s, de_s = (statistics.median(x) for x in zip(*splits))
    total = fe_s + li_s + de_s
    emit({
        "phase": 3, "shape": f"B={FLAGSHIP_B} x {SECONDS} s, {DECODE_STEPS} greedy steps",
        "utt_per_s": FLAGSHIP_B / total, "total_ms": total * 1e3, "frontend_ms": fe_s * 1e3,
        "listener_ms": li_s * 1e3, "decoder_ms": de_s * 1e3, "launches": flag_launches,
        "card": card,
    })

    # ---- phase 4: the training slice, under grad
    with torch.enable_grad():
        train_recs = [
            check_lstm_train(params.listener.layers[layer], t, prec, seed=20 + i)
            for i, (t, layer, prec) in enumerate(LSTM_CASES)
        ]
        for i, (t, b, u) in enumerate(RAGGED_LSTM):
            check_lstm_bwd_ragged(t, b, u, seed=70 + i)
        check_train_step(ckpt, data, kernels)
        _, train_launches = train_flagship(ckpt, kernels)
        api_launches = drive_lstm_layer(params, kernels)

    # ---- phase 5: beam search, joint CTC, and the artifact Transcriber
    check_beam_eval(params, params_cpu, cfg, data, kernels)
    time_beam_flagship(params, cfg, kernels, card)
    check_gate_transcriber(data, kernels)
    check_staging()

    # ---- phase 6: production mode, augmentation, checkpoints and the workdir Transcriber
    check_production_eval(params, params_cpu, cfg, data, kernels)
    serve_modes_in_turns(params, cfg, kernels, card)
    with torch.enable_grad():
        train_modes_in_turns(ckpt, kernels, card)
        train_gate_augmented(data, kernels)
        check_workdir(ckpt, data, kernels)

    # ---- phase 7: the data layer and fit over record files (its fine-tuned run kept for phase 14), with 8a's
    # records prepared beside it
    front_started = []
    front_work = start_front_prepare(front_started)
    try:
        tuned = check_data_layer(ckpt, cfg, kernels)
    except BaseException:
        stop(front_started)
        shutil.rmtree(front_work, ignore_errors=True)
        raise

    try:
        # ---- phase 8: the CLIs, the HTTP server and exported programs
        check_front_doors(ckpt, cfg, kernels, front_work, front_started)

        # the artifacts that phases 12b and 13b serve, written by a thread beside phases 9–11, and 12d's
        # records prepared beside them
        artifacts = Prewritten()
        artifacts.queue_served()
        preset_work, preset_started = make_preset_work(), []
        try:
            start_preset_prepare(preset_work, preset_started)
            # ---- phase 9: the seq2seq G2P at its widths: kernels, serving, training, corpus prep
            g2p_launches = check_g2p(kernels)

            # ---- phase 10: several devices: the sharded step, NCCL, data-parallel and replica serving
            mesh_launches = check_multi_device(ckpt, data, kernels)

            # ---- phase 11: degenerate rows and pad content through every serving and training kernel
            degen_launches = check_degenerate_serving(params, params_cpu, cfg, kernels, card)
            with torch.enable_grad():
                degen_train_launches = check_degenerate_training(ckpt, kernels, card)

            # ---- phase 12: the reference's five presets at their own widths: the decoder kernel, serving,
            # training, CLIs
            preset_launches = check_presets(cfg, dec_recs[-1], kernels, card, artifacts, preset_work, preset_started)

            # ---- phase 13: the reference's width flags: LAS-4-1024 and an odd width through every kernel
            widths = check_widths(kernels, card, artifacts)
            width_launches = widths["launches"]
        finally:
            stop(preset_started)
            shutil.rmtree(preset_work, ignore_errors=True)
            artifacts.close()

        # ---- phase 14: the reference's entry points: the bench's rows, entry(), the bench assets
        bench_launches = check_entry_points(tuned, kernels, card)
    finally:
        shutil.rmtree(tuned.work, ignore_errors=True)

    def kernel_entry(name, source, replaces, rec, n_launches):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_launches, "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        }

    emit({"phase": "end", "wall_s": round(time.perf_counter() - T0, 1)})
    lstm_cu = "phones_las_torch/csrc/lstm.cu"
    # each wide route a kernel of its own in the line: the listener's grid
    # layouts (the forward's, the VJP's loop's; U = 1024 at T = 999 as 13a
    # times them; the one-direction forward at B = 32) and the decoder's grid
    # layout (13a's W1024 at T_enc 219), with the launches phase 13's model
    # runs (13b–13d: W1024, W2048, the 690 s call; 13c's lstm_layer) made
    # through them
    wrec, wroutes = widths["records"], widths["routes"]
    route_entries = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for prec in ("highest", "bf16"):
        timed = wrec["u1024"][prec]
        for name, line, b, nd in (("bidir_recurrence", 269, FLAGSHIP_B, 2), ("recurrence", 164, TRAIN_B, 1),
                                  ("recurrence_residual", 485, TRAIN_B, 2), ("recurrence_bwd", 536, TRAIN_B, 2)):
            grid, replaces = wroutes[f"{name} bf16_grid"], f"phones_las_tpu/ops/lstm.py:{line}"
            if prec == "highest" or name == "recurrence_bwd":
                label = "float32" if prec == "highest" else "bf16, mma.sync"
                route_entries.append(kernel_entry(f"{name} (grid layout, {label}, U = 1024)", lstm_cu, replaces,
                                                  timed[name], grid if prec == "bf16" else wroutes[f"{name} grid"] - grid))
                continue
            # the bf16 forward's two kernels, each with the launches made through it: the route the plan takes at
            # each timed shape (the BiLSTM also at 13b's served rows)
            wgmma = wroutes[f"{name} wgmma_grid"]
            timed_at = [(timed[name], b)] + ([(wrec["bidir_bf16_rows"], WIDTH_ROWS)] if nd == 2 and b == FLAGSHIP_B
                                             else [])
            for rec, rows in timed_at:
                mma = forward_plan(rows, 1024, nd, prec, sms=sms).grid.mma
                route_entries.append(kernel_entry(
                    f"{name} (grid layout, bf16, {'mma.sync' if mma else 'wgmma'}, U = 1024, B = {rows})", lstm_cu,
                    replaces, rec, grid - wgmma if mma else wgmma))
    route_entries.append(kernel_entry("greedy_decode_fused (grid layout)", "phones_las_torch/csrc/greedy.cu",
                                      "phones_las_tpu/decode/pallas_greedy.py:134", wrec["grid"],
                                      wroutes["greedy_decode_fused grid"]))
    idle = [e["name"] for e in route_entries if e["launches"] < 1]
    if idle:
        fail(f"phase 13's model runs never launched these routes: {idle}")
    # launches: the main path's (phase 2 serving, 4c training; the
    # unidirectional primal runs on no model path, so the ops API's, 4d),
    # the G2P's (9b lookups, 9c training steps), phase 10's (the ranks'
    # sharded steps, the NCCL mesh step, a data-parallel call, the
    # replicated server), phase 11's (the degenerate batch served and
    # stepped on the card), phase 12's (the presets served, stepped and
    # driven through the CLIs in this process), phase 13's (W1024 and
    # W100 served, W1024 stepped) and phase 14's (the bench's rows as its
    # process reports them, entry() and the accuracy row on the fine-tuned
    # run's assets)
    main_path = {**launches, "recurrence": api_launches["recurrence"],
                 "recurrence_residual": train_launches["recurrence_residual"],
                 "recurrence_bwd": train_launches["recurrence_bwd"]}
    total = lambda name: (main_path[name] + g2p_launches[name] + mesh_launches[name] + degen_launches[name]
                          + degen_train_launches[name] + preset_launches[name] + width_launches[name]
                          + bench_launches[name])
    emit({"kernels": [
        kernel_entry("fused_logmel", "phones_las_torch/csrc/frontend.cu",
                     "phones_las_tpu/frontend/pallas_frontend.py:110", fe_rec, total("fused_logmel")),
        kernel_entry("bidir_recurrence", lstm_cu, "phones_las_tpu/ops/lstm.py:269", lstm_recs[0],
                     total("bidir_recurrence")),
        kernel_entry("greedy_decode_fused", "phones_las_torch/csrc/greedy.cu",
                     "phones_las_tpu/decode/pallas_greedy.py:134", dec_recs[-1], total("greedy_decode_fused")),
        kernel_entry("recurrence", lstm_cu, "phones_las_tpu/ops/lstm.py:164", train_recs[0][0], total("recurrence")),
        kernel_entry("recurrence_residual", lstm_cu, "phones_las_tpu/ops/lstm.py:485", train_recs[0][1],
                     total("recurrence_residual")),
        kernel_entry("recurrence_bwd", lstm_cu, "phones_las_tpu/ops/lstm.py:536", train_recs[0][2],
                     total("recurrence_bwd")),
        *route_entries,
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
