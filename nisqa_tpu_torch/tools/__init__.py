"""Measurement tools of the port, each run as ``python -m nisqa_tpu_torch.tools.<name>``.

Counterparts of the JAX package's measurement tools (``bench.py`` and
``tools/`` at the repository root), rewritten for one CUDA card:

  * ``bench``       predict_dir throughput of NISQA_DIM (released weights)
                    in the cold, fetched, fetch-free and async regimes,
                    with the FLOP count and MFU of the cached pass;
  * ``bench_tts``   the same for the released NISQA-TTS model at its
                    checkpoint geometry (bs 8, seg_hop 1, 6,000 segments);
  * ``bench_de``    the same for NISQA_DE (``tests/goldens/de_trained.tar``)
                    over degraded / reference pairs;
  * ``bench_train`` train audio-s/s of NISQA from scratch over the bench
                    corpus, from the device-resident corpus;
  * ``flops``       the analytic FLOP count of a serving pass;
  * ``parity``      each released checkpoint's predictions over the
                    corpora against ``nisqa_tpu``'s, stored as numbers in
                    ``parity_ref.npz``, with the JAX drift gate's budgets
                    and its bound against a recorded run
                    (``parity_h100.json``);
  * ``corpus``      the seeded corpora the tools run over, and the
                    reference-format ``.tar`` of a golden's weights;
  * ``measure``     what the tools share: the device idle share from
                    ``torch.profiler``, the serving regimes, the peak rates.

Every tool runs on CUDA unless given ``--device cpu`` (it raises when there
is no card), prints one JSON record as the last line of its standard output
and its progress on standard error. None imports jax, pandas, yaml or
anything of ``nisqa_tpu``.
"""
