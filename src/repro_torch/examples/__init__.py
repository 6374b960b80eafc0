"""Runnable examples, the JAX package's ``examples/`` on the port: each is
``python -m repro_torch.examples.<name>`` (on the card; ``--device cpu``
runs the plain torch versions), and each ``main(argv)`` returns what it
printed for callers and tests.

  multiport_memory_demo  the paper's Figures 4 and 6: the clock generator's
                         waveform and a walk over 4-, 3-, 2- and 1-port
                         configurations on ``core.step``
  serve_multiport        the 4-port engine against ``--single-port`` (claim
                         C1: one pool traversal per steady decode step)
  quickstart             60 AdamW steps of reduced tinyllama on the chain task
  elastic_restart        a run that fails twice and recovers exactly
  train_100m             a ~100M-parameter model through the production loop
"""
