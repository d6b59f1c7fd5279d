"""Entry points of the port: `train` (the HAPFL transformer training
driver). ``launch/serve.py`` and the XLA/TPU tooling of the reference's
``repro.launch`` are not ported yet (ROADMAP §1 items 16 and 17)."""
