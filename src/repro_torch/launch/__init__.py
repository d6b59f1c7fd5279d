"""Entry points of the port: `train` (the HAPFL transformer training
driver, with --checkpoint) and `serve` (the long-running parameter
service). The XLA/TPU tooling of the reference's ``repro.launch`` is not
ported yet (ROADMAP §1 item 17)."""
