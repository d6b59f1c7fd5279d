"""Entry points of the port: `train` (the HAPFL transformer training
driver, with --checkpoint) and `serve` (the long-running parameter
service); `mesh` (device meshes and process groups over
`torch.distributed`) and `axes` (the logical-axis rules and the current
mesh). The XLA/TPU tooling of the reference's ``repro.launch`` is not
ported yet (ROADMAP §1 item 17)."""
