"""Entry points of the port: `train` (the HAPFL transformer training
driver, with --checkpoint) and `serve` (the long-running parameter
service); `mesh` (device meshes and process groups over
`torch.distributed`) and `axes` (the logical-axis rules and the current
mesh); the launch tooling: `specs` (meta-device step inputs), `sharding`
(the FSDP x TP rules and their placement), `dryrun` (each step's FLOPs,
bytes, kernel calls and collectives against the H100's roofline, counted
on the meta device), `hlo_analysis` (the collectives the port issues),
`roofline_fixup` (the inner-scan formulas, the dry run's cross-check) and
`validate` (the static pre-flight). docs/port.md says what each counts in
place of what XLA gave the reference's ``repro.launch``."""
