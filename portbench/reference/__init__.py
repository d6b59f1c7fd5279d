"""The benchmark's plain reference, in plain PyTorch and float32: no code of
the program."""
