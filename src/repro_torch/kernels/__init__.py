"""The port's kernels: one package per TPU kernel of ``repro.kernels``."""
