"""Plain PyTorch references of the benchmark's model families.

They import nothing but ``torch`` and each other: no kernel, cache or
module of the program under test.
"""
