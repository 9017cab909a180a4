"""PyTorch/CUDA port of the paper's loop: a code generator emits a stencil
kernel, the §III analytic estimator ranks its launch configurations from the
address expressions alone, and the chosen configuration runs on an NVIDIA
H100.

Layout mirrors the JAX package ``repro``:

* ``core`` / ``frontend`` — the port's own copy of the GPU estimator;
* ``kernels/<name>/{ref,kernel,ops}.py`` — plain PyTorch version, CUDA
  wrapper, and the entry point with estimator-guided block selection;
* ``csrc/*.cu`` — the hand-written CUDA kernels, built by ``_build``.

The package imports torch and numpy only, never jax or ``repro``.
"""
