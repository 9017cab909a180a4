"""The paper's §III GPU estimator, as the port's own copy.

Every module here is a copy of the same-named module of ``repro.core`` with
only its relative imports and the parts the port does not use changed; float
operations run in the same order, so ``estimator.estimate`` plus
``model.predict`` give results equal with ``==`` to the JAX package's
(held by ``tests/test_torch_estimator.py``).
"""
