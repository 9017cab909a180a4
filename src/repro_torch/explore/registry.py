"""Estimator and machine registry: the part of ``repro.explore.registry`` the
whole-model estimator reads.

``ESTIMATORS`` maps a backend name to a factory of a
:class:`~repro_torch.core.record.Estimator`; the port has the ``"gpu"``
entry (the paper's §III pipeline).  The JAX package's ``"tpu"`` entry waits
for the port's TPU backend (ROADMAP Queue 1 item 10), and its kernel table
(``KERNELS``, ``get_kernel``) for the port of ``explore`` (item 8).
"""
from __future__ import annotations

from typing import Callable

from ..core.machine import (
    MACHINES,
    canonical_machine_name,
    get_machine,
)
from ..core.suggest import unknown_name_message

__all__ = [
    "ESTIMATORS",
    "MACHINES",
    "canonical_machine_name",
    "get_estimator",
    "get_machine",
]


def _make_gpu_estimator(method: str = "sym", fits=None):
    from ..core.estimator import GPUAnalyticEstimator

    return GPUAnalyticEstimator(method=method, fits=fits)


# backend name -> Estimator factory (lazy imports keep the registry light)
ESTIMATORS: dict[str, Callable] = {
    "gpu": _make_gpu_estimator,
}


def get_estimator(backend: str, method: str | None = None, fits=None):
    """Resolve a backend name to a fresh :class:`~repro_torch.core.record.Estimator`."""
    factory = ESTIMATORS.get(backend)
    if factory is None:
        if backend == "tpu":
            raise NotImplementedError(
                "the port has no TPU estimator (core/tpu_estimator and a "
                "counterpart of frontend/pallas; ROADMAP Queue 1 item 10)"
            )
        raise KeyError(unknown_name_message("backend", backend, ESTIMATORS))
    kwargs = {} if method is None else {"method": method}
    return factory(fits=fits, **kwargs)
