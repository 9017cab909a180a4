"""repro_torch.frontend — the canonical kernel IR (AccessIR) and its frontends.

Copies of ``repro.frontend``'s modules (see ``repro_torch.core``), with the
same exports.  The layer between code generators and estimators (paper
§I.B: the estimator's only inputs are address expressions, launch geometry
and field metadata):

* :mod:`repro_torch.frontend.ir`       — the AccessIR data model + canonical fingerprint,
* :mod:`repro_torch.frontend.lower`    — per-backend lowering (GPU KernelSpec / TPU PallasConfig),
* :mod:`repro_torch.frontend.pallas`   — tracing frontend: PallasConfig -> AccessIR via
  affine index-map probing, with a non-affinity guard,
* :mod:`repro_torch.frontend.builders` — GPU-space IR builders for the frontier kernels.
"""
from .builders import attention_gpu_ir, wkv_gpu_ir
from .ir import (
    AccessIR,
    IRAccess,
    IRField,
    dedupe_ir,
    fold_ir,
    ir_fingerprint,
)
from .lower import from_kernel_spec, lower_gpu, lower_tpu
from .pallas import NonAffineIndexMapError, trace_index_map, trace_pallas

__all__ = [
    "AccessIR",
    "IRAccess",
    "IRField",
    "NonAffineIndexMapError",
    "attention_gpu_ir",
    "dedupe_ir",
    "fold_ir",
    "from_kernel_spec",
    "ir_fingerprint",
    "lower_gpu",
    "lower_tpu",
    "trace_index_map",
    "trace_pallas",
    "wkv_gpu_ir",
]
