"""The paper's contribution as the port's own copy: analytic hardware-metric
estimation + multi-limiter roofline performance modeling for
code-generation-time configuration selection, on GPU (faithful
reproduction) and TPU (Pallas/mesh adaptation, priced on the host).

Every module here is a copy of the same-named module of ``repro.core`` with
only its relative imports and the parts the port does not use changed; float
operations run in the same order, so ``estimator.estimate`` plus
``model.predict`` give results equal with ``==`` to the JAX package's
(held by ``tests/test_torch_estimator.py``).  The package exports the JAX
package's names (``tests/test_torch_exports.py``).  ``gpu_roofline`` is the
port's own: the H100 as a roofline machine beside the copy of ``roofline``.
"""

from .address import (  # noqa: F401
    Access,
    Field,
    KernelSpec,
    LaunchConfig,
    ThreadBox,
    dedupe_accesses,
    fold_accesses,
)
from .capacity import DEFAULT_FITS, CapacityFits, Sigmoid, fit_sigmoid  # noqa: F401
from .estimator import GPUAnalyticEstimator, VolumeEstimate, estimate  # noqa: F401
from .machine import (  # noqa: F401
    A100_40GB,
    H100_SXM,
    MACHINES,
    MULTI_POD_MESH,
    SINGLE_POD_MESH,
    TPU_V5E,
    TPU_V6E,
    V100,
    GPUMachine,
    MeshSpec,
    TPUMachine,
    canonical_machine_name,
    get_machine,
    gpu_machines,
    tpu_machines,
)
from .model import Prediction, predict, predict_from_volumes  # noqa: F401
from .record import (  # noqa: F401
    EstimateRecord,
    Estimator,
    gpu_record,
    record_from_payload,
    record_payload,
    tpu_record,
)
from .ranking import (  # noqa: F401
    RankedConfig,
    kendall_tau,
    rank_configs,
    spearman_rho,
    top_k,
)
from .roofline import RooflineReport, build_report, model_flops_lm  # noqa: F401
from .tpu_estimator import (  # noqa: F401
    BlockAccess,
    PallasConfig,
    TPUEstimate,
    TPUPallasEstimator,
    select_config,
)
