"""Multi-limiter roofline performance model (paper §II.A, §IV.H).

The naive roofline (DRAM bandwidth vs peak FP) is extended with two cache-related
limiters: L2 bandwidth and the L1→register throughput (from the bank-conflict cycle
count).  Predicted kernel time is the maximum of the four limiter times; the limiter
achieving it is the predicted bottleneck.
"""
from __future__ import annotations

from dataclasses import dataclass

from .address import KernelSpec
from .estimator import VolumeEstimate
from .machine import V100, GPUMachine


@dataclass(frozen=True)
class Prediction:
    kernel: str
    block: tuple[int, int, int]
    fold: tuple[int, int, int]
    t_dram: float
    t_l2: float
    t_l1: float
    t_fp: float
    lups: int

    @property
    def time(self) -> float:
        return max(self.t_dram, self.t_l2, self.t_l1, self.t_fp)

    @property
    def limiter(self) -> str:
        terms = {
            "DRAM": self.t_dram,
            "L2": self.t_l2,
            "L1": self.t_l1,
            "FP": self.t_fp,
        }
        return max(terms, key=terms.get)

    @property
    def glups(self) -> float:
        return self.lups / self.time / 1e9 if self.time > 0 else float("inf")

    @property
    def terms(self) -> dict[str, float]:
        return {
            "DRAM": self.t_dram,
            "L2": self.t_l2,
            "L1": self.t_l1,
            "FP": self.t_fp,
        }


def predict(
    spec: KernelSpec, est: VolumeEstimate, machine: GPUMachine = V100
) -> Prediction:
    lups = spec.total_lups
    t_dram = est.v_dram * lups / machine.bw_dram
    t_l2 = est.v_l2l1 * lups / machine.bw_l2
    # bank-conflict cycles accrue per SM; all SMs work in parallel
    t_l1 = est.l1_cycles * lups / (machine.n_sm * machine.clock_hz)
    # FP peak picked by the kernel's dtype: fp32 kernels run at the fp32 peak
    t_fp = est.flops * lups / machine.peak_fp(spec.element_size)
    return Prediction(
        kernel=spec.name,
        block=spec.launch.block,
        fold=tuple(spec.meta.get("fold", (1, 1, 1))),
        t_dram=t_dram,
        t_l2=t_l2,
        t_l1=t_l1,
        t_fp=t_fp,
        lups=lups,
    )


def predict_from_volumes(
    lups: int,
    v_dram: float,
    v_l2: float,
    l1_cycles: float,
    flops: float,
    machine: GPUMachine = V100,
    name: str = "phenomenological",
    block=(0, 0, 0),
    fold=(1, 1, 1),
    element_size: int = 8,
) -> Prediction:
    """Phenomenological prediction from *measured* volumes (paper's gray markers).

    ``element_size`` selects the FP peak (8 = fp64, the paper's kernels;
    4 = fp32), matching :func:`predict`'s dtype-aware FP term.
    """
    return Prediction(
        kernel=name,
        block=tuple(block),
        fold=tuple(fold),
        t_dram=v_dram * lups / machine.bw_dram,
        t_l2=v_l2 * lups / machine.bw_l2,
        t_l1=l1_cycles * lups / (machine.n_sm * machine.clock_hz),
        t_fp=flops * lups / machine.peak_fp(element_size),
        lups=lups,
    )
