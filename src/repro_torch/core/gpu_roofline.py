"""The H100 as a roofline machine: a port-side term beside the copy of
``repro.core.roofline``.

:func:`repro_torch.core.roofline.build_report` asks its machine for five
things, which a ``TPUMachine`` has and a ``GPUMachine`` lacks in part.
:class:`GPURooflineMachine` answers them for a GPU, leaving both copies
(``roofline``, ``machine``) as they are:

* ``peak_flops(bits)``: the dense tensor-core peak at 16 bits (the data
  sheet's 989 TFLOP/s bf16 for the H100 SXM), the CUDA cores' FP32 peak
  (``GPUMachine.peak_fp32``) above;
* ``bw_hbm``: the data sheet's HBM rate (3.35 TB/s), the one ``PERF.md``'s
  kernel bounds use (``GPUMachine.bw_dram`` is a STREAM-scale 3.0);
* ``bw_ici_link``: the NVLink rate a GPU has per direction (``bw_link``);
* ``bw_inter_pod``: the per-GPU share of the node's NICs (``bw_inter_node``);
* the axis bandwidth: ``MeshSpec.bandwidth`` prices a mesh axis of a machine
  that is not a ``TPUMachine`` by ``bw_link``, and the pod axis by
  ``bw_inter_pod``.
"""
from __future__ import annotations

from dataclasses import dataclass

from .machine import H100_SXM, GPUMachine


@dataclass(frozen=True)
class GPURooflineMachine:
    gpu: GPUMachine
    peak_bf16: float  # FLOP/s, dense tensor cores
    bw_hbm: float  # B/s, data sheet

    @property
    def name(self) -> str:
        return self.gpu.name

    def peak_flops(self, dtype_bits: int) -> float:
        return self.peak_bf16 if dtype_bits <= 16 else self.gpu.peak_fp32

    @property
    def bw_link(self) -> float:
        return self.gpu.bw_link

    @property
    def bw_ici_link(self) -> float:
        return self.gpu.bw_link

    @property
    def bw_inter_pod(self) -> float:
        return self.gpu.bw_inter_node

    @property
    def bw_inter_node(self) -> float:
        return self.gpu.bw_inter_node


H100_ROOFLINE = GPURooflineMachine(gpu=H100_SXM, peak_bf16=989e12, bw_hbm=3.35e12)
