"""Machine models: a parametric architecture registry.

Copy of ``repro.core.machine``; the constants and the lookup must stay
identical to it (held by ``tests/test_torch_estimator.py`` and
``tests/test_torch_tpu_estimator.py``).  The TPU machines are analytic
models that run on the host: the TPU backend (``core/tpu_estimator``) prices
Pallas configurations with them, as the JAX package does.

The paper instantiates its estimator on one machine (V100); the method itself
is architecture-parametric — the authors' follow-up (arXiv:2204.14242,
"Analytical Performance Estimation during Code Generation on Modern GPUs")
re-instantiates the identical model on A100 by swapping machine constants.
This module holds those constants for every supported architecture:

GPU (paper §III estimator):

* ``V100``      — the paper's §IV.A values: 80 SMs @ 1.38 GHz, L1 128 kB
  (configured), L2 6 MB, 790 GB/s DRAM (STREAM scale), 2500 GB/s L2.
* ``A100_40GB`` — arXiv:2204.14242's A100-SXM4-40GB instantiation: 108 SMs
  @ 1.41 GHz, L1 192 kB, L2 40 MB, ~1.4 TB/s DRAM (STREAM scale), ~4.5 TB/s L2.
* ``H100_SXM``  — H100-SXM5-80GB from NVIDIA's Hopper whitepaper: 132 SMs
  @ 1.98 GHz boost, L1 256 kB, L2 50 MB, HBM3 ~3.0 TB/s (STREAM scale),
  64 FP64 lanes/SM.

TPU (Pallas adaptation):

* ``TPU_V5E`` — 197 TFLOP/s bf16, 819 GB/s HBM, VMEM 128 MB, (8,128) native
  vector tiling, 128x128 MXU, ~50 GB/s/link ICI.
* ``TPU_V6E`` — Trillium: 918 TFLOP/s bf16, 1640 GB/s HBM, 32 GB HBM,
  256x256 MXU, ~100 GB/s/link ICI.

``MACHINES`` / ``get_machine`` form the registry used by estimation call
sites, the exploration engine and the CLI; lookups are case- and
punctuation-insensitive (``"a100"``, ``"A100-40GB"`` and ``"a100_40gb"`` all
resolve to the same entry).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

from .capacity import A100_FITS, DEFAULT_FITS, H100_FITS, CapacityFits


@dataclass(frozen=True)
class GPUMachine:
    name: str = "V100-PCIe-32GB"
    n_sm: int = 80
    clock_hz: float = 1.38e9
    l1_bytes: int = 128 * 1024
    l2_bytes: int = 6 * 1024 * 1024
    bw_dram: float = 790e9  # B/s, STREAM scale
    bw_l2: float = 2500e9  # B/s
    peak_fp64: float = 7.066e12  # 80 SM * 32 FP64 lanes * 2 flop * 1.38 GHz
    peak_fp32: float = 14.13e12  # 80 SM * 64 FP32 lanes * 2 flop * 1.38 GHz
    line_bytes: int = 128  # allocation granularity (L1 + L2)
    sector_bytes: int = 32  # transfer granularity
    n_banks: int = 16
    bank_bytes: int = 8
    max_threads_per_sm: int = 2048
    max_blocks_per_sm: int = 32
    max_threads_per_block: int = 1024
    warp_threads: int = 32
    regs_per_sm: int = 65536  # 32-bit registers
    # interconnect (whole-model replay: collective edges on a GPU mesh) —
    # per-GPU NVLink aggregate per direction, and the per-GPU share of the
    # node's NICs for mesh axes that cross node boundaries
    bw_link: float = 150e9  # B/s (V100: 6 NVLink2 x 25 GB/s per direction)
    bw_inter_node: float = 25e9  # B/s per GPU (e.g. 200 Gb/s IB per pair of GPUs)
    # per-architecture capacity-miss calibration (paper §III.E sigmoids); the
    # V100 values transfer as the initial calibration for newer parts and can
    # be re-fit per machine via capacity.fit_sigmoid + core/exactcount.py
    fits: CapacityFits = DEFAULT_FITS

    def peak_fp(self, element_size: int) -> float:
        """FP peak for the given arithmetic width in bytes: fp32 kernels must
        be held against the fp32 peak, not the (half-rate) fp64 one."""
        return self.peak_fp32 if element_size <= 4 else self.peak_fp64

    def blocks_per_sm(self, block_threads: int, regs_per_thread: int) -> int:
        """Occupancy: thread-, block- and register-file-limited blocks per SM."""
        if block_threads <= 0:
            return 0
        by_threads = self.max_threads_per_sm // block_threads
        # DP kernels: regs_per_thread counted in 32-bit registers already
        by_regs = self.regs_per_sm // max(regs_per_thread * block_threads, 1)
        return max(1, min(by_threads, by_regs, self.max_blocks_per_sm))

    @property
    def machine_balance_fp64(self) -> float:
        """Flop/B at DRAM — paper: 4 Flop/B for the stencil instruction mix."""
        return self.peak_fp64 / self.bw_dram / 2  # FMA-mix derating, cf. §IV.C


V100 = GPUMachine()

# arXiv:2204.14242 §IV: A100-SXM4-40GB — 108 SMs, 1.41 GHz, 192 kB unified L1,
# 40 MB L2, measured STREAM ~1.4 TB/s of the 1555 GB/s spec, ~4.5 TB/s L2.
A100_40GB = GPUMachine(
    name="A100-SXM4-40GB",
    n_sm=108,
    clock_hz=1.41e9,
    l1_bytes=192 * 1024,
    l2_bytes=40 * 1024 * 1024,
    bw_dram=1400e9,
    bw_l2=4500e9,
    peak_fp64=9.746e12,  # 108 SM * 32 FP64 lanes * 2 flop * 1.41 GHz
    peak_fp32=19.49e12,  # 108 SM * 64 FP32 lanes * 2 flop * 1.41 GHz
    bw_link=300e9,  # 12 NVLink3 x 25 GB/s per direction
    fits=A100_FITS,
)

# NVIDIA Hopper whitepaper: H100-SXM5-80GB — 132 SMs, 1.98 GHz boost, 256 kB
# unified L1, 50 MB L2, HBM3 3.35 TB/s spec (~3.0 TB/s STREAM scale), and
# 64 FP64 lanes per SM (vs 32 on Volta/Ampere).
H100_SXM = GPUMachine(
    name="H100-SXM5-80GB",
    n_sm=132,
    clock_hz=1.98e9,
    l1_bytes=256 * 1024,
    l2_bytes=50 * 1024 * 1024,
    bw_dram=3000e9,
    bw_l2=5500e9,
    peak_fp64=33.45e12,  # 132 SM * 64 FP64 lanes * 2 flop * 1.98 GHz
    peak_fp32=66.9e12,  # 132 SM * 128 FP32 lanes * 2 flop * 1.98 GHz
    bw_link=450e9,  # 18 NVLink4 x 25 GB/s per direction
    bw_inter_node=50e9,  # 400 Gb/s NIC per GPU (SXM reference system)
    fits=H100_FITS,
)


@dataclass(frozen=True)
class TPUMachine:
    """Single TPU chip (v5e-class) + ICI fabric constants."""

    name: str = "tpu-v5e"
    peak_bf16: float = 197e12  # FLOP/s per chip
    peak_fp32: float = 98.5e12
    bw_hbm: float = 819e9  # B/s per chip
    hbm_bytes: int = 16 * 2**30
    vmem_bytes: int = 128 * 2**20
    vmem_usable: int = 100 * 2**20  # leave headroom for XLA-reserved scratch
    bw_ici_link: float = 50e9  # B/s per link per direction
    ici_links: int = 4  # 2D torus: +-x, +-y
    bw_inter_pod: float = 25e9  # effective per-chip cross-pod (DCN-assisted) B/s
    mxu_dim: int = 128
    sublanes: int = 8  # native (8, 128) fp32 vector tile
    lanes: int = 128
    vpu_flops: float = 4e12  # elementwise VPU throughput, FLOP/s

    def peak_flops(self, dtype_bits: int) -> float:
        return self.peak_bf16 if dtype_bits <= 16 else self.peak_fp32

    def sublane_multiple(self, dtype_bits: int) -> int:
        """Second-to-last-dim tiling multiple: (8,128) fp32, (16,128) bf16, (32,128) int8."""
        return self.sublanes * max(1, 32 // dtype_bits)


TPU_V5E = TPUMachine()

# Trillium (v6e): ~4.7x v5e peak bf16, 1640 GB/s HBM, 32 GB HBM per chip,
# 256x256 MXU, roughly doubled per-link ICI bandwidth.
TPU_V6E = TPUMachine(
    name="tpu-v6e",
    peak_bf16=918e12,
    peak_fp32=459e12,
    bw_hbm=1640e9,
    hbm_bytes=32 * 2**30,
    bw_ici_link=100e9,
    mxu_dim=256,
    vpu_flops=14.7e12,  # scaled with the 4096-lane (vs 1024) Trillium VPU
)


# --------------------------------------------------------------------------- #
# architecture registry


MACHINES: dict[str, GPUMachine | TPUMachine] = {
    "V100": V100,
    "A100": A100_40GB,
    "H100": H100_SXM,
    "TPUv5e": TPU_V5E,
    "TPUv6e": TPU_V6E,
}


def _norm(name: str) -> str:
    return re.sub(r"[^a-z0-9]", "", name.lower())


def _lookup() -> dict[str, str]:
    """normalized alias -> canonical registry key (keys + full model names)."""
    table: dict[str, str] = {}
    for key, m in MACHINES.items():
        table[_norm(key)] = key
        table[_norm(m.name)] = key
    return table


def canonical_machine_name(name: str) -> str:
    """Registry key for any accepted spelling (``"a100"`` -> ``"A100"``)."""
    from .suggest import unknown_name_message

    key = _lookup().get(_norm(name))
    if key is None:
        raise KeyError(unknown_name_message("machine", name, MACHINES))
    return key


def get_machine(name: str) -> GPUMachine | TPUMachine:
    """Resolve a machine by registry key, full model name, or any
    case/punctuation variant thereof; unknown names get a did-you-mean."""
    return MACHINES[canonical_machine_name(name)]


def gpu_machines() -> dict[str, GPUMachine]:
    return {k: m for k, m in MACHINES.items() if isinstance(m, GPUMachine)}


def tpu_machines() -> dict[str, TPUMachine]:
    return {k: m for k, m in MACHINES.items() if isinstance(m, TPUMachine)}


@dataclass(frozen=True)
class MeshSpec:
    """Logical device mesh over the ICI fabric (axis name -> size)."""

    axes: tuple[tuple[str, int], ...]
    inter_pod_axes: tuple[str, ...] = ("pod",)

    @property
    def n_devices(self) -> int:
        n = 1
        for _, s in self.axes:
            n *= s
        return n

    def axis_size(self, name: str) -> int:
        for a, s in self.axes:
            if a == name:
                return s
        raise KeyError(name)

    def axis_bandwidth(self, name: str, tpu: TPUMachine = TPU_V5E) -> float:
        """Per-chip bandwidth available to collectives on one mesh axis.

        Intra-pod axes ride the 2D torus (2 links per axis direction pair);
        the pod axis crosses the data-center network.
        """
        return self.bandwidth(name, tpu)

    def bandwidth(self, name: str, machine) -> float:
        """Per-device collective bandwidth on one mesh axis, for either
        machine family: TPU axes ride the ICI torus / DCN, GPU axes ride
        NVLink within a node and the NIC across nodes (the whole-model
        replay's link-bandwidth model for communication edges)."""
        if name in self.inter_pod_axes:
            return getattr(machine, "bw_inter_pod", None) or machine.bw_inter_node
        if isinstance(machine, TPUMachine):
            return 2 * machine.bw_ici_link  # bidirectional ring on one torus dim
        return machine.bw_link


SINGLE_DEVICE_MESH = MeshSpec(axes=(("data", 1), ("model", 1)))
SINGLE_POD_MESH = MeshSpec(axes=(("data", 16), ("model", 16)))
MULTI_POD_MESH = MeshSpec(axes=(("pod", 2), ("data", 16), ("model", 16)))
