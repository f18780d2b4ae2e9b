"""Hardware profiles for the ASA cost model and roofline analysis (copy of
``repro/core/hardware.py``, plus the port's own ``H100_SXM``).

TPU_V5E is the reference's deployment target (roofline constants per the
spec) and stays the planner's default, so that a plan here equals the
reference's for the same inputs; V100_CLUSTER reproduces the paper's own
8-GPU setting for Table I validation; H100_SXM is the card the port runs
on, which the port's Trainer and launchers plan for on CUDA.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    peak_flops: float          # per chip, bf16/fp16 FLOP/s
    hbm_bw: float              # per chip, bytes/s
    link_bw: float             # per link, bytes/s (ICI / NVLink)
    hbm_bytes: float           # per chip HBM capacity
    # inter-pod (DCN) bandwidth per host, bytes/s; 0 => single-pod only
    dcn_bw: float = 0.0
    # fraction of peak realistically achievable on large matmuls (MFU ceiling
    # used by the *cost model*, not the roofline — roofline uses raw peak)
    matmul_efficiency: float = 0.6


TPU_V5E = HardwareProfile(
    name="tpu_v5e",
    peak_flops=197e12,         # bf16
    hbm_bw=819e9,
    link_bw=50e9,              # ~50 GB/s per ICI link
    hbm_bytes=16e9,
    dcn_bw=25e9,
    matmul_efficiency=0.6,
)

V100_CLUSTER = HardwareProfile(
    name="v100_nvlink",
    peak_flops=125e12,         # fp16 tensor core
    hbm_bw=900e9,
    link_bw=25e9,              # NVLink2 per direction per link
    hbm_bytes=32e9,
    dcn_bw=0.0,
    matmul_efficiency=0.45,    # V100-era utilization on 25M-86M param models
)

# NVIDIA H100 SXM5 80GB, from NVIDIA's H100 Tensor Core GPU datasheet:
# 989 TFLOP/s dense bf16 on the tensor cores (1,979 is with 2:4
# sparsity), 3.35 TB/s of HBM3, 80 GB; NVLink 4 gives 900 GB/s a GPU over
# NVSwitch, both directions together, so 450 GB/s per direction; one
# ConnectX-7 port at 400 Gb/s InfiniBand NDR = 50 GB/s between hosts.
# matmul_efficiency stays the reference's 0.6 until it is measured
# (chip_smoke.py phase 33 calibrates per component instead).
H100_SXM = HardwareProfile(
    name="h100_sxm",
    peak_flops=989e12,         # bf16 dense tensor core
    hbm_bw=3.35e12,
    link_bw=450e9,             # NVLink 4 via NVSwitch, per direction
    hbm_bytes=80e9,
    dcn_bw=50e9,               # 400 Gb/s InfiniBand NDR
    matmul_efficiency=0.6,
)


def ring_allreduce_time(bytes_: float, n: int, link_bw: float) -> float:
    """Bandwidth-optimal ring all-reduce: 2*(n-1)/n * bytes / link_bw."""
    if n <= 1 or bytes_ == 0:
        return 0.0
    return 2.0 * (n - 1) / n * bytes_ / link_bw


def allgather_time(bytes_out: float, n: int, link_bw: float) -> float:
    """Ring all-gather of a full tensor of `bytes_out` total size."""
    if n <= 1 or bytes_out == 0:
        return 0.0
    return (n - 1) / n * bytes_out / link_bw


def reducescatter_time(bytes_in: float, n: int, link_bw: float) -> float:
    if n <= 1 or bytes_in == 0:
        return 0.0
    return (n - 1) / n * bytes_in / link_bw


def alltoall_time(bytes_: float, n: int, link_bw: float) -> float:
    if n <= 1 or bytes_ == 0:
        return 0.0
    return (n - 1) / n * bytes_ / link_bw
