"""Hardware constants for the roofline model of the dry run (target: one
NVIDIA H100 SXM5 80 GB a rank), the counterpart of the JAX package's
`repro.common.hw`.

Source: NVIDIA's H100 Tensor Core GPU datasheet (SXM5): 989.4 TFLOP/s
dense BF16 (1,979 with sparsity), 3.35 TB/s of HBM3, 80 GB, 50 MB of L2,
228 KB of shared memory an SM, 132 SMs; NVLink4 at 900 GB/s both
directions together (450 GB/s each way). A 16-rank mesh axis spans two
8-GPU NVLink nodes, so the link that binds a collective along it is the
node's InfiniBand: one NDR port (400 Gb/s, 50 GB/s each way) a GPU.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops_bf16: float          # per device, FLOP/s (dense)
    hbm_bandwidth: float            # per device, B/s
    hbm_bytes: float                # per device capacity
    link_bandwidth: float           # the binding link per direction, B/s
    nvlink_bandwidth: float = 0.0   # within a node, per direction, B/s
    l2_bytes: float = 0.0
    smem_bytes_per_sm: float = 0.0
    n_sms: int = 0


H100_SXM = HardwareSpec(
    name="h100_sxm",
    peak_flops_bf16=989.4e12,
    hbm_bandwidth=3.35e12,
    hbm_bytes=80e9,
    link_bandwidth=50e9,
    nvlink_bandwidth=450e9,
    l2_bytes=50 * 2 ** 20,
    smem_bytes_per_sm=228 * 2 ** 10,
    n_sms=132,
)
