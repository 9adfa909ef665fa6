"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit), and the least time a fused BN -> ReLU -> 1x1
conv kernel can take, copied unchanged from ``chip_smoke.py``
(``H100_*``, ``fused_bound_ms``, ``FUSED_CASES``, ``FUSED_DEVICE_KERNELS``)
so that a later change to the program's smoke test cannot move the
benchmark's yardstick."""

from __future__ import annotations

H100_BYTES_PER_S = 3.35e12  # HBM3
H100_F32_OPS_PER_S = 67e12  # fp32 outside the tensor cores
H100_TF32_OPS_PER_S = 495e12  # TF32 on the tensor cores
H100_BF16_OPS_PER_S = 989e12  # bf16 on the tensor cores

# (N, C, F) of the fused stages at batch 8 that the smoke test times, and
# one ragged case (the last): the stage list below must reproduce the first
# eight
FUSED_CASES = [
    (16384, 64, 128),
    (16384, 224, 128),
    (16384, 256, 128),
    (2048, 480, 128),
    (2048, 512, 256),
    (256, 992, 128),
    (256, 1024, 512),
    (32, 992, 128),
    (5003, 200, 72),
]
FUSED_NAMES = ("moments", "apply", "bwd_reduce", "bwd_dx")
# the device kernels each fused wrapper launches, by a part of their names
# in a profile; all but bwd_dx end with one launch of the fold kernel
FUSED_DEVICE_KERNELS = {
    "moments": ("::moments_partial_kernel",),
    "apply": ("::apply_kernel<",),
    "bwd_reduce": ("::bwd_reduce_kernel<",),
    "bwd_dx": ("::bwd_dx_kernel<", "::bwd_dx_cluster_kernel<"),
}
FUSED_FOLD_KERNEL = "::fold_parts_kernel<"


def fused_bound_ms(name, n, c, f):
    """``(bound ms, bound by, CUDA-core bound ms)`` of one float32 call:
    the JAX kernels' CostEstimate operations, each input byte read once and
    each output byte written once; products as three TF32 products on the
    tensor cores, elementwise work at the fp32 rate."""
    product, elementwise, n_bytes = {
        "moments": (0, 3 * n * c, 4 * n * c + 8 * c),
        "apply": (2 * n * c * f, 3 * n * c,
                  4 * (n * c + c * f + n * f) + 8 * c),
        "bwd_reduce": (4 * n * c * f, 8 * n * c,
                       4 * (n * c + n * f + c * f) + 4 * c * f + 24 * c),
        "bwd_dx": (2 * n * c * f, 10 * n * c,
                   4 * (2 * n * c + n * f + c * f) + 24 * c),
    }[name]
    t_bytes = n_bytes / H100_BYTES_PER_S
    t_ops = (3 * product / H100_TF32_OPS_PER_S
             + elementwise / H100_F32_OPS_PER_S)
    t_cuda_core = max(t_bytes, (product + elementwise) / H100_F32_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", t_cuda_core * 1e3)


def densenet_fused_stages(densenet: dict, image_shape, batch: int) -> list:
    """``[(rows, C, F)]`` of the DenseNet's BN -> ReLU -> 1x1-conv stages
    (every dense layer's first stage, then the block's transition) at
    ``batch`` patients of ``image_shape``: conv0 and the max pool halve each
    spatial dim twice, each transition once more."""
    g, bn_size = densenet["growth_rate"], densenet["bn_size"]
    c = densenet["init_features"]
    voxels = 1
    for s in image_shape:
        voxels *= s // 4
    stages = []
    blocks = densenet["block_config"]
    for bi, n_layers in enumerate(blocks):
        rows = batch * voxels
        for li in range(n_layers):
            stages.append((rows, c + li * g, bn_size * g))
        c += n_layers * g
        if bi != len(blocks) - 1:
            stages.append((rows, c, c // 2))
            c //= 2
            voxels //= 8
    return stages


def fused_step_bound_ms(stages) -> float:
    """The least device time of one training step's fused kernels: every
    stage's four calls at their bounds."""
    return sum(fused_bound_ms(name, n, c, f)[0]
               for n, c, f in stages for name in FUSED_NAMES)


def is_fused_kernel(name: str) -> bool:
    return FUSED_FOLD_KERNEL in name or any(
        part in name for parts in FUSED_DEVICE_KERNELS.values()
        for part in parts)
