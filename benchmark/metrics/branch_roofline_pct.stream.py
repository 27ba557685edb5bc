"""The whole-branch kernel's share of its roofline: per launch the larger
of operations / peak and bytes / 3.35 TB/s (``flops/model.py``), summed
over the traced launches (half of them each branch), over the device
time of the kernels named below.  Nothing to read: None."""

from benchmark.flops.model import PEAKS, bound_seconds

KERNELS = ("fused_layers_kernel",)


def read(view, facts):
    ops = view.named(KERNELS)
    n = facts["branch_launches"]
    if not ops or not n:
        return None
    peak = PEAKS["bf16_flops" if facts["config"]["model"]["compute_dtype"]
                 == "bfloat16" else "tf32_flops"]
    bound = sum(bound_seconds(o, b, peak)
                for o, b in facts["branch_bounds"]) * n / 2
    return 100.0 * bound / sum(op.end - op.start for op in ops)
