"""The linear-attention kernel's share of its roofline in training: per
launch the larger of operations / peak and bytes / 3.35 TB/s at its
(B, T, D, heads) (``flops/model.py``), summed over the traced launches
(``fused_linear_attention.launches_by_shape``), over the device time of
the kernels named below.  Nothing to read: None."""

from benchmark.flops.model import PEAKS, bound_seconds, linear_attention_bound

KERNELS = ("linear_attention_kernel",)


def read(view, facts):
    ops = view.named(KERNELS)
    launches = facts["linear_attention_launches"]
    if not ops or not launches:
        return None
    bound = sum(n * bound_seconds(*linear_attention_bound(B, T, D, H, 4),
                                  PEAKS["tf32_flops"])
                for (B, T, D, H), n in launches.items())
    return 100.0 * bound / sum(op.end - op.start for op in ops)
