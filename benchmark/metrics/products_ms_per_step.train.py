"""Device milliseconds a training step spends in matrix-product kernels
(cuBLAS / CUTLASS products and cuDNN's convolutions, by the name
patterns below), over the steps traced."""

PATTERNS = ("gemm", "xmma", "cutlass", "Kernel2", "conv", "dgrad", "wgrad",
            "fprop")


def read(view, facts):
    ops = view.named(PATTERNS)
    if not ops:
        return None
    return 1e3 * sum(op.end - op.start for op in ops) / facts["items"]
