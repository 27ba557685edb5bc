"""Device milliseconds a clip spends in the speech frontend: the kernels
launched inside the benchmark's span around the mel and HuBERT callables
it hands to ``FusedPipeline``, summed, over the clips traced."""


def read(view, facts):
    ops = view.launched_in("frontend")
    if not ops:
        return None
    return 1e3 * sum(op.end - op.start for op in ops) / facts["items"]
