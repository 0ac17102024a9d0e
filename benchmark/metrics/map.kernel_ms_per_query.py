"""Device milliseconds a query of the port's kernels (the profiler's CUDA
activity, copies and PyTorch's own kernels left out), in a ``map``
cell of a traced run."""


def read(run):
    t = run["trace"]
    if run["entry"] != "map" or t is None or not t["kernel_s"]:
        return None
    return 1e3 * t["kernel_s"] / run["n"]
