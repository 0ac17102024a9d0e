"""The kernels' share of their roofline: the least time the card could
take for the DP work the window's problems need (``benchmark.work``),
over the device time of all the port's kernels (the profiler's), in %,
in a ``map`` cell of a traced run."""


def read(run):
    t = run["trace"]
    if run["entry"] != "map" or t is None or not t["least_s"]:
        return None
    return 100.0 * t["least_s"] / t["kernel_s"]
