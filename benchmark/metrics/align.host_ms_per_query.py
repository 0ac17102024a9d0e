"""Host milliseconds a query in the ``align`` entry: the queries' walls
(the benchmark's spans, call to the end of the output) less the device
time of the port's kernels (the profiler's), over the window's queries,
in an ``align`` cell of a traced run."""


def read(run):
    t = run["trace"]
    if run["entry"] != "align" or t is None:
        return None
    return 1e3 * (sum(run["query_s"]) - t["kernel_s"]) / run["n"]
