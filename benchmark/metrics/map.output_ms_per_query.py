"""Milliseconds a query in the CLI's ``OutputSink.emit`` (the -O0,4
text), the benchmark's own span, in a ``map`` cell of a traced run."""


def read(run):
    if run["entry"] != "map" or run["trace"] is None:
        return None
    return 1e3 * run["output_s"] / run["n"]
