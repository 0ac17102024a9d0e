"""Queries mapped and written a second over the window's whole time
(host clock), in a ``map`` cell."""


def read(run):
    if run["entry"] != "map":
        return None
    return run["n"] / run["window_s"]
