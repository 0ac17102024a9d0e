"""Queries aligned onto their loci and written a second over the window's
whole time (host clock), in an ``align`` cell."""


def read(run):
    if run["entry"] != "align":
        return None
    return run["n"] / run["window_s"]
