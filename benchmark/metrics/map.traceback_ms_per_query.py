"""Milliseconds a query of the program's ``traceback`` stage timer
(``spaln_tpu_torch.utils.metrics``), summed over the window, in a
``map`` cell of a traced run."""


def read(run):
    t = run["trace"]
    if run["entry"] != "map" or t is None or "traceback" not in t["stage_s"]:
        return None
    return 1e3 * t["stage_s"]["traceback"] / run["n"]
