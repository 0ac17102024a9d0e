"""Milliseconds a query of the program's ``refine`` span (each
``refine_ends``: the creepback and the first and last exons planted,
inside ``traceback``), a ``stage`` of ``spaln_tpu_torch.utils.metrics``,
summed over the window, in an ``align`` cell of a traced run."""


def read(run):
    t = run["trace"]
    if run["entry"] != "align" or t is None or "refine" not in t["stage_s"]:
        return None
    return 1e3 * t["stage_s"]["refine"] / run["n"]
