"""Milliseconds a query of the program's ``long_join`` span (each
closed-form junction of the long-intron path, the splice join and the
micro-exon join, inside ``prep``), a ``stage`` of
``spaln_tpu_torch.utils.metrics``, summed over the window, in an
``align`` cell of a traced run."""


def read(run):
    t = run["trace"]
    if (run["entry"] != "align" or t is None
            or "long_join" not in t["stage_s"]):
        return None
    return 1e3 * t["stage_s"]["long_join"] / run["n"]
