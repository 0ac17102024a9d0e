"""Step probes on the card: the H100 counterparts of the TPU micro-probes
of scripts/ and of the slab kernel's knock-out modes, which measure what
one step of a serial DP loop is made of.

Each probe module runs as ``python -m spaln_tpu_torch.probes.<name>``
with its script's arguments, plus ``--device`` (cuda, the default, is an
error without a card; cpu runs the plain versions) and ``--threads``
(the CTA's 128-1024 threads), and holds a plain PyTorch version of every
body, the wrapper of its kernel in csrc/probes.cu and a ``main`` that
prints ns a step (T-differenced, _cuda.step_ns).  ablate_pallas,
time_kernel_pieces and bisect_mosaic time or launch spliced_slab_score
in knocked-out builds of csrc/spliced_dp.cu; mosaic_repro holds the
growing skeletons of the slab step (csrc/mosaic_repro.cu), each level
with its plain version.

  module          C entry          replaces (the script's pallas_call)
  pallas_probe    probe_k0         scripts/pallas_probe.py:69
                  probe_pallas     scripts/pallas_probe.py:49
  pallas_probe2   probe_pallas2    scripts/pallas_probe2.py:45
  probe_gather    probe_gather     scripts/probe_gather.py:93
  probe_step_ops  probe_step_ops   scripts/probe_step_ops.py:80
  probe_int16     probe_int16      scripts/probe_int16.py:42
  ablate_pallas   spliced_slab_score (SLAB_ABLATE builds)
                                   scripts/ablate_pallas.py:53 ->
                                   spaln_tpu/ops/dp_spliced_pallas.py:215
  time_kernel_pieces, bisect_mosaic
                  spliced_slab_score (SLAB_ABLATE builds)
                                   scripts/time_kernel_pieces.py:60,
                                   scripts/bisect_mosaic.py:103 ->
                                   spaln_tpu/ops/dp_spliced_pallas.py:767
  mosaic_repro    mosaic_repro     scripts/mosaic_repro.py:93, 265, 449
"""
from __future__ import annotations

# the step-probe modules in the order they were ported, and the
# scripts/ line of the TPU kernel each C entry replaces
PROBES = ("pallas_probe", "pallas_probe2", "probe_gather", "probe_step_ops",
          "probe_int16")
REPLACES = {"probe_k0": "scripts/pallas_probe.py:69",
            "probe_pallas": "scripts/pallas_probe.py:49",
            "probe_pallas2": "scripts/pallas_probe2.py:45",
            "probe_gather": "scripts/probe_gather.py:93",
            "probe_step_ops": "scripts/probe_step_ops.py:80",
            "probe_int16": "scripts/probe_int16.py:42"}


def modules() -> list:
    """The step-probe modules, imported."""
    import importlib
    return [importlib.import_module(f"{__name__}.{m}") for m in PROBES]
