"""The port imports neither jax nor spaln_tpu: checked in a fresh
interpreter, after importing the package, its CLI and every module of
the map (cDNA and protein), align and search paths, of the step probes
and skeletons, of the bench, the tools, the data-parallel layer and the
entry module."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = ["spaln_tpu_torch", "spaln_tpu_torch.cli",
           "spaln_tpu_torch.align.mapper", "spaln_tpu_torch.align.driver",
           "spaln_tpu_torch.ops.dp_spliced_cuda",
           "spaln_tpu_torch.ops.dp_spliced_udh",
           "spaln_tpu_torch.align.segment",
           "spaln_tpu_torch.align.protein_search",
           "spaln_tpu_torch.seed.dbindex",
           "spaln_tpu_torch.ops.dp_tron", "spaln_tpu_torch.ops.dp_tron_cuda",
           "spaln_tpu_torch.ops.tron_params",
           "spaln_tpu_torch.align.protein_driver",
           "spaln_tpu_torch.ops.convert", "spaln_tpu_torch.utils.metrics",
           "spaln_tpu_torch.utils.errors", "spaln_tpu_torch.native",
           "spaln_tpu_torch.probes", "spaln_tpu_torch.probes._cuda",
           "spaln_tpu_torch.probes.pallas_probe",
           "spaln_tpu_torch.probes.pallas_probe2",
           "spaln_tpu_torch.probes.probe_gather",
           "spaln_tpu_torch.probes.probe_step_ops",
           "spaln_tpu_torch.probes.probe_int16",
           "spaln_tpu_torch.probes.ablate_pallas",
           "spaln_tpu_torch.probes.mosaic_repro",
           "spaln_tpu_torch.probes.time_kernel_pieces",
           "spaln_tpu_torch.probes.bisect_mosaic", "spaln_tpu_torch.bench",
           "spaln_tpu_torch.tools", "spaln_tpu_torch.tools.seqextras",
           "spaln_tpu_torch.tools.kmers", "spaln_tpu_torch.tools.divergence",
           "spaln_tpu_torch.tools.exinpot", "spaln_tpu_torch.tools.npssm",
           "spaln_tpu_torch.tools.makmdm", "spaln_tpu_torch.tools.fitild",
           "spaln_tpu_torch.tools.make_ssp", "spaln_tpu_torch.parallel",
           "spaln_tpu_torch.parallel.sharding", "spaln_tpu_torch.entry",
           "spaln_tpu_torch.out.sortgrcd"]


@pytest.mark.parametrize("mods", [MODULES[:2], MODULES])
def test_port_never_imports_jax_or_reference(mods):
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(k for k in sys.modules if k == 'jax' "
            "or k.startswith(('jax.', 'jaxlib', 'spaln_tpu.')) "
            "or k == 'spaln_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
