"""The port imports neither jax nor spaln_tpu: checked in a fresh
interpreter, after importing the package, its CLI and every module of
the map path."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = ["spaln_tpu_torch", "spaln_tpu_torch.cli",
           "spaln_tpu_torch.align.mapper", "spaln_tpu_torch.align.driver",
           "spaln_tpu_torch.ops.dp_spliced_cuda",
           "spaln_tpu_torch.ops.convert", "spaln_tpu_torch.utils.metrics",
           "spaln_tpu_torch.utils.errors", "spaln_tpu_torch.native"]


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
