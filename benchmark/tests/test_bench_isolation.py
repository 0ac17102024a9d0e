"""Nothing of the benchmark brings in JAX or the JAX package, and the
plain reference brings in nothing of the program.  Names are compared
whole by their top-level part: the port's name starts with the JAX
package's."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
BANNED = {"jax", "jaxlib", "flax", "spaln_tpu"}

PROBE = r"""
import importlib, importlib.util, json, sys
from pathlib import Path
bench = Path(sys.argv[1])
for p in sorted(bench.rglob("*.py")):
    if "tests" in p.parts or p.name == "__init__.py":
        continue
    rel = p.relative_to(bench.parent).with_suffix("")
    name = ".".join(rel.parts)
    if all(part.isidentifier() for part in rel.parts):
        importlib.import_module(name)
    else:
        spec = importlib.util.spec_from_file_location(name, p)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
if len(sys.argv) > 2:
    from benchmark.system import System
    from benchmark.trace import Tracer
    import spaln_tpu_torch.cli, spaln_tpu_torch.align.mapper
    import spaln_tpu_torch.align.protein_driver
    import spaln_tpu_torch.ops.dp_tron_cuda
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _loaded(*extra) -> set:
    p = subprocess.run([sys.executable, "-c", PROBE, str(BENCH), *extra],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    import json
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_benchmark_modules_bring_in_no_jax():
    assert not _loaded() & BANNED


def test_program_as_the_harness_loads_it_brings_in_no_jax():
    got = _loaded("program")
    assert "spaln_tpu_torch" in got
    assert not got & BANNED


def _imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            out.add(".")
    return out


def test_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert files
    for f in files:
        got = _imports(f)
        assert not got & (BANNED | {"spaln_tpu_torch", "torch", "."}), (
            f, got)
    assert "spaln_tpu_torch" not in _loaded_reference()


def _loaded_reference() -> set:
    code = ("import importlib.util, sys, json, pathlib\n"
            "for p in sorted(pathlib.Path(sys.argv[1]).rglob('*.py')):\n"
            "    s = importlib.util.spec_from_file_location(p.stem, p)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code,
                        str(BENCH / "reference")], cwd="/",
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    import json
    return set(json.loads(p.stdout.strip().splitlines()[-1]))
