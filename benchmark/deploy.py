"""A configuration's deployment, built by the builder the configuration
names (``benchmark/builders/<builder>.py``, with ``build(cfg, root)`` and
``open_built(cfg, root)``) from the configuration alone, and cached in a
fixed, git-ignored directory of the checkout keyed by the digests of the
configuration file and of its builder: only a checkout's first run of a
configuration builds it.
"""
from __future__ import annotations

import hashlib
import importlib.util
import os
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CACHE = HERE / "cache"


def digest(path: Path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()[:16]


def load_module(path: Path, kind: str, name: str):
    """The module of a part found by name (a builder, an entry, a
    metric's reader ...), loaded from its file and registered under a
    name of its own."""
    key = f"benchmark_{kind}_{name}".replace(".", "_")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def builder(name: str, base: Path = HERE):
    path = base / "builders" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no builder file {path}")
    return load_module(path, "builders", name)


def load(cfg: dict, cfg_path: Path, cache: Path = CACHE, base: Path = HERE):
    """The deployment of ``cfg`` from its cache directory, built there
    first where missing.  Returns (deployment, whether it was built
    now)."""
    mod = builder(cfg["builder"], base)
    key = digest(cfg_path) + digest(Path(mod.__file__))[:8]
    root = cache / f"{cfg['name']}-{key}"
    built = False
    if not (root / "done").exists():
        tmp = root.with_name(root.name + ".partial")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        mod.build(cfg, tmp)
        (tmp / "done").write_text("")
        shutil.rmtree(root, ignore_errors=True)
        os.replace(tmp, root)
        built = True
    return mod.open_built(cfg, root), built


def ensure(dep, key: str, make) -> bool:
    """A product of the program kept beside the deployment (an index),
    made by ``make()`` where the mark ``key`` is missing.  Returns whether
    it was made now."""
    mark = Path(dep.root) / f"{key}.done"
    if mark.exists():
        return False
    make()
    mark.write_text("")
    return True
