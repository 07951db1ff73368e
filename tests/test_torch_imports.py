"""The port stands alone: no module of `iip_uavsal_saliency_tpu_torch`, and
not chip_smoke.py, imports JAX, flax, optax or the JAX package."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "iip_uavsal_saliency_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "iip_uavsal_saliency_tpu")

_PROBE = """
import importlib, pkgutil, sys
import iip_uavsal_saliency_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
forbidden = {forbidden!r}
bad = sorted(m for m in sys.modules if m.split(".")[0] in forbidden)
print(len(names), bad)
"""


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_importing_every_port_module_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _PROBE.format(forbidden=FORBIDDEN)],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 20, out.stdout  # every subpackage was walked
    assert bad == "[]", f"importing the port loaded {bad}"


def _sources():
    for dirpath, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", list(_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_source_has_no_jax_import(path):
    tree = ast.parse(open(path).read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                found.append(node.module)
    assert not found, f"{os.path.relpath(path, ROOT)} imports {found}"


_LAZY_PROBE = """
import importlib, pkgutil, sys
import iip_uavsal_saliency_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
print(sorted(m for m in sys.modules if m.split(".")[0] in ("msgpack", "cv2", "h5py")))
"""


def test_port_needs_no_msgpack_and_loads_cv2_and_h5py_lazily():
    """The card's machine has none of msgpack, cv2 and h5py: importing the
    port loads none of them, and no module of it imports msgpack at all
    (checkpoints go through the port's own codec)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _LAZY_PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    for path in _sources():
        tree = ast.parse(open(path).read(), filename=path)
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        assert not any(name.split(".")[0] == "msgpack" for name in names), path
