"""The port stands alone: no JAX, nothing of the JAX package.

An AST scan of every module under ``src/repro_torch`` and of
``chip_smoke.py`` for imports of ``jax``/``jaxlib`` or of ``repro``
(whose ``__init__`` imports JAX), and a subprocess that imports every
port module and then finds neither in ``sys.modules``.
"""
import ast
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def test_no_port_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert (REPO / "chip_smoke.py").exists()
    assert len(files) > 20
    bad = [
        f"{p.relative_to(REPO)}:{line} imports {root}"
        for p in files
        for line, root in _imported_roots(p)
        if root in FORBIDDEN
    ]
    assert not bad, "\n".join(bad)


def test_importing_the_port_leaves_jax_unloaded():
    modules = sorted(
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    body = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import repro_torch.launch.train\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
        "print('OK', len(sys.modules))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    res = subprocess.run(
        [sys.executable, "-c", body], capture_output=True, text=True,
        timeout=120, env=env, cwd=REPO,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.startswith("OK")
