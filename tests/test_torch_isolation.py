"""The port stands alone: no JAX, nothing of the JAX package.

An AST scan of every module under ``src/repro_torch`` and of
``chip_smoke.py`` for imports of ``jax``/``jaxlib``, of ``repro``
(whose ``__init__`` imports JAX), and of ``msgpack`` / ``ml_dtypes``
(which the JAX package's checkpoints use and the machines the port runs
on need not have: the port carries its own MessagePack codec and bit
views), and a subprocess that imports every port module and then finds
none of them in ``sys.modules``.
"""
import ast
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro", "msgpack", "ml_dtypes"}


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


NEW_IN_PR_21 = [
    "launch/dryrun.py", "analysis/cost.py", "analysis/launch_counts.py",
    "analysis/checks.py", "analysis/schedule.py", "analysis/kernel_cases.py",
    "analysis/kernel_lint.py", "analysis/docs_lint.py", "analysis/check.py",
    "kernels/meta.py", "examples/quickstart.py", "examples/topology_explorer.py",
    "examples/serve_batched.py", "examples/train_decentralized.py",
]


def test_dry_run_analysis_and_example_modules_stand_alone():
    """The dry run, the analysis checks and the examples are the port's
    own modules (copies where the JAX package's are numpy only), with no
    import of jax or of the JAX package."""
    for rel in NEW_IN_PR_21:
        path = PORT / rel
        assert path.exists(), rel
        roots = {root for _, root in _imported_roots(path)}
        assert not roots & FORBIDDEN, (rel, roots & FORBIDDEN)
        assert "importlib" not in roots or rel == "analysis/docs_lint.py", rel


NEW_IN_PR_22 = [
    "launch/mesh.py", "dist/sharding.py", "dist/fsdp.py", "dist/gossip.py",
    "dist/decen_train.py", "dist/bucketing.py", "launch/train.py",
    "examples/train_decentralized.py", "telemetry/probes.py", "analysis/bytes_model.py",
]


def test_mesh_and_fsdp_modules_stand_alone():
    """The mesh, the node-axis exchange and the FSDP runtime import no
    JAX and nothing of the JAX package; the sharded pieces come from the
    port's own modules."""
    for rel in NEW_IN_PR_22:
        path = PORT / rel
        assert path.exists(), rel
        roots = {root for _, root in _imported_roots(path)}
        assert not roots & FORBIDDEN, (rel, roots & FORBIDDEN)
    fsdp_imports = {name for _, name in _imported_modules(PORT / "dist/fsdp.py")}
    assert {"repro_torch.dist", "repro_torch.dist.sharding",
            "repro_torch.dist.decen_train"} <= fsdp_imports


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
