"""The benchmark stands apart from the JAX package: no module under
fdbench/ imports jax, jaxlib, flax or repro (top-level names compared
whole: repro_torch is the port), the references import no repro_torch
either, nothing names a path under benchmarks/ or a BENCH_*.json, and
importing every module of the harness leaves none of them loaded."""
import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

FDBENCH = Path(__file__).resolve().parents[1]
ROOT = FDBENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
HERE = Path(__file__).resolve()


def _files():
    return sorted(FDBENCH.rglob("*.py"))


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", _files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_the_jax_package(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_module_roots_compare_whole():
    src = "import repro_torch.serving\nfrom repro_torch import x\n"
    p = FDBENCH / "tests" / "_roots_probe.py"
    try:
        p.write_text(src)
        assert set(_imported_roots(p)) == {"repro_torch"}
    finally:
        p.unlink()


@pytest.mark.parametrize("path", sorted((FDBENCH / "reference")
                                        .rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    roots = set(_imported_roots(path))
    assert not roots & (FORBIDDEN | {"repro_torch", "fdbench"}), roots


@pytest.mark.parametrize("path", [p for p in _files() if p != HERE],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_nothing_opens_the_old_benchmarks(path):
    text = path.read_text()
    assert "benchmarks/" not in text
    assert not re.search(r"BENCH_\w*\.json|BENCH_\*", text)


def test_importing_the_harness_loads_no_jax():
    mods = sorted(
        "fdbench." + ".".join(p.relative_to(FDBENCH).with_suffix("").parts)
        for p in _files()
        if "tests" not in p.parts and "metrics" not in p.parts
        and p.name not in ("__init__.py", "run.py"))
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "from fdbench.lib import cell as C\n"
            + "b = C.load_benchmark()\n"
            + "for m in b['end_to_end'] + b['per_layer']:\n"
            + "    C.reader(m['name'])\n"
            + "import repro_torch.serving.engine\n"
            + "print(C.banned_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
