"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the system under test. Top-level module
names are compared whole: the system's name begins with the JAX
package's."""

import ast
from pathlib import Path

from benchmark.harness import common

BENCH = Path(__file__).resolve().parents[1]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        bad = _imports(path) & set(common.FORBIDDEN_MODULES)
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_system():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "matcha_tpu_torch" not in _imports(path), path
        assert all(n.startswith("benchmark.reference") for n in _from_modules(path)), path


def _from_modules(path: Path) -> list:
    tree = ast.parse(path.read_text())
    return [n.module for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.module and n.module.startswith("benchmark")]


def test_forbidden_loaded_compares_whole_names():
    assert common.forbidden_loaded({"matcha_tpu_torch": 1, "matcha_tpu_torch.cli": 1,
                                    "jaxtyping": 1, "numpy": 1}) == []
    assert common.forbidden_loaded({"matcha_tpu.cli": 1, "jax.numpy": 1}) == ["jax", "matcha_tpu"]


def test_a_run_loads_no_forbidden_module():
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, '.'); "
            "import benchmark.harness.execute, benchmark.harness.judge, benchmark.harness.flops; "
            "import benchmark.harness.models as m; m.system_pipeline; "
            "from benchmark.harness import common; "
            "import matcha_tpu_torch.cli, matcha_tpu_torch.serve; "
            "print(common.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
