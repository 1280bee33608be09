"""Import hygiene: nothing the benchmark runs loads JAX or the JAX package,
compared by whole top-level module names (the port's name begins with the
JAX package's), and the plain reference loads nothing of the port."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "quadruped_ctrl_tpu"}


def imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported_roots(path) & BANNED


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert imported_roots(path) <= {"__future__", "torch", "numpy", "math"}


def test_whole_name_comparison_tells_the_port_from_the_jax_package():
    import sys
    import types

    from benchmark.run import banned_modules

    before = banned_modules()
    sys.modules["quadruped_ctrl_tpu_torch_probe"] = types.ModuleType("probe")
    sys.modules["quadruped_ctrl_tpu.probe"] = types.ModuleType("probe")
    try:
        found = banned_modules()
    finally:
        del sys.modules["quadruped_ctrl_tpu_torch_probe"], sys.modules["quadruped_ctrl_tpu.probe"]
    assert "quadruped_ctrl_tpu" in found and "quadruped_ctrl_tpu" not in before
    assert not any(name.startswith("quadruped_ctrl_tpu_torch") for name in found)


def test_a_cpu_run_loads_neither_jax_nor_the_jax_package():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, '.');"
            "from benchmark import run as R;"
            "a = R.parse(['--workload', 'h10_trot_solve', '--seed', '5', '--seconds', '0.1']);"
            "R.run(a, device='cpu', traffic_over={'batch': 2, 'pool': 1},"
            " workload_over={'check': {'scenarios': 2, 'limits': {'gap_p50': 1, 'gap_p90': 1}}});"
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))" % BANNED)
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
