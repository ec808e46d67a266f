"""What the benchmark may import: never JAX or the JAX package, and in its
reference nothing of the program either (compared by whole top-level
names: `opus_tpu_torch` is not `opus_tpu`)."""

import ast
import pathlib
import subprocess
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "opus_tpu"}


def imported(path: pathlib.Path) -> set:
    """Top-level names of the absolute imports in a file (relative
    imports stay inside opusbench)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 40
    bad = {str(f.relative_to(BENCH)): imported(f) & FORBIDDEN for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert len(files) >= 30 and BENCH / "reference" / "multistream.py" in files
    for f in files:
        assert imported(f) <= {"__future__", "copy", "dataclasses", "enum", "math", "numpy"}, f


def test_no_file_names_the_ported_benchmark_scripts():
    """The harness keeps frozen copies of what it needs of bench.py,
    opus_tpu_torch/bench.py and chip_smoke.py; it reads none of them."""
    for f in BENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                        else [node.module or ""])
                assert not any(m.split(".")[-1] in ("bench", "chip_smoke") for m in mods), f


def test_a_reference_worker_loads_no_torch():
    """The check's worker processes load numpy and the reference only."""
    code = ("import sys; import opusbench.check, opusbench.reference, "
            "opusbench.reference.multistream, opusbench.traffic.schedule; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'torch', 'jax', 'jaxlib', 'flax', 'opus_tpu', 'opus_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
