"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port. Module names are compared by their
whole top-level name: the port's own name begins with the JAX package's."""

from __future__ import annotations

import ast
import subprocess
import sys

from port_bench.tests.tiny import PB

FORBIDDEN = {"jax", "jaxlib", "flax", "gstex_tpu"}


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=PB.parent, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_the_harness_loads_no_jax():
    tops = loaded_after(
        "import port_bench.run, port_bench.train_cell, port_bench.calibrate,"
        " port_bench.faults\nfrom port_bench import spec\n"
        "[spec.reader(m['name']) for m in spec.load_benchmark()"
        "['per_layer']]")
    assert not tops & FORBIDDEN
    assert "gstex_torch" in tops


def test_the_reference_loads_nothing_of_the_port():
    tops = loaded_after("import port_bench.reference.gstex_ref, "
                        "port_bench.check, port_bench.scene")
    assert not tops & (FORBIDDEN | {"gstex_torch"})


def test_no_source_of_the_benchmark_names_jax():
    for path in PB.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)
                if path.parent.name == "reference":
                    assert n.split(".")[0] != "gstex_torch", (path, n)
