"""Nothing under bench_port/ imports JAX or the JAX package, and the
reference imports nothing of the port (whole top-level module names)."""

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    names = set(top_level_imports(path))
    assert not names & {"jax", "jaxlib", "flax", "object_detector_6d_tpu"}, names


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_port(path):
    """The reference imports the port nowhere, and nothing of bench_port
    outside the reference itself."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] != "object_detector_6d_tpu_torch", name
            if name.split(".")[0] == "bench_port":
                assert name.startswith("bench_port.reference"), name


@pytest.mark.parametrize("name", ["bank.py", "frames.py", "compare.py", "roofline.py",
                                  "trace.py", "run.py", "program_trace.py", "control.py"])
def test_neutral_modules_import_nothing_of_the_port(name):
    assert "object_detector_6d_tpu_torch" not in set(top_level_imports(BENCH / name))
