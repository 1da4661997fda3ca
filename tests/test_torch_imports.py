"""The port's import hygiene, read from the sources with ``ast``.

No module of ``vrenderer_pathtracer_tpu_torch`` and not ``chip_smoke.py``
imports ``jax`` (or ``jaxlib``), the JAX package ``vrenderer_pathtracer_tpu``,
the repository's ``examples`` or ``tests``, or the root ``bench*`` scripts:
the port keeps its own copies of what it needs, and runs on a machine
without JAX.  Imports inside functions count as well.
"""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "vrenderer_pathtracer_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "vrenderer_pathtracer_tpu", "examples", "tests")
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported(tree):
    """(line, top-level module) of every absolute import in ``tree``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN or top.startswith("bench")


def test_the_port_has_modules():
    assert len(SOURCES) > 40
    assert PORT / "view.py" in SOURCES and PORT / "bench_scaling.py" in SOURCES


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_package_examples_tests_or_bench_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, name) for line, name in _imported(tree) if _forbidden(name)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.mark.parametrize("name,bad", [
    ("jax.numpy", True), ("vrenderer_pathtracer_tpu.view", True),
    ("vrenderer_pathtracer_tpu_torch.view", False), ("examples.config5", True),
    ("tests.test_mesh_render", True), ("bench_scaling", True), ("bench", True),
    ("vrenderer_pathtracer_tpu_torch.bench_scaling", False), ("torch", False)])
def test_the_rule_itself(name, bad):
    assert _forbidden(name) == bad
