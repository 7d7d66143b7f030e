"""Nothing under benchmark/ imports JAX or the JAX package, and the plain
reference imports nothing of the program. Top-level names are compared
whole: the program's name (h264bsd_tpu_torch) begins with the JAX
package's (h264bsd_tpu)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "h264bsd_tpu"}
PROGRAM = "h264bsd_tpu_torch"


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_no_jax_import(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)


def test_whole_names_are_compared():
    """The port's own name is not taken for the JAX package's."""
    src = "import h264bsd_tpu_torch.models\nfrom h264bsd_tpu_torch import x\n"
    tree = ast.parse(src)
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert names == {PROGRAM} and not names & JAX
