"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the measured program: an AST walk of every
module under perfbench/, comparing top-level names whole."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax",
                                          "remhos_tpu"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert top_level_imports(path) <= {"__future__", "math", "numpy",
                                       "torch"}


def test_the_walk_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import remhos_torch.ops\nfrom jax_free import x\n")
    assert top_level_imports(f) == {"remhos_torch", "jax_free"}
