"""Nothing under portbench/ imports JAX, Flax or the JAX package, and the
reference imports nothing of the port; names are compared by their whole
top-level part, so motionstyle_torch is not motionstyle."""
import ast
import glob
import os

from portbench.harness.cell import forbidden_modules

HOME = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def imported_tops(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".", 1)[0])
    return tops


def sources(sub: str = "") -> list:
    return sorted(glob.glob(os.path.join(HOME, sub, "**", "*.py"), recursive=True))


def test_no_module_imports_jax_flax_or_the_jax_package():
    for path in sources():
        bad = imported_tops(path) & {"jax", "jaxlib", "flax", "motionstyle"}
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_port_or_the_harness():
    for path in sources("reference"):
        tops = imported_tops(path)
        assert not tops & {"motionstyle_torch", "motionstyle"}, path
        with open(path) as f:
            assert "portbench.harness" not in f.read(), path


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["motionstyle_torch", "motionstyle_torch.ops", "numpy"]) == []
    assert forbidden_modules(["motionstyle.models", "jaxlib.xla", "flax"]) == [
        "flax", "jaxlib", "motionstyle"]
    assert forbidden_modules(["jaxtyping", "flaxen"]) == []


def test_the_scan_sees_an_import_it_must_refuse(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import motionstyle.models\nfrom jax import numpy\nimport motionstyle_torch\n")
    assert imported_tops(str(p)) == {"motionstyle", "jax", "motionstyle_torch"}
