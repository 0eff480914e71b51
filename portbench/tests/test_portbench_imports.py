"""What the benchmark may import: nothing of JAX or of the JAX package
anywhere under ``portbench/``, and nothing of the port in the yardstick
(the reference, the scene generator, the check and the roofline). Top-level
names are compared whole: ``reze_tpu_torch`` begins with ``reze_tpu`` and
is the code under test."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import pytest

from portbench import harness

HERE = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "reze_tpu"}
YARDSTICK = ("reference/", "scene/", "check.py", "roofline.py")


def imported_top_levels(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


MODULES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p.relative_to(HERE).as_posix())
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported_top_levels(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in MODULES
                                  if p.relative_to(HERE).as_posix().startswith(YARDSTICK)],
                         ids=lambda p: p.relative_to(HERE).as_posix())
def test_the_yardstick_imports_nothing_of_the_port(path):
    assert "reze_tpu_torch" not in imported_top_levels(path)


def test_the_run_time_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "reze_tpu_torch_fake", sys)
    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.forbidden_modules()


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; import portbench.harness, portbench.check, portbench.calibrate; "
            "import portbench.reference.step, portbench.scene.spec; "
            "[portbench.harness.load_module('drivers', d) for d in ('viewer', 'crowd')]; "
            "import reze_tpu_torch, reze_tpu_torch.distrib; "
            "print(portbench.harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
