"""Execute the documentation notebooks end to end (reference analog: its
``docs/examples/*.ipynb`` are the de-facto integration tests of the public
workflows).

``optimize_speed.ipynb`` is excluded: its unoptimized-baseline cell compiles
a 195-element graph that takes >2 min on the CPU test backend; the same
optimizations are covered by ``test_speed_optimizations``.
"""

import json
import pathlib

import matplotlib
import pytest

pytestmark = pytest.mark.slow

matplotlib.use("Agg")

NOTEBOOK_DIR = pathlib.Path(__file__).parent.parent / "docs" / "examples"


@pytest.mark.parametrize(
    "name", ["simple", "convert", "gradientbased", "rl_tuning"]
)
def test_notebook_executes(name):
    notebook = json.loads((NOTEBOOK_DIR / f"{name}.ipynb").read_text())
    namespace = {}
    for i, cell in enumerate(notebook["cells"]):
        if cell["cell_type"] != "code":
            continue
        source = "".join(cell["source"])
        exec(compile(source, f"<{name} cell {i}>", "exec"), namespace)
