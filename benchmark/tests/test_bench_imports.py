"""Nothing the benchmark runs loads jax, flax or the JAX package, and the
reference loads nothing of the program: each checked by whole top-level
module name (phovo_tpu_torch begins with phovo_tpu), in a fresh process
that runs a cell, and by a scan of every import in the folder. A run
whose metric readers load such a module prints no result and exits 3."""

import ast
import json
import shutil
import subprocess
import sys

import pytest

from benchmark import run

FORBIDDEN = {"jax", "jaxlib", "flax", "phovo_tpu"}
SCRIPT = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
from benchmark import run
from benchmark.tests.helpers import small_run
rec = small_run("analytic5.replay")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=str(run.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    top = _modules(SCRIPT.format(root=str(run.ROOT)))
    assert "phovo_tpu_torch" in top and not top & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import json, sys; sys.path.insert(0, {str(run.ROOT)!r}); import benchmark.reference.vo, "
            "benchmark.check; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    top = _modules(code)
    assert not top & (FORBIDDEN | {"phovo_tpu_torch"})


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (run.ROOT / "benchmark").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"
                if "reference" in path.parts:
                    assert name.split(".")[0] != "phovo_tpu_torch", f"{path} imports {name}"


REPORT = """
import json, sys
sys.path.insert(0, {stubs!r})
sys.path.insert(0, {root!r})
sys.path.append({program!r})  # the program, after the copy's benchmark
from benchmark import run
from benchmark.tests.helpers import small_run
bench = json.loads(open({bench!r}).read())
rec = small_run("analytic5.replay", root=run.Path({root!r}), bench=bench)
sys.exit(run.report(bench, "analytic5.replay", rec, False, {{"platform": "cpu"}}, root=run.Path({root!r})))
"""


@pytest.mark.parametrize("planted", [False, True])
def test_a_reader_that_loads_a_forbidden_module_leaves_no_result(tmp_path, planted):
    """A reader of a copy of the benchmark imports `flax` (a stub that
    imports nothing else): the run's look at sys.modules comes after every
    reader, so it exits 3 and prints no result line; without the import it
    prints the line and exits 0."""
    root, stubs = tmp_path / "checkout", tmp_path / "stubs"
    shutil.copytree(run.ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    (stubs / "flax").mkdir(parents=True)
    (stubs / "flax" / "__init__.py").write_text("")
    body = "    import flax  # noqa: F401\n" if planted else ""
    (root / "benchmark" / "metrics" / "hidden_import.py").write_text(
        "def read(record):\n" + body + "    return 1.0\n")
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "hidden_import", "unit": "s", "better": "lower", "bound": 0.25,
                                "source": "host_clock", "workloads": ["analytic5.replay"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = REPORT.format(stubs=str(stubs), root=str(root), program=str(run.ROOT), bench=str(root / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=str(root))
    lines = [x for x in out.stdout.splitlines() if x.startswith("{")]
    if planted:
        assert out.returncode == 3, out.stderr[-2000:]
        assert not lines and "['flax']" in out.stderr
        assert out.stderr.rstrip().splitlines()[-1].startswith("check ")
    else:
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(lines[-1])["metrics"]["hidden_import"]["value"] == 1.0
