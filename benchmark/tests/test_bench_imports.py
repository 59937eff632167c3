"""What the benchmark may import: the reference nothing of the port nor of
JAX, the harness nothing of the probes, the bridge, ``bench.py``,
``chip_smoke.py`` or ``scripts/``; and the run's guard compares whole
top-level names."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def imported(path: pathlib.Path) -> set[str]:
    """Dotted names of every module ``path`` imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
            out |= {f"{node.module}.{a.name}" for a in node.names}
    return out


def sources():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def test_reference_imports_nothing_of_the_port_or_jax():
    for path in (BENCH / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in imported(path)}
        assert not tops & {"rtgs_tpu_torch", "rtgs_tpu", "jax", "jaxlib",
                           "flax"}, path


def test_harness_imports_no_side_tool():
    banned = ("rtgs_tpu_torch.probes", "rtgs_tpu_torch.bridge", "bench",
              "chip_smoke", "scripts")
    for path in sources():
        for mod in imported(path):
            assert not any(mod == b or mod.startswith(b + ".")
                           for b in banned), (path, mod)
            assert mod.split(".")[0] not in ("rtgs_tpu", "jax", "jaxlib",
                                             "flax"), (path, mod)


def test_a_run_loads_no_jax():
    """Importing the harness with every traffic kind and reader, and the
    port's modules a run uses, leaves no JAX and no ``rtgs_tpu`` in
    ``sys.modules``; the guard itself tells ``rtgs_tpu_torch`` from
    ``rtgs_tpu``."""
    mods = ["benchmark.run", "benchmark.control", "benchmark.trace"] + \
        [f"benchmark.{p.parent.name}.{p.stem}"
         for sub in ("traffic", "readers", "reference")
         for p in (BENCH / sub).glob("*.py") if p.stem != "__init__"] + \
        ["rtgs_tpu_torch.render.api", "rtgs_tpu_torch.train.solver",
         "rtgs_tpu_torch.viewer.orbit", "rtgs_tpu_torch.camera"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from benchmark.run import forbidden_modules\n"
            "assert forbidden_modules() == [], forbidden_modules()\n"
            "sys.modules['rtgs_tpu.x'] = sys.modules['rtgs_tpu_torch']\n"
            "assert forbidden_modules() == ['rtgs_tpu']\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "render1m_orbit_d16", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"correct"' not in out.stdout
