"""Nothing the benchmark runs loads JAX, Flax or the JAX package; nothing
under ucg_bench imports them, the earlier measuring scripts, or (from the
reference) the port.  Module names are compared by their whole top-level
name: the port's own name begins with the JAX package's.  A run in which
any process, the parent or a rank of a cell on several cards, holds one
after the window prints no result."""

import ast
import subprocess
import sys
import types
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "lammps_ucg_dev_tpu", "chip_smoke",
             "profile_paths", "bench"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_nothing_forbidden():
    for path in BENCH_DIR.rglob("*.py"):
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH_DIR / "reference").rglob("*.py"):
        assert "lammps_ucg_dev_tpu_torch" not in set(_imports(path)), path
    for path in (BENCH_DIR / "roofline").rglob("*.py"):
        assert "lammps_ucg_dev_tpu_torch" not in set(_imports(path)), path


def test_loaded_modules_of_a_run():
    """Every module that the entry point, the harness and the port load has
    a top-level name that is none of the forbidden ones."""
    code = (
        "import sys\n"
        "import ucg_bench.run, ucg_bench.harness, ucg_bench.calibrate\n"
        "import ucg_bench.trace, ucg_bench.check\n"
        "from ucg_bench.harness import benchmark\n"
        "import importlib\n"
        "b = benchmark()\n"
        "for m in b['end_to_end'] + b['per_layer']:\n"
        "    importlib.import_module('ucg_bench.metrics.' + m['name'])\n"
        "import lammps_ucg_dev_tpu_torch.compat.script\n"
        "import lammps_ucg_dev_tpu_torch.parallel.launch\n"
        "import lammps_ucg_dev_tpu_torch.parallel.spatial\n"
        "import lammps_ucg_dev_tpu_torch.ops.kernel_select as ks\n"
        "ks.select_pair_kernel(None, None, 0.0, 0.0, force=False)\n"
        "from ucg_bench.run import forbidden_loaded\n"
        "print(','.join(forbidden_loaded()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_forbidden_names_compared_whole(monkeypatch):
    """The port's name begins with the JAX package's and is not taken for
    it; the JAX package's own modules are."""
    import lammps_ucg_dev_tpu_torch  # noqa: F401
    from ucg_bench.run import forbidden_loaded
    assert "lammps_ucg_dev_tpu_torch" in sys.modules
    assert "lammps_ucg_dev_tpu" not in forbidden_loaded()
    monkeypatch.setitem(sys.modules, "lammps_ucg_dev_tpu.io", object())
    assert forbidden_loaded() == ["lammps_ucg_dev_tpu"]


def jaxlib_on_rank_2():
    """A hook: rank 2 of a cell on several ranks loads a module named
    ``jaxlib``."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_rank() == 2:
        sys.modules["jaxlib"] = types.ModuleType("jaxlib")


def test_a_rank_holding_jax_fails_the_run(four_card_cell):
    from ucg_bench import harness
    from ucg_bench.nojax import ForbiddenLoaded
    with pytest.raises(ForbiddenLoaded) as e:
        harness.run_cell(four_card_cell, 2**31 + 55, 1.0, False,
                         device="cpu", n_atoms=8192,
                         steps={"warmup_steps": 20, "steps_per_s": 10},
                         hook=f"{__name__}:jaxlib_on_rank_2")
    assert e.value.found == {2: ["jaxlib"]}


@pytest.mark.parametrize("where", ["rank", "parent"])
def test_command_prints_no_result_with_jax_loaded(where, monkeypatch,
                                                  capsys, four_card_cell):
    import torch

    from ucg_bench import harness, run
    from ucg_bench.nojax import ForbiddenLoaded
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)

    def planted(*a, **k):
        if where == "rank":
            raise ForbiddenLoaded({2: ["jaxlib"]})
        monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
        return {"correct": True}
    monkeypatch.setattr(harness, "run_cell", planted)
    assert run.main(["--workload", four_card_cell, "--seed", "1",
                     "--seconds", "1"]) == 3
    cap = capsys.readouterr()
    assert cap.out == ""
    assert ("rank 2: jaxlib" if where == "rank" else "main: flax") in cap.err
