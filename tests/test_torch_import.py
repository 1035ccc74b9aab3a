"""The port imports without JAX and builds nothing at import time: every
module of the package (the Bethe and density-CV paths' included) is
imported in a fresh interpreter, and every source is scanned for imports
of ``jax`` or the JAX package."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PROBE = """
import importlib, pkgutil, sys
from pathlib import Path
import lammps_ucg_dev_tpu_torch as pkg
build = Path(pkg.__file__).parent / "_build"
before = sorted(build.iterdir()) if build.exists() else []
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from lammps_ucg_dev_tpu_torch.ops import cuda_lib
jax_mods = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
assert not jax_mods, jax_mods
assert "lammps_ucg_dev_tpu" not in sys.modules
assert not cuda_lib._LOADED
after = sorted(build.iterdir()) if build.exists() else []
assert before == after, (before, after)
print(" ".join(names))
"""

NEW_MODULES = ("models.pair_bethe", "ops.hopper_bethe", "ops.kernel_select",
               "fixes.ucgstate", "flagship", "convert", "models.density",
               "models.pair_bethe_density", "models.pair_rleucg",
               "ops.hopper_cv", "ops.hopper_density", "ops.hopper_rleucg",
               "ops.clusters", "ops.hopper_cluster", "ops.hopper_ablation",
               "tools.kbench", "tools.timing", "models.bonded",
               "fixes.cluster_switch", "compat.script", "io.data", "io.dump",
               "io.restart", "runtime.native", "models.pair_single",
               "models.registry", "utils.profiling", "tools.make_deck",
               "tools.deckgap", "parallel.comm", "parallel.launch",
               "parallel.spatial", "parallel.domain", "tools.spatial_check")


def test_port_imports_without_jax_and_builds_nothing():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    names = r.stdout.split()
    assert len(names) >= 45
    for mod in NEW_MODULES:
        assert f"lammps_ucg_dev_tpu_torch.{mod}" in names, mod


def test_port_sources_never_name_jax():
    """Nor the JAX package, its ``tools/`` or its ``attic/``; the smoke
    script and the profiler script are held to the same rule."""
    pkg = ROOT / "lammps_ucg_dev_tpu_torch"
    for path in [*pkg.rglob("*.py"), ROOT / "chip_smoke.py",
                 ROOT / "profile_paths.py"]:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith(("import jax", "from jax"))
                        or "import lammps_ucg_dev_tpu." in s
                        or s.startswith("from lammps_ucg_dev_tpu.")
                        or s.startswith(("import tools", "from tools",
                                         "import attic", "from attic"))), \
                f"{path}: {line}"
