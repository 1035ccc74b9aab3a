"""``Simulation.run(thermo_callback=)`` and ``utils.profiling`` on the CPU:
the callback gets each thermo row as the run appends it, ``trace`` writes
a ``torch.profiler`` trace of the run, and ``Throughput`` counts its
steps."""

import torch

from lammps_ucg_dev_tpu_torch import flagship
from lammps_ucg_dev_tpu_torch.utils import profiling
from test_torch_core import one_torch_thread  # noqa: F401


def test_thermo_callback_gets_each_row():
    sim = flagship.build_sim(n=256, dtype=torch.float64, device="cpu")
    rows = []
    sim.run(20, thermo_every=10, thermo_callback=rows.append)
    assert [row["step"] for row in rows] == [10, 20]
    assert rows == sim.thermo_rows


def test_trace_and_throughput(tmp_path):
    sim = flagship.build_sim(n=256, dtype=torch.float64, device="cpu")
    tp = profiling.Throughput(sim.state.n_atoms)
    with profiling.trace(str(tmp_path / "trace")), tp:
        with profiling.named_scope("run"):
            sim.run(10)
    tp.add_steps(10)
    assert any((tmp_path / "trace").iterdir())
    assert tp.steps == 10 and tp.elapsed > 0
    row = tp.row()
    assert row["steps"] == 10
    assert row["atom_steps_per_sec"] == round(tp.steps_per_sec * 256, 1)
