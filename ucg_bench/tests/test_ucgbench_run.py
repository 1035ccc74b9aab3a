"""A run of each cell, shrunk for the CPU (4,096 beads; the slab cell
8,192, since at 4,096 beads the program's slab capacities overflow, and
put into the benchmark by ``four_card_cell``), for
a 2 s window: its last line is the contract's JSON object, and the run is
correct.  The kernels, the card and the device metrics are not here; the
command refuses a machine without enough cards."""

import json

import pytest

from ucg_bench import harness, run

SMALL = {"warmup_steps": 20, "steps_per_s": 10}
CELLS = [("ucgld_fluid.nvt_1m", 4096), ("bethe_density.switch_1m", 4096),
         ("ucgld_fluid.slabs4_4m", 8192)]


@pytest.mark.parametrize("cell,n", CELLS, ids=[c for c, _ in CELLS])
def test_last_line(cell, n, capsys, request):
    if cell not in {c["name"] for c in harness.benchmark()["workloads"]}:
        request.getfixturevalue("four_card_cell")
    res = harness.run_cell(cell, 2**31 + 99, 2.0, False, device="cpu",
                           n_atoms=n, steps=SMALL)
    print(run.line(res))
    last = capsys.readouterr().out.strip().splitlines()[-1]
    d = json.loads(last)
    assert list(d)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(d)[-1] == "compared"
    assert d["correct"] is True and d["failed"] == 0
    assert set(d["metrics"]) == {"steps_per_s", "block_ms_p95", "setup_s"}
    for m in d["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert d["device"]["count"] == harness.cell_of(
        harness.benchmark(), cell)["chips"]
    for name, c in d["compared"].items():
        assert set(c) == {"value", "limit"}


def test_traced_run_reports_host_layers(capsys):
    res = harness.run_cell("bethe_density.switch_1m", 2**31 + 98, 1.0, True,
                           device="cpu", n_atoms=4096, steps=SMALL)
    assert res["correct"]
    # on the CPU only the host-clock and counter layers have a reading
    assert {"read_data_s", "sim_setup_s", "sweeps_per_event"} <= set(
        res["metrics"])


def test_command_refuses_without_cards(capsys):
    assert run.main(["--workload", "ucgld_fluid.nvt_1m", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
