"""The benchmark's CPU tests run PyTorch on a few threads: the small decks
are launch-bound, and parallel test workers share the machine.

``four_card_cell`` puts the four-card slab cell, which ``BENCHMARK.json``
does not hold yet, into the benchmark that the harness reads, so that the
harness's slab path (the ranks, their gather, their no-JAX report, the
exchange metrics) stays tested for the entries that add it."""

import pytest
import torch

SLAB_CELL = {
    "name": "ucgld_fluid.slabs4_4m", "config": "ucgld_fluid",
    "traffic": "slabs4_4m", "chips": 4,
    "why": "2^22 beads on 4 x-slabs over NCCL, one rank a card, 2^20 a rank "
           "plus halos: migration, halos, the refresh and the per-block "
           "all_reduce exist only across cards"}
SLAB_METRICS = [
    {"name": "exchange_ms_per_step", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "decomposition",
     "moves": "steps_per_s", "workloads": [SLAB_CELL["name"]]},
    {"name": "exchange_mb_per_step", "unit": "MB", "better": "lower",
     "source": "program_counter", "layer": "decomposition",
     "moves": "steps_per_s", "workloads": [SLAB_CELL["name"]]}]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def four_card_cell(monkeypatch):
    from ucg_bench import harness
    bench = harness.benchmark()
    bench["workloads"].append(SLAB_CELL)
    bench["per_layer"].extend(SLAB_METRICS)
    monkeypatch.setattr(harness, "benchmark", lambda: bench)
    return SLAB_CELL["name"]
