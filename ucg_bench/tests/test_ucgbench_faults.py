"""The check of ``correct`` fails what it must.  The control (the reference
in bfloat16 put in the program's place) comes out not correct, and so does
a run with the timed path broken underneath: a step that returns its state
unchanged, half of the beads' forces left out, one bead's force altered
where it is produced, one bead's type altered in the cluster_switch event,
and, on slabs, the halo exchange between ranks left out.  Each fault is
planted by a hook that the harness calls on every rank before the deck.
CPU, 4,096 beads (the slab cell 8,192)."""

import dataclasses

import pytest

from ucg_bench import check, harness

SMALL = {"warmup_steps": 20, "steps_per_s": 10}


def _run(cell, hook=None, n=4096, **kw):
    return harness.run_cell(cell, 2**31 + 77, 1.0, False, device="cpu",
                            n_atoms=n, steps=SMALL, hook=hook, **kw)


# ---- the faults (module-level: the slab ranks import them by name) ------

def unchanged_state():
    from lammps_ucg_dev_tpu_torch.fixes import integrate as fi
    fi.initial_integrate = lambda state, *a, **k: state
    fi.final_integrate = lambda state, *a, **k: state


def _altered_pair(alter):
    from lammps_ucg_dev_tpu_torch.runtime import sim as rs
    orig = rs.Simulation._pair_pass

    def pair_pass(self, state, *a, **k):
        fo = orig(self, state, *a, **k)
        return dataclasses.replace(fo, f=alter(fo.f.clone()))
    rs.Simulation._pair_pass = pair_pass


def half_left_out():
    def half(f):
        f[f.shape[0] // 2:] = 0
        return f
    _altered_pair(half)


def one_force_altered():
    def one(f):
        f[f.shape[0] // 3] += 1.0
        return f
    _altered_pair(one)


def one_type_altered():
    from lammps_ucg_dev_tpu_torch.runtime import sim as rs
    orig = rs.Simulation._cswitch_event

    def event(self, state, stats, u):
        st, stats, info = orig(self, state, stats, u)
        typ = st.typ.clone()
        k = typ.shape[0] // 2
        typ[k] = 3 - typ[k]
        return dataclasses.replace(st, typ=typ), stats, info
    rs.Simulation._cswitch_event = event


def exchange_left_out():
    from lammps_ucg_dev_tpu_torch.parallel import comm
    orig = comm.Ring.exchange

    def exchange(self, axis, to_lo, to_hi, kind="halo"):
        if kind == "halo":
            return to_lo.new_zeros(to_lo.shape), to_hi.new_zeros(to_hi.shape)
        return orig(self, axis, to_lo, to_hi, kind)
    comm.Ring.exchange = exchange


@pytest.fixture(autouse=True)
def restore(monkeypatch):
    """The faults patch modules of this process; put them back after."""
    from lammps_ucg_dev_tpu_torch.fixes import integrate as fi
    from lammps_ucg_dev_tpu_torch.parallel import comm
    from lammps_ucg_dev_tpu_torch.runtime import sim as rs
    for owner, name in ((fi, "initial_integrate"), (fi, "final_integrate"),
                        (rs.Simulation, "_pair_pass"),
                        (rs.Simulation, "_cswitch_event"),
                        (comm.Ring, "exchange")):
        monkeypatch.setattr(owner, name, getattr(owner, name))


@pytest.mark.parametrize("cell", ["ucgld_fluid.nvt_1m",
                                  "bethe_density.switch_1m"])
def test_control_is_not_correct(cell):
    res = _run(cell, control=True, calibrate=True)
    assert res["correct"]
    ok, rows = check.judge(res["control"], check.limits(
        harness.cell_of(harness.benchmark(), cell)["config"]))
    assert not ok


FAULTS = [("ucgld_fluid.nvt_1m", "unchanged_state"),
          ("ucgld_fluid.nvt_1m", "half_left_out"),
          ("ucgld_fluid.nvt_1m", "one_force_altered"),
          ("bethe_density.switch_1m", "unchanged_state"),
          ("bethe_density.switch_1m", "half_left_out"),
          ("bethe_density.switch_1m", "one_force_altered"),
          ("bethe_density.switch_1m", "one_type_altered")]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, fault):
    res = _run(cell, hook=f"{__name__}:{fault}")
    assert res["correct"] is False, res["compared"]


def test_slab_exchange_left_out_is_not_correct(four_card_cell):
    res = _run(four_card_cell, hook=f"{__name__}:exchange_left_out",
               n=8192)
    assert res["correct"] is False, res["compared"]
