"""The roofline reads the same work whatever implements it: the pair count
is the benchmark's own, and two column lists of different depth over the
same positions give the same operations and bytes.  The pair count matches
a brute-force count."""

import numpy as np
import torch

from ucg_bench import roofline
from ucg_bench.gen import decks
from ucg_bench.metrics import pair_roofline_pct
from ucg_bench.reference import deck as rdeck


def _system(tmp_path, cfg="ucgld_fluid", n=4096, seed=3):
    d = decks.write_deck(decks.load_config(cfg), decks.load_traffic("nvt_1m"),
                         seed, str(tmp_path / cfg), n_atoms=n)
    ph = rdeck.read(d["script"])
    rows = open(tmp_path / cfg / "system.data").read().split(
        "Atoms # ucg\n\n")[1].split("\n")
    a = np.array([r.split() for r in rows if r.strip()], dtype=float)
    x = torch.as_tensor(a[:, 4:7])
    typ = torch.as_tensor(a[:, 2]).long()
    L = np.full(3, d["box_length"])
    return ph, x, typ, L


def _brute(ph, x, typ, L):
    d = x[:, None, :] - x[None, :, :]
    Lt = torch.as_tensor(L)
    d = d - Lt * torch.round(d / Lt)
    r2 = (d * d).sum(-1)
    cut = torch.as_tensor(ph.cutsq)[typ[:, None], typ[None, :]]
    iu = torch.triu_indices(len(x), len(x), 1)
    return int((r2 < cut)[iu[0], iu[1]].sum())


def test_pair_count_matches_brute_force(tmp_path):
    for cfg in ("ucgld_fluid", "bethe_density"):
        ph, x, typ, L = _system(tmp_path, cfg)
        assert roofline.count_pairs(ph, x, typ, L) == _brute(ph, x, typ, L)


def test_same_work_for_two_column_layouts(tmp_path):
    """Two column lists of different depth over the same positions: the
    program's layouts differ (slot counts), the yardstick does not."""
    import dataclasses

    from lammps_ucg_dev_tpu_torch.core.state import Box
    from lammps_ucg_dev_tpu_torch.ops import colpack
    ph, x, typ, L = _system(tmp_path)
    xw = np.mod(x.numpy(), L)
    shallow = colpack.measure_spec(xw, L, 2.5, 0.4)
    deep = dataclasses.replace(shallow, cz=shallow.cz + 64,
                               czp=shallow.czp + 64)
    box = Box.create(np.zeros(3), L, periodic=(True, True, True),
                     dtype=torch.float32, device="cpu")
    xt = torch.as_tensor(xw, dtype=torch.float32)
    layouts, readings = [], []
    for spec in (shallow, deep):
        cl = colpack.build(xt, box, spec)
        layouts.append(int(cl.n_slots))
        pairs = roofline.count_pairs(ph, x, typ, L)
        ctx = {"config": {"pair_style": ph.style}, "world": 1,
               "ranks": [{"pairs": pairs, "n_atoms": len(x),
                          "physics_tables": (len(ph.tables),
                                             len(ph.tables[0][2])),
                          "trace": {"span": {"pair": (10, 1e-3)},
                                    "pack_in_pair": 0.0},
                          "trace_steps": 10}]}
        readings.append((roofline.work(ph.style, pairs, len(x),
                                       len(ph.tables),
                                       len(ph.tables[0][2])),
                         pair_roofline_pct.read(ctx)))
    assert layouts[0] != layouts[1]
    assert readings[0] == readings[1]
    assert 0 < readings[0][1] < 100
