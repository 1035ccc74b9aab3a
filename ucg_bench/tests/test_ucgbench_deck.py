"""The seeded deck: byte for byte the same for one seed, another for
another seed, at the same sizes."""

import filecmp
import os

from ucg_bench.gen import decks


def _write(tmp_path, cfg, seed, tag):
    out = tmp_path / f"{cfg}-{tag}"
    d = decks.write_deck(decks.load_config(cfg),
                         decks.load_traffic("nvt_1m"), seed, str(out),
                         n_atoms=512)
    return out, d


def test_same_seed_same_bytes_other_seed_other_bytes(tmp_path):
    for cfg in ("ucgld_fluid", "bethe_density"):
        a, da = _write(tmp_path, cfg, 2**31 + 12345, "a")
        b, _ = _write(tmp_path, cfg, 2**31 + 12345, "b")
        c, dc = _write(tmp_path, cfg, 2**31 + 12346, "c")
        names = sorted(os.listdir(a))
        assert names == sorted(os.listdir(b)) == sorted(os.listdir(c))
        for name in names:
            assert filecmp.cmp(a / name, b / name, shallow=False), name
        assert not filecmp.cmp(a / "system.data", c / "system.data",
                               shallow=False)
        script_a = open(da["script"]).read()
        assert script_a != open(dc["script"]).read()
        # the seed sets the velocity, Langevin and switch seeds, not sizes
        assert da["n_atoms"] == dc["n_atoms"] == 512
        assert da["seeds"] != dc["seeds"]


def test_pinned_seed_molecule(tmp_path):
    for seed in range(6):
        out, _ = _write(tmp_path, "bethe_density", seed, f"p{seed}")
        rows = open(out / "system.data").read().split("Atoms # ucg\n\n")[1]
        assert rows.splitlines()[0].split()[2] == "2"


def test_deck_lines_before_run(tmp_path):
    from ucg_bench.harness import deck_commands
    _, d = _write(tmp_path, "ucgld_fluid", 5, "r")
    pre = deck_commands(d["script"])
    assert "run" not in [c.split()[0] for c in pre]
    assert [c.split()[0] for c in pre][-1] == "thermo"
    assert any(c.startswith("read_data") for c in pre)
