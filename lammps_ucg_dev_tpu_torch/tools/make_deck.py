"""Generate complete reference-style UCG input decks (data file, table files,
state-settings, rates/contacts files, input script) — the seven writers of
the JAX package's ``examples/make_deck.py``, writing the same bytes for the
same arguments through the port's ``io/table_io.write_table_file``.  The
deck grammar matches the reference package's user surface (SURVEY.md §5):
``compat.script.ScriptRunner`` runs these decks, and so does reference
LAMMPS.

    python -m lammps_ucg_dev_tpu_torch.tools.make_deck OUTDIR [--n N] [--steps S]

Beyond the JAX package's arguments, each writer takes ``tabstyle`` (the
``pair_style`` table style, ``linear`` by default; with ``bitmap`` the
``tablength`` is its number of index bits), and ``write_ucgld_deck`` takes
``tilt``: the box's ``xy xz yz`` in units of its length, written to the
data file.  The data file does not depend on ``tabstyle``: decks that
differ only in it read the same bytes.
"""

from __future__ import annotations

import os

import numpy as np

from lammps_ucg_dev_tpu_torch.io.table_io import (RLINEAR, RawTable,
                                                  write_table_file)


def soft_table(eps: float, rc: float, n: int = 2000, rlo: float = 1e-3):
    r = np.linspace(rlo, rc, n)
    e = eps * (1.0 + np.cos(np.pi * r / rc))
    f = eps * np.pi / rc * np.sin(np.pi * r / rc)
    return RawTable(r=r, e=e, f=f, rflag=RLINEAR, rlo=rlo, rhi=rc)


def lattice_positions(n: int, L: float, jitter: float = 0.05, seed: int = 1):
    rng = np.random.default_rng(seed)
    m = int(np.ceil(n ** (1 / 3)))
    a = L / m
    grid = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)[:n]
    return (grid + 0.5) * a + rng.normal(0, jitter, (n, 3))


def write_ucgld_deck(outdir: str, n: int = 4096, rho: float = 0.6,
                     rc: float = 2.5, eps=(1.0, 0.6, 0.6, 0.25),
                     mu=(0.0, 0.3), lam_mass: float = 5.0,
                     thermostat: bool = True, wall: bool = True,
                     T: float = 0.8, nsteps: int = 1000, dt: float = 0.004,
                     thermo_every: int = 100,
                     seed: int = 7, mol_per: int = 1,
                     tablength: int = 2000,
                     tabstyle: str = "linear",
                     tilt: tuple[float, float, float] | None = None) -> str:
    """Config-1/2 style deck: 2-state UCG-LD fluid (one actual type, formal
    types 1/2). Returns the input-script path."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    L = (n / rho) ** (1 / 3)
    x = lattice_positions(n, L, seed=seed)

    # tables: formal pairs (1,1) (1,2) (2,2) -> combos 00, 01=10, 11
    write_table_file(os.path.join(outdir, "ucg.table"), {
        "UCG_00": soft_table(eps[0], rc),
        "UCG_01": soft_table(eps[1], rc),
        "UCG_10": soft_table(eps[2], rc),
        "UCG_11": soft_table(eps[3], rc),
    })

    with open(os.path.join(outdir, "ucg.settings"), "w") as fh:
        fh.write("1 2 2\n1 2\n1 2\n%g %g\n" % mu)

    # data file
    with open(os.path.join(outdir, "system.data"), "w") as fh:
        fh.write("2-state UCG-LD fluid\n\n")
        fh.write(f"{n} atoms\n1 atom types\n\n")
        fh.write(f"0 {L:.10g} xlo xhi\n0 {L:.10g} ylo yhi\n0 {L:.10g} zlo zhi\n")
        if tilt is not None:
            fh.write(" ".join(f"{t * L:.10g}" for t in tilt) + " xy xz yz\n")
        fh.write("\nMasses\n\n1 1.0\n\n")
        fh.write("Atoms # ucg\n\n")
        lam0 = rng.uniform(0.2, 0.8, n)
        st0 = (lam0 > 0.5).astype(int)
        for k in range(n):
            mol = k // mol_per + 1
            fh.write(f"{k + 1} {mol} 1 0.0 {x[k, 0]:.10g} {x[k, 1]:.10g} "
                     f"{x[k, 2]:.10g} {st0[k]} {lam0[k]:.6f} {lam_mass}\n")

    lines = [
        "# 2-state UCG-LD fluid (reference configs 1-2)",
        "units lj",
        "dimension 3",
        "boundary p p p",
        "atom_style ucg",
        "read_data system.data",
        f"pair_style table_ucgld {tabstyle} {tablength} ucg.settings",
        "pair_coeff 1 1 2 2 "
        f"ucg.table UCG_00 {rc} ucg.table UCG_01 {rc} "
        f"ucg.table UCG_10 {rc} ucg.table UCG_11 {rc}",
        "neighbor 0.4 bin",
        "neigh_modify every 10",
        f"timestep {dt}",
        f"velocity all create {T} {seed + 1}",
    ]
    if wall:
        lines.append("fix 1 all nve/ucgld/wall/hard bias_potential 0.1")
    else:
        lines.append("fix 1 all nve/ucgld")
    if thermostat:
        lines.append(f"fix 2 all ucgld/langevin {T} {T} 0.5 {seed + 2}")
    lines += [
        "fix 3 all ucgstate ld",
        f"thermo {thermo_every}",
        f"run {nsteps}",
    ]
    path = os.path.join(outdir, "in.ucgld")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def write_bethe_deck(outdir: str, n: int = 512, rho: float = 0.5,
                     rc: float = 2.5, nsteps: int = 200, dt: float = 0.002,
                     T: float = 0.8, pseudo: str = "yes", method: str = "bethe",
                     thermo_every: int = 50, seed: int = 11,
                     tablength: int = 1200,
                     tabstyle: str = "linear") -> str:
    """Config-3 style deck: two-state self-consistent Bethe UCG +
    fix ucgstate."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    L = (n / rho) ** (1 / 3)
    x = lattice_positions(n, L, seed=seed)
    write_table_file(os.path.join(outdir, "ucg.table"), {
        "UCG_00": soft_table(1.0, rc), "UCG_01": soft_table(0.6, rc),
        "UCG_10": soft_table(0.6, rc), "UCG_11": soft_table(0.25, rc),
    })
    with open(os.path.join(outdir, "ucg.settings"), "w") as fh:
        fh.write("1 2 2\n1 2\n1 2\n0.0 0.3\n")
    with open(os.path.join(outdir, "system.data"), "w") as fh:
        fh.write("two-state self-consistent Bethe UCG\n\n")
        fh.write(f"{n} atoms\n1 atom types\n\n")
        fh.write(f"0 {L:.10g} xlo xhi\n0 {L:.10g} ylo yhi\n0 {L:.10g} zlo zhi\n\n")
        fh.write("Masses\n\n1 1.0\n\nAtoms # ucg\n\n")
        lam0 = rng.uniform(0.3, 0.7, n)
        for k in range(n):
            fh.write(f"{k + 1} {k + 1} 1 0.0 {x[k, 0]:.10g} {x[k, 1]:.10g} "
                     f"{x[k, 2]:.10g} {int(lam0[k] > 0.5)} {lam0[k]:.6f} 5.0\n")
    lines = [
        "units lj", "atom_style ucg", "read_data system.data",
        f"pair_style table_ucg_bethe {tabstyle} {tablength} ucg.settings "
        f"method {method} pseudo {pseudo} prior chemical_potential",
        "pair_coeff 1 1 2 2 "
        f"ucg.table UCG_00 {rc} ucg.table UCG_01 {rc} "
        f"ucg.table UCG_10 {rc} ucg.table UCG_11 {rc}",
        "neighbor 0.4 bin", "neigh_modify every 5",
        f"timestep {dt}", f"velocity all create {T} {seed + 1}",
        "fix 1 all nve/ucgld",
        f"fix 2 all ucgld/langevin {T} {T} 0.5 {seed + 2}",
        "fix 3 all ucgstate",
        f"thermo {thermo_every}", f"run {nsteps}",
    ]
    path = os.path.join(outdir, "in.bethe")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def write_bethe_density_deck(outdir: str, n: int = 512, rho: float = 0.5,
                             rc: float = 2.5, nsteps: int = 100,
                             dt: float = 0.002, T: float = 0.8,
                             switch_freq: int = 20, thermo_every: int = 50,
                             seed: int = 13, tablength: int = 1200,
                             tabstyle: str = "linear") -> str:
    """Config-4 style deck: density-dependent states (2 actual types: CG
    solvent + density-CV UCG) + fix cluster_switch."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    L = (n / rho) ** (1 / 3)
    x = lattice_positions(n, L, seed=seed)
    typ = np.where(rng.uniform(size=n) < 0.7, 2, 1)
    write_table_file(os.path.join(outdir, "ucg.table"), {
        "T11": soft_table(1.0, rc),
        "T12": soft_table(0.8, rc), "T13": soft_table(0.5, rc),
        "T22": soft_table(0.9, rc), "T23": soft_table(0.55, rc),
        "T33": soft_table(0.3, rc),
    })
    with open(os.path.join(outdir, "ucg.settings"), "w") as fh:
        fh.write("2 3 2\n1 1\n2 2\n2 3 density entropy\n6.0 1.5\n0.0 0.2\n")
    with open(os.path.join(outdir, "rates.txt"), "w") as fh:
        fh.write("0.5\n1\n2\n1\n")   # probON; 1 switch type; ON=2; OFF=1
    with open(os.path.join(outdir, "contacts.txt"), "w") as fh:
        fh.write("n 1\nm 1\n2 2\n")
    with open(os.path.join(outdir, "system.data"), "w") as fh:
        fh.write("density-CV UCG + cluster switching\n\n")
        fh.write(f"{n} atoms\n2 atom types\n\n")
        fh.write(f"0 {L:.10g} xlo xhi\n0 {L:.10g} ylo yhi\n0 {L:.10g} zlo zhi\n\n")
        fh.write("Masses\n\n1 1.0\n2 1.0\n\nAtoms # ucg\n\n")
        for k in range(n):
            fh.write(f"{k + 1} {k + 1} {typ[k]} 0.0 {x[k, 0]:.10g} "
                     f"{x[k, 1]:.10g} {x[k, 2]:.10g} 0 0.5 5.0\n")
    lines = [
        "units lj", "atom_style ucg", "read_data system.data",
        f"pair_style table_ucg_bethe_density {tabstyle} {tablength} "
        "ucg.settings",
        f"pair_coeff 1 1 1 1 ucg.table T11 {rc}",
        "pair_coeff 1 2 1 2 "
        f"ucg.table T12 {rc} ucg.table T13 {rc}",
        "pair_coeff 2 2 2 2 "
        f"ucg.table T22 {rc} ucg.table T23 {rc} "
        f"ucg.table T23 {rc} ucg.table T33 {rc}",
        "neighbor 0.4 bin", "neigh_modify every 10",
        f"timestep {dt}", f"velocity all create {T} {seed + 1}",
        "fix 1 all nve/ucgld",
        f"fix 2 all ucgld/langevin {T} {T} 0.5 {seed + 2}",
        f"fix 4 all cluster_switch 1 0 1.3 {seed + 3} rateFreq {switch_freq} "
        "rateFile rates.txt contactFile contacts.txt",
        f"thermo {thermo_every}", f"run {nsteps}",
    ]
    path = os.path.join(outdir, "in.bethe_density")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def write_rleucg_deck(outdir: str, n: int = 512, rho: float = 0.5,
                      rc: float = 2.5, nsteps: int = 100, dt: float = 0.002,
                      T: float = 0.8, thermo_every: int = 50, seed: int = 17,
                      tablength: int = 1200,
                      tabstyle: str = "linear") -> str:
    """Config-5 style deck: confined-interface RLE-UCG (substate types) +
    fix nve/ucgld/wall/hard."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    L = (n / rho) ** (1 / 3)
    x = lattice_positions(n, L, seed=seed)
    # base substate types: 1 (2-state actual 1) or 3 (1-state actual 2)
    typ = np.where(rng.uniform(size=n) < 0.7, 1, 3)
    write_table_file(os.path.join(outdir, "rle.table"), {
        "T11": soft_table(1.0, rc), "T12": soft_table(0.7, rc),
        "T13": soft_table(0.8, rc), "T22": soft_table(0.4, rc),
        "T23": soft_table(0.5, rc), "T33": soft_table(0.9, rc),
    })
    with open(os.path.join(outdir, "rle.settings"), "w") as fh:
        fh.write("2 3\n2 density use_entropy\n5.0 1.5\n0.4\n1 density no_entropy\n")
    with open(os.path.join(outdir, "system.data"), "w") as fh:
        fh.write("RLE-UCG interface system\n\n")
        fh.write(f"{n} atoms\n3 atom types\n\n")
        fh.write(f"0 {L:.10g} xlo xhi\n0 {L:.10g} ylo yhi\n0 {L:.10g} zlo zhi\n\n")
        fh.write("Masses\n\n1 1.0\n2 1.0\n3 1.0\n\nAtoms # ucg\n\n")
        for k in range(n):
            fh.write(f"{k + 1} {k + 1} {typ[k]} 0.0 {x[k, 0]:.10g} "
                     f"{x[k, 1]:.10g} {x[k, 2]:.10g} 0 0.5 5.0\n")
    lines = [
        "units lj", "atom_style ucg", "read_data system.data",
        f"pair_style table_rleucg_interface {tabstyle} {tablength} "
        "rle.settings",
        f"pair_coeff 1 1 rle.table T11 {rc}",
        f"pair_coeff 1 2 rle.table T12 {rc}",
        f"pair_coeff 1 3 rle.table T13 {rc}",
        f"pair_coeff 2 2 rle.table T22 {rc}",
        f"pair_coeff 2 3 rle.table T23 {rc}",
        f"pair_coeff 3 3 rle.table T33 {rc}",
        "neighbor 0.4 bin", "neigh_modify every 10",
        f"timestep {dt}", f"velocity all create {T} {seed + 1}",
        "fix 1 all nve/ucgld/wall/hard bias_potential 0.1",
        f"fix 2 all ucgld/langevin {T} {T} 0.5 {seed + 2}",
        f"thermo {thermo_every}", f"run {nsteps}",
    ]
    path = os.path.join(outdir, "in.rleucg")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def write_molecular_switch_deck(outdir: str, nmol: int = 64, rho: float = 0.1,
                                rc: float = 2.5, nsteps: int = 100,
                                dt: float = 0.002, T: float = 0.8,
                                switch_freq: int = 20, thermo_every: int = 50,
                                seed: int = 23, tablength: int = 1200,
                                tabstyle: str = "linear",
                                bond_r0: float = 0.9, bond_k: float = 50.0,
                                angle_k: float = 10.0) -> str:
    """Molecular deck: 3-atom bonded molecules (A-B-C chain, 2 harmonic
    bonds + 1 harmonic angle) under ``fix cluster_switch`` — exercises the
    reference's molecule-level machinery (whole-molecule type flips,
    contact-gated clustering, fix_cluster_switch.cpp:799-823) together with
    the bonded force styles the molecular atom style implies
    (atom_vec_ucg.cpp:33-96).  Both atom types are single-state, so the UCG
    pair style reduces to plain tabulated CG pairs; type 1 = OFF, 2 = ON."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = 3 * nmol
    L = (n / rho) ** (1 / 3)
    centers = lattice_positions(nmol, L, jitter=0.1, seed=seed)
    # linear trimer along a random direction, |bond| = bond_r0
    dirs = rng.normal(size=(nmol, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    x = np.concatenate([centers - bond_r0 * dirs, centers,
                        centers + bond_r0 * dirs], axis=1).reshape(-1, 3) % L
    typ = np.where(rng.uniform(size=nmol) < 0.5, 1, 2)

    write_table_file(os.path.join(outdir, "mol.table"), {
        "T11": soft_table(1.0, rc), "T12": soft_table(0.6, rc),
        "T22": soft_table(0.3, rc),
    })
    with open(os.path.join(outdir, "mol.settings"), "w") as fh:
        # 2 actual types, 2 formal types, 1 state each (plain CG)
        fh.write("2 2 1\n1 1\n2 1\n0.0\n0.0\n")
    with open(os.path.join(outdir, "rates.txt"), "w") as fh:
        fh.write("0.5\n1\n2\n1\n")   # probON; 1 switch type; ON=2; OFF=1
    with open(os.path.join(outdir, "contacts.txt"), "w") as fh:
        fh.write("n 1\nm 1\n2 2\n")

    with open(os.path.join(outdir, "system.data"), "w") as fh:
        fh.write("bonded trimers + cluster switching\n\n")
        fh.write(f"{n} atoms\n{2 * nmol} bonds\n{nmol} angles\n"
                 "2 atom types\n1 bond types\n1 angle types\n\n")
        fh.write(f"0 {L:.10g} xlo xhi\n0 {L:.10g} ylo yhi\n0 {L:.10g} zlo zhi\n\n")
        fh.write("Masses\n\n1 1.0\n2 1.0\n\nAtoms # ucg\n\n")
        for k in range(n):
            mol = k // 3 + 1
            fh.write(f"{k + 1} {mol} {typ[k // 3]} 0.0 {x[k, 0]:.10g} "
                     f"{x[k, 1]:.10g} {x[k, 2]:.10g} 0 0.5 5.0\n")
        fh.write("\nBonds\n\n")
        b = 1
        for m in range(nmol):
            a1 = 3 * m + 1
            fh.write(f"{b} 1 {a1} {a1 + 1}\n"); b += 1
            fh.write(f"{b} 1 {a1 + 1} {a1 + 2}\n"); b += 1
        fh.write("\nAngles\n\n")
        for m in range(nmol):
            a1 = 3 * m + 1
            fh.write(f"{m + 1} 1 {a1} {a1 + 1} {a1 + 2}\n")

    lines = [
        "units lj", "atom_style ucg", "read_data system.data",
        f"pair_style table_ucgld {tabstyle} {tablength} mol.settings",
        f"pair_coeff 1 1 1 1 mol.table T11 {rc}",
        f"pair_coeff 1 2 1 1 mol.table T12 {rc}",
        f"pair_coeff 2 2 1 1 mol.table T22 {rc}",
        "bond_style harmonic", f"bond_coeff 1 {bond_k} {bond_r0}",
        "angle_style harmonic", f"angle_coeff 1 {angle_k} 180.0",
        "special_bonds lj 0 0 0",
        "neighbor 0.4 bin", "neigh_modify every 5",
        f"timestep {dt}", f"velocity all create {T} {seed + 1}",
        "fix 1 all nve/ucgld",
        f"fix 4 all cluster_switch 1 0 1.3 {seed + 3} rateFreq {switch_freq} "
        "rateFile rates.txt contactFile contacts.txt",
        f"thermo {thermo_every}", f"run {nsteps}",
    ]
    path = os.path.join(outdir, "in.molecular_switch")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def write_molecular_ucgld_deck(outdir: str, nmol: int = 256,
                               rho: float = 0.3, rc: float = 2.5,
                               eps=(1.0, 0.6, 0.6, 0.25), mu=(0.0, 0.3),
                               lam_mass: float = 5.0, T: float = 0.8,
                               nsteps: int = 200, dt: float = 0.002,
                               thermo_every: int = 50, seed: int = 31,
                               tablength: int = 2000,
                               tabstyle: str = "linear",
                               bond_r0: float = 0.9, bond_k: float = 50.0,
                               angle_k: float = 10.0) -> str:
    """Molecular UCG-LD deck: bent trimers of ONE 2-state UCG type under
    λ-dynamics, harmonic bonds + angles, and the LAMMPS-default
    ``special_bonds`` exclusion of 1-2/1-3 pairs.  On TPU this deck
    auto-selects the fused column kernel WITH the bonded/exclusion
    composition (additive bonded terms + excl_delta subtraction,
    ops/kernel_select.py) — the configuration the reference runs as
    `atom_style ucg` molecular systems (atom_vec_ucg.cpp:33-96, bonded
    styles via stock LAMMPS; special culling via the neighbor list)."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = 3 * nmol
    L = (n / rho) ** (1 / 3)
    centers = lattice_positions(nmol, L, jitter=0.1, seed=seed)
    u1 = rng.normal(size=(nmol, 3))
    u1 /= np.linalg.norm(u1, axis=1, keepdims=True)
    p = rng.normal(size=(nmol, 3))
    p -= np.sum(p * u1, axis=1, keepdims=True) * u1
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    th = np.deg2rad(120.0)
    u2 = np.cos(th) * u1 + np.sin(th) * p
    x = np.concatenate([centers + bond_r0 * u1, centers,
                        centers + bond_r0 * u2], axis=1).reshape(-1, 3) % L

    write_table_file(os.path.join(outdir, "ucg.table"), {
        "UCG_00": soft_table(eps[0], rc), "UCG_01": soft_table(eps[1], rc),
        "UCG_10": soft_table(eps[2], rc), "UCG_11": soft_table(eps[3], rc),
    })
    with open(os.path.join(outdir, "ucg.settings"), "w") as fh:
        fh.write("1 2 2\n1 2\n1 2\n%g %g\n" % mu)

    with open(os.path.join(outdir, "system.data"), "w") as fh:
        fh.write("UCG-LD trimers\n\n")
        fh.write(f"{n} atoms\n{2 * nmol} bonds\n{nmol} angles\n"
                 "1 atom types\n1 bond types\n1 angle types\n\n")
        fh.write(f"0 {L:.10g} xlo xhi\n0 {L:.10g} ylo yhi\n"
                 f"0 {L:.10g} zlo zhi\n\n")
        fh.write("Masses\n\n1 1.0\n\nAtoms # ucg\n\n")
        lam0 = rng.uniform(0.2, 0.8, n)
        st0 = (lam0 > 0.5).astype(int)
        for k in range(n):
            fh.write(f"{k + 1} {k // 3 + 1} 1 0.0 {x[k, 0]:.10g} "
                     f"{x[k, 1]:.10g} {x[k, 2]:.10g} {st0[k]} "
                     f"{lam0[k]:.6f} {lam_mass}\n")
        fh.write("\nBonds\n\n")
        b = 1
        for m in range(nmol):
            a1 = 3 * m + 1
            fh.write(f"{b} 1 {a1} {a1 + 1}\n"); b += 1
            fh.write(f"{b} 1 {a1 + 1} {a1 + 2}\n"); b += 1
        fh.write("\nAngles\n\n")
        for m in range(nmol):
            a1 = 3 * m + 1
            fh.write(f"{m + 1} 1 {a1} {a1 + 1} {a1 + 2}\n")

    lines = [
        "# molecular 2-state UCG-LD trimers (bonded + exclusion + kernel)",
        "units lj", "atom_style ucg", "read_data system.data",
        f"pair_style table_ucgld {tabstyle} {tablength} ucg.settings",
        "pair_coeff 1 1 2 2 "
        f"ucg.table UCG_00 {rc} ucg.table UCG_01 {rc} "
        f"ucg.table UCG_10 {rc} ucg.table UCG_11 {rc}",
        "bond_style harmonic", f"bond_coeff 1 {bond_k} {bond_r0}",
        "angle_style harmonic", f"angle_coeff 1 {angle_k} 120.0",
        "special_bonds lj 0 0 0",
        "neighbor 0.4 bin", "neigh_modify every 5",
        f"timestep {dt}", f"velocity all create {T} {seed + 1}",
        "fix 1 all nve/ucgld/wall/hard",
        f"fix 2 all ucgld/langevin {T} {T} 0.5 {seed + 2}",
        "fix 3 all ucgstate ld",
        f"thermo {thermo_every}", f"run {nsteps}",
    ]
    path = os.path.join(outdir, "in.molecular_ucgld")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def write_molecular_tetramer_deck(outdir: str, nmol: int = 128,
                                  rho: float = 0.2, rc: float = 2.5,
                                  eps=(1.0, 0.6, 0.6, 0.25), mu=(0.0, 0.3),
                                  lam_mass: float = 5.0, T: float = 0.8,
                                  nsteps: int = 200, dt: float = 0.002,
                                  thermo_every: int = 50, seed: int = 37,
                                  tablength: int = 2000,
                                  tabstyle: str = "linear") -> str:
    """Tetramer chains with the FULL molecular topology surface: harmonic
    bonds + angles + dihedrals + impropers and the LAMMPS-default 1-2/1-3/1-4
    special exclusions — the complete `atom_style ucg` molecular deck
    (atom_vec_ucg.cpp:33-96 carries all four term classes; forces come from
    the stock harmonic styles)."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = 4 * nmol
    L = (n / rho) ** (1 / 3)
    centers = lattice_positions(nmol, L, jitter=0.1, seed=seed)
    xs = []
    for m in range(nmol):
        pts = [centers[m]]
        prev = None
        for _ in range(3):
            step = rng.normal(size=3)
            step /= np.linalg.norm(step)
            if prev is not None:
                while abs(step @ prev) > 0.7:     # avoid collinear chains
                    step = rng.normal(size=3)
                    step /= np.linalg.norm(step)
            pts.append(pts[-1] + 0.8 * step)
            prev = step
        xs.append(np.stack(pts))
    x = np.concatenate(xs) % L

    write_table_file(os.path.join(outdir, "ucg.table"), {
        "UCG_00": soft_table(eps[0], rc), "UCG_01": soft_table(eps[1], rc),
        "UCG_10": soft_table(eps[2], rc), "UCG_11": soft_table(eps[3], rc),
    })
    with open(os.path.join(outdir, "ucg.settings"), "w") as fh:
        fh.write("1 2 2\n1 2\n1 2\n%g %g\n" % mu)

    with open(os.path.join(outdir, "system.data"), "w") as fh:
        fh.write("UCG-LD tetramer chains\n\n")
        fh.write(f"{n} atoms\n{3 * nmol} bonds\n{2 * nmol} angles\n"
                 f"{nmol} dihedrals\n{nmol} impropers\n"
                 "1 atom types\n1 bond types\n1 angle types\n"
                 "1 dihedral types\n1 improper types\n\n")
        fh.write(f"0 {L:.10g} xlo xhi\n0 {L:.10g} ylo yhi\n"
                 f"0 {L:.10g} zlo zhi\n\n")
        fh.write("Masses\n\n1 1.0\n\nAtoms # ucg\n\n")
        lam0 = rng.uniform(0.2, 0.8, n)
        st0 = (lam0 > 0.5).astype(int)
        for k in range(n):
            fh.write(f"{k + 1} {k // 4 + 1} 1 0.0 {x[k, 0]:.10g} "
                     f"{x[k, 1]:.10g} {x[k, 2]:.10g} {st0[k]} "
                     f"{lam0[k]:.6f} {lam_mass}\n")
        fh.write("\nBonds\n\n")
        b = 1
        for m in range(nmol):
            a1 = 4 * m + 1
            for k in range(3):
                fh.write(f"{b} 1 {a1 + k} {a1 + k + 1}\n"); b += 1
        fh.write("\nAngles\n\n")
        for m in range(nmol):
            a1 = 4 * m + 1
            fh.write(f"{2 * m + 1} 1 {a1} {a1 + 1} {a1 + 2}\n")
            fh.write(f"{2 * m + 2} 1 {a1 + 1} {a1 + 2} {a1 + 3}\n")
        fh.write("\nDihedrals\n\n")
        for m in range(nmol):
            a1 = 4 * m + 1
            fh.write(f"{m + 1} 1 {a1} {a1 + 1} {a1 + 2} {a1 + 3}\n")
        fh.write("\nImpropers\n\n")
        for m in range(nmol):
            a1 = 4 * m + 1
            fh.write(f"{m + 1} 1 {a1} {a1 + 1} {a1 + 2} {a1 + 3}\n")

    lines = [
        "# tetramer UCG-LD chains: bonds + angles + dihedrals + impropers",
        "units lj", "atom_style ucg", "read_data system.data",
        f"pair_style table_ucgld {tabstyle} {tablength} ucg.settings",
        "pair_coeff 1 1 2 2 "
        f"ucg.table UCG_00 {rc} ucg.table UCG_01 {rc} "
        f"ucg.table UCG_10 {rc} ucg.table UCG_11 {rc}",
        "bond_style harmonic", "bond_coeff 1 50.0 0.8",
        "angle_style harmonic", "angle_coeff 1 10.0 110.0",
        "dihedral_style harmonic", "dihedral_coeff 1 2.0 1 3",
        "improper_style harmonic", "improper_coeff 1 1.5 35.0",
        "special_bonds lj 0 0 0",
        "neighbor 0.4 bin", "neigh_modify every 5 one 96",
        f"timestep {dt}", f"velocity all create {T} {seed + 1}",
        "fix 1 all nve/ucgld/wall/hard",
        f"fix 2 all ucgld/langevin {T} {T} 0.5 {seed + 2}",
        "fix 3 all ucgstate ld",
        f"thermo {thermo_every}", f"run {nsteps}",
    ]
    path = os.path.join(outdir, "in.molecular_tetramer")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path



def add_bonds(deck: str, nbonds: int, bond_k: float = 10.0,
              bond_r0: float = 1.0) -> str:
    """Bond atoms 2k+1 and 2k+2 for k < ``nbonds`` in the data file that the
    deck at ``deck`` reads: one harmonic bond type, its pairs excluded from
    the pair lists by ``special_bonds lj 0 0 0``; the deck declares those
    styles before its ``velocity`` line.  Returns ``deck``."""
    with open(deck) as fh:
        text = fh.read()
    data = os.path.join(os.path.dirname(deck), next(
        ln.split()[1] for ln in text.splitlines()
        if ln.startswith("read_data")))
    with open(data) as fh:
        body = fh.read()
    body = body.replace(" atoms\n", f" atoms\n{nbonds} bonds\n"
                        "1 bond types\n", 1)
    body += "\nBonds\n\n" + "".join(f"{k + 1} 1 {2 * k + 1} {2 * k + 2}\n"
                                    for k in range(nbonds))
    with open(data, "w") as fh:
        fh.write(body)
    text = text.replace("velocity", f"bond_style harmonic\nbond_coeff 1 "
                        f"{bond_k} {bond_r0}\nspecial_bonds lj 0 0 0\n"
                        "velocity", 1)
    with open(deck, "w") as fh:
        fh.write(text)
    return deck

if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=1000)
    args = ap.parse_args()
    print(write_ucgld_deck(args.outdir, n=args.n, nsteps=args.steps))
