"""Formal/actual type maps and the multi-table ``pair_coeff`` assembly (port
of ``lammps_ucg_dev_tpu/models/typemap.py``).

The reference distinguishes ACTUAL atom types from FORMAL types (one per
internal state of a UCG type); tables are indexed by formal-type pairs
(``PairTable_UCGLD::coeff``, ``UCG/pair_table_ucgld.cpp:719-865``).  The
whole mapping is precompiled into dense tensors:

    tab4[itype, jtype, si, sj] -> table id
    cutsq[itype, jtype]        -> interaction gate (the (0,0)-state cutoff)

``RLEUCGBuilder`` is the single-table assembly of ``table_rleucg_interface``,
whose atom types are substates: ``tabSS[i, j, si, sj]`` plays tab4's role.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.core.state import resolve_device
from lammps_ucg_dev_tpu_torch.io.state_settings import StateSettings
from lammps_ucg_dev_tpu_torch.io.table_io import read_table_file
from lammps_ucg_dev_tpu_torch.ops.table import BuiltTable, TableBank, build_table


@dataclasses.dataclass(frozen=True)
class UCGTypeParams:
    """Per-type UCG structure on the device (actual-type indexed, 1-based)."""

    n_states: torch.Tensor    # (T+1,) int32
    formal: torch.Tensor      # (T+1, 2) int32 formal type per state
    mu: torch.Tensor          # (F+1,) chemical potential per formal type
    mu_diff: torch.Tensor     # (T+1,) mu[formal1] - mu[formal0] (0 for 1-state)
    tab4: torch.Tensor        # (T+1, T+1, 2, 2) int64 table ids
    cutsq: torch.Tensor       # (T+1, T+1) pair gate
    use_density: torch.Tensor       # (T+1,) int32 (bethe_density dialect)
    use_entropy: torch.Tensor       # (T+1,) int32
    cv_threshold: torch.Tensor      # (T+1,) density threshold ρ*
    threshold_radius: torch.Tensor  # (T+1,) proximity radius R

    @property
    def ntypes(self) -> int:
        return self.cutsq.shape[0] - 1

    def is_ucg(self, typ: torch.Tensor) -> torch.Tensor:
        return self.n_states[typ] > 1


def _parse_bounds(spec, ntypes: int):
    """LAMMPS-style type bounds: int, '*', 'n*', '*n', 'n*m'."""
    s = str(spec)
    if "*" not in s:
        v = int(s)
        return v, v
    if s == "*":
        return 1, ntypes
    lo, hi = s.split("*")
    return (int(lo) if lo else 1), (int(hi) if hi else ntypes)


@dataclasses.dataclass
class TablePairBuilder:
    """Mirrors the reference's ``pair_style``/``pair_coeff`` assembly for the
    multi-table UCG styles. Produces a TableBank + UCGTypeParams."""

    tabstyle: str
    tablength: int
    settings: StateSettings

    def __post_init__(self):
        F = self.settings.n_formal_types
        self.tables: list[BuiltTable] = []
        self.tabindex = np.full((F + 1, F + 1), -1, dtype=np.int64)

    def pair_coeff(self, ispec, jspec, Ns_i: int, Ns_j: int, entries):
        """``entries`` is a list of Ns_i*Ns_j (table, cutoff) pairs in
        (si-major, sj-minor) order; ``table`` is a RawTable or a
        (filename, keyword) tuple."""
        st = self.settings
        ilo, ihi = _parse_bounds(ispec, st.n_actual_types)
        jlo, jhi = _parse_bounds(jspec, st.n_actual_types)
        for lo, hi, ns in ((ilo, ihi, Ns_i), (jlo, jhi, Ns_j)):
            for t in range(lo, hi + 1):
                if ns != st.n_states_per_type[t]:
                    raise ValueError(
                        f"Number of states for atom type {t} does not match "
                        "the settings file")
        if len(entries) != Ns_i * Ns_j:
            raise ValueError(f"Expected {Ns_i * Ns_j} (table, cutoff) "
                             f"entries, got {len(entries)}")
        e = 0
        for s_i in range(Ns_i):
            for s_j in range(Ns_j):
                table, cut = entries[e]
                e += 1
                if isinstance(table, tuple):
                    table = read_table_file(*table)
                built = build_table(table, self.tabstyle, self.tablength,
                                    float(cut))
                tid = len(self.tables)
                self.tables.append(built)
                count = 0
                for i in range(ilo, ihi + 1):
                    for j in range(max(jlo, i), jhi + 1):
                        fi = int(st.formal_from_actual[i, s_i])
                        fj = int(st.formal_from_actual[j, s_j])
                        if fi == 0 or fj == 0:
                            raise ValueError(f"Formal type not defined for "
                                             f"actual type {i}/{j}")
                        # DIRECTED assignment, like the reference's coeff()
                        # (:844); build() symmetrizes like init_one
                        self.tabindex[fi, fj] = tid
                        count += 1
                if count == 0:
                    raise ValueError("Illegal pair_coeff command")

    def build(self, dtype=torch.float32, device="cuda"):
        """(bank, tp) on ``device`` (the card unless told ``device="cpu"``;
        raises without CUDA)."""
        device = resolve_device(device)
        st = self.settings
        T, F = st.n_actual_types, st.n_formal_types
        if not self.tables:
            raise ValueError("No pair_coeff tables defined")
        # init_one symmetrization (:892): the UPPER triangular entry wins
        for a in range(1, F + 1):
            for b in range(a, F + 1):
                if self.tabindex[a, b] >= 0:
                    self.tabindex[b, a] = self.tabindex[a, b]
                elif self.tabindex[b, a] >= 0:
                    self.tabindex[a, b] = self.tabindex[b, a]

        tab4 = np.zeros((T + 1, T + 1, 2, 2), dtype=np.int64)
        cutsq = np.zeros((T + 1, T + 1), dtype=np.float64)
        cuts = np.array([t.cut for t in self.tables])
        ns = st.n_states_per_type
        for i in range(1, T + 1):
            for j in range(1, T + 1):
                for si in range(int(ns[i])):
                    for sj in range(int(ns[j])):
                        fi = int(st.formal_from_actual[i, si])
                        fj = int(st.formal_from_actual[j, sj])
                        tid = self.tabindex[fi, fj]
                        if tid < 0:
                            raise ValueError(f"All pair coeffs are not set: "
                                             f"formal pair ({fi},{fj})")
                        tab4[i, j, si, sj] = tid
                # unused state slots repeat state 0 so gathers stay in range
                for si in range(2):
                    for sj in range(2):
                        if tab4[i, j, si, sj] == 0 and (si >= ns[i]
                                                        or sj >= ns[j]):
                            tab4[i, j, si, sj] = tab4[
                                i, j, min(si, ns[i] - 1), min(sj, ns[j] - 1)]
                cutsq[i, j] = cuts[tab4[i, j, 0, 0]] ** 2

        bank = TableBank.from_built(self.tables, self.tabstyle, dtype=dtype,
                                    device=device)
        mu = np.asarray(st.chemical_potentials, dtype=np.float64)
        formal = np.zeros((T + 1, 2), dtype=np.int64)
        formal[:, :] = st.formal_from_actual[:, :2]
        mu_diff = np.where(ns[:T + 1] > 1, mu[formal[:, 1]] - mu[formal[:, 0]],
                           0.0)

        def t(a, dt):
            return torch.as_tensor(a, dtype=dt, device=device)

        tp = UCGTypeParams(
            n_states=t(np.asarray(ns), torch.int32),
            formal=t(formal, torch.int32), mu=t(mu, dtype),
            mu_diff=t(mu_diff, dtype), tab4=t(tab4, torch.int64),
            cutsq=t(cutsq, dtype),
            use_density=t(st.use_density, torch.int32),
            use_entropy=t(st.use_entropy, torch.int32),
            cv_threshold=t(st.cv_thresholds, dtype),
            threshold_radius=t(st.threshold_radii, dtype))
        return bank, tp

    @property
    def max_cutoff(self) -> float:
        return max(t.cut for t in self.tables)


@dataclasses.dataclass
class RLEUCGBuilder:
    """Single-table ``pair_coeff`` assembly over SUBSTATE types for
    ``table_rleucg_interface`` (P4), where atom types enumerate substates
    (``PairTable_RLEUCG_INTERFACE::coeff``,
    UCG/pair_table_rleucg_interface.cpp:672-744)."""

    tabstyle: str
    tablength: int
    settings: StateSettings   # rleucg dialect

    def __post_init__(self):
        S = self.settings.n_formal_types       # total substate types
        self.tables: list[BuiltTable] = []
        self.tabindex = np.full((S + 1, S + 1), -1, dtype=np.int64)

    def pair_coeff(self, ispec, jspec, table, cut: float):
        S = self.settings.n_formal_types
        ilo, ihi = _parse_bounds(ispec, S)
        jlo, jhi = _parse_bounds(jspec, S)
        if isinstance(table, tuple):
            table = read_table_file(*table)
        built = build_table(table, self.tabstyle, self.tablength, float(cut))
        tid = len(self.tables)
        self.tables.append(built)
        count = 0
        for i in range(ilo, ihi + 1):
            for j in range(max(jlo, i), jhi + 1):
                self.tabindex[i, j] = tid
                self.tabindex[j, i] = tid
                count += 1
        if count == 0:
            raise ValueError("Illegal pair_coeff command")

    def build(self, dtype=torch.float32, device="cuda"):
        """(bank, tabSS, cutsq) on ``device`` (the card unless told
        ``device="cpu"``; raises without CUDA): tabSS[i, j, si, sj] is the
        table of substate types (i + si, j + sj), clipped to the last type."""
        device = resolve_device(device)
        st = self.settings
        S = st.n_formal_types
        Smax = int(st.max_states)
        if np.any(self.tabindex[1:, 1:] < 0):
            missing = np.argwhere(self.tabindex[1:, 1:] < 0)[0] + 1
            raise ValueError(f"All pair coeffs are not set: pair "
                             f"{tuple(int(v) for v in missing)}")
        tabSS = np.zeros((S + 1, S + 1, Smax, Smax), dtype=np.int64)
        for i in range(1, S + 1):
            for j in range(1, S + 1):
                for si in range(Smax):
                    for sj in range(Smax):
                        tabSS[i, j, si, sj] = self.tabindex[min(i + si, S),
                                                            min(j + sj, S)]
        cuts = np.array([t.cut for t in self.tables])
        cutsq = np.zeros((S + 1, S + 1))
        cutsq[1:, 1:] = cuts[self.tabindex[1:, 1:]] ** 2
        bank = TableBank.from_built(self.tables, self.tabstyle, dtype=dtype,
                                    device=device)
        return (bank, torch.as_tensor(tabSS, dtype=torch.int64, device=device),
                torch.as_tensor(cutsq, dtype=dtype, device=device))

    @property
    def max_cutoff(self) -> float:
        return max(t.cut for t in self.tables)
