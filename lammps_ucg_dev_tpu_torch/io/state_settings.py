"""State-settings file parsers — the three dialects of the reference package.

1. ``ucgld`` / ``bethe`` dialect
   (``PairTable_UCGLD::read_state_settings``,
   UCG/pair_table_ucgld.cpp:543-652):

       4 6 2            <- n_actual_types n_formal_types max_states
       1 1              <- actual type 1, 1 state (plain CG)
       2 1
       3 1
       4 2              <- actual type 4, 2 states; 2 lines follow
       4 6                 <- formal types of the two states
       0.0 0.0             <- chemical potentials (per formal type)

2. ``bethe_density`` dialect
   (``PairTable_UCG_Bethe_Density::read_state_settings``,
   UCG/pair_table_ucg_bethe_density.cpp:778-893): the 2-state
   detail line is ``<formal0> <formal1> <density|single> <entropy|no_entropy>``
   followed (for ``density``) by ``<cv_threshold> <threshold_radius>`` and then
   the chemical-potential line.

3. ``rleucg`` dialect
   (``PairTable_RLEUCG_INTERFACE::read_state_settings``,
   UCG/pair_table_rleucg_interface.cpp:577-666): header is
   ``n_actual_types n_total_states``; per actual type one line
   ``<n_states> <density> <use_entropy|no_entropy>``, then (if n_states > 1)
   ``<cv_threshold> <threshold_radius>`` and ``<mu_0> ... <mu_{n-2}>``.
   Atom types enumerate SUBSTATES here; ``actual_types_from_state`` maps back.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StateSettings:
    """Parsed state settings, numpy, 1-based type indexing (index 0 unused)."""

    dialect: str
    n_actual_types: int
    n_formal_types: int            # rleucg: total number of substate types
    max_states: int
    n_states_per_type: np.ndarray      # (n_actual+1,)
    formal_from_actual: np.ndarray     # (n_actual+1, max_states); rleucg: state s of type i = i+s... via table
    actual_from_formal: np.ndarray     # (n_formal+1,)
    chemical_potentials: np.ndarray    # (n_formal+1,)
    use_entropy: np.ndarray            # (n_actual+1,)
    use_density: np.ndarray            # (n_actual+1,)
    cv_thresholds: np.ndarray          # (n_actual+1,)
    threshold_radii: np.ndarray        # (n_actual+1,)


def _lines(path_or_text: str):
    if "\n" in path_or_text:
        raw = path_or_text.splitlines()
    else:
        with open(path_or_text) as fh:
            raw = fh.read().splitlines()
    return [ln for ln in raw]


def parse_state_settings(path_or_text: str, dialect: str = "ucgld") -> StateSettings:
    lines = _lines(path_or_text)
    it = iter(lines)

    def nxt():
        try:
            return next(it)
        except StopIteration:
            raise ValueError("Unexpected end of UCG state settings file") from None

    if dialect in ("ucgld", "bethe", "bethe_density"):
        head = nxt().split()
        n_actual, n_formal, max_states = int(head[0]), int(head[1]), int(head[2])
        st = StateSettings(
            dialect=dialect,
            n_actual_types=n_actual,
            n_formal_types=n_formal,
            max_states=max_states,
            n_states_per_type=np.zeros(n_actual + 1, np.int32),
            formal_from_actual=np.zeros((n_actual + 1, max(max_states, 2)), np.int32),
            actual_from_formal=np.zeros(n_formal + 1, np.int32),
            chemical_potentials=np.zeros(n_formal + 1, np.float64),
            use_entropy=np.zeros(n_actual + 1, np.int32),
            use_density=np.zeros(n_actual + 1, np.int32),
            cv_thresholds=np.zeros(n_actual + 1, np.float64),
            threshold_radii=np.zeros(n_actual + 1, np.float64),
        )
        for i in range(1, n_actual + 1):
            toks = nxt().split()
            this_type, ns = int(toks[0]), int(toks[1])
            if this_type != i:
                raise ValueError(
                    f"Please write orderly: expected type {i}, got {this_type}"
                )
            if ns < 1 or ns > 2:
                raise ValueError(f"Invalid number of states for type {i}: {ns}")
            st.n_states_per_type[i] = ns
            if ns == 1:
                # 1-state types: formal type == actual type
                st.formal_from_actual[i, :] = i
                if i <= n_formal:
                    st.actual_from_formal[i] = i
                continue

            detail = nxt().split()
            formals = [int(detail[0]), int(detail[1])]
            st.formal_from_actual[i, 0] = formals[0]
            st.formal_from_actual[i, 1] = formals[1]
            for f in formals:
                st.actual_from_formal[f] = i

            if dialect == "bethe_density":
                state_type, entropy_spec = detail[2], detail[3]
                if entropy_spec == "entropy":
                    st.use_entropy[i] = 1
                elif entropy_spec == "no_entropy":
                    st.use_entropy[i] = 0
                else:
                    raise ValueError(f"Unknown entropy spec {entropy_spec!r}")
                if state_type == "density":
                    st.use_density[i] = 1
                    cv = nxt().split()
                    st.cv_thresholds[i] = float(cv[0])
                    st.threshold_radii[i] = float(cv[1])
                elif state_type != "single":
                    raise ValueError(f"Unknown state type {state_type!r}")

            mus = nxt().split()
            st.chemical_potentials[formals[0]] = float(mus[0])
            st.chemical_potentials[formals[1]] = float(mus[1])
        return st

    if dialect == "rleucg":
        head = nxt().split()
        n_actual, n_total_states = int(head[0]), int(head[1])
        max_states = 2
        rows = []
        for i in range(1, n_actual + 1):
            toks = nxt().split()
            ns = int(toks[0])
            state_type = toks[1] if len(toks) > 1 else "density"
            entropy_spec = toks[2] if len(toks) > 2 else "no_entropy"
            max_states = max(max_states, ns)
            cv = (0.0, 0.0)
            mus = []
            if ns > 1:
                if state_type != "density":
                    raise ValueError("Unknown state assignment type for RLEUCG")
                cvline = nxt().split()
                cv = (float(cvline[0]), float(cvline[1]))
                mus = [float(v) for v in nxt().split()[: ns - 1]]
            rows.append((ns, state_type, entropy_spec, cv, mus))

        st = StateSettings(
            dialect=dialect,
            n_actual_types=n_actual,
            n_formal_types=n_total_states,
            max_states=max_states,
            n_states_per_type=np.zeros(n_actual + 1, np.int32),
            formal_from_actual=np.zeros((n_actual + 1, max_states), np.int32),
            actual_from_formal=np.zeros(n_total_states + 1, np.int32),
            chemical_potentials=np.zeros(n_total_states + 1, np.float64),
            use_entropy=np.zeros(n_actual + 1, np.int32),
            use_density=np.zeros(n_actual + 1, np.int32),
            cv_thresholds=np.zeros(n_actual + 1, np.float64),
            threshold_radii=np.zeros(n_actual + 1, np.float64),
        )
        curr = 1
        for i, (ns, state_type, entropy_spec, cv, mus) in enumerate(rows, start=1):
            st.n_states_per_type[i] = ns
            st.use_entropy[i] = 1 if entropy_spec == "use_entropy" else 0
            st.use_density[i] = 1 if ns > 1 else 0
            st.cv_thresholds[i] = cv[0]
            st.threshold_radii[i] = cv[1]
            # substate type ids are consecutive (atom types ARE states);
            # chemical potentials attach to the first n_states-1 substates
            # (pair_table_rleucg_interface.cpp:646-653: mu stored at [i + j])
            for j in range(ns):
                st.formal_from_actual[i, j] = curr + j if j < st.formal_from_actual.shape[1] else 0
                st.actual_from_formal[curr + j] = i
            for j, mu in enumerate(mus):
                st.chemical_potentials[curr + j] = mu
            curr += ns
        if curr - 1 != n_total_states:
            raise ValueError(
                f"state count mismatch: header says {n_total_states}, rows sum to {curr - 1}"
            )
        return st

    raise ValueError(f"unknown state-settings dialect {dialect!r}")
