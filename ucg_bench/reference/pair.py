"""What every pair style of the reference shares, and the loader that finds
a deck's pair style by name: ``pair_styles/<pair_style>.py`` holds its
``Pair`` (a ``Style`` with ``compute``) and, where its settings file has
lines of its own, ``read_state_extra``.

Each directed pair (i, j) adds to bead i only; ``index_add_`` sums them,
block by block of pairs.
Everything runs in ``dtype`` (float64 for the reference, a lower precision
for the control) except the search for the pairs, which is exact.
"""

from __future__ import annotations

import importlib

import torch

from ucg_bench.reference.pairs import min_image, pairs_within

CHUNK = 1 << 23                 # pairs a block of the pair loop holds


def style_module(name: str):
    """The module of ``pair_style name``; ValueError where there is none."""
    mod = f"ucg_bench.reference.pair_styles.{name}"
    try:
        return importlib.import_module(mod)
    except ModuleNotFoundError as e:
        if e.name != mod:
            raise
        raise ValueError(f"pair_style {name} not followed") from None


def make(ph, bank, kT: float, dtype, device) -> "Style":
    """The deck's pair style on ``device`` in ``dtype``."""
    return style_module(ph.style).Pair(ph, bank, kT, dtype, device)


class Style:
    """A deck's pair style on one device, in one precision; a style's
    ``Pair`` adds ``compute(x, typ, lam, ucgstate, L)``."""

    def __init__(self, ph, bank, kT: float, dtype, device):
        def t(a, dt=dtype):
            return torch.as_tensor(a, dtype=dt, device=device)
        self.ph, self.bank, self.dtype = ph, bank, dtype
        self.kT = t(kT)
        self.tab4 = t(ph.tab4, torch.int64)
        self.cutsq = t(ph.cutsq)
        self.n_states = t(ph.n_states, torch.int64)
        self.mu = t(ph.mu)
        self.formal = t(ph.formal, torch.int64)
        self.use_density = t(ph.use_density, torch.int64)
        self.use_entropy = t(ph.use_entropy, torch.int64)
        self.cvt = t(ph.cv_threshold)
        self.rad = t(ph.radius)

    def geometry(self, x, typ, L):
        """(i, j) of every directed pair within its type pair's cutoff."""
        i, j = pairs_within(x, L, self.ph.max_cutoff)
        keep = torch.cat([(rsq < self.cutsq[typ[a], typ[b]])
                          for a, b, _, rsq in self.chunks(i, j, x, L)])
        return i[keep], j[keep]

    def chunks(self, i, j, x, L):
        """(i, j, dr, rsq) over blocks of ``CHUNK`` pairs, so that the
        per-pair working set fits beside the program's state."""
        x = x.to(self.dtype)
        Lt = torch.as_tensor(L, dtype=self.dtype, device=x.device)
        for p0 in range(0, len(i), CHUNK):
            a, b = i[p0:p0 + CHUNK], j[p0:p0 + CHUNK]
            dr = min_image(x[a] - x[b], Lt)
            yield a, b, dr, (dr * dr).sum(-1)

    def e4f4(self, ti, tj, rsq):
        tid = self.tab4[ti, tj]                               # (P, 2, 2)
        return self.bank.interp(tid, rsq[:, None, None].expand_as(tid))

    def near(self, x, L, mask, reach: float = 0.5):
        """Beads within the cutoff plus ``reach`` of a bead in ``mask``, and
        those beads themselves."""
        i, j = pairs_within(x, L, self.ph.max_cutoff + reach)
        out = mask.clone()
        out[i[mask[j]]] = True
        return out
