"""``pair_style table_ucgld`` written plainly over a list of pairs
(PairTable_UCGLD::compute, pair_table_ucgld.cpp:111-541): the forces mixed
over both beads' lambda weights, the lambda forces, the pair energy and the
state scores."""

from __future__ import annotations

import torch

from ucg_bench.reference.pair import Style


class Pair(Style):
    def compute(self, x, typ, lam, ucgstate, L):
        n = x.shape[0]
        i, j = self.geometry(x, typ, L)
        is_ucg = self.n_states[typ] > 1
        lam = lam.to(self.dtype)
        w1 = torch.where(is_ucg, lam, torch.zeros_like(lam))
        w = torch.stack([1 - w1, w1], -1)                     # (N, 2)
        f = torch.zeros((n, 3), dtype=self.dtype, device=x.device)
        lamf = torch.zeros(n, dtype=self.dtype, device=x.device)
        scores = torch.zeros((n, 2), dtype=self.dtype, device=x.device)
        pe = torch.zeros((), dtype=self.dtype, device=x.device)
        for a, b, dr, rsq in self.chunks(i, j, x, L):
            e4, f4 = self.e4f4(typ[a], typ[b], rsq)
            wi, wj = w[a], w[b]
            fmix = torch.einsum("ps,pt,pst->p", wi, wj, f4)
            pe = pe + 0.5 * torch.einsum("ps,pt,pst->p", wi, wj, e4).sum()
            f.index_add_(0, a, fmix[:, None] * dr)
            du = e4[:, 1, :] - e4[:, 0, :]
            lamf.index_add_(0, a, -(wj * du).sum(-1))
            js = (ucgstate[b] > 0)[:, None]
            scores.index_add_(0, a, -torch.where(js, e4[:, :, 1],
                                                 e4[:, :, 0]))
        scores = scores / self.kT
        mu_d = torch.where(is_ucg, self.mu[self.formal[typ, 1]]
                           - self.mu[self.formal[typ, 0]],
                           torch.zeros_like(lam))
        zero = torch.zeros((), dtype=self.dtype, device=x.device)
        lamf = torch.where(is_ucg, lamf - mu_d, zero)
        scores = torch.stack([scores[:, 0], scores[:, 1] - mu_d / self.kT], 1)
        scores = torch.where(is_ucg[:, None], scores, zero)
        return {"f": f, "lamf": lamf, "scores": scores, "pe": pe,
                "ucgp": None}
