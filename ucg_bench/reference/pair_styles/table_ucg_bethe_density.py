"""``pair_style table_ucg_bethe_density`` written plainly over a list of
pairs (PairTable_UCG_Bethe_Density::compute,
pair_table_ucg_bethe_density.cpp:133-758, in the conventions the port
documents: the real in-cutoff count in the one-body entropy, the
conservative CV back-force with -dw/dr, the stable Bethe log ratio)."""

from __future__ import annotations

import torch

from ucg_bench.reference.pair import Style

_PEPS = 1e-12
_EPSILONE = 1e-6


def read_state_extra(d: list, it, i: int, arr: dict):
    """A UCG type's line ``formal0 formal1 density|- entropy|-`` of the
    settings file, and the density line ``cv_threshold radius`` after it."""
    arr["use_entropy"][i] = d[3] == "entropy"
    if d[2] == "density":
        arr["use_density"][i] = 1
        arr["cv_threshold"][i], arr["radius"][i] = (
            float(v) for v in next(it).split())


class Pair(Style):
    def _priors(self, typ, rho):
        is_ucg = self.n_states[typ] > 1
        use_den = (self.use_density[typ] == 1) & is_ucg
        cvt = torch.clamp(self.cvt[typ], min=_PEPS)
        th = torch.tanh((rho - cvt) / (0.1 * cvt))
        p_thr, part = 0.5 + 0.5 * th, 0.5 * (1 - th * th) / (0.1 * cvt)
        b0 = torch.exp(-self.mu[self.formal[typ, 0]] / self.kT)
        b1 = torch.exp(-self.mu[self.formal[typ, 1]] / self.kT)
        one = torch.ones((), dtype=self.dtype, device=rho.device)
        p0 = torch.where(use_den, p_thr,
                         torch.where(is_ucg, b0 / (b0 + b1), one))
        partial0 = torch.where(use_den, part, torch.zeros_like(one))
        return torch.stack([p0, 1 - p0], -1), partial0

    def _bethe_p11(self, J, pi1, pj1):
        """p11 of the Bethe two-point distribution (:544-581): the root of
        (1 - b) p11^2 + Q p11 - b pi pj = 0 with b = e^{-J/kT}, a = b - 1,
        Q = (pi + pj) a + 1, taken for x = -J/kT >= 0 with every term
        scaled by 1/b (t = e^{-x}), so that no precision overflows."""
        kT = self.kT
        xx = -torch.maximum(J, -700.0 * kT) / kT
        t = torch.exp(-xx.abs())
        pp = pi1 * pj1
        # x >= 0: Q/b = (pi + pj)(1 - t) + t, D/b^2 = (Q/b)^2 - 4 (1 - t) pp
        Qs = (pi1 + pj1) * (1.0 - t) + t
        pos = 2.0 * pp / (Qs + torch.sqrt(torch.clamp(
            Qs * Qs - 4.0 * (1.0 - t) * pp, min=0.0)))
        # x < 0: b = t, a = expm1(x)
        a = torch.expm1(-xx.abs())
        Q = (pi1 + pj1) * a + 1.0
        sqD = torch.sqrt(torch.clamp(Q * Q - 4.0 * a * t * pp, min=0.0))
        small = torch.abs(a) < _EPSILONE
        neg = torch.where(Q < 0.0, (Q - sqD) / (2.0 * torch.where(
            small, torch.ones_like(a), a)), 2.0 * t * pp / (Q + sqD))
        return torch.where(small, pp, torch.where(xx >= 0.0, pos, neg))

    def _log_ratio(self, J, pi1, pj1):
        def lg(v):
            return torch.log(torch.clamp(v, min=_PEPS))
        xx = torch.clamp(-J / self.kT, max=700.0)
        e1, e0 = pj1 - pi1, 1.0 - pi1 - pj1
        c4 = 4.0 * pi1 * (1.0 - pi1)
        t = torch.exp(-torch.abs(xx))
        Es = e1 + e0 * t
        Ds = torch.sqrt(torch.clamp(Es * Es + c4 * t, min=0.0))
        pos = torch.where(Es >= 0, lg(2 * pi1) - lg(Es + Ds),
                          xx + lg(Ds - Es) - lg(2 * (1 - pi1)))
        Eu = e1 * t + e0
        Du = torch.sqrt(torch.clamp(Eu * Eu + c4 * t, min=0.0))
        neg = torch.where(Eu >= 0, xx + lg(2 * pi1) - lg(Eu + Du),
                          lg(Du - Eu) - lg(2 * (1 - pi1)))
        return torch.where(xx >= 0, pos, neg)

    def compute(self, x, typ, lam, ucgstate, L):
        n = x.shape[0]
        kT = self.kT
        dev, dt = x.device, self.dtype
        i, j = self.geometry(x, typ, L)
        zero = torch.zeros((), dtype=dt, device=dev)
        is_ucg = self.n_states[typ] > 1
        use_den = (self.use_density[typ] == 1) & is_ucg
        rad = torch.clamp(self.rad[typ], min=_PEPS)
        # pass 1: local density and the in-cutoff count
        rho = torch.zeros(n, dtype=dt, device=dev)
        for a, b, dr, rsq in self.chunks(i, j, x, L):
            ra = rad[a]
            rho.index_add_(0, a, 0.5 * (1 - torch.tanh(
                (torch.sqrt(rsq) - ra) / (0.1 * ra))))
        n_real = torch.bincount(i, minlength=n).to(dt)
        prior, partial0 = self._priors(typ, rho)
        pi1 = prior[:, 1]
        logp = torch.log(torch.clamp(prior, min=_PEPS))
        # pass 2: Bethe mixing, the prior forces, the scores
        f = torch.zeros((n, 3), dtype=dt, device=dev)
        pf = torch.zeros((n, 2), dtype=dt, device=dev)
        scores = torch.zeros((n, 2), dtype=dt, device=dev)
        pe = torch.zeros((), dtype=dt, device=dev)
        for a, b, dr, rsq in self.chunks(i, j, x, L):
            e4, f4 = self.e4f4(typ[a], typ[b], rsq)
            p1i, p1j = pi1[a], pi1[b]
            J = e4[:, 1, 1] + e4[:, 0, 0] - e4[:, 0, 1] - e4[:, 1, 0]
            p11 = self._bethe_p11(J, p1i, p1j)
            p4 = torch.stack([
                torch.stack([1 + p11 - p1i - p1j, p1j - p11], -1),
                torch.stack([p1i - p11, p11], -1)], -2)
            f.index_add_(0, a, (p4 * f4).sum((-1, -2))[:, None] * dr)
            pe = pe + 0.5 * (p4 * e4).sum()
            lr = self._log_ratio(J, p1i, p1j)
            ucg1 = -(e4[:, 1, 1] - e4[:, 0, 1] + kT * lr)
            ucg0 = torch.zeros_like(ucg1)
            cg0 = -(e4[:, 0, 0] + kT * logp[a, 0])
            cg1 = -(e4[:, 1, 0] + kT * logp[a, 1])
            ucg_j = self.n_states[typ[b]] > 1
            gate = use_den[a]
            pf.index_add_(0, a, torch.stack([
                torch.where(gate, torch.where(ucg_j, ucg0, cg0), zero),
                torch.where(gate, torch.where(ucg_j, ucg1, cg1), zero)], -1))
            js = (ucgstate[b] > 0)[:, None]
            scores.index_add_(0, a, -torch.where(js, e4[:, :, 1],
                                                 e4[:, :, 0]))
        scores = scores / kT
        mu_i = self.mu[self.formal[typ]]                      # (N, 2)
        use_ent = (self.use_entropy[typ] == 1) & use_den
        ent = kT * logp * (1.0 - n_real)[:, None]
        one_body = -mu_i - torch.where(use_ent[:, None], ent, zero)
        pf = pf + torch.where(use_den[:, None], one_body, zero)
        scores = scores - torch.where(use_den[:, None], mu_i / kT, zero)
        scores = torch.where(is_ucg[:, None], scores, zero)
        s = torch.clamp(scores, max=700.0)
        s = s - s.max(-1, keepdim=True).values
        ex = torch.exp(s)
        ucgp = torch.clamp(ex[:, 1] / ex.sum(-1), 1e-6, 1 - 1e-6)
        ucgp = torch.where(is_ucg, ucgp, torch.ones_like(ucgp))
        # pass 3: the CV back-force with g = -dw/dr at both ends
        cvf = torch.where(use_den, (pf[:, 0] - pf[:, 1]) * partial0, zero)
        for a, b, dr, rsq in self.chunks(i, j, x, L):
            r = torch.sqrt(rsq)
            ra, rb = rad[a], rad[b]
            ta = torch.tanh((r - ra) / (0.1 * ra))
            tb = torch.tanh((r - rb) / (0.1 * rb))
            g_a = -0.5 * (1 - ta * ta) / (0.1 * ra)
            g_b = -0.5 * (1 - tb * tb) / (0.1 * rb)
            fcv = (cvf[a] * g_a + cvf[b] * g_b) / r
            f.index_add_(0, a, fcv[:, None] * dr)
        return {"f": f, "lamf": torch.zeros_like(rho), "scores": scores,
                "pe": pe, "ucgp": ucgp}
