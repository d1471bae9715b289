"""The memory experiment's detector error model, frozen for the reference.

A CSS memory experiment: every stabilizer of both types measured each
round through an ancilla (CX fan-in for Z checks, H-CX fan-out-H for X
checks, checks in index order), uniform depolarizing noise (DEPOLARIZE1
after H, DEPOLARIZE2 after CX, X flips before measurement and after reset),
detectors on round 0 of the deterministic checks, on consecutive rounds of
all checks and on the final data readout, and the rows of Lz (Z basis) as
observables. A backward Pauli-frame pass gives each elementary fault's
signature over (detectors | observables); faults with one signature merge,
and with every noise strength a ratio r of one rate p, a mechanism with
c_j faults of ratio r_j has the prior

    q(p) = (1 - prod_j (1 - 2 r_j p)^c_j) / 2.

Columns are the signatures in ascending order, read as integers whose bit
d is detector d and bit D + k observable k.
"""

from __future__ import annotations

import numpy as np
import torch


def _ops(code: dict, basis: str, rounds: int):
    """(ops, n_qubits, detectors, observables) of the experiment, with every
    noise strength 1.0 (a ratio of p)."""
    if basis == "z":
        det_H, rnd_H, L_obs = code["Hz"], code["Hx"], code["Lz"]
    else:
        det_H, rnd_H, L_obs = code["Hx"], code["Hz"], code["Lx"]
    n = det_H.shape[1]
    m_det, m_rnd = det_H.shape[0], rnd_H.shape[0]
    det_supp = [np.flatnonzero(det_H[k]).tolist() for k in range(m_det)]
    rnd_supp = [np.flatnonzero(rnd_H[k]).tolist() for k in range(m_rnd)]
    a_det = [n + k for k in range(m_det)]
    a_rnd = [n + m_det + k for k in range(m_rnd)]
    ops = []
    rec = 0
    rec_det = np.zeros((rounds, m_det), np.int64)
    rec_rnd = np.zeros((rounds, m_rnd), np.int64)

    def reset(q):
        ops.append(("R", q))
        ops.append(("XE", 1.0, q))

    def had(q):
        ops.append(("H", q))
        ops.append(("DEP1", 1.0, q))

    def cx(a, b):
        ops.append(("CX", a, b))
        ops.append(("DEP2", 1.0, a, b))

    for q in range(n):
        reset(q)
        if basis == "x":
            had(q)
    for a in a_det + a_rnd:
        reset(a)

    def extract(anc, supp, xtype):
        if xtype:
            had(anc)
        for q in supp:
            if xtype:
                cx(anc, q)
            else:
                cx(q, anc)
        if xtype:
            had(anc)

    det_x = basis == "x"
    for r in range(rounds):
        for k in range(m_det):
            extract(a_det[k], det_supp[k], det_x)
        for k in range(m_rnd):
            extract(a_rnd[k], rnd_supp[k], not det_x)
        for anc, recs in ((a_det, rec_det), (a_rnd, rec_rnd)):
            for k, a in enumerate(anc):
                ops.append(("XE", 1.0, a))
                ops.append(("MR", a))
                recs[r, k] = rec
                rec += 1
                ops.append(("XE", 1.0, a))
    rec_data = np.zeros(n, np.int64)
    for q in range(n):
        if basis == "x":
            had(q)
        ops.append(("XE", 1.0, q))
        ops.append(("M", q))
        rec_data[q] = rec
        rec += 1

    detectors = [[int(rec_det[0, k])] for k in range(m_det)]
    for r in range(1, rounds):
        detectors += [[int(rec_det[r - 1, k]), int(rec_det[r, k])] for k in range(m_det)]
        detectors += [[int(rec_rnd[r - 1, k]), int(rec_rnd[r, k])] for k in range(m_rnd)]
    detectors += [[int(rec_det[rounds - 1, k])] + [int(rec_data[q]) for q in det_supp[k]]
                  for k in range(m_det)]
    observables = [[int(rec_data[q]) for q in np.flatnonzero(row)]
                   for row in np.atleast_2d(L_obs)]
    return ops, n + m_det + m_rnd, detectors, observables, rec


def parametric_dem(code: dict, basis: str, rounds: int) -> dict:
    """{"H", "L", "ratios", "counts"} of the experiment's DEM."""
    ops, n_qubits, detectors, observables, n_rec = _ops(code, basis, rounds)
    n_det = len(detectors)
    record_sig = [0] * n_rec
    for k, recs in enumerate(detectors):
        for j in recs:
            record_sig[j] ^= 1 << k
    for k, recs in enumerate(observables):
        for j in recs:
            record_sig[j] ^= 1 << (n_det + k)
    mech: dict[int, dict[float, int]] = {}

    def emit(sig, ratio):
        if sig:
            d = mech.setdefault(sig, {})
            d[ratio] = d.get(ratio, 0) + 1

    Sx = [0] * n_qubits
    Sz = [0] * n_qubits
    rec = n_rec
    for op in reversed(ops):
        tag = op[0]
        if tag == "M":
            rec -= 1
            Sx[op[1]] ^= record_sig[rec]
        elif tag == "MR":
            rec -= 1
            Sx[op[1]] = record_sig[rec]
            Sz[op[1]] = 0
        elif tag == "R":
            Sx[op[1]] = Sz[op[1]] = 0
        elif tag == "H":
            q = op[1]
            Sx[q], Sz[q] = Sz[q], Sx[q]
        elif tag == "CX":
            c, t = op[1], op[2]
            Sx[c] ^= Sx[t]
            Sz[t] ^= Sz[c]
        elif tag == "XE":
            emit(Sx[op[2]], op[1])
        elif tag == "DEP1":
            q = op[2]
            for s in (Sx[q], Sz[q], Sx[q] ^ Sz[q]):
                emit(s, op[1] / 3.0)
        elif tag == "DEP2":
            a, b = op[2], op[3]
            sa = (Sx[a], Sz[a], Sx[a] ^ Sz[a])
            sb = (Sx[b], Sz[b], Sx[b] ^ Sz[b])
            w = op[1] / 15.0
            for s in sa + sb:
                emit(s, w)
            for s1 in sa:
                for s2 in sb:
                    emit(s1 ^ s2, w)
    sigs = sorted(mech)
    ratios = sorted({r for d in mech.values() for r in d})
    counts = np.array([[mech[s].get(r, 0) for r in ratios] for s in sigs], np.int32)
    n_obs = len(observables)
    H = np.zeros((n_det, len(sigs)), np.uint8)
    L = np.zeros((n_obs, len(sigs)), np.uint8)
    for col, sig in enumerate(sigs):
        s = sig
        while s:
            low = s & -s
            bit = low.bit_length() - 1
            if bit < n_det:
                H[bit, col] = 1
            else:
                L[bit - n_det, col] = 1
            s ^= low
    return {"H": H, "L": L, "ratios": np.array(ratios, np.float64), "counts": counts}


def priors(dem: dict, p: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Each mechanism's prior at ``p`` and its LLR, float32 on the CPU: the
    closed form in float32, clipped to [1e-15, 1 - 1e-15] for the LLR."""
    p32 = torch.tensor(p, dtype=torch.float32)
    ratios = torch.tensor(dem["ratios"], dtype=torch.float32)
    counts = torch.tensor(dem["counts"], dtype=torch.float32)
    q = 0.5 * (1.0 - torch.exp(counts @ torch.log1p(-2.0 * ratios * p32)))
    qc = torch.clamp(q, 1e-15, 1.0 - 1e-15)
    return q, torch.log((1.0 - qc) / qc)
