"""AlteredMetric: the implicit-gravity modification of the Poisson metric
(PyTorch port of `somar_tpu.projection.altered_metric`).

    Jgup'^{ij} = J * (g^{ij} - (w^2 / (1 + w^2)) dxi^i/dz dxi^j/dz),
    w = dt * theta * N(z)

Making gravity implicit inside the pressure projection costs no extra
Poisson solve: the metric of the single projection changes instead.  The
static per-MG-level fields P^{ij} = J (dxi^i/dz)(dxi^j/dz) and N^2 at faces
are computed once on the host in float64; each step's additive
`jgup_delta` = -fac * P with fac = w^2/(1+w^2) is a few elementwise ops.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


class AlteredMetric:
    """Static altered-metric fields for every level of one MG hierarchy."""

    def __init__(self, mg, background, dtype=torch.float32):
        """mg: a LevelMultigrid (its ops define the level geometries);
        background: a BackgroundProfile supplying N^2(z)."""
        self.mg = mg
        self.background = background
        self.levels = [self._build_level(op.geo, dtype) for op in mg.ops]
        # fine-level CC N^2 (static data)
        geo0 = mg.ops[0].geo
        grid0 = geo0.grid
        z = np.broadcast_to(geo0.phys_coords_cc()[grid0.vertical_dir],
                            grid0.shape)
        self._nsq_cc_fine = torch.as_tensor(
            np.maximum(np.asarray(background.nsq(z)), 0.0) * np.ones(
                grid0.shape), dtype=dtype, device=geo0.device)

    def _build_level(self, geo, dtype):
        grid = geo.grid
        ndim = grid.ndim
        vert = grid.vertical_dir
        P_diag, nsq_fc, P_rows = [], [], []
        diagonal_only = geo.is_uniform or geo.is_diagonal

        def tensor(a):
            return torch.as_tensor(np.array(a), dtype=dtype,
                                   device=geo.device)

        for d in range(ndim):
            cent = [0] * ndim
            cent[d] = 1
            xi = grid.coords(cent)
            fshape = grid.fc_shape(d)
            # physical z and dxi^i/dz at the d-faces
            if geo.is_uniform:
                zf = np.broadcast_to(xi[vert], fshape)
                dxidz = np.zeros((ndim,) + fshape)
                dxidz[vert] = 1.0
                J = np.ones(fshape)
            else:
                J, _, _, _, einv = geo.geo.metrics(xi)
                J = np.broadcast_to(J, fshape)
                zf = np.broadcast_to(geo.geo.phys_coor(vert, xi), fshape)
                dxidz = np.stack([np.broadcast_to(einv[i, vert], fshape)
                                  for i in range(ndim)])
            nsq = np.maximum(np.asarray(self.background.nsq(zf)), 0.0) \
                * np.ones(fshape)
            nsq_fc.append(tensor(nsq))
            P_diag.append(tensor(J * dxidz[d] ** 2))
            if not diagonal_only:
                P_rows.append(tensor(np.stack(
                    [J * dxidz[d] * dxidz[j] for j in range(ndim)])))
        return {
            "P_diag": tuple(P_diag),
            "nsq_fc": tuple(nsq_fc),
            "P_rows": tuple(P_rows) if P_rows else None,
        }

    def jgup_delta_list(self, dt_theta: float) -> List:
        """Per-MG-level (delta_diag, delta_full) for dt * theta."""
        out = []
        dt2 = dt_theta * dt_theta
        for lev in self.levels:
            diag, full = [], []
            for d in range(len(lev["P_diag"])):
                nsq = lev["nsq_fc"][d]
                fac = dt2 * nsq / (1.0 + dt2 * nsq)
                diag.append(-fac * lev["P_diag"][d])
                if lev["P_rows"] is not None:
                    full.append(-fac * lev["P_rows"][d])
            out.append((tuple(diag), tuple(full) if full else None))
        return out

    def nsq_cc(self):
        """N^2 at cell centers of the fine level."""
        return self._nsq_cc_fine
