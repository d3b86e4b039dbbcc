"""Coordinate maps (metric sources), PyTorch port of
`somar_tpu.geometry.geo_source`.

A map supplies x_mu = X_mu(xi).  This slice ports the abstract `GeoSource`
and the identity `CartesianMap`, whose metric is uniform; the stretched,
twisted and cylindrical maps and the host-side metric derivation come
with the mapped-metric slice (ROADMAP slice 3).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class GeoSource:
    """Abstract coordinate map xi -> x."""

    #: True when the Jacobian is everywhere diagonal
    is_diagonal: bool = False
    #: True when the map is the identity up to constant scalings
    is_uniform: bool = False

    name: str = "abstract"

    def phys_coor(self, mu: int, xi: Sequence[np.ndarray]) -> np.ndarray:
        """x_mu evaluated at mapped coordinates xi (broadcastable arrays)."""
        raise NotImplementedError


class CartesianMap(GeoSource):
    """Identity map."""

    is_diagonal = True
    is_uniform = True
    name = "Cartesian"

    def phys_coor(self, mu, xi):
        return xi[mu]
