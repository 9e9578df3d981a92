"""Satellite desaturation with a TRUE second-order-cone wheel envelope.

The reference's problem class is mixed-integer QP/SOCP (SURVEY.md
section 1 [P]); every driver benchmark is QP-representable, so this
config exists to exercise the cone path end to end (round-3 verdict
item 9): the three-axis satellite (problems/satellite.py) with the
box constraint on the transverse wheel torques replaced by the physical
circular envelope of a two-axis gimballed wheel assembly:

    || (u_w,x(k), u_w,y(k)) ||_2 <= r      for every horizon step k

-- one 3-dim second-order cone per step, identical across commutations
(the thruster integer structure is untouched).  The box rows from the
base class remain (ball subset box: redundant but sound); the cone is
what binds on diagonal-torque maneuvers.

Scope: point MICP queries, online fixed-commutation solves, and
closed-loop simulation run through oracle.soc_point.SOCPointOracle; the
partition certificates stay QP-only -- the recorded scoping decision and
what lifting it would take are in docs/socp_scope.md.
"""

from __future__ import annotations

import numpy as np

from explicit_hybrid_mpc_tpu_torch.problems.registry import register
from explicit_hybrid_mpc_tpu_torch.problems.satellite import Satellite


@register
class SatelliteSOC(Satellite):
    name = "satellite_soc"

    def __init__(self, soc_radius: float | None = None, **kw):
        kw.setdefault("axes", 3)
        if kw["axes"] != 3:
            raise ValueError("satellite_soc needs axes=3 (the cone "
                             "couples the two transverse wheel channels)")
        super().__init__(**kw)
        # Default: the cone circumscribes nothing new (radius = box
        # half-width) -- it strictly tightens the corners of the
        # (u_w,x, u_w,y) box, which is where it binds.
        self.soc_radius = float(soc_radius if soc_radius is not None
                                else self.u_w_max)
        if self.soc_radius <= 0:
            raise ValueError("soc_radius must be > 0")

    def soc_cones(self) -> tuple[np.ndarray, np.ndarray]:
        """(Ac, bc) with Ac (K, 3, nz), bc (K, 3), K = N cones: per step
        k, s = bc_k - Ac_k z = (r, u_w,x(k), u_w,y(k)) in SOC_3.

        Identical for every commutation: the wheel channels occupy the
        same z slots in each delta slice (satellite.build_canonical
        orders z as N blocks of (u_w (3), m (3)))."""
        N, nz = self.N, self.canonical.nz
        n_u = 6  # per-step input block: 3 wheel torques + 3 magnitudes
        Ac = np.zeros((N, 3, nz))
        bc = np.zeros((N, 3))
        for k in range(N):
            bc[k, 0] = self.soc_radius
            Ac[k, 1, k * n_u + 0] = -1.0   # s1 = u_w,x(k)
            Ac[k, 2, k * n_u + 1] = -1.0   # s2 = u_w,y(k)
        return Ac, bc
