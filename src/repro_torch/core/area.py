"""Area model of MAGIA + FractalSync (paper §4.2, Fig. 4); the port's copy
of ``repro/core/area.py``.

Published synthesis constants (GF 12nm FinFET, Design Compiler, SSPG −40°C,
1 GHz target):

  * MAGIA tile without FractalSync : 1.5816 mm²
  * MAGIA tile with    FractalSync : 1.5814 mm²   (difference = synthesis noise
    → FS adds no measurable tile area; AMO + FS each < 0.03% of the tile)
  * Full system (k=16, memory banks excluded from the 'total' in the paper's
    overhead quote): NoC ≤ 1.7%, synchronization network ≤ 0.007%, > 98%
    compute + communication logic.

We invert those shares at k = 16 to obtain per-element areas, then model

    total(k) = k²·(A_tile + A_router) + (k²−1)·A_fs

which reproduces the paper's overhead numbers at k = 16 (tests assert this)
and shows the key scalability property: the FS share is bounded as k → ∞
(both numerator and denominator scale as k²).
"""

from __future__ import annotations

from dataclasses import dataclass

from .tree import FractalTree

# Published constants -------------------------------------------------------
TILE_AREA_MM2 = 1.5814          # tile incl. AMO + FractalSync support
TILE_AREA_NO_FS_MM2 = 1.5816    # tile without FractalSync (synthesis noise)
NOC_SHARE_AT_16 = 0.017         # ≤1.7% of full system at k=16
FS_SHARE_AT_16 = 0.00007        # ≤0.007% of full system at k=16
K_REF = 16

# Invert the k=16 shares: with T = k²(A_t + A_r) + (k²−1)A_fs,
#   A_r  = share_noc · T / k²,   A_fs = share_fs · T / (k²−1)
# and T = k²·A_t / (1 − share_noc − share_fs).
_T16 = (K_REF**2 * TILE_AREA_MM2) / (1.0 - NOC_SHARE_AT_16 - FS_SHARE_AT_16)
ROUTER_AREA_MM2 = NOC_SHARE_AT_16 * _T16 / K_REF**2
FS_MODULE_AREA_MM2 = FS_SHARE_AT_16 * _T16 / (K_REF**2 - 1)


@dataclass(frozen=True)
class AreaBreakdown:
    k: int
    tiles_mm2: float
    noc_mm2: float
    fs_mm2: float

    @property
    def total_mm2(self) -> float:
        return self.tiles_mm2 + self.noc_mm2 + self.fs_mm2

    @property
    def noc_share(self) -> float:
        return self.noc_mm2 / self.total_mm2

    @property
    def fs_share(self) -> float:
        return self.fs_mm2 / self.total_mm2


def system_area(k: int) -> AreaBreakdown:
    """Full-system area for a k×k mesh (paper's model: k² tiles, k×k NoC,
    k²−1 FS modules)."""
    tree = FractalTree((k, k))
    return AreaBreakdown(
        k=k,
        tiles_mm2=k * k * TILE_AREA_MM2,
        noc_mm2=k * k * ROUTER_AREA_MM2,
        fs_mm2=tree.num_fs_modules * FS_MODULE_AREA_MM2,
    )


def fs_tile_overhead() -> float:
    """FractalSync overhead on the tile itself (paper: < 0.01%, in fact the
    synthesized tile got *smaller* within noise)."""
    return (TILE_AREA_MM2 - TILE_AREA_NO_FS_MM2) / TILE_AREA_NO_FS_MM2


# Fig. 4 tile breakdown (qualitative: the text pins >98% to compute+comm and
# AMO+FS < 0.03%; the named components below follow §2.1's inventory).
TILE_BREAKDOWN = {
    "redmule_gemm": 0.315,
    "tcdm_banks_logic": 0.330,
    "hci_interconnect": 0.085,
    "core_cv32e40x_icache": 0.130,
    "idma": 0.060,
    "axi_obi_xbar": 0.073,
    "amo_module": 0.0003,
    "fractalsync_support": 0.0002,
    "other": 0.0065,
}
assert abs(sum(TILE_BREAKDOWN.values()) - 1.0) < 1e-9
