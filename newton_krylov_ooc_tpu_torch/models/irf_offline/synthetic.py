"""synthetic IRF circulation generator for irf_offline (numpy).

Port of newton_krylov_ooc_tpu/models/irf_offline/synthetic.py: a
POP-convention circulation (UET/VNT face transports from a discrete corner
streamfunction -- exactly non-divergent per cell per level -- plus lateral
conductances, a surface-intensified VDC profile, TAREA and dz), and the
explicit stability bound of its year.  Writing the circulation and its
grid_vars as netCDF files (write_circulation, write_grid_vars) needs the
netCDF layer, which comes with the file-backed slice.
"""

from __future__ import annotations

import numpy as np


def gen_circulation(nz, nlat, nlon, psi_max=1.0e12, hmix_cond=2.0e11,
                    vdc_surf=50.0e4, vdc_deep=0.1e4, mask=None,
                    n_seasons=None):
    """synthetic circulation fields (numpy dict)

    psi_max: gyre streamfunction amplitude [cm^3/s]; hmix_cond: lateral
    conductance [cm^3/s]; vdc_*: vertical diffusivity [cm^2/s] at the
    surface / at depth.  mask: optional (nz, nlat, nlon) ints (>0 wet).

    n_seasons: generate SEASONAL circulation -- UET/VNT and VDC gain a
    leading time axis of that length, the gyre strength and the mixing's
    surface intensification modulating sinusoidally over the year (each
    month's transports remain exactly non-divergent, being differences of
    that month's streamfunction).
    """
    dz = 100.0e2 * (1.0 + np.arange(nz))  # thickening layers [cm]
    tarea = np.full((nlat, nlon), 1.0e14)  # [cm^2]

    # corner streamfunction, zero on the north/south boundary rows and
    # periodic zonally: a single basin-scale gyre, weakening with depth
    jj = np.linspace(0.0, np.pi, nlat + 1)[:, None]
    ii = np.linspace(0.0, 2.0 * np.pi, nlon, endpoint=False)[None, :]
    psi = psi_max * np.sin(jj) ** 2 * np.cos(ii)  # (nlat+1, nlon)
    depth_fac = np.exp(-np.arange(nz) / max(nz / 2.0, 1.0))

    psi_e = np.roll(psi, -1, axis=1)  # corner column east of face i
    uet2 = psi_e[1:, :] - psi_e[:-1, :]          # (nlat, nlon)
    vnt2 = -(np.roll(psi[1:, :], -1, axis=1) - psi[1:, :])
    uet = depth_fac[:, None, None] * uet2[None, :, :]
    vnt = depth_fac[:, None, None] * vnt2[None, :, :]
    wtt = np.zeros((nz, nlat, nlon))

    hde = np.full((nz, nlat, nlon), hmix_cond)
    hdn = np.full((nz, nlat, nlon), hmix_cond)
    hdn[:, -1, :] = 0.0  # north face closed

    # VDC: interface diffusivity below level k, surface intensified
    surf_shape = np.exp(-np.arange(nz) / 2.0)[:, None, None]
    vdc = (vdc_deep + (vdc_surf - vdc_deep) * surf_shape) * np.ones(
        (nz, nlat, nlon)
    )

    if n_seasons is not None:
        # gyre spins up/down +-50% over the year; surface mixing deepens
        # in "winter" (antiphase) -- midpoint-sampled like monthly means
        phase = 2.0 * np.pi * (np.arange(n_seasons) + 0.5) / n_seasons
        gyre_fac = 1.0 + 0.5 * np.cos(phase)[:, None, None, None]
        uet = gyre_fac * uet[None, ...]
        vnt = gyre_fac * vnt[None, ...]
        mix_fac = 1.0 - 0.5 * np.cos(phase)[:, None, None, None]
        vdc = vdc_deep + mix_fac * (vdc_surf - vdc_deep) * surf_shape * np.ones(
            (n_seasons, nz, nlat, nlon)
        )

    if mask is None:
        mask = np.ones((nz, nlat, nlon), np.int32)
    return {
        "mask": np.asarray(mask, np.int32),
        "dz": dz,
        "TAREA": tarea,
        "UET": uet,
        "VNT": vnt,
        "WTT": wtt,
        "HDIFF_E": hde,
        "HDIFF_N": hdn,
        "VDC": vdc,
    }


def stable_steps_per_year(circ, safety=0.5):
    """steps/year keeping the explicit lateral advance inside its stability
    bound: dt <= safety * min(vol / sum|outgoing transports + conductances|);
    seasonal fields bound by their worst month (negative axes keep the
    arithmetic rank-agnostic)"""
    vol = circ["dz"][:, None, None] * circ["TAREA"][None, :, :]

    def south_shift(arr):
        return np.concatenate(
            [np.zeros_like(arr[..., :1, :]), arr[..., :-1, :]], axis=-2
        )

    outflow = (
        np.abs(circ["UET"])
        + np.abs(np.roll(circ["UET"], 1, axis=-1))
        + np.abs(circ["VNT"])
        + np.abs(south_shift(circ["VNT"]))
        + np.abs(circ["WTT"])
        + circ["HDIFF_E"]
        + np.roll(circ["HDIFF_E"], 1, axis=-1)
        + circ["HDIFF_N"]
        + south_shift(circ["HDIFF_N"])
    )
    wet = circ["mask"] > 0
    rate = np.where(wet & (outflow > 0), outflow / vol, 0.0)
    rate_max = float(rate.max())
    if rate_max == 0.0:
        return 365
    dt_max = safety / rate_max
    year = 365.0 * 86400.0
    return max(365, int(np.ceil(year / dt_max)))
