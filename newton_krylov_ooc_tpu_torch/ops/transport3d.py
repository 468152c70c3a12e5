"""3D offline tracer transport operators assembled from IRF circulation
fields, evaluated as stencils on tensors.

Port of newton_krylov_ooc_tpu/ops/transport3d.py, in plain PyTorch.  The
same POP-convention circulation fields (face volume transports UET/VNT/WTT,
face conductances HDIFF_E/N, TAREA, dz) become stencil operators on the
device, so the annual transport integration runs there.

Conventions (those of the JAX module and of native/precond_tools/gen_A.cpp):
  UET[k,j,i]  volume transport across the EAST face of cell (k,j,i)
              [cm^3/s], positive eastward; zonally periodic
  VNT[k,j,i]  transport across the NORTH face [cm^3/s]; north face of the
              last latitude row is closed
  WTT[k,j,i]  transport across the TOP face [cm^3/s], positive UP (POP
              convention); the surface face is closed
  HDIFF_E/N   diffusive conductances kappa*A/dx across east/north faces
              [cm^3/s]
  TAREA[j,i]  horizontal cell area [cm^2]; with dz[k] [cm] gives volumes
Faces touching a masked cell carry no flux.  upwind3 uses the 3rd-order
upwind-biased face value (-T_uu + 5 T_up + 2 T_down)/6, falling back to
1st-order upwind where the far-upwind cell is masked or off-grid.  The
divergence is flux-form, so the volume-weighted integral of the
advective+diffusive tendency vanishes identically (tracer conservation).

The layout is the JAX one, (..., nz, nlat, nlon), and the coefficient dict
has the JAX keys; a coefficient that is absent stays None.  `jnp.roll` is
`torch.roll`; `_shift` zero-fills off-grid.  The set-up functions
(build_transport3d, vmix_vertical_coeff, mask_vmix_coeff,
assemble_rate_fields) take numpy inputs and compute in float64 before the
cast, as the JAX ones do.  transport_stencil_coef collapses a steady
operator into the 13 per-offset fields that stencil_tend applies (the
stencil mode of kernel B5, ops/transport3d_stream_cuda.py).
"""

from __future__ import annotations

import numpy as np
import torch

_SIXTH = 1.0 / 6.0

# coefficient arrays that may carry a leading (seasonal) time axis; the
# selector/geometry arrays are mask-derived and always static
_TIME_VARYING_KEYS = ("t_e", "t_n", "t_t", "cond_e", "cond_n")


def transport_coef_n_time(coef):
    """leading time-axis length of the face arrays (None if steady)"""
    for key in _TIME_VARYING_KEYS:
        arr = coef.get(key)
        if arr is not None and arr.ndim == 4:
            return arr.shape[0]
    return None


def month_bracket(frac, n_time):
    """(m0, m1, w1) of the periodic midpoint interpolation at period
    fraction `frac` (a tensor): samples sit at (m + 0.5)/n_time of the
    period, m0 and m1 = m0 + 1 (mod n_time) bracket frac, w1 is the weight
    of m1.  m0 and m1 are int64 tensors, w1 has frac's dtype."""
    x = frac * n_time - 0.5
    m0f = torch.floor(x)
    w1 = x - m0f
    m0 = torch.remainder(m0f.to(torch.int64), n_time)
    return m0, torch.remainder(m0 + 1, n_time), w1


def interp_month(arr, frac):
    """periodic linear interpolation along a leading time axis whose
    samples sit at interval midpoints (m + 0.5)/n_time of the period;
    frac is the fraction of the period in [0, 1), a 0-d tensor on arr's
    device (no host synchronisation)"""
    m0, m1, w1 = month_bracket(frac, arr.shape[0])
    a0 = torch.index_select(arr, 0, m0.reshape(1))[0]
    a1 = torch.index_select(arr, 0, m1.reshape(1))[0]
    w1 = w1.to(arr.dtype)
    return (1.0 - w1) * a0 + w1 * a1


def assemble_rate_fields(specs, wet, dz_surf, sec_per_year):
    """local linear rates of a tracer module from its gen_A-vocabulary specs

    specs: per-tracer dicts with (all optional) source_per_year,
    sink_rate_per_year, surf_restore_pv_cm_s, surf_restore_target,
    surf_flux_const_cm_s, surf_flux_d ({tracer_name: cm/s} linearized
    gas-exchange derivatives); wet: (nz, nh) 0/1 mask; dz_surf: surface
    layer thickness [cm].

    Returns numpy (diag, src, couple): implicit per-tracer rates [1/s] and
    explicit sources [tracer/s], each (tracer_cnt, nz, nh), plus the
    cross-tracer surface coupling matrix (tracer_cnt, tracer_cnt) [1/s at
    the surface layer] or None when no off-diagonal terms exist.  The
    surf_flux_d SELF-derivatives fold into diag (solved implicitly); only
    the off-diagonal (nilpotent) part stays explicit in couple.
    """
    names = [spec.get("name") for spec in specs]
    wet = np.asarray(wet, np.float64)
    nz, nh = wet.shape
    diag = np.zeros((len(specs), nz, nh))
    src = np.zeros((len(specs), nz, nh))
    couple = np.zeros((len(specs), len(specs)))
    for ind, spec in enumerate(specs):
        diag[ind] -= spec.get("sink_rate_per_year", 0.0) / sec_per_year
        src[ind] += spec.get("source_per_year", 0.0) / sec_per_year
        pv = spec.get("surf_restore_pv_cm_s", 0.0)
        if pv != 0.0:
            # gen_A `pv` convention: surface-layer rate pv/dz_surf [1/s]
            rate = pv / dz_surf
            diag[ind, 0, :] -= rate
            src[ind, 0, :] += rate * spec.get("surf_restore_target", 0.0)
        src[ind, 0, :] += spec.get("surf_flux_const_cm_s", 0.0) / dz_surf
        for other, deriv in spec.get("surf_flux_d", {}).items():
            if other not in names:
                raise ValueError(
                    f"surf_flux_d of {spec.get('name')} names a tracer "
                    f"not in its module: {other}"
                )
            rate = deriv / dz_surf
            if other == spec.get("name"):
                diag[ind, 0, :] += rate
            else:
                couple[ind, names.index(other)] += rate
        diag[ind] *= wet
        src[ind] *= wet
    return diag, src, (couple if couple.any() else None)


def mean_transport_coef(coef):
    """annual-mean coefficient dict of a (possibly seasonal) one -- what an
    annual-mean IRF file would have produced; used for the linearized
    preconditioner operator"""
    out = dict(coef)
    for key in _TIME_VARYING_KEYS:
        arr = coef.get(key)
        if arr is not None and arr.ndim == 4:
            out[key] = arr.mean(dim=0)
    return out


def interp_transport_coef(coef, frac):
    """sample a seasonal coefficient dict at a fraction of the period;
    steady entries (and a fully steady dict) pass through unchanged"""
    out = dict(coef)
    for key in _TIME_VARYING_KEYS:
        arr = coef.get(key)
        if arr is not None and arr.ndim == 4:
            out[key] = interp_month(arr, frac)
    return out


def _shift(arr, off, axis):
    """result[..., idx, ...] = arr[..., idx + off, ...], zero-filled
    off-grid (for the non-periodic lat/depth axes)"""
    if off == 0:
        return arr
    axis = axis % arr.ndim
    pad_shape = list(arr.shape)
    pad_shape[axis] = abs(off)
    zeros = arr.new_zeros(pad_shape)
    if off > 0:
        return torch.cat([arr.narrow(axis, off, arr.shape[axis] - off), zeros],
                         dim=axis)
    return torch.cat([zeros, arr.narrow(axis, 0, arr.shape[axis] + off)],
                     dim=axis)


def build_transport3d(
    mask,
    dz,
    tarea,
    uet=None,
    vnt=None,
    wtt=None,
    hdiff_e=None,
    hdiff_n=None,
    adv_type="upwind3",
    *,
    device,
    dtype,
):
    """precompute the stencil coefficient dict for transport_tend

    mask: (nz, nlat, nlon) ints, >0 = wet; dz: (nz,) [cm];
    tarea: (nlat, nlon) [cm^2]; uet/vnt/wtt/hdiff_*: (nz, nlat, nlon)
    [cm^3/s] numpy arrays (None = term absent); adv_type: upwind3 | centered

    SEASONAL circulation: any face field may instead be (n_time, nz, nlat,
    nlon), e.g. monthly IRF means.  The resulting time-varying coefficient
    tensors carry the leading time axis; sample them at a time of year with
    interp_transport_coef before calling transport_tend.
    """
    if adv_type not in ("upwind3", "centered"):
        raise ValueError(f"adv_type {adv_type!r} not supported")
    mask = np.asarray(mask)
    if mask.ndim != 3:
        raise ValueError("mask must be (nz, nlat, nlon)")
    nz, nlat, nlon = mask.shape
    wet = (mask > 0).astype(np.float64)
    vol = np.asarray(dz, np.float64)[:, None, None] * np.asarray(
        tarea, np.float64
    )[None, :, :]

    def tensor(arr):
        return torch.as_tensor(arr, dtype=dtype, device=device)

    def prep(field, other_wet, closed_top=False):
        """mask a face field: zero where either side of the face is dry"""
        if field is None:
            return None
        field = np.asarray(field, np.float64)
        if field.ndim not in (3, 4):
            raise ValueError("face fields must be rank 3 or (seasonal) 4")
        vals = field * wet * other_wet  # broadcasts over a leading time axis
        if closed_top:
            vals = vals.copy()
            vals[..., 0, :, :] = 0.0
        return tensor(vals)

    wet_e = np.roll(wet, -1, axis=2)
    wet_n = np.concatenate([wet[:, 1:, :], np.zeros((nz, 1, nlon))], axis=1)
    wet_up = np.concatenate([np.zeros((1, nlat, nlon)), wet[:-1, :, :]], axis=0)

    coef = {
        "wet": tensor(wet),
        "recip_vol": tensor(wet / vol),
        "t_e": prep(uet, wet_e),
        "t_n": prep(vnt, wet_n),
        # top face of cell k couples k (below) and k-1 (above); surface closed
        "t_t": prep(wtt, wet_up, closed_top=True),
        "cond_e": prep(hdiff_e, wet_e),
        "cond_n": prep(hdiff_n, wet_n),
    }
    if adv_type == "upwind3":
        # 3rd-order usable only where the far-upwind cell is wet and on-grid
        coef.update(upwind3_selectors(coef["wet"]))
    return coef


UPWIND3_SELECTOR_KEYS = (
    "sel3p_e", "sel3n_e", "sel3p_n", "sel3n_n", "sel3p_t", "sel3n_t",
)


def upwind3_selectors(wet):
    """the six upwind3 far-cell selector fields of a wet mask.

    Every selector is a pure shift of `wet` (periodic in lon, zero-filled
    in lat/depth) -- identical to the arrays build_transport3d keeps, which
    is why the year kernel holds only `wet` and derives them per cell.
    """
    return {
        "sel3p_e": torch.roll(wet, 1, dims=-1),
        "sel3n_e": torch.roll(wet, -2, dims=-1),
        "sel3p_n": _shift(wet, -1, -2),
        "sel3n_n": _shift(wet, 2, -2),
        "sel3p_t": _shift(wet, 1, -3),
        "sel3n_t": _shift(wet, -2, -3),
    }


# the bits of the selector byte, the SelBit of csrc/transport3d_year.cu and
# csrc/transport3d_stream_passes.cuh
SEL_BITS = ("wet", "sel3p_e", "sel3n_e", "sel3p_n", "sel3n_n", "sel3p_t",
            "sel3n_t")


def pack_selectors(wet):
    """the byte a cell the 3D kernels (B4 and the fused step of B5, B6 and
    B7) read for its upwind3 faces: bit 0 the
    wet mask, bits 1-6 the far-cell selectors of the cell's east, north and
    top faces (ops/transport3d.py::upwind3_selectors: shifts of `wet`,
    periodic in longitude, zero past the grid in latitude and depth), in
    SEL_BITS order.  wet: (nz, nlat, nlon) 0/1 tensor; returns uint8 on its
    device."""
    fields = {"wet": wet, **upwind3_selectors(wet)}
    out = torch.zeros(wet.shape, dtype=torch.uint8, device=wet.device)
    for pos, name in enumerate(SEL_BITS):
        out |= (fields[name] != 0).to(torch.uint8) << pos
    return out


def _face_value(trans, y_up, y_dn, y_uu, y_dd, sel3p, sel3n, upwind3):
    """advective face tracer value for transport `trans` from cell `up`
    toward cell `dn` (positive trans); y_uu/y_dd are the far cells"""
    if not upwind3:
        return 0.5 * (y_up + y_dn)
    v_pos = sel3p * _SIXTH * (-y_uu + 5.0 * y_up + 2.0 * y_dn) + (
        1.0 - sel3p
    ) * y_up
    v_neg = sel3n * _SIXTH * (2.0 * y_up + 5.0 * y_dn - y_dd) + (
        1.0 - sel3n
    ) * y_dn
    return torch.where(trans > 0.0, v_pos, v_neg)


def transport_tend(coef, y):
    """advection + lateral-diffusion tendency dy/dt [tracer/s]

    y: (..., nz, nlat, nlon); returns the same shape, exactly zero on land.
    Linear in y.  coef must be a STEADY dict here: sample a seasonal one at
    the wanted time of year with interp_transport_coef first.
    """
    up3 = coef.get("sel3p_e") is not None
    y = y * coef["wet"]
    flux_div = torch.zeros_like(y)

    if coef.get("t_e") is not None or coef.get("cond_e") is not None:
        y_e = torch.roll(y, -1, dims=-1)
        flux = torch.zeros_like(y)
        if coef.get("t_e") is not None:
            val = _face_value(
                coef["t_e"], y, y_e, torch.roll(y, 1, dims=-1),
                torch.roll(y, -2, dims=-1), coef.get("sel3p_e"),
                coef.get("sel3n_e"), up3,
            )
            flux = coef["t_e"] * val
        if coef.get("cond_e") is not None:
            flux = flux + coef["cond_e"] * (y - y_e)
        flux_div = flux_div + torch.roll(flux, 1, dims=-1) - flux

    if coef.get("t_n") is not None or coef.get("cond_n") is not None:
        y_n = _shift(y, 1, -2)
        flux = torch.zeros_like(y)
        if coef.get("t_n") is not None:
            val = _face_value(
                coef["t_n"], y, y_n, _shift(y, -1, -2), _shift(y, 2, -2),
                coef.get("sel3p_n"), coef.get("sel3n_n"), up3,
            )
            flux = coef["t_n"] * val
        if coef.get("cond_n") is not None:
            flux = flux + coef["cond_n"] * (y - y_n)
        flux_div = flux_div + _shift(flux, -1, -2) - flux

    if coef.get("t_t") is not None:
        # flux UP across the top face of cell k: leaves k, enters k-1;
        # upwind cell for positive (upward) transport is k itself
        val = _face_value(
            coef["t_t"], y, _shift(y, -1, -3), _shift(y, 1, -3),
            _shift(y, -2, -3), coef.get("sel3p_t"), coef.get("sel3n_t"), up3,
        )
        flux = coef["t_t"] * val
        flux_div = flux_div + _shift(flux, 1, -3) - flux

    return flux_div * coef["recip_vol"]


def _face_derivs(trans, sel3p, sel3n, upwind3):
    """per-face partial derivatives of _face_value wrt its four cell values

    returns (d_up, d_dn, d_uu, d_dd), each the face-field shape; the where()
    on the transport sign mirrors _face_value exactly.
    """
    if not upwind3:
        half = 0.5 * torch.ones_like(trans)
        zero = torch.zeros_like(trans)
        return half, half, zero, zero
    pos = trans > 0.0
    zero = torch.zeros_like(trans)
    d_up = torch.where(pos, sel3p * (5.0 * _SIXTH) + (1.0 - sel3p),
                       sel3n * (2.0 * _SIXTH))
    d_dn = torch.where(pos, sel3p * (2.0 * _SIXTH),
                       sel3n * (5.0 * _SIXTH) + (1.0 - sel3n))
    d_uu = torch.where(pos, -sel3p * _SIXTH, zero)
    d_dd = torch.where(pos, zero, -sel3n * _SIXTH)
    return d_up, d_dn, d_uu, d_dd


def transport_tridiag_bands(coef):
    """exact same-column tridiagonal part of the transport_tend operator

    returns (lo, diag, up), each (..., nz, nlat, nlon) in tendency units
    [1/s]: diag[k] = d tend[k] / d y[k] (every direction's diagonal
    contribution, advective and diffusive), lo[k] = d tend[k] / d y[k-1]
    and up[k] = d tend[k] / d y[k+1] (the vertical-advection couplings,
    including the upwind3 far-cell terms that land on adjacent levels).
    Together with the implicit vertical-mixing bands it is the transport
    part of the column-tridiagonal preconditioner.  coef must be a STEADY
    dict (sample or mean a seasonal one first).
    """
    up3 = coef.get("sel3p_e") is not None
    zeros = torch.zeros_like(coef["wet"])
    diag = zeros
    lo = zeros
    up = zeros

    if coef.get("t_e") is not None or coef.get("cond_e") is not None:
        flux_dup = zeros
        flux_ddn = zeros
        if coef.get("t_e") is not None:
            d_up, d_dn, _uu, _dd = _face_derivs(
                coef["t_e"], coef.get("sel3p_e"), coef.get("sel3n_e"), up3
            )
            flux_dup = coef["t_e"] * d_up
            flux_ddn = coef["t_e"] * d_dn
        if coef.get("cond_e") is not None:
            flux_dup = flux_dup + coef["cond_e"]
            flux_ddn = flux_ddn - coef["cond_e"]
        # east face of c: y[c] is y_up; west face (= east face of c-1,
        # periodic): y[c] is y_dn
        diag = diag + torch.roll(flux_ddn, 1, dims=-1) - flux_dup

    if coef.get("t_n") is not None or coef.get("cond_n") is not None:
        flux_dup = zeros
        flux_ddn = zeros
        if coef.get("t_n") is not None:
            d_up, d_dn, _uu, _dd = _face_derivs(
                coef["t_n"], coef.get("sel3p_n"), coef.get("sel3n_n"), up3
            )
            flux_dup = coef["t_n"] * d_up
            flux_ddn = coef["t_n"] * d_dn
        if coef.get("cond_n") is not None:
            flux_dup = flux_dup + coef["cond_n"]
            flux_ddn = flux_ddn - coef["cond_n"]
        diag = diag + _shift(flux_ddn, -1, -2) - flux_dup

    if coef.get("t_t") is not None:
        # face k couples y_up=y[k], y_dn=y[k-1], y_uu=y[k+1], y_dd=y[k-2];
        # tend[k] gets +flux[k+1] - flux[k]
        d_up, d_dn, d_uu, d_dd = _face_derivs(
            coef["t_t"], coef.get("sel3p_t"), coef.get("sel3n_t"), up3
        )
        t = coef["t_t"]
        diag = diag + _shift(t * d_dn, 1, -3) - t * d_up
        lo = lo + _shift(t * d_dd, 1, -3) - t * d_dn
        up = up + _shift(t * d_up, 1, -3) - t * d_uu

    rv = coef["recip_vol"]
    return lo * rv, diag * rv, up * rv


# the explicit transport stencil reaches two cells per direction (upwind3
# far cells); the streaming kernel sizes its halos from this
STENCIL_RADIUS = 2

# offsets (dz, dlat, dlon) of the 13-point transport stencil, centre first;
# result[i] = sum_o c_o[i] * y[i + o] with lon periodic and lat/depth
# zero-filled off-grid.  The order is the contract between
# transport_stencil_coef, stencil_tend and csrc/transport3d_stream.cu.
STENCIL_OFFSETS = (
    (0, 0, 0),
    (0, 0, 1), (0, 0, -1), (0, 0, 2), (0, 0, -2),
    (0, 1, 0), (0, -1, 0), (0, 2, 0), (0, -2, 0),
    (1, 0, 0), (-1, 0, 0), (2, 0, 0), (-2, 0, 0),
)


def transport_stencil_coef(coef):
    """collapse a STEADY transport_tend operator to 13 stencil fields.

    transport_tend is linear in y with static coefficients (the upwind
    selection depends only on the sign of the steady face transports), so
    the operator is c[o][i] = d tend[i] / d y[i+o] over STENCIL_OFFSETS:
    per face the _face_derivs partials times the face transport (plus the
    diffusive conductance on the near pair), gathered onto the two cells
    each face feeds, scaled by recip_vol, and carrying the source cell's
    wet factor (transport_tend masks y by wet before differencing).

    Returns (13, nz, nlat, nlon) in STENCIL_OFFSETS order, in the
    coefficients' dtype.  stencil_tend with it reproduces transport_tend to
    reassociation roundoff, not bitwise.
    """
    up3 = coef.get("sel3p_e") is not None
    wet = coef["wet"]
    zeros = torch.zeros_like(wet)
    c = {off: zeros for off in STENCIL_OFFSETS}

    def face_terms(t_key, cond_key, selp_key, seln_key):
        """(f_up, f_dn, f_uu, f_dd): d flux / d (near-up, near-dn,
        far-up, far-dn) for one face direction"""
        t = coef.get(t_key)
        cond = coef.get(cond_key) if cond_key else None
        f_up = f_dn = f_uu = f_dd = zeros
        if t is not None:
            d_up, d_dn, d_uu, d_dd = _face_derivs(
                t, coef.get(selp_key), coef.get(seln_key), up3
            )
            f_up, f_dn, f_uu, f_dd = t * d_up, t * d_dn, t * d_uu, t * d_dd
        if cond is not None:
            f_up = f_up + cond
            f_dn = f_dn - cond
        return f_up, f_dn, f_uu, f_dd

    # east faces: flux[i] feeds cells i (out) and i+1 (in, periodic);
    # tend[i] = flux[i-1] - flux[i], gathered through a +1 roll
    if coef.get("t_e") is not None or coef.get("cond_e") is not None:
        f_up, f_dn, f_uu, f_dd = face_terms("t_e", "cond_e", "sel3p_e",
                                            "sel3n_e")

        def r1(arr):
            return torch.roll(arr, 1, dims=-1)

        c[(0, 0, 0)] = c[(0, 0, 0)] + r1(f_dn) - f_up
        c[(0, 0, 1)] = c[(0, 0, 1)] + r1(f_dd) - f_dn
        c[(0, 0, -1)] = c[(0, 0, -1)] + r1(f_up) - f_uu
        c[(0, 0, -2)] = c[(0, 0, -2)] + r1(f_uu)
        c[(0, 0, 2)] = c[(0, 0, 2)] - f_dd

    # north faces: the same along lat with zero-filled shifts
    if coef.get("t_n") is not None or coef.get("cond_n") is not None:
        f_up, f_dn, f_uu, f_dd = face_terms("t_n", "cond_n", "sel3p_n",
                                            "sel3n_n")

        def s1(arr):
            return _shift(arr, -1, -2)  # value at j-1

        c[(0, 0, 0)] = c[(0, 0, 0)] + s1(f_dn) - f_up
        c[(0, 1, 0)] = c[(0, 1, 0)] + s1(f_dd) - f_dn
        c[(0, -1, 0)] = c[(0, -1, 0)] + s1(f_up) - f_uu
        c[(0, -2, 0)] = c[(0, -2, 0)] + s1(f_uu)
        c[(0, 2, 0)] = c[(0, 2, 0)] - f_dd

    # top faces: face k couples y_up=y[k], y_dn=y[k-1], y_uu=y[k+1],
    # y_dd=y[k-2]; tend[k] = flux[k+1] - flux[k]
    if coef.get("t_t") is not None:
        f_up, f_dn, f_uu, f_dd = face_terms("t_t", None, "sel3p_t", "sel3n_t")

        def s1(arr):
            return _shift(arr, 1, -3)  # value at k+1

        c[(0, 0, 0)] = c[(0, 0, 0)] + s1(f_dn) - f_up
        c[(1, 0, 0)] = c[(1, 0, 0)] + s1(f_up) - f_uu
        c[(-1, 0, 0)] = c[(-1, 0, 0)] + s1(f_dd) - f_dn
        c[(2, 0, 0)] = c[(2, 0, 0)] + s1(f_uu)
        c[(-2, 0, 0)] = c[(-2, 0, 0)] - f_dd

    rv = coef["recip_vol"]
    return torch.stack([rv * c[off] * _offset(wet, off)
                        for off in STENCIL_OFFSETS])


def _offset(arr, off):
    """result[..., i] = arr[..., i + off]: lon periodic, lat and depth
    zero-filled off-grid"""
    dz_, dy_, dx_ = off
    if dx_:
        arr = torch.roll(arr, -dx_, dims=-1)
    if dy_:
        arr = _shift(arr, dy_, -2)
    if dz_:
        arr = _shift(arr, dz_, -3)
    return arr


def stencil_tend(st, y):
    """apply a transport_stencil_coef operator: 13 multiply-adds per cell,
    the centre first, then the offsets in STENCIL_OFFSETS order.

    st: (13, nz, nlat, nlon) (or any sequence of 13 per-offset fields that
    broadcast against y); y: (..., nz, nlat, nlon).  Exactly zero on land
    (every c_o carries recip_vol's wet factor)."""
    acc = st[0] * y
    for ind, off in enumerate(STENCIL_OFFSETS[1:], 1):
        acc = acc + st[ind] * _offset(y, off)
    return acc


def vmix_vertical_coeff(vdc, dz, *, device, dtype):
    """vertical-mixing coupling for the implicit (Crank-Nicolson) solve

    vdc: (nz, nlat, nlon) interface diffusivity below each level [cm^2/s]
    (VDC convention; the bottom row is unused), or seasonal
    (n_time, nz, nlat, nlon); dz: (nz,) [cm]

    returns (kv, dz_r): kv ([n_time,] nz-1, nlat*nlon) = kappa/dz_mid [m/s]
    and dz_r (nz,) = 1/dz [1/m], the operands ops/imex.py's
    cn_vertical_increment expects -- units follow gen_A.cpp (cm -> m) so
    the assembled rates match the preconditioner matrix exactly
    """
    vdc = np.asarray(vdc, np.float64)
    dz_m = 1.0e-2 * np.asarray(dz, np.float64)
    dz_mid = 0.5 * (dz_m[:-1] + dz_m[1:])
    kappa = 1.0e-4 * vdc[..., :-1, :, :]  # cm^2/s -> m^2/s, interface below k
    kv = kappa / dz_mid[:, None, None]
    return (
        torch.as_tensor(kv.reshape(kv.shape[:-2] + (-1,)), dtype=dtype,
                        device=device),
        torch.as_tensor(1.0 / dz_m, dtype=dtype, device=device),
    )


def mask_vmix_coeff(kv, mask):
    """zero the vertical-mixing coupling across faces touching dry cells

    kv: ([n_time,] nz-1, nlat*nlon) tensor; mask: (nz, nlat, nlon)
    """
    mask = np.asarray(mask)
    wet = (mask.reshape(mask.shape[0], -1) > 0).astype(np.float64)
    return kv * torch.as_tensor(wet[:-1, :] * wet[1:, :], dtype=kv.dtype,
                                device=kv.device)
