"""minimal unit-string algebra (self-contained replacement for pint).

The reference uses pint in exactly two places: canonicalizing unit strings for
derived history variables (nk_ooc/utils.py:189-205) and converting values when
unit attributes differ during baseline comparison (nk_ooc/utils.py:296-312).
Both are small, closed problems over the handful of units this domain uses, so a
dependency-free table-driven implementation suffices (pint is not installed).

The port's own copy of newton_krylov_ooc_tpu/utils/units.py.
"""

from __future__ import annotations

import re

# canonical name -> (dimension, scale factor to the dimension's base unit)
_UNIT_TABLE = {
    "m": ("length", 1.0),
    "cm": ("length", 0.01),
    "km": ("length", 1000.0),
    "s": ("time", 1.0),
    "min": ("time", 60.0),
    "h": ("time", 3600.0),
    "d": ("time", 86400.0),
    "years": ("time", 365.0 * 86400.0),  # noleap calendar, matching model constants
    "mol": ("substance", 1.0),
    "mmol": ("substance", 1.0e-3),
    "umol": ("substance", 1.0e-6),
    "nmol": ("substance", 1.0e-9),
    "g": ("mass", 1.0e-3),
    "kg": ("mass", 1.0),
    "1": (None, 1.0),
}

_ALIASES = {
    "meter": "m",
    "meters": "m",
    "second": "s",
    "seconds": "s",
    "sec": "s",
    "day": "d",
    "days": "d",
    "hour": "h",
    "hours": "h",
    "year": "years",
    "yr": "years",
    "a": "years",
    "mole": "mol",
    "moles": "mol",
    "millimole": "mmol",
    "gram": "g",
    "grams": "g",
    "kilogram": "kg",
}

# display order within a product: time units print last in the numerator group and
# first among denominators is alphabetical; this mirrors the canonical strings the
# reference's tests pin down (tests/test_utils.py:32-55)
_SORT_KEY = {name: name for name in _UNIT_TABLE}
_SORT_KEY["years"] = "a"  # abbreviation used for ordering


def _canon(token: str) -> str:
    token = token.strip()
    if token in _UNIT_TABLE:
        return token
    if token in _ALIASES:
        return _ALIASES[token]
    raise ValueError(f"unknown unit '{token}'")


def parse_units(units_str: str) -> dict:
    """
    parse a unit string into {canonical_unit: exponent}

    Handles the grammar the reference's data uses: space-separated products,
    '/'-separated quotients, '^' or '**' exponents, parenthesized groups
    multiplied by juxtaposition (e.g. '( mmol / m^3 ) ( m )'), and a literal
    '1' numerator.
    """
    s = units_str.replace("**", "^")
    # split top level into parenthesized groups and bare segments
    groups = []
    depth = 0
    cur = []
    for ch in s:
        if ch == "(":
            if depth == 0:
                if "".join(cur).strip():
                    groups.append("".join(cur))
                cur = []
            else:
                cur.append(ch)
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                groups.append("".join(cur))
                cur = []
            else:
                cur.append(ch)
        else:
            cur.append(ch)
    if "".join(cur).strip():
        groups.append("".join(cur))

    exps: dict = {}
    for group in groups:
        for unit, exp in _parse_flat(group).items():
            exps[unit] = exps.get(unit, 0) + exp
    return {unit: exp for unit, exp in exps.items() if exp != 0 and unit != "1"}


def _parse_flat(s: str) -> dict:
    """parse a parenthesis-free unit expression"""
    exps: dict = {}
    # '/' flips sign for the single factor that follows it; subsequent
    # space-separated factors multiply (pint grammar)
    parts = re.split(r"\s*/\s*", s.strip())
    for ind, part in enumerate(parts):
        if not part:
            continue
        for factor_ind, factor in enumerate(part.split()):
            sign = -1 if (ind > 0 and factor_ind == 0) else 1
            match = re.fullmatch(r"([A-Za-z1]+)(?:\^(-?\d+))?", factor)
            if match is None:
                raise ValueError(f"cannot parse unit factor '{factor}' in '{s}'")
            name, exp_str = match.groups()
            exp = int(exp_str) if exp_str is not None else 1
            unit = _canon(name)
            exps[unit] = exps.get(unit, 0) + sign * exp
    return exps


def format_units(exps: dict) -> str:
    """canonical string for an exponent dict (reference-format parity)"""
    num = sorted(
        [(u, e) for u, e in exps.items() if e > 0], key=lambda ue: _SORT_KEY[ue[0]]
    )
    den = sorted(
        [(u, e) for u, e in exps.items() if e < 0], key=lambda ue: _SORT_KEY[ue[0]]
    )
    if not num and not den:
        return "1"

    def fmt(unit, exp):
        return unit if exp == 1 else f"{unit}^{exp}"

    numerator = " ".join(fmt(u, e) for u, e in num) if num else "1"
    parts = [numerator] + [fmt(u, -e) for u, e in den]
    res = " / ".join(parts)
    # canonical ordering quirk preserved from the reference: a bare time unit in
    # the middle of a 3-term quotient moves to the end ("mmol / d / m^2" ->
    # "mmol / m^2 / d"), see nk_ooc/utils.py:196-205
    res_split = res.split(" / ")
    if len(res_split) == 3 and res_split[1] in ("d", "s"):
        res = " / ".join([res_split[0], res_split[2], res_split[1]])
    return res


def units_str_format(units_str: str) -> str:
    """return unit string in canonical format"""
    return format_units(parse_units(units_str))


def unit_conversion_factor(units_from: str, units_to: str) -> float:
    """
    multiplicative factor converting values in units_from to units_to;
    raises if the unit strings are not dimensionally compatible
    """
    exps_from = parse_units(units_from)
    exps_to = parse_units(units_to)

    def dims(exps):
        res: dict = {}
        for unit, exp in exps.items():
            dim = _UNIT_TABLE[unit][0]
            if dim is not None:
                res[dim] = res.get(dim, 0) + exp
        return {d: e for d, e in res.items() if e != 0}

    if dims(exps_from) != dims(exps_to):
        raise ValueError(f"units '{units_from}' and '{units_to}' are incompatible")

    factor = 1.0
    for unit, exp in exps_from.items():
        factor *= _UNIT_TABLE[unit][1] ** exp
    for unit, exp in exps_to.items():
        factor /= _UNIT_TABLE[unit][1] ** exp
    return factor


def units_equal(units1: str, units2: str) -> bool:
    """True if two unit strings denote the same physical unit"""
    try:
        return abs(unit_conversion_factor(units1, units2) - 1.0) < 1e-12
    except ValueError:
        return False
