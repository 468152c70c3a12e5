"""time-unit conversions on the noleap (365-day) calendar.

The port's own copy of newton_krylov_ooc_tpu/models/test_problem/
constants.py.  test_problem tendencies are per second while tracer units
(e.g. ideal age) are per year, so conversion factors are provided in both
directions.
"""

_HOURS_PER_DAY = 24.0
_SEC_PER_HOUR = 3600.0

day_per_year = 365.0  # noleap calendar
sec_per_day = _HOURS_PER_DAY * _SEC_PER_HOUR
sec_per_year = day_per_year * sec_per_day

day_per_sec = 1.0 / sec_per_day
year_per_sec = 1.0 / sec_per_year
