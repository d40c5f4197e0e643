"""Gumbel temperature policies (``gan_image_captioning_tpu/ops/temperature.py``).

All seven policies of the reference's ``get_fixed_temperature``
(``utils.py:55-76``) as a host-side function of ``(max_temp, i, N)``.
"""

from __future__ import annotations

import math

ADAPT_TYPES = ("no", "lin", "exp", "log", "sigmoid", "quad", "sqrt")


def get_fixed_temperature(temper: float, i: float, N: float,
                          adapt: str) -> float:
    """Temperature at progress ``i`` of ``N`` units, formula for formula
    with the reference (including ``no`` returning 1.0, not ``temper``)."""
    if adapt == "no":
        t = 1.0
    elif adapt == "lin":
        t = 1 + i / (N - 1) * (temper - 1)
    elif adapt == "exp":
        t = temper ** (i / N)
    elif adapt == "log":
        t = 1 + (temper - 1) / math.log(N) * math.log(i + 1)
    elif adapt == "sigmoid":
        t = (temper - 1) * 1 / (1 + math.exp((N / 2 - i) * 20 / N)) + 1
    elif adapt == "quad":
        t = (temper - 1) / (N - 1) ** 2 * i ** 2 + 1
    elif adapt == "sqrt":
        t = (temper - 1) / math.sqrt(N - 1) * math.sqrt(i) + 1
    else:
        raise Exception("Unknown adapt type!")
    return float(t)
