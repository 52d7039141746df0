"""The Cash-Karp embedded Runge-Kutta tableau of the RK45 march
(counterpart of ``bhx/integrate.py:38-76``).

Python floats computed the way bhx computes them: each quotient in double,
the error weights ``E = B - BH`` as double differences.  The march's plain
version multiplies float32 rows by them (torch rounds each constant once
to float32), and ``csrc/march.cu`` writes each as that double rounded once
to float.  The stepping itself is inlined in the march
(``bhx_torch/kernels/march.py``), as the reference inlines it in its
kernel (``bhx/kernels/march_substep.py:195-240``).

The tableau is the correct Cash-Karp one; the reference renderer's
``a_43 * k_2`` typo (ray.wgsl:431) is not copied, as bhx does not copy it.
"""

from __future__ import annotations

A21 = 1.0 / 5.0
A31, A32 = 3.0 / 40.0, 9.0 / 40.0
A41, A42, A43 = 3.0 / 10.0, -9.0 / 10.0, 6.0 / 5.0
A51, A52, A53, A54 = -11.0 / 54.0, 5.0 / 2.0, -70.0 / 27.0, 35.0 / 27.0
A61, A62, A63, A64, A65 = (
    1631.0 / 55296.0,
    175.0 / 512.0,
    575.0 / 13824.0,
    44275.0 / 110592.0,
    253.0 / 4096.0,
)
# 5th-order solution weights.
B1, B2, B3, B4, B5, B6 = (
    37.0 / 378.0,
    0.0,
    250.0 / 621.0,
    125.0 / 594.0,
    0.0,
    512.0 / 1771.0,
)
# Embedded 4th-order weights.
BH1, BH2, BH3, BH4, BH5, BH6 = (
    2825.0 / 27648.0,
    0.0,
    18575.0 / 48384.0,
    13525.0 / 55296.0,
    277.0 / 14336.0,
    1.0 / 4.0,
)
# Error weights (b - b_hat).
E1, E2, E3, E4, E5, E6 = (
    B1 - BH1,
    B2 - BH2,
    B3 - BH3,
    B4 - BH4,
    B5 - BH5,
    B6 - BH6,
)
