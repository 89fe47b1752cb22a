"""Skewed Student-t pdf plot (a paper figure).

Counterpart of ``nfdpf_tpu/data/skew_t_plot.py``: Hansen's (1994) skewed
Student-t density in numpy, and the figure of four of its shapes.
matplotlib is imported by ``main`` only.

    python -m nfdpf_torch.data.skew_t_plot [out.png]
"""

from __future__ import annotations

import math
import sys

import numpy as np


def hansen_skew_t_pdf(x: np.ndarray, eta: float, lam: float) -> np.ndarray:
    """Hansen (1994) skewed-t density with dof η ∈ (2, ∞), skew λ ∈ (−1, 1)."""
    c = math.gamma((eta + 1) / 2) / (
        math.sqrt(math.pi * (eta - 2)) * math.gamma(eta / 2)
    )
    a = 4 * lam * c * (eta - 2) / (eta - 1)
    b = math.sqrt(1 + 3 * lam**2 - a**2)
    z = b * x + a
    sign = np.where(z < 0, -1.0, 1.0)
    denom = 1 + (z / (1 + sign * lam)) ** 2 / (eta - 2)
    return b * c * denom ** (-(eta + 1) / 2)


def main(out_path: str = "skew_t.png") -> None:
    """Plot the density at (η, λ) = (30, 0), (5, 0), (5, 0.5), (5, −0.5)
    over [−5, 5] into ``out_path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x = np.linspace(-5, 5, 1000)
    fig, ax = plt.subplots(figsize=(6, 4))
    for eta, lam in [(30.0, 0.0), (5.0, 0.0), (5.0, 0.5), (5.0, -0.5)]:
        ax.plot(x, hansen_skew_t_pdf(x, eta, lam),
                label=f"$\\eta$={eta:g}, $\\lambda$={lam:g}")
    ax.set_xlabel("x")
    ax.set_ylabel("pdf")
    ax.legend()
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print(f"saved {out_path}")


if __name__ == "__main__":
    main(*(sys.argv[1:2] or []))
