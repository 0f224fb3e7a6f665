"""Mean-optical-depth laws and forest-noise redshift evolution.

Pure ``jax.numpy`` implementations of the physics functions the
reference keeps in ``/root/reference/QFA/utils.py:57-203``:

* ``tau_becker`` / ``tau_fg`` / ``tau_kamble`` / ``tau_mock`` — published
  mean-optical-depth measurements of the Ly-alpha forest.
* ``tau`` — dispatcher scaling a law to an arbitrary Lyman-series line.
* ``tau_total`` — summed optical depth of all Lyman lines covering a
  rest-frame wavelength grid; the number of contributing lines is resolved at
  trace time from the static grid, so the result is a fixed-shape tensor
  program (no data-dependent Python loops under ``jit``).
* ``tau_hi`` / ``omega_func`` — the trainable power-law optical depth
  ``tau0 (1+z)^beta`` and the forest-noise evolution
  ``(1 - c0 - exp(-tau_hi))^2``.

All functions accept and return ``jnp`` arrays and are safe to ``vmap``/
``jit``/differentiate.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax.numpy as jnp
import numpy as np

from .lyman import COEFF, LYA_WAVELENGTH, N_LINES, WAVELENGTH

Array = jnp.ndarray

__all__ = [
    "tau_becker",
    "tau_fg",
    "tau_kamble",
    "tau_mock",
    "tau",
    "tau_total",
    "tau_hi",
    "omega_func",
    "TAU_LAWS",
    "get_tau_law",
    "resolve_tau",
]


def tau_becker(z: Array) -> Array:
    """Becker et al. 2012 (arXiv:1208.2584) mean optical depth."""
    tau0, beta, c, z0 = 0.751, 2.90, -0.132, 3.5
    return tau0 * ((1.0 + z) / (1.0 + z0)) ** beta + c


def tau_fg(z: Array) -> Array:
    """Faucher-Giguere et al. 2008 mean optical depth."""
    tau0, beta = 0.0018, 3.92
    return tau0 * (1.0 + z) ** beta


def tau_kamble(z: Array) -> Array:
    """Kamble et al. 2020 mean optical depth."""
    tau0, beta = 5.54e-3, 3.182
    return tau0 * (1.0 + z) ** beta


def tau_mock(z: Array) -> Array:
    """Mock-catalog optical depth (Bautista et al. 2015)."""
    return 0.2231435513142097 * ((1.0 + z) / 3.25) ** 3.2


TAU_LAWS: dict = {
    "becker": tau_becker,
    "fg": tau_fg,
    "kamble": tau_kamble,
    "mock": tau_mock,
}


def get_tau_law(which: str) -> Callable[[Array], Array]:
    """Look up a mean-optical-depth law by name."""
    try:
        return TAU_LAWS[which]
    except KeyError:
        raise NotImplementedError(
            f"unknown mean optical depth law {which!r}; "
            f"available: {sorted(TAU_LAWS)}"
        ) from None


def resolve_tau(tau_spec) -> str | Callable[[Array], Array]:
    """Normalize a mean-optical-depth spec to a law NAME where possible.

    The reference model constructor takes ``tau: Callable``, built by the
    driver as ``partial(tau, which=config.MODEL.TAU)``
    (``/root/reference/QFA/model.py:26-33``, ``/root/reference/main.py:87``).
    This helper lets every entry point accept either form:

    * a law name (``"becker"``/``"fg"``/``"kamble"``/``"mock"``) — validated
      and returned as-is;
    * a ``functools.partial`` carrying a ``which=`` keyword (the reference
      idiom) — resolved to that name, so ported code keeps its law;
    * one of the law functions themselves (:data:`TAU_LAWS` values) —
      resolved to its name;
    * any other callable ``tau(z) -> tau`` — returned verbatim and traced
      exactly.
    """
    if isinstance(tau_spec, str):
        get_tau_law(tau_spec)  # validate the name
        return tau_spec
    if isinstance(tau_spec, functools.partial):
        # Only the reference dispatcher idiom resolves to a name: the
        # wrapped function must BE a tau dispatcher (ours, or a
        # same-named one like the reference's utils.tau) and the partial
        # must pin nothing beyond which= and the Ly-alpha series —
        # a partial of a USER callable keeps the callable (anything else
        # would silently swap the user's physics for a built-in law).
        func = tau_spec.func
        which = tau_spec.keywords.get("which")
        extras = set(tau_spec.keywords) - {"which", "series"}
        dispatcher = func is tau or getattr(func, "__name__", "") == "tau"
        if (
            dispatcher
            and isinstance(which, str)
            and not tau_spec.args
            and not extras
            and tau_spec.keywords.get("series", 1) == 1
        ):
            get_tau_law(which)
            return which
    for name, fn in TAU_LAWS.items():
        if tau_spec is fn:
            return name
    if callable(tau_spec):
        return tau_spec
    raise TypeError(
        f"tau must be a law name or a callable tau(z); got {tau_spec!r}"
    )


def tau(z: Array, which: str = "becker", series: int = 1) -> Array:
    """Mean optical depth of Lyman line ``series`` (1 = alpha) at redshift z.

    Mirrors ``/root/reference/QFA/utils.py:149-171``: the Ly-alpha law scaled
    by the line's ``lambda f`` coefficient (arXiv:2003.11036 Eq. 17).
    """
    coeff = float(COEFF[series - 1])
    return get_tau_law(which)(z) * coeff


def n_contributing_lines(wav_start: float) -> int:
    """Number of Lyman lines with rest wavelength above ``wav_start``.

    Static (host-side) helper: for a given wavelength grid the set of
    contributing lines is fixed, so the per-line loop in :func:`tau_total`
    unrolls at trace time.
    """
    n = int(np.sum(WAVELENGTH > wav_start))
    if n == 0:
        raise ValueError(
            "wavelength grid does not cover any Lyman series line "
            f"(grid starts at {wav_start} A > Ly-limit)"
        )
    return min(n, N_LINES)


def tau_total(
    wav_grid: Array,
    zqso: Array,
    which: str = "becker",
    wav_start: float | None = None,
) -> Array:
    """Total Lyman-series optical depth over the blue-side wavelength grid.

    Args:
        wav_grid: rest-frame wavelength grid, shape ``(Npix,)`` (static values
            — the blue pixel count and the contributing-line set derive from
            it at trace time).
        zqso: quasar redshifts, shape ``(...,)`` (broadcast against pixels).
        which: name of the mean-optical-depth law.
        wav_start: override for the grid's first wavelength (defaults to
            ``wav_grid[0]``; only needed if ``wav_grid`` is traced).

    Returns:
        Array of shape ``zqso.shape + (Nb,)`` where ``Nb`` is the number of
        pixels bluer than Ly-alpha: the per-pixel summed optical depth.

    The reference implements this with a data-dependent numpy loop
    (``/root/reference/QFA/utils.py:174-203``); here each line contributes a
    masked fixed-shape term so the whole computation jits.
    """
    wav_np = np.asarray(wav_grid) if wav_start is None else None
    start = float(wav_np[0]) if wav_start is None else float(wav_start)
    n_lines = n_contributing_lines(start)

    wav = jnp.asarray(wav_grid)
    nb = int(np.sum(np.asarray(wav_grid) < LYA_WAVELENGTH))
    blue = wav[:nb]
    z = jnp.asarray(zqso)[..., None]  # (..., 1)

    law = get_tau_law(which)
    total = jnp.zeros(z.shape[:-1] + (nb,), dtype=blue.dtype)
    for i in range(n_lines):
        lam_i = float(WAVELENGTH[i])
        coeff_i = float(COEFF[i])
        zabs_i = (1.0 + z) * (blue / lam_i) - 1.0
        contrib = law(zabs_i) * coeff_i
        total = total + jnp.where(blue < lam_i, contrib, 0.0)
    return total


def tau_hi(z: Array, tau0: Array, beta: Array) -> Array:
    """Trainable power-law effective optical depth ``tau0 (1+z)^beta``.

    (Reference: ``/root/reference/QFA/utils.py:57-72``.)
    """
    return tau0 * (1.0 + z) ** beta


def omega_func(z: Array, tau0: Array, beta: Array, c0: Array) -> Array:
    """Forest-noise redshift evolution ``(1 - c0 - exp(-tau_hi(z)))^2``.

    (Reference: ``/root/reference/QFA/utils.py:75-92``.)
    """
    root = 1.0 - c0 - jnp.exp(-tau_hi(z, tau0, beta))
    return root * root
