"""Training against the plain dense reference: one ``make_epoch_fn`` step
against a step built by hand from the dense reference — ``jax.grad`` of the
summed dense NLL (``linalg.dense_masked_nll``), the reference's gradient
normalization, ``train/adam.py`` and the parameter clip — over every tau
law, both normalizations and three batch shapes."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import qfa_tpu
from qfa_tpu.data.loader import ResidualDataset, epoch_indices
from qfa_tpu.data.synthetic import generate
from qfa_tpu.linalg import dense_masked_nll
from qfa_tpu.models import ModelOptions, absorption, clip_params, random_init
from qfa_tpu.physics import omega_func
from qfa_tpu.train import TrainConfig, TrainState, adam, make_epoch_fn

TAUS = ["becker", "fg", "kamble", "mock"]
GRID = qfa_tpu.make_grid(1100.0, 1400.0, 2e-3)  # blue and red pixels


def true_params(nh, seed=0):
    p = random_init(jax.random.key(seed), GRID.npix, GRID.nb, nh)
    return p._replace(Psi=jnp.full((GRID.npix,), 0.05),
                      omega=jnp.full((GRID.nb,), 0.2),
                      tau0=jnp.asarray(0.1), c0=jnp.asarray(0.25),
                      beta=jnp.asarray(1.8))


@functools.partial(jax.jit, static_argnums=(3,))
def dense_step(params, batch_rows, weight, config):
    """One optimizer step from the dense reference, built by hand."""
    delta, error, zabs, mask = batch_rows
    nb = zabs.shape[-1]
    nr = delta.shape[-1] - nb
    tau = config.options.tau_which
    w = jnp.asarray(weight, jnp.float32)
    mask = mask * w[:, None]

    def summed(p):
        amp = absorption(zabs, nr, tau)
        zdep = omega_func(zabs, p.tau0, p.beta, p.c0)
        omega_full = jnp.concatenate(
            [p.omega * zdep, jnp.zeros(zdep.shape[:-1] + (nr,))], axis=-1
        )
        d = amp * amp * p.Psi + omega_full + error * error
        per = jax.vmap(
            lambda de, a, dd, m: dense_masked_nll(p.F, de, a, dd, m)
        )(delta * mask, amp, d, mask)
        return jnp.sum(per * w)

    total, grads = jax.value_and_grad(summed)(params)
    n_real = jnp.maximum(jnp.sum(w), 1.0)
    if config.reference_norm:
        pix = jnp.sum(mask, axis=0)
        scalar = jnp.sum((jnp.sum(mask[:, :nb], axis=1) > 0).astype(
            jnp.float32))

        def div(g, c):
            return jnp.where(c > 0, g / jnp.maximum(c, 1.0), 0.0)

        grads = grads._replace(
            F=div(grads.F, pix[:, None]), Psi=div(grads.Psi, pix),
            omega=div(grads.omega, pix[:nb]), tau0=div(grads.tau0, scalar),
            c0=div(grads.c0, scalar), beta=div(grads.beta, scalar),
        )
    else:
        grads = jax.tree.map(lambda g: g / n_real, grads)
    new_params, new_opt = adam.apply_update(
        params, grads, adam.init(params), config.adam_config()
    )
    return total / n_real, clip_params(new_params, config.bounds), new_opt


@pytest.mark.parametrize("shape", ["tail_of_500", "odd", "one_row"])
@pytest.mark.parametrize("reference_norm", [True, False])
@pytest.mark.parametrize("tau", TAUS)
def test_epoch_step_matches_dense_reference_step(tau, reference_norm, shape):
    """One step of the jitted epoch equals the dense-reference step: the
    loss, the Adam moments (which hold the gradient) and every parameter
    the step moves by more than a rounding-level gradient."""
    n, batch = {"tail_of_500": (503, 500), "odd": (7, 7),
                "one_row": (1, 1)}[shape]
    params = true_params(4)
    mu = jnp.full((GRID.npix,), 1.1, jnp.float32)
    syn = generate(jax.random.key(2), params, mu, GRID, n, mask_frac=0.2,
                   tau_which=tau)
    b = syn.to_batch(mu, tau_which=tau)
    data = ResidualDataset(delta=b.delta, error=b.error, zabs=b.zabs,
                           mask=b.mask)
    ei = epoch_indices(jax.random.key(4), n, batch)
    idx, wt = ei.idx[-1:], ei.weight[-1:]  # the last (tail) batch
    cfg = TrainConfig(batch_size=batch, learning_rate=1e-2,
                      weight_decay=0.01, reference_norm=reference_norm,
                      options=ModelOptions(tau_which=tau))
    rows = tuple(jnp.asarray(x)[idx[0]] for x in
                 (data.delta, data.error, data.zabs, data.mask))
    p0 = random_init(jax.random.key(5), GRID.npix, GRID.nb, 4)
    loss_ref, params_ref, opt_ref = dense_step(p0, rows, wt[0], cfg)

    p1 = random_init(jax.random.key(5), GRID.npix, GRID.nb, 4)
    st, loss = make_epoch_fn(cfg)(TrainState(p1, adam.init(p1)), data, idx,
                                  wt)
    niter = max(n // batch, 1)
    assert float(loss) * niter == pytest.approx(float(loss_ref), rel=3e-5,
                                                abs=3e-4)
    for name in params_ref._fields:
        m_ref = np.asarray(getattr(opt_ref.m, name))
        scale = float(np.max(np.abs(m_ref)))
        np.testing.assert_allclose(
            np.asarray(getattr(st.opt_state.m, name)), m_ref, rtol=2e-3,
            atol=1e-4 * scale + 1e-12, err_msg=f"m.{name}",
        )
        # Adam's first step moves each entry by lr * sign(m): compare where
        # the sign is not a rounding-level coin flip
        moved = np.abs(m_ref) > 1e-2 * scale
        np.testing.assert_allclose(
            np.asarray(getattr(st.params, name))[moved],
            np.asarray(getattr(params_ref, name))[moved],
            rtol=1e-5, atol=1e-6, err_msg=name,
        )
