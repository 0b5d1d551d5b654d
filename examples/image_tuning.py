"""Image-based quadrupole tuning against a target screen image.

Hard histograms are piecewise-constant in the particle positions, so their
gradient w.r.t. magnet settings is zero — in the reference exactly as here.
The differentiable route is the analytic screen reading of a
``ParameterBeam`` (a transverse Gaussian PDF on the pixel grid, reference
``lynx/accelerator/screen.py:143-216``): smooth in the beam moments, hence
in every upstream magnet parameter.  This example recovers quadrupole
strengths from a *camera image alone* by gradient descent on the pixel MSE.

Run: python examples/image_tuning.py
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import optax

import lynx_tpu as lt
from lynx_tpu.functional import track
from lynx_tpu.models import ares_ea_segment


SEGMENT = ares_ea_segment()
SEGMENT.AREABSCR1.is_active = True
SEGMENT.AREABSCR1.binning = 8  # 306 x 255 px: plenty for moment recovery


def reading(k1: jax.Array, k2: jax.Array, beam: lt.ParameterBeam) -> jax.Array:
    SEGMENT.AREAMQZM1.k1 = k1
    SEGMENT.AREAMQZM2.k1 = k2
    _, diagnostics = track(SEGMENT, beam)
    return diagnostics["AREABSCR1"]


def main() -> None:
    beam = lt.ParameterBeam.from_parameters(
        sigma_x=jnp.array(1.75e-4),
        sigma_y=jnp.array(1.75e-4),
        sigma_xp=jnp.array(2e-5),
        sigma_yp=jnp.array(2e-5),
        energy=jnp.array(1.073e8),
    )

    true_k = (jnp.array(4.2), jnp.array(-4.2))
    target = reading(*true_k, beam)
    # PDF readings peak at ~1/(2*pi*sigma_x*sigma_y) ~ 1e7; normalize to
    # O(1) pixels so the f32 MSE and its gradients are well-scaled.
    scale = 1.0 / jnp.max(target)

    @jax.jit
    @jax.value_and_grad
    def loss_fn(params):
        image = reading(params[0], params[1], beam)
        return jnp.mean(((image - target) * scale) ** 2)

    params = jnp.array([1.0, -1.0])
    optimizer = optax.adam(0.1)
    opt_state = optimizer.init(params)

    loss0 = None
    for step in range(200):
        loss, grads = loss_fn(params)
        if loss0 is None:
            loss0 = loss
        updates, opt_state = optimizer.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        if step % 40 == 0:
            print(
                f"step {step:3d}  loss {float(loss):.3e}"
                f"  k = ({float(params[0]):+.3f}, {float(params[1]):+.3f})"
            )

    print(
        f"recovered k = ({float(params[0]):+.4f}, {float(params[1]):+.4f})"
        f"  true k = ({float(true_k[0]):+.4f}, {float(true_k[1]):+.4f})"
    )
    assert float(loss) < 1e-3 * float(loss0), "image loss did not collapse"


if __name__ == "__main__":
    from lynx_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
