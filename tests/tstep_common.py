"""Shared inputs of the t-step port's CPU tests: the JAX package's scenes,
cameras and parameters beside their volym_tpu_torch counterparts, and the
eager JAX call the port is held to.

The JAX side runs under ``jax.disable_jit()``: jitted XLA contracts
multiply-adds into FMAs, eager JAX rounds op by op as PyTorch does (C5 in
``ROADMAP.md``).  Eager JAX dispatches every primitive from Python, one
march step at a time, so the cases keep 16^3 scenes, 8x8 or 16x16 rays and
a bounded ``max_steps``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import volym_tpu as vj
from volym_tpu_torch import convert, parity

SIDE = 16


def teapot(side=SIDE):
    """The teapot stand-in with importance ``max(importance, 0.9 volume)``
    (as ``tests/test_golden_vs_scalar.py``), so that coloring and the
    look-ahead have importance everywhere there is material; -> (JAX scene,
    port scene)."""
    base = vj.Scene.synthetic("teapot", side=side)
    sj = vj.Scene(base.volume, jnp.maximum(base.importance, base.volume * 0.9), base.tf_lut)
    return sj, convert.scene_from_jax(sj)


def sphere(side=SIDE):
    sj = vj.Scene.synthetic("sphere", side=side)
    return sj, convert.scene_from_jax(sj)


def camera(h=30.0, v=20.0, distance=1.1):
    """(JAX camera, JAX matrices, port matrices) of an orbit camera whose
    90-degree frustum the unit box fills."""
    cam = vj.Camera(aspect=1.0, distance=distance).orbit(h, v, 0.0)
    mj = cam.matrices()
    return cam, mj, convert.camera_matrices_from_jax(mj)


def params(**kw):
    """(JAX params, port params) from the same fields."""
    pj = vj.RenderParams(**kw)
    return pj, convert.render_params(pj)


def eager(fn, *args, **kwargs):
    """``fn`` under ``jax.disable_jit()``, its array results as numpy."""
    with jax.disable_jit():
        out = fn(*args, **kwargs)
    return jax.tree_util.tree_map(np.asarray, out)


def check_image(want, got, name):
    """An image within 1e-6 absolute of eager JAX's (images here peak at
    about 1); knife-edge entries are counted by the repo's rule
    (``parity.check_close``), not absorbed by a wider bound."""
    if hasattr(got, "detach"):
        got = got.detach().numpy()
    assert np.isfinite(got).all(), name
    return parity.check_close(want, got, name, bulk=1e-6)


def lit(img):
    """The share of pixels with colour above 0.01: a guard against a
    comparison of black frames."""
    return float((np.asarray(img)[..., :3].max(-1) > 0.01).mean())


#: the gradient leaves compared, scene then camera
LEAVES = ("volume", "importance", "tf_lut", "inverse_view_proj", "position")


def cotangent(res):
    """The weights of the loss ``sum(img * w)`` (``tests/test_diff.py``'s:
    a cosine over the colour, 0.5 on alpha)."""
    w = np.empty((res, res, 4), np.float32)
    w[..., :3] = np.cos(np.arange(res * res * 3).reshape(res, res, 3) * 0.1)
    w[..., 3] = 0.5
    return w


def jax_vjp(render, sj, mj, pj, w, res):
    """(image, {leaf: gradient}) of ``sum(render(...) * w)`` under eager
    JAX."""
    def f(s, m):
        return render(s, m, pj, res, res)

    with jax.disable_jit():
        img, vjp = jax.vjp(f, sj, mj)
        gs, gm = vjp(jnp.asarray(w))
    grads = {n: np.asarray(getattr(gs, n)) for n in LEAVES[:3]}
    grads.update({n: np.asarray(getattr(gm, n)) for n in LEAVES[3:]})
    return np.asarray(img), grads


def port_vjp(render, st, mt, pt, w, res):
    """(image, {leaf: gradient}) of the port's ``sum(render(...) * w)``."""
    for leaf in (st.volume, st.importance, st.tf_lut, mt.inverse_view_proj, mt.position):
        leaf.requires_grad_(True)
        leaf.grad = None
    img = render(st, mt, pt, res, res)
    (img * torch.from_numpy(w)).sum().backward()
    grads = {n: getattr(st, n).grad for n in LEAVES[:3]}
    grads.update({n: getattr(mt, n).grad for n in LEAVES[3:]})
    return img.detach().numpy(), {n: None if g is None else g.numpy() for n, g in grads.items()}


def check_grads(want, got, name, atol_of_scale=1e-4):
    """Each leaf within ``atol_of_scale`` of the scale of JAX's gradient; a
    leaf the port leaves without a gradient must be zero in JAX."""
    for leaf, a in want.items():
        b = got[leaf]
        assert np.isfinite(a).all(), f"{name} d {leaf}: JAX is not finite"
        if b is None:
            assert not a.any(), f"{name} d {leaf}: the port gives none, JAX {np.abs(a).max()}"
            continue
        assert np.isfinite(b).all(), f"{name} d {leaf}"
        scale = max(float(np.abs(a).max()), 1e-6)
        err = float(np.abs(a - b).max())
        assert err <= atol_of_scale * scale, f"{name} d {leaf}: {err:.3e} of scale {scale:.3e}"
