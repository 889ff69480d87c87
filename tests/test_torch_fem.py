"""Parity of the port's FEM device layer (alfi_torch.fem.nsforms,
alfi_torch.solvers.linear) with the JAX package on ldc2d baseN=4 nref=1,
in f64 on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  The
tolerance is normwise relative, max|a - b| / max|b|: 1e-12 for the
closed-form quantities (the two packages sum in different orders), 1e-11
for the Jacobian action (forward AD through the same sums)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alfi_torch
import alfi_tpu
from alfi_torch.problems import TwoDimLidDrivenCavityProblem as TorchLDC
from alfi_tpu.problems import TwoDimLidDrivenCavityProblem as JaxLDC

PARAMS = {"nu": 0.02, "gamma": 1e4, "advect": 1.0}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _build(pkg, problem):
    from importlib import import_module

    fem = import_module(pkg + ".fem")
    mesh = problem.mesh_hierarchy("uniform", 1)[-1]
    V = fem.VectorFunctionSpace(mesh, fem.lagrange(2, 2))
    Q = fem.FunctionSpace(mesh, fem.dg_lagrange(2, 0))
    Z = fem.MixedFunctionSpace(V, Q)
    kw = {"device": "cpu"} if pkg == "alfi_torch" else {}
    form = fem.NSForm(V, Q, graddiv_mode="cell_avg", **kw)
    bcset = fem.BCSet(Z, problem.bcs(Z), **kw)
    return form, bcset


@pytest.fixture(scope="module")
def pair():
    torch.set_num_threads(1)
    jf, jb = _build("alfi_tpu", JaxLDC(4))
    tf, tb = _build("alfi_torch", TorchLDC(4))
    rng = np.random.default_rng(7)
    nv, nq = tf.V.ndof, tf.Q.ndof
    data = {k: rng.standard_normal(s) for k, s in
            (("u", (nv, 2)), ("p", (nq,)), ("w", (nv, 2)),
             ("vu", (nv, 2)), ("vp", (nq,)))}
    return jf, jb, tf, tb, data


def _jz(*arrs):
    return tuple(jnp.asarray(a) for a in arrs)


def _tz(*arrs):
    return tuple(torch.as_tensor(a) for a in arrs)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _quantities(jf, jb, tf, tb, d):
    """name -> (torch value, jax value) thunks."""
    ju, jp = _jz(d["u"], d["p"])
    tu, tp = _tz(d["u"], d["p"])
    jw, tw = jnp.asarray(d["w"]), torch.as_tensor(d["w"])

    return {
        "residual_u": (lambda: tf.residual((tu, tp), PARAMS)[0],
                       lambda: jf.residual((ju, jp), PARAMS)[0]),
        "residual_p": (lambda: tf.residual((tu, tp), PARAMS)[1],
                       lambda: jf.residual((ju, jp), PARAMS)[1]),
        "K": (lambda: tf._static_velocity_tensors()[0],
              lambda: jf._static_velocity_tensors()[0]),
        "G": (lambda: tf._static_velocity_tensors()[1],
              lambda: jf._static_velocity_tensors()[1]),
        "N": (lambda: tf.advection_element_tensors(tw),
              lambda: jf.advection_element_tensors(jw)),
        "velocity_tensors": (
            lambda: tf.velocity_element_tensors(PARAMS, tw),
            lambda: jf.velocity_element_tensors(PARAMS, jw)),
        "graddiv_factors": (tf.graddiv_factors, jf.graddiv_factors),
        "pressure_mass_inverse": (tf.pressure_mass_inverse,
                                  jf.pressure_mass_inverse),
        "pressure_massinv_apply": (
            lambda: tf.apply_pressure_massinv(tf.pressure_mass_inverse(),
                                              tp),
            lambda: jf.apply_pressure_massinv(jf.pressure_mass_inverse(),
                                              jp)),
        "divergence": (lambda: tf.apply_divergence(tu),
                       lambda: jf.apply_divergence(ju)),
        "pressure_gradient": (lambda: tf.apply_pressure_gradient(tp),
                              lambda: jf.apply_pressure_gradient(jp)),
        "pressure_integral": (lambda: tf.pressure_integral(tp),
                              lambda: jf.pressure_integral(jp)),
        "area": (tf.area, jf.area),
        "bc_apply_u": (lambda: tb.apply((tu, tp))[0],
                       lambda: jb.apply((ju, jp))[0]),
        "bc_identity_rows_u": (
            lambda: tb.identity_rows((tu, tp), _tz(d["vu"], d["vp"]))[0],
            lambda: jb.identity_rows((ju, jp), _jz(d["vu"], d["vp"]))[0]),
    }


NAMES = ["residual_u", "residual_p", "K", "G", "N", "velocity_tensors",
         "graddiv_factors", "pressure_mass_inverse",
         "pressure_massinv_apply", "divergence", "pressure_gradient",
         "pressure_integral", "area", "bc_apply_u", "bc_identity_rows_u"]


@pytest.mark.parametrize("name", NAMES)
def test_fem_quantity_matches_jax(pair, name):
    jf, jb, tf, tb, d = pair
    t_fn, j_fn = _quantities(jf, jb, tf, tb, d)[name]
    assert _rel(t_fn(), j_fn()) < 1e-12


@pytest.mark.parametrize("part", [0, 1])
def test_jacobian_matvec_matches_jax(pair, part):
    import alfi_torch.solvers.linear as tlin
    import alfi_tpu.solvers.linear as jlin

    jf, jb, tf, tb, d = pair
    tJ = tlin.make_jacobian_matvec(tf.residual, tb, _tz(d["u"], d["p"]),
                                   PARAMS)
    jJ = jlin.make_jacobian_matvec(jf.residual, jb, _jz(d["u"], d["p"]),
                                   PARAMS)
    t_out = tJ(_tz(d["vu"], d["vp"]))[part]
    j_out = jJ(_jz(d["vu"], d["vp"]))[part]
    assert _rel(t_out, j_out) < 1e-11


def test_closed_form_tensors_are_the_residual_jacobian(pair):
    """K, G, N assembled into nu K + gamma G + advect N equal the
    forward-AD Jacobian of the port's own cell residual."""
    _, _, tf, _, d = pair
    w = torch.as_tensor(d["w"])
    w_loc = w[tf.cd_v]
    _, nl, dim = w_loc.shape

    def r(ul):
        return tf.cell_velocity_residual(ul, ul, PARAMS)

    J = torch.func.jacfwd(r)(w_loc)  # (nc, nl, d, nc, nl, d)
    J = torch.stack([J[c, :, :, c].reshape(nl * dim, nl * dim)
                     for c in range(3)])
    T = tf.velocity_element_tensors(PARAMS, w)[:3]
    assert _rel(T, J) < 1e-12


def test_port_packages_are_distinct():
    assert alfi_torch.ConstantPressureSolver is not \
        alfi_tpu.ConstantPressureSolver
