"""Port parity: the Wilson hopping term and the SU(3)/Dirac algebra against
the JAX package (jnp oracle and the pallas kernel in interpret mode)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import Field as JField  # noqa: E402
from repro.core import TargetConfig as JTC  # noqa: E402
from repro.kernels.wilson_dslash import dslash as j_dslash  # noqa: E402
from repro.kernels.wilson_dslash import ref as JR  # noqa: E402
from repro.maths import su3 as JSU3  # noqa: E402
from repro_torch.core import Field as PField  # noqa: E402
from repro_torch.core import LaunchGraph, TargetConfig  # noqa: E402
from repro_torch.kernels.wilson_dslash import dslash as p_dslash  # noqa: E402
from repro_torch.kernels.wilson_dslash import kernel as PK  # noqa: E402
from repro_torch.kernels.wilson_dslash import ref as PR  # noqa: E402
from repro_torch.kernels.wilson_dslash.ops import dslash_stencil_body  # noqa: E402
from repro_torch.maths import su3 as PSU3  # noqa: E402

LAT = (4, 4, 4, 4)
# rtol 1e-5, and atol 1e-6 of the field's largest magnitude: at |D psi| ~ 20
# one fp32 ulp is 1.9e-6, and an output near zero is a cancelling sum whose
# terms the two packages add in different orders
RTOL, ATOL = 1e-5, 1e-6
TORCH = TargetConfig("torch", device="cpu")


def assert_field_close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=ATOL * np.abs(want).max())


def _problem(rng, lat=LAT):
    psi = rng.normal(size=(24,) + lat).astype(np.float32)
    u = rng.normal(size=(72,) + lat).astype(np.float32)
    return psi, u


def _dense_dslash(psi_c, u_c):
    out = np.zeros_like(psi_c)
    for mu in range(4):
        g = PSU3.gamma_dense(mu)
        pm, pp = np.eye(4) - g, np.eye(4) + g
        fwd = np.roll(psi_c, -1, axis=2 + mu)
        bwd = np.roll(psi_c, 1, axis=2 + mu)
        ubwd = np.roll(u_c[mu], 1, axis=2 + mu)
        t1 = np.einsum("st,ta...->sa...", pm, np.einsum("ab...,sb...->sa...", u_c[mu], fwd))
        t2 = np.einsum("st,ta...->sa...", pp,
                       np.einsum("ba...,sb...->sa...", ubwd.conj(), bwd))
        out += t1 + t2
    return out


def test_dslash_ref_matches_jax(rng):
    psi, u = _problem(rng)
    want = np.asarray(JR.dslash_ref(jnp.asarray(psi), jnp.asarray(u)))
    got = PR.dslash_ref(torch.from_numpy(psi), torch.from_numpy(u)).numpy()
    assert_field_close(got, want)


def test_dslash_matches_dense_gamma_oracle(rng):
    psi, u = _problem(rng)
    psi_c = psi.reshape(4, 3, 2, *LAT)
    u_c = u.reshape(4, 3, 3, 2, *LAT)
    want = _dense_dslash(psi_c[:, :, 0] + 1j * psi_c[:, :, 1],
                         u_c[..., 0, :, :, :, :] + 1j * u_c[..., 1, :, :, :, :])
    got = PR.dslash_ref(torch.from_numpy(psi), torch.from_numpy(u)).numpy()
    got = got.reshape(4, 3, 2, *LAT)
    np.testing.assert_allclose(got[:, :, 0] + 1j * got[:, :, 1], want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("jcfg", [JTC("jnp"), JTC("pallas", vvl=128)], ids=["jnp", "pallas"])
def test_dslash_op_matches_jax_engines(jcfg, rng):
    lat = (2, 4, 4, 8)
    psi, u = _problem(rng, lat)
    want = j_dslash(JField.from_numpy("psi", psi, lat), JField.from_numpy("u", u, lat),
                    config=jcfg).to_numpy()
    got = p_dslash(PField.from_numpy("psi", psi, lat), PField.from_numpy("u", u, lat),
                   config=TORCH).to_numpy()
    assert_field_close(got, want)


def test_stencil_body_in_a_graph_matches_ref(rng):
    psi, u = _problem(rng)
    g = LaunchGraph("d").add_stencil(dslash_stencil_body, {"psi": "psi", "u": "u"},
                                     {"d": 24}, width=1)
    assert g.halo_widths() == {"psi": 1, "u": 1}
    got = g.launch({"psi": PField.from_numpy("psi", psi, LAT),
                    "u": PField.from_numpy("u", u, LAT)}, config=TORCH)["d"].to_numpy()
    want = PR.dslash_ref(torch.from_numpy(psi), torch.from_numpy(u)).numpy()
    assert_field_close(got, want)


def test_free_field_constant_mode(rng):
    from repro_torch.apps.milc import fields as F

    u = F.random_su3_gauge(LAT, seed=0, hot=0.0)
    chi = rng.normal(size=(24,)).astype(np.float32)
    psi = np.broadcast_to(chi[:, None, None, None, None], (24,) + LAT).copy()
    got = PR.dslash_ref(torch.from_numpy(psi), torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, 8.0 * psi, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mu", range(4))
def test_su3_algebra_matches_jax(mu, rng):
    assert np.array_equal(PSU3.gamma_dense(mu), JSU3.gamma_dense(mu))
    psi = [rng.normal(size=(4, 3, 6)).astype(np.float32) for _ in range(2)]
    u = [rng.normal(size=(3, 3, 6)).astype(np.float32) for _ in range(2)]
    tp = tuple(torch.from_numpy(a) for a in psi)
    jp = tuple(jnp.asarray(a) for a in psi)
    tu = tuple(torch.from_numpy(a) for a in u)
    ju = tuple(jnp.asarray(a) for a in u)
    for fn in ("project_minus", "project_plus"):
        got, want = getattr(PSU3, fn)(tp, mu), getattr(JSU3, fn)(jp, mu)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    h = PSU3.project_minus(tp, mu)
    jh = JSU3.project_minus(jp, mu)
    for fn in ("su3_mult_halfspinor", "su3_adj_mult_halfspinor"):
        for g, w in zip(getattr(PSU3, fn)(tu, h), getattr(JSU3, fn)(ju, jh)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    for fn in ("reconstruct_minus", "reconstruct_plus"):
        for g, w in zip(getattr(PSU3, fn)(h, mu), getattr(JSU3, fn)(jh, mu)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    v = (tp[0][0], tp[1][0])
    jv = (jp[0][0], jp[1][0])
    for fn in ("su3_mult_vec", "su3_adj_mult_vec"):
        for g, w in zip(getattr(PSU3, fn)(tu, v), getattr(JSU3, fn)(ju, jv)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_wrappers_on_cpu_give_plain_versions(rng):
    psi, u = _problem(rng)
    tp, tu = torch.from_numpy(psi).reshape(24, -1), torch.from_numpy(u).reshape(72, -1)
    assert torch.equal(PK.dslash_cuda(tp, tu, LAT), PK.dslash_plain(tp, tu, LAT))
    ap, pap = PK.wilson_normal_cuda(tp, tu, 0.1, LAT)
    ap2, pap2 = PK.wilson_normal_plain(tp, tu, 0.1, LAT)
    assert torch.equal(ap, ap2) and torch.equal(pap, pap2)
    with pytest.raises(ValueError, match="4-D"):
        PK.dslash_plain(tp, tu, (16, 16))


def test_wilson_normal_plain_matches_jax_graph(rng):
    from repro.apps.milc import cg as JCG
    from repro.apps.milc import fields as JF

    psi, _ = _problem(rng)
    u = JF.random_su3_gauge(LAT, seed=5, hot=0.6)
    jap, jpap = JCG.make_fused_normal(JField.from_numpy("u", u, LAT), 0.12, JTC("jnp"))(
        JField.from_numpy("p", psi, LAT))
    ap, pap = PK.wilson_normal_plain(torch.from_numpy(psi).reshape(24, -1),
                                     torch.from_numpy(u).reshape(72, -1), 0.12, LAT)
    assert_field_close(ap.numpy(), jap.canonical())
    np.testing.assert_allclose(float(pap.sum()), float(jpap), rtol=1e-5)
