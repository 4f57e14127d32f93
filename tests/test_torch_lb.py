"""Port parity for the D3Q19 LB kernels: the velocity tables, collision,
propagation (bitwise) and the fused collide -> propagate graph against the
JAX package, the reference's physical invariants on the port, the kernel
wrappers' CPU behaviour and the cuda engine's refusals."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import AOS as J_AOS  # noqa: E402
from repro.core import SOA as J_SOA  # noqa: E402
from repro.core import Field as JField  # noqa: E402
from repro.core import TargetConfig as JTC  # noqa: E402
from repro.core import aosoa as j_aosoa  # noqa: E402
from repro.core import stencil as j_stencil  # noqa: E402
from repro.kernels.lb_collision import collide as j_collide  # noqa: E402
from repro.kernels.lb_collision import ref as j_lbref  # noqa: E402
from repro.kernels.lb_propagation import propagate as j_propagate  # noqa: E402
from repro.kernels.lb_propagation.kernel import propagate_pallas  # noqa: E402
from repro.kernels.lb_propagation.ops import collide_propagate as j_collide_propagate  # noqa: E402
from repro.maths import d3q19 as j_d3q19  # noqa: E402
from repro_torch.core import AOS, SOA, LoweringPlan, TargetConfig, aosoa  # noqa: E402
from repro_torch.core import Field as PField  # noqa: E402
from repro_torch.kernels.lb_collision import collide  # noqa: E402
from repro_torch.kernels.lb_collision import kernel as K7  # noqa: E402
from repro_torch.kernels.lb_collision import ref as lbref  # noqa: E402
from repro_torch.kernels.lb_propagation import kernel as K8  # noqa: E402
from repro_torch.kernels.lb_propagation import propagate  # noqa: E402
from repro_torch.kernels.lb_propagation.ops import collide_propagate  # noqa: E402
from repro_torch.maths import d3q19  # noqa: E402

TORCH = TargetConfig("torch", device="cpu")
LAYOUTS = [(SOA, J_SOA), (AOS, J_AOS), (aosoa(32), j_aosoa(32))]
LAYOUT_IDS = ["soa", "aos", "aosoa32"]
# tests/test_kernels_lb.py's own tolerance for collision against its oracle
COLLIDE_RTOL, COLLIDE_ATOL = 2e-5, 2e-6


def _lb_inputs(rng, lat):
    f0 = (1.0 + 0.1 * rng.normal(size=(19,) + lat)).astype(np.float32)
    frc = (0.01 * rng.normal(size=(3,) + lat)).astype(np.float32)
    return f0, frc


def test_d3q19_tables_equal_reference():
    assert d3q19.NVEL == j_d3q19.NVEL and d3q19.CS2 == j_d3q19.CS2
    np.testing.assert_array_equal(d3q19.CV, j_d3q19.CV)
    np.testing.assert_array_equal(d3q19.WV, j_d3q19.WV)
    assert d3q19.CV.dtype == j_d3q19.CV.dtype and d3q19.WV.dtype == j_d3q19.WV.dtype


@pytest.mark.parametrize("lays", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("lat", [(4, 4, 8), (4, 4, 16)], ids=str)
def test_collide_matches_reference(lat, lays, rng):
    lay, jlay = lays
    f0, frc = _lb_inputs(rng, lat)
    got = collide(PField.from_numpy("dist", f0, lat, lay),
                  PField.from_numpy("force", frc, lat, lay), tau=0.8, config=TORCH)
    assert got.layout == lay
    want = j_collide(JField.from_numpy("dist", f0, lat, jlay),
                     JField.from_numpy("force", frc, lat, jlay), tau=0.8,
                     config=JTC("jnp"))
    np.testing.assert_allclose(got.to_numpy(), np.asarray(want.to_numpy()),
                               rtol=COLLIDE_RTOL, atol=COLLIDE_ATOL)


def test_collide_matches_reference_pallas_interpret(rng):
    lat = (4, 4, 16)
    f0, frc = _lb_inputs(rng, lat)
    got = collide(PField.from_numpy("dist", f0, lat), PField.from_numpy("force", frc, lat),
                  tau=1.1, config=TORCH)
    want = j_collide(JField.from_numpy("dist", f0, lat), JField.from_numpy("force", frc, lat),
                     tau=1.1, config=JTC("pallas", vvl=128))
    np.testing.assert_allclose(got.to_numpy(), np.asarray(want.to_numpy()),
                               rtol=COLLIDE_RTOL, atol=COLLIDE_ATOL)


def test_moments_and_equilibrium_match_reference(rng):
    f0, frc = _lb_inputs(rng, (4, 4, 4))
    f = f0.reshape(19, -1)
    rho, u = lbref.moments(torch.from_numpy(f))
    jrho, ju = j_lbref.moments(jnp.asarray(f))
    np.testing.assert_allclose(rho.numpy(), np.asarray(jrho), rtol=1e-6)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-7)
    uu = 0.05 * frc.reshape(3, -1)
    feq = lbref.equilibrium(rho, torch.from_numpy(uu))
    jfeq = j_lbref.equilibrium(jrho, jnp.asarray(uu))
    np.testing.assert_allclose(feq.numpy(), np.asarray(jfeq), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("tau", [0.6, 0.8, 1.0, 1.7])
def test_collision_conserves_mass_and_momentum(tau, rng):
    """tests/test_kernels_lb.py's invariants, on the port."""
    lat = (8, 8, 8)
    f0, frc = _lb_inputs(rng, lat)
    o = collide(PField.from_numpy("dist", f0, lat), PField.from_numpy("force", frc, lat),
                tau=tau, config=TORCH).to_numpy()
    # mass: sum_i f'_i == rho  (Guo forcing is mass-conserving)
    np.testing.assert_allclose(o.sum(0), f0.sum(0), rtol=1e-5)
    # momentum: the net change is the force
    cv = np.asarray(d3q19.CV, np.float32)
    mom_in = np.einsum("ia,i...->a...", cv, f0)
    mom_out = np.einsum("ia,i...->a...", cv, o)
    np.testing.assert_allclose(mom_out - mom_in, frc, rtol=5e-2, atol=1e-5)


def test_collision_fixed_point():
    """Equilibrium at rest with no force is a fixed point."""
    lat = (4, 4, 4)
    nsites = int(np.prod(lat))
    feq = lbref.equilibrium(torch.ones(nsites), torch.zeros((3, nsites)))
    d = PField.from_canonical("dist", feq, lat, SOA)
    g = PField.from_canonical("force", torch.zeros((3, nsites)), lat, SOA)
    out = collide(d, g, tau=0.8, config=TORCH)
    np.testing.assert_allclose(out.to_numpy(), feq.numpy().reshape((19,) + lat), atol=1e-7)


@pytest.mark.parametrize("lat", [(4, 4, 8), (6, 10, 8), (1, 6, 4), (2, 3, 5)], ids=str)
def test_propagate_bitwise_against_reference(lat, rng):
    f0 = rng.normal(size=(19,) + lat).astype(np.float32)
    got = propagate(PField.from_numpy("dist", f0, lat), config=TORCH).to_numpy()
    want = np.asarray(j_propagate(JField.from_numpy("dist", f0, lat),
                                  config=JTC("jnp")).to_numpy())
    np.testing.assert_array_equal(got, want)
    fh = j_stencil.halo_pad(jnp.asarray(f0), 1, (1, 2, 3))
    np.testing.assert_array_equal(got, np.asarray(propagate_pallas(fh, width=1, interpret=True)))
    # semantic spot-checks: f'_i(r + c_i) = f_i(r)
    for i in [1, 4, 7, 18]:
        src = (0, 1 % lat[1], 2 % lat[2])
        dst = tuple((np.array(src) + d3q19.CV[i]) % np.array(lat))
        assert got[(i,) + dst] == f0[(i,) + src]


@pytest.mark.parametrize("lays", [LAYOUTS[0], LAYOUTS[2]], ids=["soa", "aosoa32"])
def test_collide_propagate_matches_reference(lays, rng):
    lay, jlay = lays
    lat = (4, 4, 8)
    f0, frc = _lb_inputs(rng, lat)
    got = collide_propagate(PField.from_numpy("dist", f0, lat, lay),
                            PField.from_numpy("force", frc, lat, lay), tau=0.8, config=TORCH)
    assert got.layout == lay
    want = j_collide_propagate(JField.from_numpy("dist", f0, lat, jlay),
                               JField.from_numpy("force", frc, lat, jlay), tau=0.8,
                               config=JTC("jnp"))
    np.testing.assert_allclose(got.to_numpy(), np.asarray(want.to_numpy()),
                               rtol=COLLIDE_RTOL, atol=COLLIDE_ATOL)
    # the fused graph is collide then propagate, collision running on the
    # halo'd window there: rho is added in velocity order whatever the
    # chunk's size, so the two agree bit for bit
    unfused = propagate(collide(PField.from_numpy("dist", f0, lat, lay),
                                PField.from_numpy("force", frc, lat, lay), tau=0.8,
                                config=TORCH), config=TORCH)
    np.testing.assert_array_equal(got.to_numpy(), unfused.to_numpy())


def test_collision_bits_do_not_depend_on_the_chunk(rng):
    """A site's post-collision values and moments are the same bits whatever
    chunk of sites it is collided in (a tile's window or the whole lattice):
    rho is added in velocity order, not by torch.sum, whose vectorized
    reduction rounds a ragged tail apart.  It also equals the JAX package's
    jnp.sum bitwise."""
    n = 1728
    f = torch.from_numpy((1.0 + 0.1 * rng.normal(size=(19, n))).astype(np.float32))
    g = torch.from_numpy((0.01 * rng.normal(size=(3, n))).astype(np.float32))
    whole, (rho, u) = lbref.collide_chunk(f, g, 0.8), lbref.moments(f)
    for m in (7, 16, 100, 216):
        assert torch.equal(lbref.collide_chunk(f[:, :m].contiguous(), g[:, :m].contiguous(),
                                               0.8), whole[:, :m])
        rho_m, u_m = lbref.moments(f[:, :m].contiguous())
        assert torch.equal(rho_m, rho[:m]) and torch.equal(u_m, u[:, :m])
    np.testing.assert_array_equal(rho.numpy(), np.asarray(jnp.sum(jnp.asarray(f.numpy()), axis=0)))


@pytest.mark.parametrize("lat", [(4, 4, 8), (1, 6, 4)], ids=str)
def test_kernel_wrappers_take_their_plain_version_on_the_cpu(lat, rng):
    f0, frc = _lb_inputs(rng, lat)
    f, g = torch.from_numpy(f0.reshape(19, -1)), torch.from_numpy(frc.reshape(3, -1))
    assert torch.equal(K7.collide_cuda(f, g, 0.8), K7.collide_plain(f, g, 0.8))
    assert torch.equal(K8.propagate_cuda(f, lat), K8.propagate_plain(f, lat))
    dist2, u = K8.lb_step_cuda(f, g, 0.8, lat)
    assert torch.equal(dist2, K8.propagate_plain(K7.collide_plain(f, g, 0.8), lat))
    rho, mu = lbref.moments(f)
    assert torch.equal(u, mu + 0.5 * g / rho[None, :])
    assert K8.lb_step_cuda(f, g, 0.8, lat, with_u=False)[1] is None
    # lb_params: the reference's coefficients, formed in double
    omega, pw0, pw1, pw2 = K7.lb_params(0.8)
    assert (omega, pw0, pw1, pw2) == (1.0 / 0.8, (1.0 - 0.5 / 0.8) * (1.0 / 3.0),
                                      (1.0 - 0.5 / 0.8) * (1.0 / 18.0),
                                      (1.0 - 0.5 / 0.8) * (1.0 / 36.0))


def test_cuda_engine_refuses_cpu_fields_and_other_layouts(rng):
    lat = (4, 4, 8)
    f0, frc = _lb_inputs(rng, lat)
    d, g = PField.from_numpy("dist", f0, lat), PField.from_numpy("force", frc, lat)
    cuda = TargetConfig("cuda", device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        collide(d, g, tau=0.8, config=cuda)
    with pytest.raises(ValueError, match="CUDA device"):
        propagate(d, config=cuda)
    with pytest.raises(ValueError, match="CUDA device"):
        collide_propagate(d, g, tau=0.8, config=cuda)
    # other layouts are accepted (the CPU tensor is what refuses), dist and
    # force each in its own; SAL must divide vvl, before any launch
    with pytest.raises(ValueError, match="CUDA device"):
        collide(PField.from_numpy("dist", f0, lat, AOS), g, tau=0.8, config=cuda)
    with pytest.raises(ValueError, match="multiple of AoSoA sal=64"):
        collide(PField.from_numpy("dist", f0, lat, aosoa(64)), g, tau=0.8,
                config=TargetConfig("cuda", device="cpu", plan_policy=LoweringPlan("cuda", 32)))
