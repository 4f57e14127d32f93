"""Port parity: layouts, Fields, stencil helpers and plans against the JAX
package, bitwise where the operation moves data."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import layout as JL  # noqa: E402
from repro.core import plan as JP  # noqa: E402
from repro.core import stencil as JS  # noqa: E402
from repro.core.field import Field as JField  # noqa: E402
from repro_torch.core import layout as PL  # noqa: E402
from repro_torch.core import plan as PP  # noqa: E402
from repro_torch.core import stencil as PS  # noqa: E402
from repro_torch.core.field import Field as PField  # noqa: E402

SPECS = ["soa", "aos", "aosoa2", "aosoa4", "aosoa8", "aosoa16"]


@pytest.mark.parametrize("spec", SPECS)
def test_pack_unpack_bitwise(spec, rng):
    canon = rng.normal(size=(5, 64)).astype(np.float32)
    want = np.asarray(JL.parse_layout(spec).pack(jnp.asarray(canon)))
    lay = PL.parse_layout(spec)
    got = lay.pack(torch.from_numpy(canon))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(lay.unpack(got).numpy(), canon)
    assert lay.physical_shape(5, 64) == JL.parse_layout(spec).physical_shape(5, 64)
    # the INDEX() macro is the flat memory order of the packed tensor
    comp, site = np.meshgrid(np.arange(5), np.arange(64), indexing="ij")
    idx = lay.flat_index(comp, site, 5, 64)
    np.testing.assert_array_equal(got.numpy().reshape(-1)[idx], canon)
    np.testing.assert_array_equal(
        idx, JL.parse_layout(spec).flat_index(comp, site, 5, 64))


def test_layout_helpers():
    assert PL.parse_layout("aosoa") == PL.aosoa(128)
    assert PL.tileable_layout(PL.aosoa(16), (4, 4)) == PL.aosoa(16)
    assert PL.tileable_layout(PL.aosoa(16), (3, 5)) == PL.SOA
    assert not PL.aosoa(8).fits(12) and PL.AOS.fits(7)
    with pytest.raises(ValueError):
        PL.parse_layout("hex")
    with pytest.raises(ValueError):
        PL.aosoa(8).pack(torch.zeros(3, 12))


@pytest.mark.parametrize("spec", ["soa", "aos", "aosoa8"])
def test_field_views_match(spec, rng):
    lat = (4, 2, 8)
    arr = rng.normal(size=(3,) + lat).astype(np.float32)
    jf = JField.from_numpy("f", arr, lat, JL.parse_layout(spec))
    pf = PField.from_numpy("f", arr, lat, PL.parse_layout(spec))
    np.testing.assert_array_equal(pf.data.numpy(), np.asarray(jf.data))
    np.testing.assert_array_equal(pf.to_numpy(), arr)
    np.testing.assert_array_equal(pf.canonical().numpy(), np.asarray(jf.canonical()))
    assert tuple(pf.canonical_nd().shape) == (3,) + lat
    g = pf.with_canonical(pf.canonical_nd() * 2)
    np.testing.assert_array_equal(g.to_numpy(), 2 * arr)
    assert g.layout == pf.layout and g.name == "f"
    assert pf.with_data(pf.data + 1).nsites == 64


@pytest.mark.parametrize("spec", ["soa", "aos", "aosoa8"])
def test_with_data_checks_the_physical_shape(spec, rng):
    """A tensor in another layout's shape is refused, not mislabelled."""
    lat = (4, 2, 8)
    pf = PField.from_numpy("f", rng.normal(size=(3,) + lat).astype(np.float32), lat,
                           PL.parse_layout(spec))
    assert pf.with_data(pf.data * 2).layout == pf.layout
    for other in ("soa", "aos", "aosoa8", "aosoa4"):
        wrong = PL.parse_layout(other).pack(pf.canonical())
        if wrong.shape == pf.data.shape:
            continue
        with pytest.raises(ValueError, match="not in its layout"):
            pf.with_data(wrong)
    with pytest.raises(ValueError, match="not in its layout"):
        pf.with_data(pf.data.reshape(-1))


@pytest.mark.parametrize("disp", [(1, 0, 0, 0), (0, -1, 0, 0), (0, 0, 2, -1),
                                  (-3, 1, 0, 1)])
def test_shift_periodic_bitwise(disp, rng):
    x = rng.normal(size=(3, 4, 3, 2, 5)).astype(np.float32)
    want = np.asarray(JS.shift_periodic(jnp.asarray(x), disp))
    got = PS.shift_periodic(torch.from_numpy(x), disp).numpy()
    np.testing.assert_array_equal(got, want)
    # the convention: out(r) = in(r - disp)
    r = (1, 2, 0, 3)
    src = tuple((r[d] - disp[d]) % x.shape[d + 1] for d in range(4))
    assert got[(0,) + r] == x[(0,) + src]


@pytest.mark.parametrize("width", [1, 2, 3])
def test_halo_pad_and_interior_bitwise(width, rng):
    x = rng.normal(size=(2, 4, 2, 5)).astype(np.float32)
    dims = (1, 2, 3)
    want = np.asarray(JS.halo_pad(jnp.asarray(x), width, dims))
    got = PS.halo_pad(torch.from_numpy(x), width, dims)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(PS.interior(got, width, dims).numpy(), x)
    np.testing.assert_array_equal(
        PS.interior(got, width, dims).numpy(),
        np.asarray(JS.interior(jnp.asarray(want), width, dims)))


@pytest.mark.parametrize("n", [1, 12, 64, 97, 360, 4096])
def test_divisors_and_choose_vvl_match(n):
    assert PP.divisors(n) == JP.divisors(n)
    for pref, mult in [(128, 1), (64, 4), (7, 1), (512, 32)]:
        try:
            want = JP.choose_vvl(n, pref, mult)
        except ValueError:
            with pytest.raises(ValueError):
                PP.choose_vvl(n, pref, mult)
            continue
        assert PP.choose_vvl(n, pref, mult) == want


def test_plan_rules():
    from repro_torch.core.target import TargetConfig

    cuda = TargetConfig("cuda", device="cpu", vvl=256)
    assert PP.default_plan(cuda, nsites=512, layouts=[PL.SOA]) == PP.LoweringPlan("cuda", 256)
    # the largest whole-warp divisor within the preferred block size
    assert PP.default_plan(cuda, nsites=96 * 4, layouts=[PL.SOA]).vvl == 192
    assert PP.default_plan(TargetConfig("torch", device="cpu"), nsites=7,
                           layouts=[PL.AOS]) == PP.LoweringPlan("torch")
    # every layout runs on the cuda engine; the block holds whole short arrays
    assert PP.default_plan(cuda, nsites=512, layouts=[PL.AOS]) == PP.LoweringPlan("cuda", 256)
    assert PP.default_plan(cuda, nsites=512, layouts=[PL.aosoa(8)]).vvl == 256
    narrow = TargetConfig("cuda", device="cpu", vvl=32)
    assert PP.default_plan(narrow, nsites=512, layouts=[PL.SOA, PL.aosoa(128)]).vvl == 128
    with pytest.raises(ValueError, match="multiple of AoSoA sal=64"):
        PP.LoweringPlan("cuda", 32).validate(nsites=512, layouts=[PL.aosoa(64)])
    # a tiled plan takes every layout (its kernels address each field through
    # INDEX): it passes the plan checks, and its launch then refuses CPU fields
    tiled = PP.LoweringPlan("cuda", bx=1, by=2)
    tiled.validate(lattice=(4, 4, 4), layouts=[PL.SOA, PL.AOS], stencil=True)
    from repro_torch.kernels.lb_propagation.ops import collide_propagate

    dist, force = (PField.from_canonical(n, torch.ones((nc, 64)), (4, 4, 4), PL.AOS)
                   for n, nc in (("dist", 19), ("force", 3)))
    with pytest.raises(ValueError, match="CUDA device"):
        collide_propagate(dist, force, tau=0.8, config=cuda, plan=tiled)
    for bad in (PP.LoweringPlan("cuda", 48), PP.LoweringPlan("cuda", 2048),
                PP.LoweringPlan("cuda", 0), PP.LoweringPlan("gpu", 128)):
        with pytest.raises(ValueError):
            bad.validate(nsites=4096)
    with pytest.raises(ValueError, match="divide"):
        PP.LoweringPlan("cuda", 128).validate(nsites=96)
    assert PP.plan_for_launch(cuda, 128, [PL.SOA]) == PP.LoweringPlan("cuda", 128)
