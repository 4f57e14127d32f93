"""Port parity for the decomposed lattice in one process, against the JAX
package on the CPU: ``Domain``'s shapes and refusals, the exchange on a
one-rank mesh (the reference's ``halo.exchange`` under a one-device
``shard_map``), ``shifted_window``, the ``*_halo`` gradients,
``propagate_halo`` and ``dslash_halo`` (K8H's and K4H's plain versions),
the ``halo="pre"`` launches of ``wilson_normal`` and ``ludwig_lb_step``
(and K5H's and K5LH's plain versions), and the refusals.

Tolerances: data movement and the port's own lowerings bitwise; dslash
against the reference at atol 1e-6 x max|D psi| (XLA and torch may round
a contracted multiply-add differently); the fused launches at rtol 1e-6
(atol 1e-6 x the output's largest magnitude, for values that cancel).
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.apps.ludwig import driver as JLD  # noqa: E402
from repro.apps.ludwig import gradients as JGR  # noqa: E402
from repro.apps.milc import cg as JCG  # noqa: E402
from repro.core import Field as JField  # noqa: E402
from repro.core import TargetConfig as JTC  # noqa: E402
from repro.core import compat as jcompat  # noqa: E402
from repro.core import halo as jhalo  # noqa: E402
from repro.core import stencil as JS  # noqa: E402
from repro.kernels.lb_propagation import ref as jpropref  # noqa: E402
from repro.kernels.wilson_dslash import ops as JWO  # noqa: E402
from repro.lattice import Domain as JDomain  # noqa: E402
from repro_torch.apps.ludwig import LudwigConfig  # noqa: E402
from repro_torch.apps.ludwig import driver as PLD  # noqa: E402
from repro_torch.apps.ludwig import gradients as PGR  # noqa: E402
from repro_torch.apps.milc import cg as PCG  # noqa: E402
from repro_torch.core import SOA, Field, LaunchGraph, LoweringPlan, TargetConfig  # noqa: E402
from repro_torch.core import halo as phalo  # noqa: E402
from repro_torch.core import stencil as PS  # noqa: E402
from repro_torch.core.plan import adapt_plan  # noqa: E402
from repro_torch.kernels.lb_propagation import kernel as lbk  # noqa: E402
from repro_torch.kernels.lb_propagation import propagate_halo  # noqa: E402
from repro_torch.kernels.wilson_dslash import dslash_halo  # noqa: E402
from repro_torch.kernels.wilson_dslash import kernel as wk  # noqa: E402
from repro_torch.lattice import Domain  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.maths import d3q19  # noqa: E402

TORCH = TargetConfig("torch", device="cpu")
CUDA_ON_CPU = TargetConfig("cuda", device="cpu")
DSLASH_ATOL = 1e-6          # x max|D psi|
LAUNCH_RTOL = LAUNCH_ATOL = 1e-6


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, rtol=LAUNCH_RTOL, atol=LAUNCH_ATOL):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * np.abs(want).max())


def _mesh(*axes):
    return Mesh((1,) * len(axes), axes, rank=0, world_size=1, local_rank=0, device="cpu")


# -- Domain and the exchange ---------------------------------------------------------

@pytest.mark.parametrize("sizes,dim_axes,halo", [
    ({"mx": 2, "my": 2}, ("mx", "my", None), 1),
    ({"mx": 4}, ("mx", None, None, None), 2),
    ({"mx": 1, "my": 4}, (None, "my", "mx"), 1),
])
def test_domain_shapes_match_the_reference(sizes, dim_axes, halo):
    """local_shape, local_shape_halo, decomposed and the site counts of the
    port's Domain equal the reference's on the same mesh sizes (both read
    only the mesh's axis sizes for these)."""
    lat = (8, 8, 8) if len(dim_axes) == 3 else (8, 4, 4, 4)
    mesh = types.SimpleNamespace(shape=dict(sizes))
    p = Domain(lat, mesh, dim_axes, halo)
    j = JDomain(global_shape=lat, mesh=mesh, dim_axes=dim_axes, halo=halo)
    assert p.local_shape == j.local_shape
    assert p.local_shape_halo == j.local_shape_halo
    assert p.decomposed == j.decomposed
    assert (p.nsites_local, p.nsites_global) == (j.nsites_local, j.nsites_global)


def test_domain_refusals_match_the_reference():
    mesh = types.SimpleNamespace(shape={"mx": 3})
    for D in (Domain, JDomain):
        with pytest.raises(ValueError, match="dim_axes must match"):
            D((8, 8, 8), mesh, ("mx", None))
        with pytest.raises(ValueError, match="not divisible"):
            D((8, 8, 8), mesh, ("mx", None, None)).local_shape


@pytest.mark.parametrize("width", [1, 2])
def test_one_rank_exchange_is_the_reference_exchange(width, rng):
    """add_halo + exchange on a one-rank mesh over every decomposed dim,
    bitwise the reference's halo.exchange under a one-device shard_map,
    and the periodic wrap; strip_halo gives the block back."""
    lat = (6, 5, 7)
    x = rng.normal(size=(3,) + lat).astype(np.float32)
    dom = Domain(lat, _mesh("a", "b"), ("a", None, "b"), halo=width)
    got = dom.exchange(dom.add_halo(torch.from_numpy(x)))

    jmesh = jcompat.make_mesh((1, 1), ("a", "b"))
    jdom = JDomain(global_shape=lat, mesh=jmesh, dim_axes=("a", None, "b"), halo=width)
    spec = JP(None, "a", None, "b")
    f = jax.jit(jcompat.shard_map(lambda xl: jdom.exchange(jdom.add_halo(xl)), mesh=jmesh,
                                  in_specs=spec, out_specs=spec))
    want = np.asarray(f(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    wrap = PS.halo_pad(torch.from_numpy(x), width, (1, 3))
    np.testing.assert_array_equal(got.numpy(), wrap.numpy())
    np.testing.assert_array_equal(dom.strip_halo(got).numpy(), x)
    assert torch.equal(dom.scatter(torch.from_numpy(x)), torch.from_numpy(x))
    assert torch.equal(dom.gather(torch.from_numpy(x)), torch.from_numpy(x))


@pytest.mark.parametrize("width", [1, 2, 3])
def test_exchange_padded_is_the_pad_then_the_exchange(width, rng):
    """exchange_padded (the sharded solve's and step's one-pass halo) is bitwise
    exchange(halo_pad(x)) on a one-rank mesh, a dim left undecomposed
    included, and for a block thinner than the halo (the fallback)."""
    for lat in ((6, 5, 7), (6, 2, 7)):   # the undecomposed dim 2 < width 3 in the second
        x = torch.from_numpy(rng.normal(size=(3,) + lat).astype(np.float32))
        dom = Domain(lat, _mesh("a", "b"), ("a", None, "b"), halo=width)
        want = dom.exchange(PS.halo_pad(x, width, (1, 2, 3)))
        got = phalo.exchange_padded(x, dom.decomposed, width=width, mesh=dom.mesh)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_axis_perms_and_mesh_geometry():
    """axis_perms is the reference's; a mesh numbers its ranks row-major,
    its neighbours the periodic line's."""
    for n in (1, 2, 5):
        assert phalo.axis_perms(n) == jhalo.axis_perms(n)
    m = Mesh((1,), ("a",), rank=0, world_size=1, local_rank=0, device="cpu")
    assert m.coords == (0,) and m.neighbours("a") == (0, 0) and m.group(("a",)) is None
    t = torch.tensor(3.0)
    assert m.all_reduce(t, ("a",)) is t
    # the geometry of a larger mesh, without its process group
    g = Mesh.__new__(Mesh)
    g.axis_names, g.shape = ("x", "y"), {"x": 2, "y": 3}
    assert [g.coords_of(r) for r in range(6)] == [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    assert all(g.rank_of(g.coords_of(r)) == r for r in range(6))
    g.coords = g.coords_of(4)
    assert g.neighbours("x") == (1, 1) and g.neighbours("y") == (5, 3)
    with pytest.raises(ValueError, match="ranks"):
        Mesh((2,), ("a",), rank=0, world_size=1, device="cpu")


# -- shifted windows, gradients, propagation and dslash on halos ----------------------

@pytest.mark.parametrize("width", [1, 2])
def test_shifted_window_and_halo_gradients_bitwise(width, rng):
    lat = (5, 6, 4)
    x = rng.normal(size=(5,) + tuple(s + 2 * width for s in lat)).astype(np.float32)
    for disp in ((0, 0, 0), (1, -1, 0), (-width, 0, width)):
        np.testing.assert_array_equal(
            PS.shifted_window(torch.from_numpy(x), disp, width, (1, 2, 3)).numpy(),
            np.asarray(JS.shifted_window(jnp.asarray(x), disp, width, (1, 2, 3))))
    with pytest.raises(ValueError, match="exceeds halo width"):
        PS.shifted_window(torch.from_numpy(x), (width + 1, 0, 0), width, (1, 2, 3))
    for pf, jf in ((PGR.grad_central_halo, JGR.grad_central_halo),
                   (PGR.laplacian_halo, JGR.laplacian_halo)):
        np.testing.assert_array_equal(pf(torch.from_numpy(x), width).numpy(),
                                      np.asarray(jf(jnp.asarray(x), width)))


@pytest.mark.parametrize("width", [1, 2])
def test_propagate_halo_bitwise(width, rng):
    """propagate_halo (K8H's plain version) bitwise the reference's
    propagate_halo_ref (the JAX package's tests/test_kernels_lb.py:100),
    and on a wrap-padded array bitwise the periodic propagation."""
    lat = (6, 5, 4)
    f0 = rng.normal(size=(19,) + lat).astype(np.float32)
    fh = PS.halo_pad(torch.from_numpy(f0), width, (1, 2, 3))
    got = propagate_halo(fh, config=TORCH, width=width)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpropref.propagate_halo_ref(jnp.asarray(fh.numpy()), width)))
    np.testing.assert_array_equal(got.numpy(), lbk.propagate_plain(
        torch.from_numpy(f0).reshape(19, -1), lat).reshape((19,) + lat).numpy())
    assert torch.equal(lbk.propagate_halo_cuda(fh, width), got)   # the CPU tensor: plain


@pytest.mark.parametrize("width", [1, 2])
def test_dslash_halo_matches_the_reference(width, rng):
    """dslash_halo (K4H's plain version) against the reference's on the
    jnp engine and on pallas in interpret mode, atol 1e-6 x max|D psi|;
    on wrap-padded fields bitwise the port's periodic dslash."""
    lat = (4, 4, 4, 4)
    hl = tuple(s + 2 * width for s in lat)
    psi = rng.normal(size=(24,) + hl).astype(np.float32)
    u = rng.normal(size=(72,) + hl).astype(np.float32)
    got = dslash_halo(torch.from_numpy(psi), torch.from_numpy(u), config=TORCH, width=width)
    assert tuple(got.shape) == (24,) + lat
    for jcfg in (JTC("jnp"), JTC("pallas", interpret=True)):
        want = np.asarray(JWO.dslash_halo(jnp.asarray(psi), jnp.asarray(u), config=jcfg,
                                          width=width))
        _close(got, want, rtol=0.0, atol=DSLASH_ATOL)
    # wrap-padded: the periodic operator
    p0, u0 = (PS.interior(torch.from_numpy(a), width, (1, 2, 3, 4)) for a in (psi, u))
    ph, uh = (PS.halo_pad(a.contiguous(), width, (1, 2, 3, 4)) for a in (p0, u0))
    np.testing.assert_array_equal(
        wk.dslash_halo_plain(ph, uh, width).numpy(),
        wk.dslash_plain(p0.reshape(24, -1), u0.reshape(72, -1), lat).reshape(
            (24,) + lat).numpy())


# -- the halo="pre" launches -----------------------------------------------------------

def _pre_inputs(rng, lat, ncomps, ring, scale=1.0):
    hl = tuple(s + 2 * ring for s in lat)
    return [(scale * rng.normal(size=(nc,) + hl)).astype(np.float32) for nc in ncomps]


def _fields(arrs, names, mod):
    return {n: mod.from_numpy(n, a.reshape(a.shape[0], -1), tuple(a.shape[1:]), _soa_of(mod))
            for n, a in zip(names, arrs)}


def _soa_of(mod):
    from repro.core import SOA as JSOA
    return SOA if mod is Field else JSOA


def test_pre_wilson_normal_matches_the_reference(rng):
    """wilson_normal under halo="pre" on halo'd p and u (ring 2): ap on the
    interior within rtol 1e-6 of the reference's "pre" launch (jnp), pap
    too; K5H's plain version bitwise the launch's ap."""
    lat = (4, 4, 4, 4)
    p, u = _pre_inputs(rng, lat, (24, 72), 2)
    pf = _fields((p, u), ("p", "u"), Field)
    out = PCG.wilson_normal_graph(0.12).launch(pf, config=TORCH, outputs=("ap", "pap"),
                                               halo="pre")
    assert out["ap"].lattice == lat
    jf = _fields((p, u), ("p", "u"), JField)
    want = JCG.wilson_normal_graph(0.12).launch(jf, config=JTC("jnp"), outputs=("ap", "pap"),
                                                halo="pre")
    _close(out["ap"].to_numpy(), want["ap"].to_numpy())
    _close(out["pap"], want["pap"], atol=1e-5)
    assert torch.equal(wk.wilson_normal_pre_plain(pf["p"].data, pf["u"].data, 0.12, lat),
                       out["ap"].data)
    assert torch.equal(wk.wilson_normal_pre_cuda(pf["p"].data, pf["u"].data, 0.12, lat),
                       out["ap"].data)   # the CPU tensor: plain


def test_pre_lb_step_matches_the_reference(rng):
    """ludwig_lb_step under halo="pre" on halo'd dist and force (ring 1):
    dist2 and u within rtol 1e-6 of the reference's "pre" launch; K5LH's
    plain version bitwise the launch's."""
    lat = (5, 4, 6)
    d = (1.0 / 19 + 1e-3 * rng.normal(size=(19,) + tuple(s + 2 for s in lat))).astype(np.float32)
    f = (1e-3 * rng.normal(size=(3,) + tuple(s + 2 for s in lat))).astype(np.float32)
    cfg = LudwigConfig(lattice=lat, target=TORCH)
    pf = _fields((d, f), ("dist", "force"), Field)
    out = PLD.lb_step_graph(cfg).launch(pf, config=TORCH, outputs=("dist2", "u"), halo="pre")
    from repro.apps.ludwig import LudwigConfig as JLC
    jf = _fields((d, f), ("dist", "force"), JField)
    want = JLD.lb_step_graph(JLC(lattice=lat)).launch(jf, config=JTC("jnp"),
                                                      outputs=("dist2", "u"), halo="pre")
    for o in ("dist2", "u"):
        _close(out[o].to_numpy(), want[o].to_numpy())
    d2, u2 = lbk.lb_step_pre_plain(pf["dist"].data, pf["force"].data, cfg.tau, lat)
    assert torch.equal(d2, out["dist2"].data) and torch.equal(u2, out["u"].data)


def test_pre_launches_on_wrap_padded_inputs_are_the_periodic_launch(rng):
    """On wrap-padded inputs a "pre" launch is bitwise the periodic launch
    of the interior: wilson_normal (ap, pap) and ludwig_lb_step (dist2, u)."""
    lat = (4, 4, 4, 4)
    p0 = torch.from_numpy(rng.normal(size=(24,) + lat).astype(np.float32))
    u0 = torch.from_numpy(rng.normal(size=(72,) + lat).astype(np.float32))
    g = PCG.wilson_normal_graph(0.1)
    per = g.launch({"p": Field.from_canonical("p", p0.reshape(24, -1), lat),
                    "u": Field.from_canonical("u", u0.reshape(72, -1), lat)},
                   config=TORCH, outputs=("ap", "pap"))
    hl = tuple(s + 4 for s in lat)
    pre = g.launch({n: Field.from_canonical(n, PS.halo_pad(a, 2, (1, 2, 3, 4)).reshape(
        a.shape[0], -1), hl) for n, a in (("p", p0), ("u", u0))}, config=TORCH,
        outputs=("ap", "pap"), halo="pre")
    assert torch.equal(pre["ap"].data, per["ap"].data)
    assert torch.equal(pre["pap"], per["pap"])

    lat3 = (6, 4, 5)
    cfg = LudwigConfig(lattice=lat3, target=TORCH)
    d0 = torch.from_numpy((1.0 / 19 + 1e-3 * rng.normal(size=(19,) + lat3)).astype(np.float32))
    f0 = torch.from_numpy((1e-3 * rng.normal(size=(3,) + lat3)).astype(np.float32))
    lg = PLD.lb_step_graph(cfg)
    per = lg.launch({"dist": Field.from_canonical("dist", d0.reshape(19, -1), lat3),
                     "force": Field.from_canonical("force", f0.reshape(3, -1), lat3)},
                    config=TORCH, outputs=("dist2", "u"))
    hl3 = tuple(s + 2 for s in lat3)
    pre = lg.launch({n: Field.from_canonical(n, PS.halo_pad(a, 1, (1, 2, 3)).reshape(
        a.shape[0], -1), hl3) for n, a in (("dist", d0), ("force", f0))}, config=TORCH,
        outputs=("dist2", "u"), halo="pre")
    assert torch.equal(pre["dist2"].data, per["dist2"].data)
    assert torch.equal(pre["u"].data, per["u"].data)


# -- refusals ------------------------------------------------------------------------

def _lap1d_body(v, gather, *, c):
    y = v["y"]
    return {"z": gather("y", (1, 0, 0)) + gather("y", (-1, 0, 0)) - 2 * y + c}


def _s1(v, *, a):
    return {"t": v["x"] * a + v["y"]}


def test_pre_halo_refusals_match_the_reference(rng):
    """tests/test_fuse.py:363-381 on the port: an input too thin for its
    ring (an empty interior) and inputs that disagree on the interior raise
    naming the interior lattice; a stencil-free graph under "pre" raises."""
    lat = (4, 4, 4)
    fx = Field.from_numpy("x", rng.normal(size=(1, 64)).astype(np.float32), lat)
    g = (LaunchGraph("thin")
         .add_stencil(_lap1d_body, {"y": "x"}, {"z": 1}, width=1, params=dict(c=0.0),
                      rename={"z": "z1"})
         .add_stencil(_lap1d_body, {"y": "z1"}, {"z": 1}, width=1, params=dict(c=0.0)))
    with pytest.raises(ValueError, match="interior lattice"):
        g.launch({"x": fx}, config=TORCH, halo="pre", outputs=("z",))
    g2 = LaunchGraph("nostencil").add(_s1, {"x": "x", "y": "y"}, {"t": 1}, params=dict(a=1.0))
    with pytest.raises(ValueError, match="stencil"):
        g2.launch({"x": fx, "y": fx}, config=TORCH, halo="pre")
    p = Field.from_numpy("p", rng.normal(size=(24, 6 ** 4)).astype(np.float32), (6,) * 4)
    u = Field.from_numpy("u", rng.normal(size=(72, 8 ** 4)).astype(np.float32), (8,) * 4)
    with pytest.raises(ValueError, match="interior lattice"):
        PCG.wilson_normal_graph(0.1).launch({"p": p, "u": u}, config=TORCH, halo="pre")


def test_pre_refusals_on_the_cuda_engine(rng):
    """Raised before any device is touched: under "overlap" (a real
    interior) pap, which K5HO does not write, CPU tensors and a graph with
    no box kernel; a graph with no "pre" kernel; pap, which K5H does not
    write; the block view of SoA fields under "pre"; a batched "pre"
    launch; an AoS field, which K5H does not take; CPU tensors (the cuda
    engine never runs the plain version), also under a tiled plan, rsplit
    or a budget, which "pre" now runs."""
    hv = (9, 9, 9, 9)   # interior (5, 5, 5, 5): an interior box of 1 site
    pv = Field.from_numpy("p", rng.normal(size=(24, 9 ** 4)).astype(np.float32), hv)
    uv = Field.from_numpy("u", rng.normal(size=(72, 9 ** 4)).astype(np.float32), hv)
    g = PCG.wilson_normal_graph(0.1)
    with pytest.raises(ValueError, match="produces"):
        g.launch({"p": pv, "u": uv}, config=CUDA_ON_CPU, outputs=("ap", "pap"), halo="overlap")
    with pytest.raises(ValueError, match="CUDA device"):
        g.launch({"p": pv, "u": uv}, config=CUDA_ON_CPU, outputs=("ap",), halo="overlap")
    hl = (8, 8, 8, 6)   # interior (4, 4, 4, 2): 128 sites
    p = Field.from_numpy("p", rng.normal(size=(24, 8 ** 3 * 6)).astype(np.float32), hl)
    u = Field.from_numpy("u", rng.normal(size=(72, 8 ** 3 * 6)).astype(np.float32), hl)
    with pytest.raises(ValueError, match="produces"):
        g.launch({"p": p, "u": u}, config=CUDA_ON_CPU, outputs=("ap", "pap"), halo="pre")
    with pytest.raises(ValueError, match="CUDA device"):
        g.launch({"p": p, "u": u}, config=CUDA_ON_CPU, outputs=("ap",), halo="pre")
    # tiles (K5TH) and rsplit (no "pre" kernel folds partial rows) run under
    # "pre": such a launch gets as far as the device check, a budget's too
    for plan in (LoweringPlan("cuda", vvl=128, bx=1, by=1, bz=1),
                 LoweringPlan("cuda", vvl=128, rsplit=2)):
        with pytest.raises(ValueError, match="CUDA device"):
            g.launch({"p": p, "u": u}, config=CUDA_ON_CPU, outputs=("ap",), halo="pre",
                     plan=plan)
        assert adapt_plan(plan, stencil=True, halo="pre").halo == "pre"
    with pytest.raises(ValueError, match="CUDA device"):
        g.launch({"p": p, "u": u}, config=TargetConfig("cuda", device="cpu", smem_bytes=4096),
                 outputs=("ap",), halo="pre")
    # the block view of SoA fields lowers nothing natively: refused as the
    # reference refuses it
    with pytest.raises(ValueError, match="block"):
        g.launch({"p": p, "u": u}, config=CUDA_ON_CPU, outputs=("ap",), halo="pre",
                 plan=LoweringPlan("cuda", vvl=128, bx=1, view="block"))
    f3 = Field.from_numpy("x", rng.normal(size=(19, 6 ** 3)).astype(np.float32), (6,) * 3)
    cp = LaunchGraph("lap").add_stencil(_lap1d_body, {"y": "x"}, {"z": 19}, width=1,
                                        params=dict(c=0.0))
    with pytest.raises(ValueError, match="halo='pre' kernel"):
        cp.launch({"x": f3}, config=CUDA_ON_CPU, halo="pre")
    with pytest.raises(ValueError, match="box kernel"):
        cp.launch({"x": f3}, config=CUDA_ON_CPU, halo="overlap")
    from repro_torch.core import BatchedField
    bp = BatchedField.stack([p, p])
    with pytest.raises(ValueError, match="batched"):
        g.launch({"p": bp, "u": u}, config=TORCH, outputs=("ap",), halo="pre")
    # K5H's impl takes SoA fields at rings (2, 2) only
    from repro_torch.core import parse_layout
    aos = parse_layout("aos")
    pa = Field("p", 24, hl, aos, aos.pack(p.canonical()))
    with pytest.raises(ValueError, match="SoA"):
        g.launch({"p": pa, "u": u}, config=CUDA_ON_CPU, outputs=("ap",), halo="pre")


def test_pre_launches_plan_interiors_no_warp_multiple_divides(rng):
    """The "pre" kernels and K4H/K8H check their last block's bounds, so
    their launches plan a block size that need not divide the interior:
    105 sites take vvl 128 (a periodic launch's plan refuses them), and
    each launch, default or explicit plan, gets as far as the device
    check."""
    from repro_torch.core import plan as PP
    assert PP.default_plan(CUDA_ON_CPU, nsites=105, layouts=[SOA], bounded=True).vvl == 128
    assert PP.default_plan(CUDA_ON_CPU, nsites=128, layouts=[SOA], bounded=True).vvl == 128
    assert PP.plan_for_launch(CUDA_ON_CPU, 105, [SOA], bounded=True).vvl == 128
    with pytest.raises(ValueError, match="no vvl"):
        PP.default_plan(CUDA_ON_CPU, nsites=105, layouts=[SOA])
    hl = (7, 9, 5, 7)   # interior (3, 5, 1, 3): 45 sites
    n = int(np.prod(hl))
    p = Field.from_numpy("p", rng.normal(size=(24, n)).astype(np.float32), hl)
    u = Field.from_numpy("u", rng.normal(size=(72, n)).astype(np.float32), hl)
    g = PCG.wilson_normal_graph(0.1)
    for plan in (None, LoweringPlan("cuda", vvl=64)):
        with pytest.raises(ValueError, match="CUDA device"):
            g.launch({"p": p, "u": u}, config=CUDA_ON_CPU, outputs=("ap",), halo="pre",
                     plan=plan)
    with pytest.raises(ValueError, match="CUDA device"):
        dslash_halo(torch.zeros((24, 5, 7, 3, 5)), torch.zeros((72, 5, 7, 3, 5)),
                    config=CUDA_ON_CPU)
    with pytest.raises(ValueError, match="CUDA device"):
        propagate_halo(torch.zeros((19, 7, 9, 5)), config=CUDA_ON_CPU)


def test_pre_plan_key_names_the_halo_and_the_interior(rng):
    """plan_key's halo element and lattice follow the reference: "pre" and
    "overlap" share keys, which differ from the periodic one's."""
    hl = (6, 6, 6, 6)
    p = Field.from_numpy("p", rng.normal(size=(24, 6 ** 4)).astype(np.float32), hl)
    u = Field.from_numpy("u", rng.normal(size=(72, 6 ** 4)).astype(np.float32), hl)
    g = PCG.wilson_normal_graph(0.1)
    kp = g.plan_key({"p": p, "u": u}, config=TORCH, halo="pre", lattice=(2, 2, 2, 2))
    assert kp == g.plan_key({"p": p, "u": u}, config=TORCH, halo="overlap",
                            lattice=(2, 2, 2, 2))
    assert kp != g.plan_key({"p": p, "u": u}, config=TORCH)


def test_dslash_halo_and_propagate_halo_refuse_cpu_tensors_on_cuda(rng):
    psi = torch.zeros((24,) + (6,) * 4)
    u = torch.zeros((72,) + (6,) * 4)
    with pytest.raises(ValueError, match="CUDA device"):
        dslash_halo(psi, u, config=CUDA_ON_CPU)
    with pytest.raises(ValueError, match="CUDA device"):
        propagate_halo(torch.zeros((19, 6, 6, 6)), config=CUDA_ON_CPU)
    with pytest.raises(ValueError, match="spinor"):
        wk.dslash_halo_plain(psi, torch.zeros((72,) + (5,) * 4))
    assert d3q19.NVEL == 19


def test_sharded_schedules_launch_what_they_name(monkeypatch):
    """The sharded solve under "pre" runs the wilson_normal graph's "pre"
    launch once an iteration (and no dslash in the loop), under None never,
    and under "overlap" at this thin block (interior 0 along x and y for
    ring 2) falls back to it, once an iteration; the sharded step runs the
    LB graph's "pre" launch once a step, under "overlap" once a box (an
    interior and two x-slabs, on the torch engine)."""
    from repro_torch.apps.ludwig import init_state
    from repro_torch.apps.milc import MilcConfig, init_problem
    from repro_torch.apps.milc.driver import make_domain, make_sharded_solver

    calls = []
    launch = LaunchGraph.launch

    def spy(self, ins, **kw):
        calls.append((self.name, kw.get("halo", "periodic")))
        return launch(self, ins, **kw)

    monkeypatch.setattr(LaunchGraph, "launch", spy)
    mc = MilcConfig(lattice=(4, 4, 4, 4), kappa=0.1, tol=1e-8, max_iter=200, target=TORCH)
    u, b = init_problem(mc, seed=0)
    dom = make_domain(mc, _mesh("x", "y"), ("x", "y", None, None))
    for halo in (None, "pre", "overlap"):
        calls.clear()
        _, it, _ = make_sharded_solver(mc, dom, halo)(dom.scatter(u.canonical_nd()),
                                                     dom.scatter(b.canonical_nd()))
        assert calls.count(("wilson_normal", "pre")) == (it if halo else 0), (halo, it)
    cfg = LudwigConfig(lattice=(6, 6, 6), target=TORCH)
    st = init_state(cfg, seed=0)
    ldom = Domain(cfg.lattice, _mesh("x"), ("x", None, None), halo=2)
    calls.clear()
    PLD.make_sharded_step(cfg, ldom)(ldom.scatter(st.dist.canonical_nd()),
                                     ldom.scatter(st.q.canonical_nd()))
    assert calls.count(("ludwig_lb_step", "pre")) == 1
    calls.clear()
    PLD.make_sharded_step(cfg, ldom, halo="overlap")(ldom.scatter(st.dist.canonical_nd()),
                                                     ldom.scatter(st.q.canonical_nd()))
    assert calls.count(("ludwig_lb_step", "pre")) == 3
    with pytest.raises(ValueError, match="halo must be"):
        PLD.make_sharded_step(cfg, ldom, halo="ring")
    with pytest.raises(ValueError, match="halo must be"):
        make_sharded_solver(mc, dom, "ring")
